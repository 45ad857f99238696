"""Port parity for the MoE family: ``models/moe.py`` and the grouped forms
of the VQ-AMM entry points (a leading expert axis) against the JAX
package on the same numpy inputs, on the CPU.

Covered: the plain grouped ops against a loop of the ungrouped ones
(bit for bit); ``precompute_layer`` on expert leaves (one int8 scale per
expert and column); ``expert_proj`` against the JAX package's with its
vmapped Pallas kernels in interpret mode (``impl="fused"`` and
``"pallas"``), int8 and float32 LUTs, and in dense mode; ``moe_ffn`` on
the deepseek-moe-16b and dbrx-132b smoke configs, and a case that drops
(64 experts, top-6, capacity factor 1.25, 32 tokens: capacity 8 for a
mean load of 3), whose kept and dropped pairs must equal the reference's;
``Model.prefill_paged`` / ``decode_paged`` chains; the continuous engine's
greedy tokens (fused, two-pass, code pool), the speculative engine
(ngram) and the batch-to-completion engine against the JAX engines.

Tolerance: rtol = atol = 1e-4 in float32 (every projection is an exact
int8 sum or a float32 sum in another order; routing, norms and attention
sum in another order); greedy tokens identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import BatchToCompletionEngine as JBatch  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (kv_codebook_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import (BatchToCompletionEngine, Engine,  # noqa
                               Request, SpecConfig)

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["deepseek-moe-16b", "dbrx-132b"]


def _torch(tree):
    """A JAX param (sub)tree as CPU tensors, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _margin_x(rng, z, m):
    """(E, M, nc, v) rows that are a centroid of their expert plus small
    noise: every argmin has a clear margin, so both packages pick it."""
    e, nc, c, v = z.shape
    pick = rng.integers(0, c, (e, m, nc))
    x = z[np.arange(e)[:, None, None], np.arange(nc)[None, None], pick]
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# the grouped kernels' plain forms and the expert LUTs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_grouped_plain_ops_equal_a_loop_of_the_ungrouped_ones(metric,
                                                              lut_dtype):
    rng = np.random.default_rng(0)
    e, m, nc, c, v, n = 3, 5, 6, 16, 4, 20
    x = torch.from_numpy(rng.standard_normal((e, m, nc, v)).astype(
        np.float32))
    z = torch.from_numpy(rng.standard_normal((e, nc, c, v)).astype(
        np.float32))
    lut = torch.from_numpy(rng.standard_normal((e, nc, c, n)).astype(
        np.float32))
    scale = None
    if lut_dtype == torch.int8:
        lut = (lut * 40).clamp(-127, 127)
        scale = torch.from_numpy((0.01 + rng.random((e, n))).astype(
            np.float32))
    lut = lut.to(lut_dtype)
    calls = (tref.vq_amm_ref.calls, tref.assign_ref.calls,
             tref.lut_gemm_onehot.calls)
    out = tops.vq_amm(x, z, lut, scale, metric)
    idx = tops.vq_assign(x, z, metric)
    two = tops.lut_matmul(idx, lut, scale)
    # one plain call each for all experts, as one kernel launch on the card
    assert (tref.vq_amm_ref.calls, tref.assign_ref.calls,
            tref.lut_gemm_onehot.calls) == tuple(c + 1 for c in calls)
    assert out.shape == (e, m, n) and idx.shape == (e, m, nc)
    for i in range(e):
        si = None if scale is None else scale[i]
        assert torch.equal(out[i], tops.vq_amm(x[i], z[i], lut[i], si,
                                               metric))
        assert torch.equal(idx[i], tops.vq_assign(x[i], z[i], metric))
        assert torch.equal(two[i], tops.lut_matmul(idx[i], lut[i], si))
    assert torch.equal(two, out)


def test_precompute_layer_on_expert_leaves_matches_jax():
    """w (E, K, N), z (E, nc, c, v) -> lut (E, nc, c, N) and, in int8,
    lut_scale (E, N): one scale per expert and column, bit for bit the
    JAX package's on the same float table (the amax never mixes
    experts)."""
    rng = np.random.default_rng(1)
    e, k, n, v, c = 4, 24, 10, 4, 8
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    w[2] *= 50.0                         # one expert far larger than the rest
    z = rng.standard_normal((e, k // v, c, v)).astype(np.float32)
    lut_j = np.asarray(jax.vmap(jlut.build_lut)(jnp.asarray(w),
                                                jnp.asarray(z)))
    lut_t = tlut.build_lut(torch.from_numpy(w), torch.from_numpy(z))
    np.testing.assert_allclose(lut_t.numpy(), lut_j, rtol=1e-5, atol=1e-5)
    q_j, s_j = jax.vmap(jlut.quantize_lut_int8)(jnp.asarray(lut_j))
    lut_c = torch.from_numpy(np.array(lut_j))
    q_t, s_t = tlut.quantize_lut_int8(lut_c)
    assert tuple(s_t.shape) == (e, n)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for i in range(e):                   # each expert alone: the same
        q_i, s_i = tlut.quantize_lut_int8(lut_c[i].clone())
        assert torch.equal(q_i, q_t[i]) and torch.equal(s_i, s_t[i])
    p_j = {"w": jnp.asarray(w), "z": jnp.asarray(z)}
    p_t = {"w": torch.from_numpy(w), "z": torch.from_numpy(z)}
    for dt in ("float32", "bfloat16", "int8"):
        out_j = jlut.precompute_layer(p_j, JQC(mode="lut_infer",
                                               lut_dtype=dt, v=v, c=c))
        out_t = tlut.precompute_layer(p_t, TQC(mode="lut_infer",
                                               lut_dtype=dt, v=v, c=c))
        assert set(out_t) == set(out_j)
        for key in out_t:
            assert tuple(out_t[key].shape) == out_j[key].shape
        got = out_t["lut"].float().numpy()
        want = np.asarray(out_j["lut"], np.float32)
        if dt == "int8":         # summation order may move a .5 rounding
            assert np.abs(got - want).max() <= 1
            np.testing.assert_allclose(out_t["lut_scale"].numpy(),
                                       np.asarray(out_j["lut_scale"]),
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2 if dt ==
                                       "bfloat16" else 1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# expert_proj and moe_ffn
# ---------------------------------------------------------------------------

def _expert_params(rng, e, k, n, v, c, lut_dtype):
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    z = rng.standard_normal((e, k // v, c, v)).astype(np.float32)
    p_j = jlut.precompute_layer({"w": jnp.asarray(w), "z": jnp.asarray(z)},
                                JQC(mode="lut_infer", lut_dtype=lut_dtype,
                                    v=v, c=c))
    return p_j, _torch(p_j)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("lut_dtype", ["int8", "float32"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
def test_expert_proj_matches_jax(impl, lut_dtype, fuse):
    """The JAX package's expert_proj with its Pallas kernels vmapped over
    the experts (interpret mode), against the port's one grouped call."""
    rng = np.random.default_rng(2)
    e, cap, k, n, v, c = 5, 7, 32, 24, 8, 16
    p_j, p_t = _expert_params(rng, e, k, n, v, c, lut_dtype)
    x = _margin_x(rng, np.asarray(p_j["z"]), cap).reshape(e, cap, k)
    qc_j = JQC(mode="lut_infer", lut_dtype=lut_dtype, v=v, c=c, impl=impl,
               fuse=fuse)
    qc_t = TQC(mode="lut_infer", lut_dtype=lut_dtype, v=v, c=c, fuse=fuse)
    want, _ = jmoe.expert_proj(p_j, jnp.asarray(x), qc_j)
    got = tmoe.expert_proj(p_t, torch.from_numpy(x), qc_t)
    assert got.shape == (e, cap, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and on random rows, through the JAX package's plain reference
    xr = rng.standard_normal((e, cap, k)).astype(np.float32)
    want, _ = jmoe.expert_proj(p_j, jnp.asarray(xr), qc_j.replace(impl="ref"))
    got = tmoe.expert_proj(p_t, torch.from_numpy(xr), qc_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_expert_proj_dense_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 16, 12)).astype(np.float32)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want, _ = jmoe.expert_proj({"w": jnp.asarray(w)}, jnp.asarray(x),
                               JQC(mode="dense"))
    got = tmoe.expert_proj({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                           TQC(mode="dense"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _moe_pair(cfg_j, seed, lut_dtype="int8"):
    """One MoE layer of cfg_j from the JAX init (lut_train centroids),
    precomputed for lut_infer, and its copy as CPU tensors."""
    qc_j = JQC(mode="lut_infer", lut_dtype=lut_dtype)
    p_j = precompute_model(jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j,
                                         JQC(mode="lut_train"), jnp.float32),
                           qc_j)
    # the router and norm are random too, so routing is not uniform
    p_j["norm"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                          p_j["norm"].shape)
    return p_j, qc_j, _torch(p_j), TQC(mode="lut_infer", lut_dtype=lut_dtype)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
def test_moe_ffn_matches_jax(arch, fuse):
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg_t = tconfigs.get_smoke_config(arch)
    p_j, qc_j, p_t, qc_t = _moe_pair(cfg_j, 4)
    assert ("shared_wg" in p_t) == (cfg_t.num_shared_experts > 0)
    x = np.random.default_rng(5).standard_normal(
        (2, 5, cfg_t.d_model)).astype(np.float32)
    out_j, _, aux_j = jmoe.moe_ffn(p_j, jnp.asarray(x), cfg_j,
                                   qc_j.replace(fuse=fuse))
    out_t, aux_t = tmoe.moe_ffn(p_t, torch.from_numpy(x), cfg_t,
                                qc_t.replace(fuse=fuse))
    assert out_t.shape == x.shape
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def _jax_routing(probs, k, cap):
    """The reference's slot assignment (src/repro/models/moe.py), on the
    JAX side: expert id, slot and keep of each (token, choice) pair."""
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    e = probs.shape[-1]
    flat_oh = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32).reshape(-1, e)
    pos_in_e = jnp.cumsum(flat_oh, axis=0) - flat_oh
    slot = jnp.sum(pos_in_e * flat_oh, axis=-1)
    return (np.asarray(gate_idx.reshape(-1)), np.asarray(slot),
            np.asarray(slot < cap))


def test_moe_ffn_drops_as_the_reference_does():
    """64 experts, top-6, capacity factor 1.25 over a 32-token chunk:
    capacity 8 for a mean load of 3. Half the tokens repeat one row, so
    their experts overflow: the dropped pairs, the kept pairs and the
    outputs must be the reference's."""
    kw = dict(name="moe-drop", family="moe", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=2, d_ff=16, vocab_size=64,
              num_experts=64, top_k=6, capacity_factor=1.25,
              num_shared_experts=1)
    cfg_j, cfg_t = JModelConfig(**kw), TModelConfig(**kw)
    p_j, qc_j, p_t, qc_t = _moe_pair(cfg_j, 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 32, 16)).astype(np.float32)
    x[0, ::2] = x[0, 0]                  # 16 tokens route alike
    t, k, e = 32, 6, 64
    cap = min(t, max(int(1.25 * t * k / e), 8))
    assert cap == 8
    # the router probabilities of both packages, then each one's routing
    xn_j = jmoe.rms_norm(jnp.asarray(x), p_j["norm"], cfg_j.norm_eps)
    probs_j = jax.nn.softmax(xn_j.reshape(t, -1) @ p_j["router"], axis=-1)
    eid_j, slot_j, keep_j = _jax_routing(probs_j, k, cap)
    xn_t = tmoe.rms_norm(torch.from_numpy(x), p_t["norm"], cfg_t.norm_eps)
    probs_t = torch.softmax((xn_t.reshape(t, -1) @ p_t["router"]).float(), -1)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               rtol=1e-5, atol=1e-6)
    eid_t, slot_t, keep_t, _, load_t = tmoe.route(probs_t, k, cap)
    assert (~keep_j).sum() >= 8          # the case really drops
    np.testing.assert_array_equal(eid_t.numpy(), eid_j)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    # the live rows the kernels take: the reference's kept pairs an expert
    np.testing.assert_array_equal(load_t.clamp(max=cap).numpy(),
                                  np.bincount(eid_j[keep_j], minlength=e))
    for fuse in (True, False):
        out_j, _, aux_j = jmoe.moe_ffn(p_j, jnp.asarray(x), cfg_j,
                                       qc_j.replace(fuse=fuse))
        out_t, aux_t = tmoe.moe_ffn(p_t, torch.from_numpy(x), cfg_t,
                                    qc_t.replace(fuse=fuse))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_route_breaks_ties_by_the_lowest_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    eid, slot, keep, gates, load = tmoe.route(probs, 3, 8)
    assert eid.tolist() == [0, 1, 2, 1, 3, 0]
    assert load.tolist() == [2, 2, 1, 1] and load.dtype == torch.int64
    assert slot.tolist() == [0, 0, 0, 1, 0, 1] and bool(keep.all())
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1])
    assert eid.tolist() == want_idx.reshape(-1).tolist()
    np.testing.assert_allclose(gates[:3].numpy(), [1 / 3] * 3, rtol=1e-6)


# ---------------------------------------------------------------------------
# live-row counts: the routed experts' calls work on the rows the router
# filled; rows past an expert's count are 0.0 (index 0 from vq_assign)
# ---------------------------------------------------------------------------

# an expert with no live row, one partly live, one full, one whose count
# passes the capacity (clamped), one with a single row
COUNTS = [0, 2, 6, 9, 1]


def _live_mask(counts, m):
    return torch.arange(m)[None] < torch.as_tensor(counts)[:, None]


@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_grouped_plain_ops_with_counts(metric, lut_dtype):
    """The grouped plain ops with counts: live rows equal the calls
    without counts bit for bit, dead rows are 0.0 (index 0), and the two
    passes equal the fused op; an ungrouped call takes counts of one."""
    rng = np.random.default_rng(20)
    e, m, nc, c, v, n = len(COUNTS), 6, 5, 16, 4, 20
    x = torch.from_numpy(rng.standard_normal((e, m, nc, v)).astype(
        np.float32))
    z = torch.from_numpy(rng.standard_normal((e, nc, c, v)).astype(
        np.float32))
    lut = torch.from_numpy(rng.standard_normal((e, nc, c, n)).astype(
        np.float32))
    scale = None
    if lut_dtype == torch.int8:
        lut = (lut * 40).clamp(-127, 127)
        scale = torch.from_numpy((0.01 + rng.random((e, n))).astype(
            np.float32))
    lut = lut.to(lut_dtype)
    counts = torch.tensor(COUNTS, dtype=torch.int64)
    live = dict(counts=counts, most_live=sum(COUNTS))
    out = tops.vq_amm(x, z, lut, scale, metric, **live)
    idx = tops.vq_assign(x, z, metric, **live)
    two = tops.lut_matmul(idx, lut, scale, **live)
    mask = _live_mask(COUNTS, m)
    assert torch.equal(out[mask], tops.vq_amm(x, z, lut, scale,
                                              metric)[mask])
    assert torch.equal(idx[mask], tops.vq_assign(x, z, metric)[mask])
    assert torch.equal(out[~mask], torch.zeros_like(out[~mask]))
    assert not torch.signbit(out[~mask]).any()        # +0.0, as written
    assert torch.equal(idx[~mask], torch.zeros_like(idx[~mask]))
    assert torch.equal(two, out)
    assert idx.dtype == torch.int32 and out.dtype == torch.float32
    # ungrouped, with the counts of one expert
    s3 = None if scale is None else scale[1]
    one = tops.vq_amm(x[1], z[1], lut[1], s3, metric, counts=counts[1:2])
    assert torch.equal(one, out[1])


def _dispatch_rows(x, counts):
    """Zero the rows of an (E, Cap, K) buffer past each expert's count, as
    the dispatch leaves them."""
    return x * _live_mask(counts, x.shape[1]).numpy()[..., None]


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("lut_dtype", ["int8", "float32"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
def test_expert_proj_with_counts_matches_jax(impl, lut_dtype, fuse):
    """The JAX package's expert_proj (its Pallas kernels vmapped over the
    experts, interpret mode) on a buffer whose rows past each count are
    zero, against the port's grouped call with the counts: live rows
    within the tolerance, dead rows 0.0."""
    rng = np.random.default_rng(21)
    e, cap, k, n, v, c = len(COUNTS), 6, 32, 24, 8, 16
    p_j, p_t = _expert_params(rng, e, k, n, v, c, lut_dtype)
    x = _margin_x(rng, np.asarray(p_j["z"]), cap).reshape(e, cap, k)
    x = _dispatch_rows(x, COUNTS).astype(np.float32)
    qc_j = JQC(mode="lut_infer", lut_dtype=lut_dtype, v=v, c=c, impl=impl,
               fuse=fuse)
    qc_t = TQC(mode="lut_infer", lut_dtype=lut_dtype, v=v, c=c, fuse=fuse)
    want, _ = jmoe.expert_proj(p_j, jnp.asarray(x), qc_j)
    got = tmoe.expert_proj(p_t, torch.from_numpy(x), qc_t,
                           counts=torch.tensor(COUNTS), most_live=18)
    mask = _live_mask(COUNTS, cap).numpy()
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask],
                               **TOL)
    assert not got.numpy()[~mask].any()


@pytest.mark.parametrize("t,k,e,cap", [(8, 6, 64, 8), (32, 6, 64, 8),
                                       (8, 4, 16, 8), (12, 2, 4, 3)])
def test_route_counts_are_the_reference_kept_pairs(t, k, e, cap):
    """route's last output, clamped to the capacity, is the number of
    pairs the reference keeps in each expert's buffer (its live rows),
    and those pairs take its first slots."""
    rng = np.random.default_rng(t * 100 + e)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[::2] = logits[0]              # tokens that route alike: drops
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    eid_j, slot_j, keep_j = _jax_routing(probs, k, cap)
    eid, slot, keep, _, load = tmoe.route(torch.from_numpy(
        np.array(probs)), k, cap)
    assert tuple(load.shape) == (e,) and load.dtype == torch.int64
    assert int(load.sum()) == t * k
    kept = np.bincount(eid_j[keep_j], minlength=e)
    np.testing.assert_array_equal(load.clamp(max=cap).numpy(), kept)
    for ex in range(e):
        assert sorted(slot_j[keep_j & (eid_j == ex)].tolist()) == list(
            range(kept[ex]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
def test_moe_ffn_passes_live_counts(arch, fuse, monkeypatch):
    """moe_ffn's routed expert calls take route's counts (E,) and the
    bound T x k, its shared expert calls none; the output still equals
    the JAX package's."""
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg_t = tconfigs.get_smoke_config(arch)
    p_j, qc_j, p_t, qc_t = _moe_pair(cfg_j, 4)
    seen = []

    def spy(name):
        orig = getattr(tops, name)

        def call(*a, counts=None, most_live=None):
            seen.append((name, a[0].shape[0], counts, most_live))
            return orig(*a, counts=counts, most_live=most_live)
        monkeypatch.setattr(tops, name, call)
    for name in ("vq_amm", "vq_assign", "lut_matmul"):
        spy(name)
    x = np.random.default_rng(5).standard_normal(
        (2, 5, cfg_t.d_model)).astype(np.float32)
    out_t, _ = tmoe.moe_ffn(p_t, torch.from_numpy(x), cfg_t,
                            qc_t.replace(fuse=fuse))
    out_j, _, _ = jmoe.moe_ffn(p_j, jnp.asarray(x), cfg_j,
                               qc_j.replace(fuse=fuse))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    t, k, e = 10, cfg_t.top_k, cfg_t.num_experts
    routed = [r for r in seen if r[2] is not None]
    shared = [r for r in seen if r[2] is None]
    assert len(routed) == 3 * (1 if fuse else 2)
    assert len(shared) == (3 * (1 if fuse else 2)
                           if cfg_t.num_shared_experts else 0)
    for _, experts, counts, most in routed:
        assert experts == e and most == t * k
        assert counts.dtype == torch.int64 and tuple(counts.shape) == (e,)
        assert int(counts.sum()) == t * k      # every pair, before the cap
    assert all(r[1] == cfg_t.num_shared_experts for r in shared)


def test_work_counts_live_rows():
    """kernels.work with counts against a hand count: live rows of x (B4:
    their indices), z and scale of experts with a live row, the LUT rows
    live rows can select, the whole output; a meta count is unknown (the
    bound most_live gives), no counts count as before."""
    from repro_torch.kernels import work
    e, m, nc, c, v, n = 3, 4, 5, 16, 8, 20
    x = torch.zeros((e, m, nc, v), dtype=torch.bfloat16)
    z = torch.zeros((e, nc, c, v), dtype=torch.bfloat16)
    lut = torch.zeros((e, nc, c, n), dtype=torch.int8)
    scale = torch.zeros((e, n))
    idx = torch.zeros((e, m, nc), dtype=torch.int32)
    counts = [0, 2, 9]                  # 0 + 2 + 4 (clamped) live rows
    rows, experts = 6, 2
    out = e * m * n * 4
    b1 = (rows * nc * v * 2 + experts * nc * c * v * 2 + experts * n * 4
          + nc * (2 + 4) * n + out,
          rows * (nc * c * (4 * v + 2) + nc * n + n))
    assert work.vq_amm(x, z, lut, scale, counts=counts) == b1
    assert work.vq_amm(x, z, lut, scale,
                       counts=torch.tensor(counts)) == b1
    assert work.vq_assign(x, z, counts=counts) == (
        rows * nc * v * 2 + experts * nc * c * v * 2 + e * m * nc * 4,
        rows * nc * c * (4 * v + 2))
    assert work.lut_gemm(idx, lut, scale, counts=counts, rows=7) == (
        rows * nc * 4 + experts * n * 4 + 7 * n + out,
        rows * (nc * n + n))
    # unknown counts: the bound of 5 live rows in all, on up to 3 experts
    meta = torch.empty(3, dtype=torch.int64, device="meta")
    assert work.vq_assign(x, z, counts=meta, most_live=5) == (
        5 * nc * v * 2 + 3 * nc * c * v * 2 + e * m * nc * 4,
        5 * nc * c * (4 * v + 2))
    assert work.vq_amm(x, z, lut, scale, most_live=5)[0] == (
        5 * nc * v * 2 + 3 * nc * c * v * 2 + 3 * n * 4
        + nc * 5 * n + out)
    # no counts: every row, as before
    assert work.vq_amm(x, z, lut, scale) == (
        work.nbytes(x, z, scale) + e * nc * min(m, c) * n + out,
        e * (m * nc * c * (4 * v + 2) + m * nc * n + m * n))
    # the LUT rows live rows select: expert 1's two rows pick 0 and 3 in
    # every subspace; expert 2's rows pick 1 (its dead rows pick 5)
    idx[1, 1] = 3
    idx[2] = 1
    idx[0] = 5
    assert work.selected_rows(idx, c) == 3 * nc + nc
    assert work.selected_rows(idx, c, counts) == 3 * nc


# ---------------------------------------------------------------------------
# the model and the engines
# ---------------------------------------------------------------------------

PS, MAX_SEQ, N_PAGES, CHUNK = 8, 32, 10, 4
ENGINE_KW = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)


def _carry(arch, seed, qc_kw=None):
    """A JAX smoke model of ``arch`` in lut_infer (int8), its params
    carried over to the port's model on the CPU."""
    qc_kw = qc_kw or {}
    jm = JModel(jconfigs.get_smoke_config(arch))
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas", **qc_kw)
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(seed), JQC(mode="lut_train")), qc_j)
    tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, TQC(mode="lut_infer",
                                                 lut_dtype="int8", **qc_kw)


@pytest.fixture(scope="module")
def deepseek():
    return _carry("deepseek-moe-16b", 8)


def test_params_from_numpy_unstacks_expert_leaves(deepseek):
    """(L, E, ...) expert leaves become one (E, ...) tensor a layer, and
    Model.init builds the same tree (keys, shapes, dtypes; no dense
    weight) in lut_infer."""
    _, params_j, _, tm, params_t, qc_t = deepseek
    cfg = tm.cfg
    moe = params_t["blocks"][1]["moe"]
    assert tuple(moe["wg"]["lut"].shape) == (cfg.num_experts,
                                             cfg.d_model // 8, 16, cfg.d_ff)
    assert tuple(moe["wg"]["lut_scale"].shape) == (cfg.num_experts,
                                                   cfg.d_ff)
    assert tuple(moe["shared_wd"]["lut"].shape) == (
        cfg.num_shared_experts, cfg.d_ff // 8, 16, cfg.d_model)
    np.testing.assert_array_equal(
        moe["wd"]["lut"].numpy(),
        np.asarray(params_j["blocks"]["moe"]["wd"]["lut"][1]))
    own = tm.init(torch.Generator().manual_seed(0), qc_t)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items() if k != "w"}
        return (tuple(tree.shape), tree.dtype)
    for lt, lr in zip(own["blocks"], params_t["blocks"]):
        assert spec(lt) == spec(lr)
    assert own.keys() == params_t.keys()


def test_config_copies_and_registry():
    for arch in MOE_ARCHS:
        for name in ("get_config", "get_smoke_config"):
            assert dataclasses.asdict(getattr(tconfigs, name)(arch)) == \
                dataclasses.asdict(getattr(jconfigs, name)(arch))
    full = tconfigs.get_config("deepseek-moe-16b")
    assert (full.num_layers, full.d_model, full.num_experts, full.top_k,
            full.num_shared_experts, full.d_ff) == (28, 2048, 64, 6, 2, 1408)
    # every family of the JAX package builds; an unknown one raises
    for family in ("ssm", "hybrid", "audio", "vlm"):
        assert TModel(full.replace(family=family),
                      device="cpu").cfg.family == family
    with pytest.raises(ValueError, match="unknown family"):
        TModel(full.replace(family="diffusion"), device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_chain_match_jax(arch):
    """Chunked prefill of three prompts (chunk pad rows route too), then a
    5-step greedy decode chain of the first two slots (slot 2 not
    decoding): logits within 1e-4, argmax equal, the pools equal."""
    jm, params_j, qc_j, tm, params_t, qc_t = _carry(arch, 9)
    cfg = tm.cfg
    kv_j = jm.init_paged_cache(3, MAX_SEQ, PS, num_pages=N_PAGES)
    kv_t = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES)
    table = np.full((3, MAX_SEQ // PS), -1, np.int32)
    table[0, :3] = [5, 2, 8]
    table[1, :2] = [0, 7]
    table[2, :1] = [9]
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (13, 9, 3)]
    pf_j = jax.jit(lambda p, t, kv, pt, s, pos, v: jm.prefill_paged(
        p, t, kv, pt, s, pos, v, qc_j))
    dec_j = jax.jit(lambda p, t, kv, pt, pos: jm.decode_paged(
        p, t, kv, pt, pos, qc_j))
    table_t = torch.from_numpy(table)
    last = {}
    for slot, prompt in enumerate(prompts):
        for pos in range(0, len(prompt), CHUNK):
            chunk = prompt[pos:pos + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :len(chunk)] = chunk
            lg_j, kv_j = pf_j(params_j, jnp.asarray(toks), kv_j,
                              jnp.asarray(table), slot, pos, len(chunk))
            lg_t = tm.prefill_paged(params_t, torch.from_numpy(toks), kv_t,
                                    table_t, slot, pos, len(chunk), qc_t)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
        last[slot] = int(np.argmax(np.asarray(lg_j)[0]))
        assert int(lg_t.argmax()) == last[slot]
    live = np.ones(N_PAGES + 1, bool)
    live[-1] = False
    positions = np.array([len(prompts[0]), len(prompts[1]), -1], np.int32)
    toks = np.array([[last[0]], [last[1]], [0]], np.int32)
    for _ in range(5):
        lg_j, kv_j = dec_j(params_j, jnp.asarray(toks), kv_j,
                           jnp.asarray(table), jnp.asarray(positions))
        lg_t = tm.decode_paged(params_t, torch.from_numpy(toks), kv_t,
                               table_t, torch.from_numpy(positions), qc_t)
        lg_j = np.asarray(lg_j)
        np.testing.assert_allclose(lg_t.numpy()[:2], lg_j[:2], **TOL)
        nxt = lg_j.argmax(-1)
        np.testing.assert_array_equal(lg_t.numpy()[:2].argmax(-1), nxt[:2])
        toks = nxt[:, None].astype(np.int32)
        positions[:2] += 1
    for key in ("k", "v"):
        np.testing.assert_allclose(kv_t[key].numpy()[:, live],
                                   np.asarray(kv_j[key])[:, live], atol=1e-5)


# (prompt length, max_new): 6 pages of demand against a 5-page pool
PLAN = ((11, 12), (6, 12), (3, 6))
LATE = (2, 5)                           # submitted mid-decode


def _serve(engine, make_req, vocab):
    rng = np.random.default_rng(11)
    plan = [(rng.integers(0, vocab, n).tolist(), m) for n, m in PLAN]
    reqs = [make_req(p, n) for p, n in plan]
    for r in reqs:
        engine.submit(r)
    for _ in range(5):
        engine.step()
    late = make_req(rng.integers(0, vocab, LATE[0]).tolist(), LATE[1])
    engine.submit(late)
    engine.run_until_idle()
    return reqs + [late]


@pytest.mark.parametrize("run", ["fused", "two-pass", "vq-kv"])
def test_engine_greedy_tokens_match_jax_engine(run):
    """deepseek-moe-16b smoke through the continuous engine: fused
    projections, two-pass, and fused on a VQ code pool (the JAX engine's
    own codebook, carried over): the JAX engine's greedy tokens,
    mid-decode admission and preemption included."""
    qc_kw = {"two-pass": dict(fuse=False), "vq-kv": dict(kv_quant="vq")}
    jm, params_j, qc_j, tm, params_t, qc_t = _carry(
        "deepseek-moe-16b", 12, qc_kw.get(run))
    j_kw, t_kw = {}, {}
    if run == "vq-kv":
        cb_j = JEngine(jm, params_j, qc_j, batch_size=1, max_seq=MAX_SEQ,
                       page_size=PS, prefill_chunk=CHUNK,
                       prefix_cache=False).kv_codebook
        j_kw["kv_codebook"] = cb_j
        t_kw["kv_codebook"] = kv_codebook_from_numpy(
            jax.tree_util.tree_map(np.asarray, cb_j.tree()), device="cpu")
    j_eng = JEngine(jm, params_j, qc_j, num_pages=5, prefix_cache=False,
                    degradation=None, **j_kw, **ENGINE_KW)
    t_eng = Engine(tm, params_t, qc_t, num_pages=5, **t_kw, **ENGINE_KW)
    vocab = tm.cfg.vocab_size
    j_reqs = _serve(j_eng, lambda p, n: JRequest(tokens=p, max_new_tokens=n),
                    vocab)
    t_reqs = _serve(t_eng, lambda p, n: Request(tokens=p, max_new_tokens=n),
                    vocab)
    assert j_eng.scheduler.preemptions >= 1
    assert t_eng.scheduler.preemptions == j_eng.scheduler.preemptions
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.done and rt.finish_reason.name == rj.finish_reason.name
        assert rt.out_tokens == rj.out_tokens


def _mixed(make):
    return [make(tokens=[3, 4, 5, 6], max_new_tokens=12),
            make(tokens=[9, 8, 7], max_new_tokens=8),
            make(tokens=[1, 2], max_new_tokens=10),
            make(tokens=[4, 4, 4, 4, 4], max_new_tokens=6)]


def test_speculative_and_batch_engines_match_jax(deepseek):
    """The ngram speculative engine's greedy streams equal the plain
    engine's and the JAX speculative engine's (the smoke config's
    capacity factor keeps every verify drop-free); the batch-to-completion
    engine's tokens and step stamps equal the JAX batch engine's."""
    jm, params_j, qc_j, tm, params_t, qc_t = deepseek
    kw = dict(batch_size=2, max_seq=48, page_size=8, prefill_chunk=4)
    base = _mixed(Request)
    Engine(tm, params_t, qc_t, **kw).run(base)
    sp = _mixed(Request)
    eng = Engine(tm, params_t, qc_t, spec_decode=SpecConfig(
        k=3, drafter="ngram"), **kw)
    eng.run(sp)
    j_sp = _mixed(JRequest)
    JEngine(jm, params_j, qc_j, prefix_cache=False, degradation=None,
            spec_decode=JSpecConfig(k=3, drafter="ngram"), **kw).run(j_sp)
    want = [r.out_tokens for r in base]
    assert [r.out_tokens for r in sp] == want
    assert [r.out_tokens for r in j_sp] == want
    assert eng.spec_rounds > 0

    def stamps(reqs):
        return [(r.finish_reason.name, r.out_tokens, r.first_token_step,
                 r.finish_step) for r in reqs]
    t_reqs = _mixed(Request)
    BatchToCompletionEngine(tm, params_t, qc_t, batch_size=2,
                            max_seq=32).run(t_reqs)
    j_reqs = _mixed(JRequest)
    JBatch(jm, params_j, qc_j, batch_size=2, max_seq=32).run(j_reqs)
    assert stamps(t_reqs) == stamps(j_reqs)
