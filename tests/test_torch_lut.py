"""Port parity: similarity, LUT construction and kernel B1's plain version
against the JAX package, on the same numpy inputs (float32, CPU).

Tolerances: values at rtol = atol = 1e-4 (float32 sums in another order);
indices compared tie-aware, i.e. wherever the JAX distances separate the
best centroid from the second by more than 1e-5 (below that, the two
frameworks' summation orders may legitimately pick either).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lut as jlut  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_amm import vq_amm_pallas  # noqa: E402
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core import similarity as tsim  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

METRICS = ["l2", "l1", "chebyshev"]
GAP = 1e-5


def _np(t):
    return np.asarray(t)


def _clear(d):
    """(..., c) distances -> (...,) True where the best centroid beats the
    second by more than GAP."""
    s = np.sort(np.asarray(d, np.float64), axis=-1)
    return (s[..., 1] - s[..., 0]) > GAP


@pytest.mark.parametrize("metric", METRICS)
def test_distances_and_assignment_match_jax(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 7, 4)).astype(np.float32)
    z = rng.standard_normal((7, 16, 4)).astype(np.float32)
    d_j = _np(jsim.pairwise_distance_subspaces(jnp.asarray(x), jnp.asarray(z),
                                               metric))
    d_t = tsim.pairwise_distance_subspaces(torch.from_numpy(x),
                                           torch.from_numpy(z), metric)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-5)
    one_j = _np(jsim.pairwise_distance(jnp.asarray(x[:, 0]),
                                       jnp.asarray(z[0]), metric))
    one_t = tsim.pairwise_distance(torch.from_numpy(x[:, 0]),
                                   torch.from_numpy(z[0]), metric)
    np.testing.assert_allclose(one_t.numpy(), one_j, rtol=1e-5, atol=1e-5)
    i_j = _np(jsim.assign_subspaces(jnp.asarray(x), jnp.asarray(z), metric))
    i_t = tsim.assign_subspaces(torch.from_numpy(x), torch.from_numpy(z),
                                metric).numpy()
    assert i_t.dtype == np.int32
    clear = _clear(d_j)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(i_t[clear], i_j[clear])


def test_assignment_ties_take_the_lowest_index():
    """Zero x and zero centroids tie everywhere: centroid 0 wins (the
    padding argument of the JAX kernel relies on it)."""
    x = torch.zeros((3, 2, 4))
    z = torch.zeros((2, 5, 4))
    for metric in METRICS:
        assert (tref.assign_ref(x, z, metric) == 0).all()


def test_build_quantize_precompute_match_jax():
    rng = np.random.default_rng(2)
    k, n, v, c = 24, 10, 4, 8
    w = rng.standard_normal((k, n)).astype(np.float32)
    z = rng.standard_normal((k // v, c, v)).astype(np.float32)
    lut_j = _np(jlut.build_lut(jnp.asarray(w), jnp.asarray(z)))
    lut_t = tlut.build_lut(torch.from_numpy(w), torch.from_numpy(z))
    np.testing.assert_allclose(lut_t.numpy(), lut_j, rtol=1e-5, atol=1e-5)
    # quantize the SAME float table on both sides: bit-identical codes
    q_j, s_j = jlut.quantize_lut_int8(jnp.asarray(lut_j))
    q_t, s_t = tlut.quantize_lut_int8(torch.from_numpy(np.array(lut_j)))
    np.testing.assert_array_equal(q_t.numpy(), _np(q_j))
    np.testing.assert_allclose(s_t.numpy(), _np(s_j), rtol=1e-7)
    p_j = {"w": jnp.asarray(w), "z": jnp.asarray(z), "b": jnp.zeros((n,))}
    p_t = {"w": torch.from_numpy(w), "z": torch.from_numpy(z),
           "b": torch.zeros(n)}
    for dt in ("float32", "bfloat16", "int8"):
        out_j = jlut.precompute_layer(
            p_j, jlut.QuantConfig(mode="lut_infer", lut_dtype=dt))
        out_t = tlut.precompute_layer(
            p_t, tlut.QuantConfig(mode="lut_infer", lut_dtype=dt))
        assert set(out_t) == set(out_j)
        got = out_t["lut"].float().numpy()
        want = np.asarray(out_j["lut"], np.float32)
        if dt == "int8":         # summation order may move a .5 rounding
            assert np.abs(got - want).max() <= 1
            assert (got != want).mean() < 0.01
            np.testing.assert_allclose(out_t["lut_scale"].numpy(),
                                       _np(out_j["lut_scale"]), rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2 if dt ==
                                       "bfloat16" else 1e-5, atol=1e-5)
    stripped = tlut.strip_for_inference(out_t)
    assert "w" not in stripped and "lut" in stripped


def _b1_inputs(m, nc, v, c, n, lut_dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, nc, v)).astype(np.float32)
    z = rng.standard_normal((nc, c, v)).astype(np.float32)
    lut = rng.standard_normal((nc, c, n)).astype(np.float32)
    scale = None
    if lut_dtype == "int8":
        scale = (np.abs(rng.standard_normal(n)) + 0.05).astype(np.float32)
        lut = np.clip(np.round(lut / scale * 16), -127, 127).astype(np.int8)
        scale = scale / 16
    return x, z, lut, scale


# ragged (M, nc, v, c, N): none is a multiple of the JAX block sizes below
_RAGGED = [(17, 5, 3, 7, 33), (1, 3, 4, 9, 50), (23, 11, 8, 16, 130)]


@pytest.mark.parametrize("metric,lut_dtype,shape", [
    ("l2", "float32", _RAGGED[0]), ("l2", "int8", _RAGGED[2]),
    ("l1", "float32", _RAGGED[1]), ("l1", "int8", _RAGGED[0]),
    ("chebyshev", "float32", _RAGGED[2]), ("chebyshev", "int8", _RAGGED[1]),
])
def test_vq_amm_plain_matches_jax_kernel_and_ref(metric, lut_dtype, shape):
    """B1's plain version (what ops.vq_amm runs on CPU tensors) against the
    JAX Pallas kernel (interpret mode, ragged M/N/nc padding path) and the
    JAX oracle. Every metric meets both LUT types; every ragged shape meets
    both LUT types."""
    m, nc, v, c, n = shape
    x, z, lut, scale = _b1_inputs(m, nc, v, c, n, lut_dtype, m * n + c)
    jx, jz, jl = jnp.asarray(x), jnp.asarray(z), jnp.asarray(lut)
    js = None if scale is None else jnp.asarray(scale)
    o_pl = _np(vq_amm_pallas(jx, jz, jl, js, metric=metric, block_m=8,
                             block_n=32, block_k=4, interpret=True))
    o_ref = _np(jref.vq_amm_ref(jx, jz, jl, js, metric))
    ts = None if scale is None else torch.from_numpy(scale)
    before = tref.vq_amm_ref.calls
    o_t = tops.vq_amm(torch.from_numpy(x), torch.from_numpy(z),
                      torch.from_numpy(lut), ts, metric)
    assert tref.vq_amm_ref.calls == before + 1      # CPU -> plain version
    assert o_t.dtype == torch.float32 and o_t.shape == (m, n)
    d = _np(jsim.pairwise_distance_subspaces(jx, jz, metric))
    clear = _clear(d)
    i_t = tref.assign_ref(torch.from_numpy(x), torch.from_numpy(z),
                          metric).numpy()
    np.testing.assert_array_equal(i_t[clear], _np(jref.assign_ref(
        jx, jz, metric))[clear])
    rows = clear.all(axis=1)
    assert rows.mean() > 0.8
    for want in (o_pl, o_ref):
        np.testing.assert_allclose(o_t.numpy()[rows], want[rows],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_vq_amm_index_probe_matches_jax(metric):
    """A LUT with entry (k, j, n) = j * [n == k] makes column n of the
    output the selected index of subspace n: the fused path's indices,
    read through its own gather."""
    m, nc, v, c = 40, 6, 4, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, nc, v)).astype(np.float32)
    z = rng.standard_normal((nc, c, v)).astype(np.float32)
    dec = (np.arange(c, dtype=np.float32)[None, :, None]
           * np.eye(nc, dtype=np.float32)[:, None, :])
    i_t = np.round(tops.vq_amm(torch.from_numpy(x), torch.from_numpy(z),
                               torch.from_numpy(dec), None,
                               metric).numpy()).astype(np.int32)
    i_j = np.round(_np(vq_amm_pallas(jnp.asarray(x), jnp.asarray(z),
                                     jnp.asarray(dec), metric=metric,
                                     block_m=8, block_k=2,
                                     interpret=True))).astype(np.int32)
    clear = _clear(_np(jsim.pairwise_distance_subspaces(
        jnp.asarray(x), jnp.asarray(z), metric)))
    np.testing.assert_array_equal(i_t[clear], i_j[clear])


def test_lut_linear_apply_matches_jax():
    rng = np.random.default_rng(3)
    k, n, v, c = 32, 24, 8, 16
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    z = 0.5 * rng.standard_normal((k // v, c, v)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    for dt in ("float32", "int8"):
        qc_j = jlut.QuantConfig(mode="lut_infer", lut_dtype=dt, v=v, c=c)
        qc_t = tlut.QuantConfig(mode="lut_infer", lut_dtype=dt, v=v, c=c)
        p_j = jlut.precompute_layer({"w": jnp.asarray(w), "z": jnp.asarray(z),
                                     "b": jnp.asarray(b)}, qc_j)
        p_t = {key: torch.from_numpy(np.array(val))
               for key, val in p_j.items()}
        out_j, _ = jlut.lut_linear_apply(p_j, jnp.asarray(x), qc_j)
        out_t = tlut.lut_linear_apply(p_t, torch.from_numpy(x), qc_t)
        np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=1e-4,
                                   atol=1e-4)
    dense_j, _ = jlut.lut_linear_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                                       jlut.DENSE)
    dense_t = tlut.lut_linear_apply({"w": torch.from_numpy(w)},
                                    torch.from_numpy(x), tlut.DENSE)
    np.testing.assert_allclose(dense_t.numpy(), _np(dense_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [{"mode": "lut_train"}])
def test_unported_quant_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        tlut.QuantConfig(**kw)
