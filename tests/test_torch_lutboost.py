"""Port parity for LUTBoost: the straight-through estimators
(``core/similarity.py``), the ``lut_train`` projection (``core/lut.py``),
the stage mechanics and the stage-1 converter (``core/lutboost.py``), and
``Model.forward`` / ``Model.loss`` with their gradients on the dense, MoE,
SSM, hybrid, audio and vlm smoke configs in ``dense`` and ``lut_train``,
against the JAX package on the same numpy inputs, on the CPU, in float32.

Tolerances: one projection (outputs, recon, every gradient) at 1e-5
relative to the largest value compared; STE values exact, their VJPs at
1e-6; a model's loss and gradients at 1e-4 relative to each leaf's
largest value (attention, norms and the scan sum in another order).
Captured activations at 1e-5; k-means from a shared init at 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import lutboost as jlb  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core import lutboost as tlb  # noqa: E402
from repro_torch.core import similarity as tsim  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.train.trainer import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa

METRICS = ["l2", "l1", "chebyshev"]
MODEL_TOL = 1e-4
PROJ_TOL = 1e-5


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tree(params, cfg):
    """The port's params in the JAX package's layout, as JAX arrays (the
    port's init is cheap; the JAX one compiles)."""
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params, cfg))


def _close(got, want, tol):
    """Elementwise within ``tol`` relative to the largest |want|."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=tol, atol=tol * scale)


# ---------------------------------------------------------------------------
# straight-through estimators and soft assignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_ste_forward_and_vjp_match_jax(metric):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 4)).astype(np.float32)
    z = rng.standard_normal((7, 4)).astype(np.float32)
    zs = rng.standard_normal((3, 7, 4)).astype(np.float32)
    g = rng.standard_normal((5, 3, 4)).astype(np.float32)
    for fj, ft, zz in ((jsim.ste_quantize, tsim.ste_quantize, z),
                       (jsim.ste_quantize_subspaces,
                        tsim.ste_quantize_subspaces, zs)):
        out_j, vjp = jax.vjp(lambda a, b: fj(a, b, metric), jnp.asarray(x),
                             jnp.asarray(zz))
        dx_j, dz_j = vjp(jnp.asarray(g))
        xt, zt = _t(x).requires_grad_(), _t(zz).requires_grad_()
        out_t = ft(xt, zt, metric)
        dx_t, dz_t = torch.autograd.grad(out_t, (xt, zt), _t(g))
        np.testing.assert_array_equal(out_t.detach().numpy(), _np(out_j))
        np.testing.assert_array_equal(dx_t.numpy(), _np(dx_j))
        np.testing.assert_allclose(dz_t.numpy(), _np(dz_j), rtol=1e-6,
                                   atol=1e-6)


def test_ste_with_an_expert_axis_is_each_expert_on_its_own():
    """z (E, nc, c, v): each expert's rows take its own codebook, as the
    JAX package's vmap over experts gives (values and VJP)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    z = rng.standard_normal((3, 2, 5, 4)).astype(np.float32)
    g = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    fj = jax.vmap(lambda a, b: jsim.ste_quantize_subspaces(a, b, "l2"))
    out_j, vjp = jax.vjp(fj, jnp.asarray(x), jnp.asarray(z))
    dx_j, dz_j = vjp(jnp.asarray(g))
    xt, zt = _t(x).requires_grad_(), _t(z).requires_grad_()
    out_t = tsim.ste_quantize_subspaces(xt, zt, "l2")
    dx_t, dz_t = torch.autograd.grad(out_t, (xt, zt), _t(g))
    np.testing.assert_array_equal(out_t.detach().numpy(), _np(out_j))
    np.testing.assert_array_equal(dx_t.numpy(), _np(dx_j))
    np.testing.assert_allclose(dz_t.numpy(), _np(dz_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_soft_assignment_matches_jax(metric):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 4)).astype(np.float32)
    z = rng.standard_normal((3, 6, 4)).astype(np.float32)
    for temp in (1.0, 0.1, 0.0):
        np.testing.assert_allclose(
            tsim.soft_assignment(_t(x), _t(z), metric, temp).numpy(),
            _np(jsim.soft_assignment(jnp.asarray(x), jnp.asarray(z), metric,
                                     temp)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tsim.soft_assignment(_t(x[:, 0]), _t(z[0]), metric).numpy(),
        _np(jsim.soft_assignment(jnp.asarray(x[:, 0]), jnp.asarray(z[0]),
                                 metric)), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the lut_train projection
# ---------------------------------------------------------------------------

def _proj_case(seed, bias=True):
    rng = np.random.default_rng(seed)
    k, n, v, c = 16, 12, 4, 8
    p = {"w": (rng.standard_normal((k, n)) / 4).astype(np.float32),
         "z": rng.standard_normal((k // v, c, v)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    cot = rng.standard_normal((2, 5, n)).astype(np.float32)
    return p, x, cot, v, c


@pytest.mark.parametrize("task_grad", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_lut_train_projection_output_recon_and_grads_match_jax(metric,
                                                               task_grad):
    """Output, recon and the gradients of sum(out * cot) + 0.7 recon with
    respect to x, w, z and b, in the paper path and the LUT-NN path."""
    p, x, cot, v, c = _proj_case(3)
    kw = dict(mode="lut_train", v=v, c=c, metric=metric,
              task_grad_to_centroids=task_grad)
    qj, qt = jlut.QuantConfig(**kw), tlut.QuantConfig(**kw)

    def f_j(pp, xx):
        out, r = jlut.lut_linear_apply(pp, xx, qj)
        return jnp.sum(out * cot) + 0.7 * r, (out, r)

    (_, (out_j, r_j)), (gp_j, gx_j) = jax.value_and_grad(
        f_j, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    pt = {key: _t(a).requires_grad_() for key, a in p.items()}
    xt = _t(x).requires_grad_()
    recon = []
    out_t = tlut.lut_linear_apply(pt, xt, qt, recon)
    assert len(recon) == 1 and recon[0].dtype == torch.float32
    obj = torch.sum(out_t * _t(cot)) + 0.7 * recon[0]
    grads = torch.autograd.grad(obj, [xt] + [pt[k] for k in p])
    _close(out_t.detach().numpy(), out_j, PROJ_TOL)
    _close(recon[0].item(), r_j, PROJ_TOL)
    _close(grads[0].numpy(), gx_j, PROJ_TOL)
    for key, g in zip(p, grads[1:]):
        _close(g.numpy(), gp_j[key], PROJ_TOL)


def test_no_task_gradient_reaches_the_centroids_in_paper_mode():
    p, x, cot, v, c = _proj_case(4, bias=False)
    qt = tlut.QuantConfig(mode="lut_train", v=v, c=c)
    pt = {key: _t(a).requires_grad_() for key, a in p.items()}
    xt = _t(x)
    recon = []
    out = tlut.lut_linear_apply(pt, xt, qt, recon)
    (gz,) = torch.autograd.grad(torch.sum(out * _t(cot)), [pt["z"]],
                                allow_unused=True)
    assert gz is None or not bool(gz.any())
    (gz,) = torch.autograd.grad(recon[0], [pt["z"]])
    assert bool(gz.any())                  # the recon loss does reach them
    # the forward value is Â·W, the LUT-NN path's too
    x_hat = tsim.ste_quantize_subspaces(xt.reshape(2, 5, 4, v), pt["z"],
                                        "l2").reshape(2, 5, 16)
    np.testing.assert_allclose(out.detach().numpy(),
                               (x_hat @ pt["w"]).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="recon"):
        tlut.lut_linear_apply(pt, xt, qt)


def test_lut_train_init_carries_weights_and_centroids():
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    qc = tlut.QuantConfig(mode="lut_train", v=8, c=16)
    params = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0),
                                            qc)
    for layer in params["blocks"]:
        for part in ("attn", "mlp"):
            for name, p in layer[part].items():
                if name != "norm":
                    assert {"w", "z"} <= set(p) and "lut" not in p
                    assert p["z"].shape == (p["w"].shape[0] // 8, 16, 8)


# ---------------------------------------------------------------------------
# stage mechanics
# ---------------------------------------------------------------------------

def test_stage_masks_schedule_and_apply_mask_match_jax():
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    params = TModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0), tlut.QuantConfig(mode="lut_train"))
    mask_j = jlb.centroid_only_mask(params_to_numpy(params, cfg))
    mask_t = tlb.centroid_only_mask(params)
    want = {jax.tree_util.keystr(p): m for p, m in
            jax.tree_util.tree_flatten_with_path(mask_j)[0]}
    got = tree_flatten_with_path(mask_t)
    n_z = sum(m for _, m in got)
    assert n_z == 7 * cfg.num_layers
    for path, m in got:
        if path.startswith("['blocks']"):       # JAX: stacked, no index
            ref_path = "['blocks']" + path[path.index("]", 10) + 1:]
        else:
            ref_path = path
        assert m == want[ref_path], path
    assert all(m for _, m in tree_flatten_with_path(tlb.stage_mask(params,
                                                                   3)))
    assert tree_flatten_with_path(tlb.stage_mask(params, 2)) == got
    grads = {"a": torch.ones(3), "b": [torch.ones(2), torch.ones(1)]}
    masked = tlb.apply_mask(grads, {"a": True, "b": [False, True]})
    assert masked["a"].sum() == 3 and masked["b"][0].sum() == 0 \
        and masked["b"][1].sum() == 1
    for kw in ({}, {"stage2_steps": 3, "stage3_steps": 5, "lr_stage2": 2e-3,
                    "recon_weight_stage3": 0.1}):
        sj, st = jlb.LutBoostSchedule(**kw), tlb.LutBoostSchedule(**kw)
        assert st.total_steps == sj.total_steps
        for step in (0, 2, 3, 999, 1000, 4000):
            assert (st.stage(step), st.lr(step), st.recon_weight(step)) == \
                (sj.stage(step), sj.lr(step), sj.recon_weight(step))


def _qwen_lut_train(seed):
    """The qwen smoke model in lut_train, its params from the port's init
    carried to the JAX package."""
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    tm, qt = TModel(cfg, device="cpu"), tlut.QuantConfig(mode="lut_train")
    params = tm.init(torch.Generator().manual_seed(seed), qt)
    jm = JModel(jconfigs.get_smoke_config("qwen1.5-4b"))
    return (jm, _jax_tree(params, cfg), jlut.QuantConfig(mode="lut_train"),
            tm, params, qt)


def test_capture_holds_each_projections_real_input(monkeypatch):
    """The port's capture around a whole Model.forward records one matrix
    a projection (layers x 7), in call order, equal to the input the JAX
    package's projection sees (its forward run eagerly, op by op, with
    every projection input recorded in order)."""
    jm, params_j, qj, tm, params, qt = _qwen_lut_train(1)
    toks = np.random.default_rng(5).integers(0, 256, (2, 12)).astype(
        np.int32)
    seen = []
    monkeypatch.setattr(jlb, "record_activation",
                        lambda p, x: seen.append(np.asarray(x)) if "z" in p
                        else None)
    with jax.disable_jit():
        jm.forward(params_j, {"tokens": jnp.asarray(toks)}, qj)
    with tlb.capture_activations() as captured:
        with torch.no_grad():
            tm.forward(params, {"tokens": _t(toks)}, qt)
    n = 7 * tm.cfg.num_layers
    assert len(seen) == len(captured) == n
    order = [id(layer[part][name]["z"]) for layer in params["blocks"]
             for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                                 ("mlp", ("wg", "wu", "wd")))
             for name in names]
    assert list(captured) == order
    for got, want in zip(captured.values(), seen):
        assert got.shape == (24, want.shape[-1])
        _close(got.numpy(), want.reshape(-1, want.shape[-1]), 1e-5)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_kmeans_init_from_capture_matches_jax_from_a_shared_init(metric):
    """Two projections captured (one over two calls, rows appended), one
    not: the port's k-means from the JAX package's initial centroids
    (x[perm] of each subspace for the layer's key) gives the JAX
    codebooks; the uncaptured layer keeps its z."""
    rng = np.random.default_rng(6)
    v, c, k = 4, 8, 16
    tree = {name: {"w": rng.standard_normal((k, 6)).astype(np.float32),
                   "z": rng.standard_normal((k // v, c, v)).astype(
                       np.float32)} for name in ("a", "b", "c")}
    xs = {"a": [rng.standard_normal((3, 10, k)), rng.standard_normal(
        (20, k))], "b": [rng.standard_normal((40, k))]}
    xs = {key: [a.astype(np.float32) for a in val] for key, val in xs.items()}
    qj = jlut.QuantConfig(mode="lut_train", v=v, c=c, metric=metric)
    qt = tlut.QuantConfig(mode="lut_train", v=v, c=c, metric=metric)
    seed, iters = 3, 4

    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    with jlb.capture_activations() as cap_j:
        for key, calls in xs.items():
            for x in calls:
                jlut.lut_linear_apply(pj[key], jnp.asarray(x), qj)
    want = jlb.kmeans_init_from_capture(pj, cap_j, qj, iters, seed)

    pt = {key: {n: _t(a) for n, a in p.items()} for key, p in tree.items()}
    with tlb.capture_activations() as cap_t:
        for key, calls in xs.items():
            for x in calls:
                tlut.lut_linear_apply(pt[key], _t(x), qt, [])
    inits = {}
    for i, key in enumerate(("a", "b"), start=1):
        acts = cap_t[id(pt[key]["z"])].numpy()
        np.testing.assert_array_equal(
            acts, np.concatenate([x.reshape(-1, k) for x in xs[key]]))
        flat = acts.reshape(-1, k // v, v)
        _, key_init = jax.random.split(jax.random.PRNGKey(seed + i))
        keys = jax.random.split(key_init, k // v)
        inits[id(pt[key]["z"])] = _t(np.stack([
            flat[_np(jax.random.permutation(keys[s], flat.shape[0]))[:c], s]
            for s in range(k // v)]))
    got = tlb.kmeans_init_from_capture(pt, cap_t, qt, iters, seed,
                                       inits=inits)
    for key in ("a", "b"):
        _close(got[key]["z"].numpy(), want[key]["z"], 1e-5)
        assert got[key]["w"] is pt[key]["w"]
    assert got["c"]["z"] is pt["c"]["z"]


def test_convert_gives_every_block_projection_a_codebook_of_its_inputs():
    """Stage 1 on the smoke Model, calibrated through its dense forward
    (the paper's and the JAX package's pipeline): every projection's z
    changes, and each one's mean nearest-centroid distance over its
    captured rows falls below that of its random init; the same seed
    gives the same codebooks; the loss and gradients of the converted
    model stay finite and bounded, where a calibration through the
    lut_train forward (upstream layers on random centroids) makes the
    gradient grow with depth."""
    _, _, _, tm, params, qt = _qwen_lut_train(2)
    toks = _t(np.random.default_rng(7).integers(0, 256, (2, 32)).astype(
        np.int32))
    with tlb.capture_activations() as captured, torch.no_grad():
        tm.forward(params, {"tokens": toks}, tlut.DENSE)

    def fwd(p, b):
        return tm.forward(p, b, tlut.DENSE)
    conv = tlb.convert(fwd, params, {"tokens": toks}, qt)
    again = tlb.convert(fwd, params, {"tokens": toks}, qt)
    n = 0
    for old, new, rep in zip(params["blocks"], conv["blocks"],
                             again["blocks"]):
        for part in ("attn", "mlp"):
            for name, p in old[part].items():
                if name == "norm":
                    continue
                z0, z1 = p["z"], new[part][name]["z"]
                assert not torch.equal(z0, z1)
                assert torch.equal(z1, rep[part][name]["z"])
                assert new[part][name]["w"] is p["w"]
                rows = captured[id(z0)]
                xs = rows.reshape(rows.shape[0], -1, qt.v)

                def dist(z):
                    return tsim.pairwise_distance_subspaces(
                        xs, z, "l2").amin(-1).mean()
                assert dist(z1) < dist(z0)
                n += 1
    assert n == 7 * tm.cfg.num_layers
    assert conv["embed"] is params["embed"]
    batch = {"tokens": toks}
    def grad_norm(p):
        _, _, g = loss_and_grads(tm, p, batch, qt)
        return sum(float(torch.sum(t ** 2))
                   for _, t in tree_flatten_with_path(g)) ** 0.5
    own = tlb.convert(lambda p, b: tm.forward(p, b, qt), params, batch, qt)
    assert grad_norm(conv) < 1e3 < grad_norm(own)


# ---------------------------------------------------------------------------
# Model.forward / Model.loss and their gradients
# ---------------------------------------------------------------------------

MODEL_ARCHS = ["qwen1.5-4b", "gemma3-4b", "deepseek-moe-16b", "mamba2-2.7b",
               "zamba2-1.2b", "musicgen-large", "paligemma-3b"]


def _model_batch(cfg, rng, b=2, s=16):
    """A training batch of the family's kind as numpy arrays: tokens;
    audio frame embeddings and per-codebook labels; vlm patch
    embeddings before s text tokens."""
    if cfg.family == "audio":
        return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (b, s, cfg.num_codebooks)).astype(
                    np.int32)}
    toks = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        toks["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return toks


def _leaf_pairs(got_tree, want_tree, path=""):
    if isinstance(got_tree, dict):
        assert set(got_tree) == set(want_tree), path
        for k in got_tree:
            yield from _leaf_pairs(got_tree[k], want_tree[k], f"{path}/{k}")
    else:
        yield path, got_tree, want_tree


@pytest.mark.parametrize("mode", ["dense", "lut_train"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_loss_and_grads_match_jax(arch, mode):
    """Loss, its parts and every parameter's gradient on the
    smoke config (gemma3-4b: windowed layers, the JAX block-local path;
    deepseek-moe-16b: the load-balancing loss; mamba2 / zamba2: the scan
    from zero state and the shared block; musicgen: the input projection
    and the codebook heads; paligemma: the bidirectional image prefix and
    a loss over the text alone)."""
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg = tconfigs.get_smoke_config(arch)
    qj = jlut.QuantConfig(mode=mode)
    qt = tlut.QuantConfig(mode=mode)
    jm = JModel(cfg_j)
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(11), qt)
    params_j = _jax_tree(params, cfg)
    arrays = _model_batch(cfg, np.random.default_rng(12))
    batch_j = {k: jnp.asarray(a) for k, a in arrays.items()}
    (loss_j, met_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, qj), has_aux=True))(params_j, batch_j)
    batch = {k: _t(a) for k, a in arrays.items()}
    loss, met, grads = loss_and_grads(tm, params, batch, qt)
    _close(loss.item(), loss_j, MODEL_TOL)
    for key in ("ce", "recon", "moe_aux", "loss"):
        _close(met[key].item(), met_j[key], MODEL_TOL)
    if mode == "lut_train":
        assert met["recon"].item() > 0
    if cfg.family == "moe":
        assert met["moe_aux"].item() > 0
    want = jax.tree_util.tree_map(np.asarray, g_j)
    n = 0
    for path, got, ref in _leaf_pairs(params_to_numpy(grads, cfg), want):
        assert got.shape == ref.shape, path
        _close(got, ref, MODEL_TOL)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want))


def test_remat_gives_the_same_loss_and_grads():
    cfg = tconfigs.get_smoke_config("zamba2-1.2b")
    qt = tlut.QuantConfig(mode="lut_train")
    params = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(3),
                                            qt)
    batch = {"tokens": _t(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))}
    loss, _, g = loss_and_grads(TModel(cfg, device="cpu"), params, batch, qt)
    loss_r, _, g_r = loss_and_grads(
        TModel(cfg.replace(remat=True), device="cpu"), params, batch, qt)
    assert loss.item() == loss_r.item()
    for (_, a), (_, b) in zip(tree_flatten_with_path(g),
                              tree_flatten_with_path(g_r)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "zamba2-1.2b",
                                  "musicgen-large", "paligemma-3b"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The port's per-layer list back to the JAX package's stacked leaves
    (the hybrid's shared block kept apart; audio's ``in_proj`` and
    ``heads`` and no ``embed``), and forth again, leaf for leaf; a bf16
    leaf comes back as float32 holding the same values."""
    cfg = tconfigs.get_smoke_config(arch)
    params = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(4),
                                            tlut.QuantConfig(mode="lut_train"))
    tree = params_to_numpy(params, cfg)
    jm = JModel(jconfigs.get_smoke_config(arch))
    want = jax.eval_shape(lambda k: jm.init(k, jlut.QuantConfig(
        mode="lut_train")), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda a: a.shape, want)
    back = dict(tree_flatten_with_path(params_from_numpy(tree, cfg,
                                                         device="cpu")))
    flat = tree_flatten_with_path(params)
    assert len(flat) == len(back)
    for path, a in flat:
        assert torch.equal(a, back[path]), path
    bf = tree_map(lambda t: t.to(torch.bfloat16), params)
    key = "in_proj" if cfg.family == "audio" else "embed"
    emb = params_to_numpy(bf, cfg)[key]
    assert emb.dtype == np.float32
    np.testing.assert_array_equal(emb, bf[key].float().numpy())
    with pytest.raises(ValueError, match="blocks"):
        params_to_numpy(params, cfg.replace(num_layers=cfg.num_layers + 1))


def test_audio_vlm_and_hd_layout_still_raise():
    """head_layout="hd" still raises (queue A item 11). The audio and vlm
    families convert: stage 1 on each smoke model, calibrated through its
    dense forward on a batch of its kind, gives every block projection a
    new z; a vlm projection's capture holds its patch rows too; the
    dense ``in_proj`` and ``heads`` (audio) and ``embed`` carry no z and
    come through as the same tensors."""
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    with pytest.raises(NotImplementedError, match="item 11"):
        TModel(cfg.replace(head_layout="hd"), device="cpu")
    qt = tlut.QuantConfig(mode="lut_train")
    for arch in ("musicgen-large", "paligemma-3b"):
        tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
        params = tm.init(torch.Generator().manual_seed(5), qt)
        batch = {k: _t(a) for k, a in _model_batch(
            tm.cfg, np.random.default_rng(6), s=8).items()}

        def fwd(p, b):
            return tm.forward(p, b, tlut.DENSE)
        with tlb.capture_activations() as captured, torch.no_grad():
            fwd(params, batch)
        conv = tlb.convert(fwd, params, batch, qt)
        rows = 2 * (8 + tm.cfg.num_patches)
        n = 0
        for old, new in zip(params["blocks"], conv["blocks"]):
            for part in ("attn", "mlp"):
                for name, p in old[part].items():
                    if name == "norm":
                        continue
                    assert captured[id(p["z"])].shape[0] == rows
                    assert not torch.equal(p["z"], new[part][name]["z"])
                    n += 1
        assert n == 7 * tm.cfg.num_layers
        dense = ("in_proj", "heads") if arch == "musicgen-large" \
            else ("embed",)
        for key in dense + ("final_norm",):
            assert conv[key] is params[key], key
