"""Port parity for training: the optimizer, gradient clipping and the LR
schedule (``train/optimizer.py``), error-feedback compression
(``train/compression.py``), the train step and the trainer
(``train/trainer.py``), checkpoints (``checkpoint/manager.py``) and the
synthetic data (``data/synthetic.py``), against the JAX package on the
same numpy inputs where the JAX package has a counterpart, on the CPU.

Tolerances: AdamW, clipping and the LR at 1e-6 (float32); error-feedback
compression bit for bit; a few train steps of the qwen smoke model in
lut_train (stage 2 then 3) at 1e-4 relative to each leaf's largest value
for the params and at 1e-4 for loss and grad_norm (with bf16 gradient
compression, in dense mode, steps x lr x 2^-7 more for the params, see
``test_train_steps_match_jax``); microbatch
accumulation against the full batch at 1e-5; the frozen leaves of stage
2, a resumed run against an uninterrupted one and a bf16 checkpoint round
trip bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_pytree,  # noqa
                                    save_pytree)
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core.lutboost import LutBoostSchedule  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: E402
                                       init_opt_state, loss_and_grads,
                                       make_train_step)
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, atol=0.0):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=tol, atol=tol * scale + atol)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal_trees(a, b):
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, path
        assert torch.equal(_bits(x), _bits(y)), path


# ---------------------------------------------------------------------------
# optimizer, clipping, LR, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_adamw_with_mask_and_weight_decay_matches_jax(masked):
    """Three AdamW steps (weight decay 0.1) on a float32 and a bf16 leaf;
    with a mask, the frozen leaf and its moments stay bit for bit and the
    count advances anyway."""
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    mask = {"a": True, "b": [False]} if masked else None
    pj = {"a": jnp.asarray(p["a"]),
          "b": [jnp.asarray(p["b"][0]).astype(jnp.bfloat16)]}
    pt = {"a": _t(p["a"]), "b": [_t(p["b"][0]).to(torch.bfloat16)]}
    b0 = pt["b"][0].clone()
    sj, st = jopt.adamw_init(pj), topt.adamw_init(pt)
    for i in range(3):
        g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": [rng.standard_normal(5).astype(np.float32)]}
        gj = {"a": jnp.asarray(g["a"]),
              "b": [jnp.asarray(g["b"][0]).astype(jnp.bfloat16)]}
        gt = {"a": _t(g["a"]), "b": [_t(g["b"][0]).to(torch.bfloat16)]}
        pj, sj = jopt.adamw_update(gj, sj, pj, 1e-2, weight_decay=0.1,
                                   mask=mask)
        pt, st = topt.adamw_update(gt, st, pt, 1e-2, weight_decay=0.1,
                                   mask=mask)
    assert int(st["count"]) == int(sj["count"]) == 3
    np.testing.assert_allclose(pt["a"].numpy(), np.asarray(pj["a"]),
                               **OPT_TOL)
    np.testing.assert_allclose(st["m"]["a"].numpy(),
                               np.asarray(sj["m"]["a"]), **OPT_TOL)
    np.testing.assert_allclose(st["v"]["a"].numpy(),
                               np.asarray(sj["v"]["a"]), **OPT_TOL)
    if masked:
        assert torch.equal(_bits(pt["b"][0]), _bits(b0))
        assert not st["m"]["b"][0].any() and not st["v"]["b"][0].any()
    else:
        np.testing.assert_allclose(
            pt["b"][0].float().numpy(),
            np.asarray(pj["b"][0].astype(jnp.float32)), rtol=1e-2,
            atol=1e-2)               # bf16: one ulp of ~1
        np.testing.assert_allclose(st["m"]["b"][0].numpy(),
                                   np.asarray(sj["m"]["b"][0]), **OPT_TOL)


def test_adamw_minimises_a_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        params, state = topt.adamw_update(
            {"x": 2 * (params["x"] - target)}, state, params, lr=0.05)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=1e-2)


def test_clip_by_global_norm_and_cosine_lr_match_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((6, 4)).astype(np.float32) * 3,
         "b": [rng.standard_normal(7).astype(np.float32)]}
    for max_norm in (1.0, 100.0):
        cj, nj = jopt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        own = tree_map(_t, g)
        ct, nt = topt.clip_by_global_norm(own, max_norm)
        assert ct is own                       # scaled in place
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        np.testing.assert_allclose(ct["a"].numpy(), np.asarray(cj["a"]),
                                   **OPT_TOL)
        np.testing.assert_allclose(ct["b"][0].numpy(),
                                   np.asarray(cj["b"][0]), **OPT_TOL)
    for step in (0, 3, 10, 11, 55, 100, 150):
        assert topt.cosine_lr(step, 2e-3, 10, 100) == pytest.approx(
            float(jopt.cosine_lr(step, 2e-3, 10, 100)), rel=1e-6, abs=1e-12)
    assert topt.cosine_lr(5, 1.0, 0, 100) == pytest.approx(
        float(jopt.cosine_lr(5, 1.0, 0, 100)), rel=1e-6)


def test_error_feedback_compression_is_bit_for_bit_the_jax_one():
    rng = np.random.default_rng(2)
    ef_j = ef_t = None
    for _ in range(3):
        g = {"w": (rng.standard_normal((64,)) * 1e-3).astype(np.float32),
             "v": [rng.standard_normal((3, 5)).astype(np.float32)]}
        cj, ef_j = jcomp.ef_compress(jax.tree_util.tree_map(jnp.asarray, g),
                                     ef_j)
        ct, ef_t = tcomp.ef_compress(tree_map(_t, g), ef_t)
        for got, want in ((ct["w"], cj["w"]), (ct["v"][0], cj["v"][0])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        np.testing.assert_array_equal(ef_t["w"].numpy(),
                                      np.asarray(ef_j["w"]))
        np.testing.assert_array_equal(ef_t["v"][0].numpy(),
                                      np.asarray(ef_j["v"][0]))
    assert tcomp.decompress(ct)["w"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="item 11"):
        tcomp.psum_hierarchical(ct)


# ---------------------------------------------------------------------------
# the train step against the JAX one
# ---------------------------------------------------------------------------

def _pair(seed=0, mode="lut_train"):
    """The qwen smoke model on both sides, its params from the port's init
    (the JAX init compiles) carried to the JAX package."""
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    tm, qt = TModel(cfg, device="cpu"), tlut.QuantConfig(mode=mode)
    params = tm.init(torch.Generator().manual_seed(seed), qt)
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params, cfg))
    jm = JModel(jconfigs.get_smoke_config("qwen1.5-4b"))
    return jm, params_j, jlut.QuantConfig(mode=mode), tm, params, qt


def _batches(n, cfg, b=4, s=16, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for _ in range(n)]


def _params_close(params, cfg, params_j, tol, atol=0.0, lr=None):
    """Every leaf of the port's tree within ``tol`` of the JAX one's
    (relative to the leaf's largest value, plus ``atol``). With ``lr``
    (params after AdamW steps): at most 1 element in 1000 of a leaf may
    miss that, and none by more than 3 lr. Adam divides each gradient
    element by its own running magnitude, so an element whose gradient
    is at the level of the two frameworks' rounding differences (a sum
    that nearly cancels) takes an update that differs by up to an lr
    while its gradient agrees within the gradient tolerance (the JAX
    package's own microbatch test compares gradients for that reason);
    a wrong step (bias correction, decay, the LR, the mask) moves every
    element and misses by far more."""
    want = jax.tree_util.tree_map(np.asarray, params_j)
    got = params_to_numpy(params, cfg)

    def walk(g, w, path=""):
        if isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
        elif lr is None:
            _close(g, w, tol, atol)
        else:
            w64 = np.asarray(w, np.float64)
            diff = np.abs(np.asarray(g, np.float64) - w64)
            scale = max(float(np.abs(w64).max()), 1e-6)
            off = diff > tol * np.abs(w64) + tol * scale + atol
            assert off.sum() <= max(1, off.size // 1000), (path, off.sum())
            assert diff.max() <= 3 * lr, (path, diff.max())
    walk(got, want)


def _from_jax(tree, cfg):
    """A JAX tree in the params' layout (params, moments, residuals) as
    the port's, on the CPU."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg,
                             device="cpu")


@pytest.mark.parametrize("mode,microbatches,compress", [
    ("lut_train", 1, False), ("lut_train", 2, False), ("dense", 2, True)])
def test_train_steps_match_jax(mode, microbatches, compress):
    """Two stage-2 then two stage-3 steps of the qwen smoke model on the
    same batches (weight decay, clipping at 1.0, warmup): each step's
    loss, grad_norm and lr, and the params, moments and count after it,
    within tolerance of the JAX step's. Each step starts from the JAX
    run's params and optimizer state: in lut_train a difference in the
    last bits of a param can decide a near-tied nearest-centroid
    assignment the other way a step later, a jump in the forward value
    that no tolerance bounds, so differences are not carried from step
    to step. With bf16 compression the two steps' float32 gradients,
    which differ in their last bits, can round to bf16 values one ulp
    (2^-8) apart; Adam normalises the step, so such a param may move up
    to about 2^-8 x lr more: the params are held at lr x 2^-7 more, the
    moments at 2^-7 of each leaf's largest (ef_compress itself is held
    bit for bit). Elements whose gradient nearly cancels are held as
    ``_params_close`` says."""
    jm, params_j, qj, tm, _, qt = _pair(1, mode)
    cfg = tm.cfg
    kw = dict(total_steps=10, lr=3e-3, warmup=2, weight_decay=0.01,
              grad_clip=1.0, microbatches=microbatches,
              compress_grads=compress)
    tcj, tct = jtrainer.TrainConfig(**kw), TrainConfig(**kw)
    opt_j = jtrainer.init_opt_state(params_j, tcj)
    steps_j = {s: jax.jit(jtrainer.make_train_step(jm, qj, tcj, s))
               for s in (2, 3)}
    steps_t = {s: make_train_step(tm, qt, tct, s) for s in (2, 3)}
    p_tol = tct.lr * 2 ** -7 if compress else 0.0
    m_tol = 2 ** -7 if compress else STEP_TOL
    for i, toks in enumerate(_batches(4, cfg)):
        stage = 2 if i < 2 else 3
        params = _from_jax(params_j, cfg)
        opt_t = {"adam": {"m": _from_jax(opt_j["adam"]["m"], cfg),
                          "v": _from_jax(opt_j["adam"]["v"], cfg),
                          "count": torch.tensor(int(opt_j["adam"]["count"]),
                                                dtype=torch.int32)}}
        if compress:
            opt_t["ef"] = _from_jax(opt_j["ef"], cfg)
        params_j, opt_j, met_j = steps_j[stage](
            params_j, opt_j, {"tokens": jnp.asarray(toks)},
            jnp.asarray(i, jnp.int32))
        params, opt_t, met_t = steps_t[stage](params, opt_t,
                                              {"tokens": _t(toks)}, i)
        _close(float(met_t["loss"]), float(met_j["loss"]), STEP_TOL)
        _close(float(met_t["grad_norm"]), float(met_j["grad_norm"]),
               STEP_TOL)
        assert met_t["lr"] == pytest.approx(float(met_j["lr"]), rel=1e-6)
        _params_close(params, cfg, params_j, STEP_TOL, p_tol, met_t["lr"])
        for key in ("m", "v"):
            _params_close(opt_t["adam"][key], cfg, opt_j["adam"][key],
                          m_tol)
        assert int(opt_t["adam"]["count"]) == int(opt_j["adam"]["count"]) \
            == i + 1
        assert ("ef" in opt_t) == compress


def test_microbatch_accumulation_equals_the_full_batch():
    """Gradients accumulated over 4 microbatches equal the full batch's
    (compared at the gradient level: Adam's first step is sign-like), and
    the step's microbatch path averages the loss."""
    _, _, _, tm, params, qt = _pair(2)
    toks = _t(_batches(1, tm.cfg, b=8)[0])
    loss, _, g_full = loss_and_grads(tm, params, {"tokens": toks}, qt)
    parts = [loss_and_grads(tm, params, {"tokens": toks[2 * i:2 * i + 2]},
                            qt) for i in range(4)]
    g_acc = tree_map(lambda *gs: sum(g.float() for g in gs) / 4,
                     *[p[2] for p in parts])
    for (path, a), (_, b) in zip(tree_flatten_with_path(g_full),
                                 tree_flatten_with_path(g_acc)):
        _close(b.numpy(), a.numpy(), 1e-5)
    step = make_train_step(tm, qt, TrainConfig(microbatches=4, warmup=0))
    _, _, met = step(_clone(params), init_opt_state(params, TrainConfig()),
                     {"tokens": toks}, 0)
    _close(float(met["loss"]), float(sum(p[0] for p in parts) / 4), 1e-6)
    _close(float(met["loss"]), float(loss), 1e-5)


def test_stage2_freezes_all_but_the_centroids_with_the_global_norm():
    """A stage-2 step changes every z and nothing else (bit for bit), and
    its grad_norm is the JAX package's over ALL leaves (weights too)."""
    jm, params_j, qj, tm, params, qt = _pair(3)
    before = _clone(params)
    tc = TrainConfig(lr=1e-2, warmup=0, grad_clip=0.5)
    toks = _batches(1, tm.cfg)[0]
    params, opt, met = make_train_step(tm, qt, tc, 2)(
        params, init_opt_state(params, tc), {"tokens": _t(toks)}, 0)
    _, _, met_j = jax.jit(jtrainer.make_train_step(
        jm, qj, jtrainer.TrainConfig(lr=1e-2, warmup=0, grad_clip=0.5), 2))(
        params_j, jtrainer.init_opt_state(params_j, jtrainer.TrainConfig()),
        {"tokens": jnp.asarray(toks)}, jnp.asarray(0, jnp.int32))
    _close(float(met["grad_norm"]), float(met_j["grad_norm"]), STEP_TOL)
    _, _, grads = loss_and_grads(tm, before, {"tokens": _t(toks)}, qt)
    w_norm = sum(float(torch.sum(g ** 2)) for p, g in
                 tree_flatten_with_path(grads) if not p.endswith("['z']"))
    assert w_norm > 0 and float(met["grad_norm"]) ** 2 > w_norm
    n_z = 0
    for (path, a), (_, b) in zip(tree_flatten_with_path(before),
                                 tree_flatten_with_path(params)):
        if path.endswith("['z']"):
            assert not torch.equal(a, b), path
            n_z += 1
        else:
            assert torch.equal(a, b), path
    assert n_z == 7 * tm.cfg.num_layers
    for (path, m) in tree_flatten_with_path(opt["adam"]["m"]):
        assert bool(m.any()) == path.endswith("['z']"), path


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class _Poisoned:
    """A model whose loss turns NaN (or spikes 1000x) at chosen calls."""

    def __init__(self, model, bad):
        self.model, self.bad, self.calls = model, bad, 0

    def loss(self, params, batch, qc):
        loss, met = self.model.loss(params, batch, qc)
        kind = self.bad.get(self.calls)
        self.calls += 1
        if kind == "nan":
            loss = loss * float("nan")
        elif kind == "spike":
            loss = loss * 1000.0
        return loss, dict(met, loss=loss)


def test_trainer_skips_nan_and_spiking_batches():
    _, _, _, tm, params, qt = _pair(4)
    ds = SyntheticDataset(tm.cfg, global_batch=4, seq_len=16, device="cpu")
    logs = []
    model = _Poisoned(tm, {1: "nan", 3: "spike"})
    tr = Trainer(model, ds, qt, TrainConfig(total_steps=5, lr=1e-3,
                                            warmup=0, log_every=100),
                 lutboost=LutBoostSchedule(stage2_steps=2),
                 log_fn=logs.append)
    start = _clone(params)
    seen = []
    step_fn = tr._step_fn

    def spy(stage):
        fn = step_fn(stage)

        def wrapped(p, o, b, s, accept):
            before = _clone(p)
            out = fn(p, o, b, s, accept)
            seen.append((s, stage, out[2]["skipped"], before, _clone(out[0])))
            return out
        return wrapped
    tr._step_fn = spy
    params, _, hist = tr.run(params)
    assert len(hist["loss"]) == 3
    assert sum("skipping batch" in line for line in logs) == 2
    assert [(s, st, sk) for s, st, sk, _, _ in seen] == [
        (0, 2, False), (1, 2, True), (2, 3, False), (3, 3, True),
        (4, 3, False)]
    for _, _, skipped, before, after in seen:
        if skipped:                       # the update was not applied
            _equal_trees(before, after)
    assert not all(torch.equal(a, b) for a, b in zip(
        [t for _, t in tree_flatten_with_path(start)],
        [t for _, t in tree_flatten_with_path(params)]))


def test_resume_is_bit_for_bit_the_uninterrupted_run(tmp_path):
    """Four steps in one run; two, a checkpoint, and two more after a
    restart from it: the same params and optimizer state, bit for bit
    (on the CPU; the card's embedding backward sums with atomics)."""
    _, _, _, tm, params, qt = _pair(5)
    ds = SyntheticDataset(tm.cfg, global_batch=4, seq_len=16, seed=9,
                          device="cpu")
    tc = TrainConfig(total_steps=4, lr=2e-3, warmup=1, checkpoint_every=100,
                     log_every=100)
    sched = LutBoostSchedule(stage2_steps=1)
    quiet = dict(lutboost=sched, log_fn=lambda _: None)
    p_a, o_a, h_a = Trainer(tm, ds, qt, tc, **quiet).run(_clone(params))
    ck = str(tmp_path / "ck")
    Trainer(tm, ds, qt, tc, checkpoint_dir=ck, **quiet).run(
        _clone(params), num_steps=2)
    assert CheckpointManager(ck).all_steps() == [2]
    logs = []
    p_b, o_b, h_b = Trainer(tm, ds, qt, tc, checkpoint_dir=ck,
                            lutboost=sched, log_fn=logs.append).run(
        _clone(params))
    assert logs[0] == "[trainer] resumed from step 2"
    assert len(h_b["loss"]) == 2 and h_b["loss"] == h_a["loss"][2:]
    _equal_trees(p_a, p_b)
    _equal_trees(o_a, o_b)
    assert CheckpointManager(ck).all_steps() == [2, 4]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_retention_and_bf16_bits(tmp_path):
    """A tree of per-layer blocks with bf16, float32, int32 leaves saves
    under stable keys and restores bit for bit (bf16 NaN payloads and
    -0.0 too); retention keeps the last 2; extra.json round-trips."""
    bf = torch.tensor([1.5, -0.0, float("inf"), 3.0e-39],
                      dtype=torch.float32).to(torch.bfloat16)
    bf = torch.cat([bf, torch.tensor([0x7FC1], dtype=torch.int16).view(
        torch.bfloat16)])
    tree = ({"blocks": [{"w": bf.clone()}, {"w": bf.flip(0).clone()}],
             "embed": torch.arange(6.0).reshape(2, 3)},
            {"count": torch.tensor(7, dtype=torch.int32)})
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, tree, extra={"step": step})
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    like = tree_map(torch.zeros_like, tree)
    restored, step, extra = mgr.restore(like)
    assert step == 30 and extra == {"step": 30}
    _equal_trees(restored, tree)
    with open(os.path.join(mgr._step_dir(30), "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["[0]['blocks'][1]['w']"]["dtype"] == "bfloat16"
    assert set(manifest) == {"[0]['blocks'][0]['w']",
                             "[0]['blocks'][1]['w']", "[0]['embed']",
                             "[1]['count']"}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like)


def test_checkpoint_detects_corruption_shape_mismatch_and_missing(tmp_path):
    path = str(tmp_path / "ck")
    save_pytree(path, {"w": torch.ones((8, 8))})
    data = dict(np.load(os.path.join(path, "arrays.npz")))
    data["['w']"] = data["['w']"] + 1.0
    np.savez(os.path.join(path, "arrays.npz"), **data)
    with pytest.raises(IOError, match="corruption"):
        load_pytree(path, {"w": torch.ones((8, 8))})
    path2 = str(tmp_path / "ck2")
    save_pytree(path2, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(path2, {"w": torch.ones((2, 2))})
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(path2, {"w": torch.ones((4, 4)), "b": torch.ones(2)})


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def test_data_is_deterministic_host_split_and_successor_structured():
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    ds = SyntheticDataset(cfg, global_batch=8, seq_len=64, seed=7,
                          device="cpu")
    b1, b2, b3 = ds.batch(5)["tokens"], ds.batch(5)["tokens"], \
        ds.batch(6)["tokens"]
    assert b1.shape == (8, 64) and b1.dtype == torch.int32
    assert torch.equal(b1, b2) and not torch.equal(b1, b3)
    assert int(b1.min()) >= 0 and int(b1.max()) < cfg.vocab_size
    assert not torch.equal(b1, SyntheticDataset(
        cfg, 8, 64, seed=8, device="cpu").batch(5)["tokens"])
    hosts = [SyntheticDataset(cfg, global_batch=8, seq_len=64, seed=7,
                              num_hosts=2, host_index=i, device="cpu")
             for i in (0, 1)]
    h0, h1 = (h.batch(0)["tokens"] for h in hosts)
    assert h0.shape == (4, 64) and not torch.equal(h0, h1)
    assert torch.equal(h0, hosts[0].batch(0)["tokens"])
    toks = torch.cat([ds.batch(s)["tokens"] for s in range(4)]).numpy()
    succ = (toks[:, 1:] == (toks[:, :-1] + 1) % cfg.vocab_size).mean()
    assert 0.85 < succ < 0.95                  # ~90% successors
    with pytest.raises(ValueError, match="divide"):
        SyntheticDataset(cfg, global_batch=3, seq_len=8, num_hosts=2)
    with pytest.raises(NotImplementedError, match="item 9"):
        SyntheticDataset(cfg.replace(family="audio"), 2, 8)
