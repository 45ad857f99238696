"""Port parity for the training half of scale-out: the sharded LUTBoost
train step (``make_train_step(..., mesh=)``, ``Trainer(mesh=)``), the
hierarchical gradient reduction (``train.compression.
psum_hierarchical``), elastic checkpoint restore (``CheckpointManager.
restore(..., mesh=)``) and the GPipe pipeline (``parallel.pipeline``),
against the JAX package on the CPU.

Every rank lies on the CPU (``make_test_mesh(..., device="cpu")``), as
the JAX distributed tests run four host devices on one CPU.

Covered: the port's sharded step on (1, 2) and (2, 2) meshes for the
qwen1.5-4b, dbrx-132b, mamba2-2.7b and zamba2-1.2b smoke configs in
lut_train, a stage-2 then a stage-3 step, against the JAX single-device
``jax.jit(make_train_step(...))`` on the same params and batches: loss,
ce, recon, moe_aux, grad_norm and lr, every gathered gradient leaf (the
sum over each entry's copies, against ``jax.grad``), the updated params
and moments. dbrx-132b runs at capacity factor 0.5 so that its experts
drop pairs: the sharded run's routing (every rank's) equals the
unsharded run's over the global batch. Microbatches 2 with bf16
gradient compression; ``Trainer(mesh=)`` equal to the step it drives,
its checkpoint resumed on (2, 2) and by an unsharded ``Trainer``; a
failing rank raises in the caller, and nothing hangs. The sharding rules
on lut_train trees (``w`` and ``z``, no ``lut``) equal the JAX ones leaf
for leaf. ``psum_hierarchical`` on a (2, 1, 2) (pod, data, model) mesh
against the JAX one inside ``shard_map`` (four host devices in a
subprocess) and against the plain sum; ``run_pipeline`` over 4 stages
against the JAX ``run_pipeline`` (same subprocess) and the sequential
loop; a checkpoint saved on (1, 2) restored unsharded, on (1, 2) and on
(2, 2) bit for bit, each resuming bit for bit as the run that never
stopped; the refusal under a mesh of a head_dim that does not divide,
which names ROADMAP.md queue A item 11, and a ``remat`` step, a vlm
step and an audio step that run; grad mode and
inference mode carried into every rank, and rank threads started at the
call for a training forward only.

Tolerances: those of ``test_torch_train.test_train_steps_match_jax``
(loss, grad_norm at 1e-4; params at 1e-4 of each leaf's largest value,
with at most 1 element in 1000 off and none by more than 3 lr; moments
at 1e-4; with bf16 compression lr x 2^-7 more for the params and 2^-7
for the moments); gradients at 1e-4 of each leaf's largest value (the
tolerance of ``test_torch_lutboost``'s model gradients); the reductions,
the checkpoints and the resumed runs bit for bit; the pipeline within
2e-5 (the JAX test's tolerance).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import run_in_devices  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.parallel import collectives as tcol  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.parallel.pipeline import run_pipeline  # noqa: E402
from repro_torch.train.compression import psum_hierarchical  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: E402
                                       init_opt_state, make_train_step,
                                       reduce_grads, shared_entries,
                                       sharded_loss_and_grads)
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402

ARCHS = ["qwen1.5-4b", "dbrx-132b", "mamba2-2.7b", "zamba2-1.2b"]
MESHES = [(1, 2), (2, 2)]
STEP_TOL = 1e-4
GRAD_TOL = 1e-4
KW = dict(total_steps=10, lr=3e-3, warmup=2, weight_decay=0.01,
          grad_clip=1.0)
#: dbrx-132b smoke at this capacity factor drops routed pairs (its own,
#: 2.0, gives every expert the whole batch)
DROP_CF = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (the tier-1 run puts several test processes on
    the machine's cores; each mesh adds rank threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if arch == "dbrx-132b":
        cj, ct = (c.replace(capacity_factor=DROP_CF) for c in (cj, ct))
    return cj, ct


def _close(got, want, tol, atol=0.0):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=tol, atol=tol * scale + atol)


def _tree_close(got, want, tol, atol=0.0, lr=None):
    """Every leaf of the numpy tree ``got`` against ``want`` (the JAX
    layout), as ``test_torch_train._params_close`` holds them: with
    ``lr`` (params after AdamW), at most 1 element in 1000 of a leaf may
    miss the tolerance, none by more than 3 lr."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _tree_close(got[k], want[k], tol, atol, lr)
        return
    w = np.asarray(want, np.float64)
    if lr is None:
        _close(got, w, tol, atol)
        return
    diff = np.abs(np.asarray(got, np.float64) - w)
    scale = max(float(np.abs(w).max()), 1e-6)
    off = diff > tol * np.abs(w) + tol * scale + atol
    assert off.sum() <= max(1, off.size // 1000), off.sum()
    assert diff.max() <= 3 * lr, diff.max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _from_jax(tree, cfg):
    return params_from_numpy(_np(tree), cfg, device="cpu")


def _opt_from_jax(opt_j, cfg):
    out = {"adam": {"m": _from_jax(opt_j["adam"]["m"], cfg),
                    "v": _from_jax(opt_j["adam"]["v"], cfg),
                    "count": torch.tensor(int(opt_j["adam"]["count"]),
                                          dtype=torch.int32)}}
    if "ef" in opt_j:
        out["ef"] = _from_jax(opt_j["ef"], cfg)
    return out


def _tokens(cfg, n, seed=3, b=4, s=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for _ in range(n)]


_REFS = {}


def _reference(arch, **tc_kw):
    """The JAX side of one arch, once per module: its params (the port's
    init carried over), two batches, and one jitted program giving the
    gradient at the start on the first batch, a stage-2 step on it and a
    stage-3 step from there on the second."""
    key = (arch, tuple(sorted(tc_kw.items())))
    if key in _REFS:
        return _REFS[key]
    cfg_j, cfg_t = _configs(arch)
    qt = tlut.QuantConfig(mode="lut_train")
    params_t = TModel(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(1), qt)
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params_t, cfg_t))
    jm, qj = JModel(cfg_j), jlut.QuantConfig(mode="lut_train")
    tc = jtrainer.TrainConfig(**KW, **tc_kw)
    steps = {s: jtrainer.make_train_step(jm, qj, tc, s) for s in (2, 3)}
    toks = _tokens(cfg_t, 2)

    def run(params, opt, b0, b1):
        grads = jax.grad(lambda p: jm.loss(p, {"tokens": b0}, qj)[0])(params)
        p1, o1, m1 = steps[2](params, opt, {"tokens": b0},
                              jnp.asarray(0, jnp.int32))
        p2, o2, m2 = steps[3](p1, o1, {"tokens": b1},
                              jnp.asarray(1, jnp.int32))
        return grads, [(p1, o1, m1), (p2, o2, m2)]
    opt0 = jtrainer.init_opt_state(params_j, tc)
    args = (params_j, opt0, *map(jnp.asarray, toks))
    # the lowest XLA backend optimization level: the same program in half
    # the compile time, which is most of this file's
    compiled = jax.jit(run).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    grads, after = compiled(*args)
    ref = dict(cfg=cfg_t, qc=qt, params=params_j, opt=opt0, toks=toks,
               grads=_np(grads), after=[_np(a) for a in after])
    _REFS[key] = ref
    return ref


def _routes():
    """Record every ``moe.route`` call's (eid, slot, keep) while open."""
    calls, own = [], tmoe.route

    def route(probs, k, cap):
        out = own(probs, k, cap)
        calls.append(tuple(t.clone() for t in out[:3]))
        return out
    return calls, own, route


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(arch, shape):
    """A stage-2 step then a stage-3 step of the sharded step (each from
    the JAX run's state, as ``test_train_steps_match_jax`` does: a last
    bit of a param can decide a near-tied centroid the other way a step
    later), against the JAX single-device step; the gathered gradient at
    the start against ``jax.grad``; for dbrx-132b the routing of every
    rank against the unsharded run's (pairs dropped)."""
    ref = _reference(arch)
    cfg, qc = ref["cfg"], ref["qc"]
    tm = TModel(cfg, device="cpu")
    mesh = make_test_mesh(shape, device="cpu")
    start = _from_jax(ref["params"], cfg)
    layout = tsh.serving_layout(start, cfg, 2)
    tc = TrainConfig(**KW)
    o_layout = tsh.opt_pspecs(layout, tc)

    # the gathered gradient (every entry summed over its copies)
    step2 = make_train_step(tm, qc, tc, 2, mesh=mesh, layout=layout)
    runner = step2.runner
    shards = tsh.shard_tree(start, layout, mesh, copy=True)
    batch = {"tokens": torch.from_numpy(ref["toks"][0])}
    calls, own, route = _routes()
    tmoe.route = route
    try:
        _, _, parts = sharded_loss_and_grads(
            tm, runner, shards, tsh.shard_batch(batch, cfg, mesh), qc)
        sharded_calls = list(calls)
        del calls[:]
        tm.loss(start, batch, qc)
    finally:
        tmoe.route = own
    if arch == "dbrx-132b":
        assert len(sharded_calls) == mesh.size * len(calls)
        dropped = sum(int((~c[2]).sum()) for c in calls)
        assert dropped > 0, "the case must drop pairs"
        for i, got in enumerate(sharded_calls):
            want = calls[i // mesh.size]
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    shared = shared_entries(layout)
    with torch.no_grad():
        reduced = runner.run(lambda tp: reduce_grads(parts[tp.me], shared))
    got = params_to_numpy(tsh.unshard_tree(reduced, layout, mesh), cfg)
    _tree_close(got, ref["grads"], GRAD_TOL)
    if cfg.family in ("ssm", "hybrid"):
        # the B and C columns every rank holds, on their own scale (their
        # gradient is ~1e-5 of the leaf's largest): a sum over the ranks
        din, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
        for key, lo in (("in_proj", 2 * din), ("conv_w", din),
                        ("conv_b", din)):
            g, w = got["blocks"][key], ref["grads"]["blocks"][key]
            if key == "in_proj":
                g, w = g["w"], w["w"]
            _close(g[..., lo:lo + 2 * gn], w[..., lo:lo + 2 * gn],
                   GRAD_TOL)

    opt_j = ref["opt"]
    params_j = ref["params"]
    for i, stage in enumerate((2, 3)):
        fn = step2 if stage == 2 else make_train_step(
            tm, qc, tc, 3, mesh=mesh, layout=layout)
        shards = tsh.shard_tree(_from_jax(params_j, cfg), layout, mesh,
                                copy=True)
        opt = tsh.shard_tree(_opt_from_jax(opt_j, cfg), o_layout, mesh,
                             copy=True)
        shards, opt, met = fn(shards, opt, {"tokens": torch.from_numpy(
            ref["toks"][i])}, i)
        params_j, opt_j, met_j = ref["after"][i]
        for key in ("loss", "ce", "recon", "moe_aux", "grad_norm"):
            _close(float(met[key]), float(met_j[key]), STEP_TOL)
        assert met["lr"] == pytest.approx(float(met_j["lr"]), rel=1e-6)
        full = tsh.unshard_tree([(p, o) for p, o in zip(shards, opt)],
                                (layout, o_layout), mesh)
        _tree_close(params_to_numpy(full[0], cfg), params_j, STEP_TOL,
                    lr=met["lr"])
        for key in ("m", "v"):
            _tree_close(params_to_numpy(full[1]["adam"][key], cfg),
                        opt_j["adam"][key], STEP_TOL)
        assert int(full[1]["adam"]["count"]) == i + 1


def test_microbatches_and_compression_sharded_match_jax():
    """Two microbatches and bf16 gradient compression on (2, 2) (each
    microbatch cut over the two data groups), a stage-3 step from the
    JAX run's state after its stage-2 step: loss, grad_norm, params and
    moments against the JAX step's, the error-feedback residuals
    present."""
    ref = _reference("qwen1.5-4b", microbatches=2, compress_grads=True)
    cfg, qc = ref["cfg"], ref["qc"]
    tm = TModel(cfg, device="cpu")
    mesh = make_test_mesh((2, 2), device="cpu")
    tc = TrainConfig(**KW, microbatches=2, compress_grads=True)
    p1_j, o1_j, _ = ref["after"][0]
    start = _from_jax(p1_j, cfg)
    layout = tsh.serving_layout(start, cfg, 2)
    o_layout = tsh.opt_pspecs(layout, tc)
    shards = tsh.shard_tree(start, layout, mesh, copy=True)
    opt = tsh.shard_tree(_opt_from_jax(o1_j, cfg), o_layout, mesh,
                         copy=True)
    fn = make_train_step(tm, qc, tc, 3, mesh=mesh, layout=layout)
    shards, opt, met = fn(shards, opt,
                          {"tokens": torch.from_numpy(ref["toks"][1])}, 1)
    p2_j, o2_j, met_j = ref["after"][1]
    _close(float(met["loss"]), float(met_j["loss"]), STEP_TOL)
    _close(float(met["grad_norm"]), float(met_j["grad_norm"]), STEP_TOL)
    full = tsh.unshard_tree([(p, o) for p, o in zip(shards, opt)],
                            (layout, o_layout), mesh)
    _tree_close(params_to_numpy(full[0], cfg), p2_j, STEP_TOL,
                tc.lr * 2 ** -7, met["lr"])
    for key in ("m", "v"):
        _tree_close(params_to_numpy(full[1]["adam"][key], cfg),
                    o2_j["adam"][key], 2 ** -7)
    # the residuals as test_train_steps_match_jax holds them (present, of
    # the params' shapes; ef_compress itself is held bit for bit there): a
    # float32 gradient a last bit off can round to the other bf16
    # neighbour, which moves its residual by a whole bf16 ulp
    ef = params_to_numpy(full[1]["ef"], cfg)
    assert jax.tree_util.tree_structure(ef) == \
        jax.tree_util.tree_structure(_np(o2_j["ef"]))
    for a, b in zip(jax.tree_util.tree_leaves(ef),
                    jax.tree_util.tree_leaves(_np(o2_j["ef"]))):
        assert a.shape == b.shape and np.isfinite(a).all()


def test_sharding_rules_on_lut_train_trees_equal_jax():
    """``param_pspecs`` of lut_train trees (``w`` and ``z``, no ``lut``)
    equal the JAX rule's leaf for leaf (the JAX leaf shapes from
    ``jax.eval_shape``; the port's block leaves have no layer axis)."""
    qc_j = jlut.QuantConfig(mode="lut_train")
    for arch in ARCHS:
        cfg_j, cfg_t = _configs(arch)
        jm = JModel(cfg_j)
        shapes = jax.eval_shape(lambda k: jm.init(k, qc_j),
                                jax.random.PRNGKey(0))
        params = TModel(cfg_t, device="cpu").init(
            torch.Generator().manual_seed(0), tlut.QuantConfig(
                mode="lut_train"))
        for msize in (2, 4):
            want = {}
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
                path = jax.tree_util.keystr(p)
                spec = tuple(jsh._spec_for_leaf(path, tuple(leaf.shape),
                                                cfg_j, "model", msize))
                if path.startswith("['blocks']"):
                    path = "['blocks'][0]" + path[len("['blocks']"):]
                    spec = spec[1:]
                want[path] = spec
            specs = tsh.param_pspecs(params, cfg_t, model_axis_size=msize)
            got = _spec_leaves(specs)
            assert len(got) == len(tree_flatten_with_path(params))
            for path, spec in got:
                key = path if not path.startswith("['blocks']") else \
                    "['blocks'][0]" + path.split("]", 2)[2]
                assert want[key] == tuple(spec), (arch, path, msize)
        assert any(path.endswith("['z']") for path in want)
        assert not any(path.endswith("['lut']") for path in want)


def _spec_leaves(specs):
    """(path, spec) of a port spec tree (a spec is a leaf, not a tuple to
    walk)."""
    out = []

    def walk(t, path):
        if isinstance(t, (tsh.P, tsh.Columns)):
            out.append((path, t))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
    walk(specs, "")
    return out


def test_trainer_on_a_mesh_drives_the_sharded_step(tmp_path):
    """``Trainer(mesh=)``: two steps from global params give the sharded
    step's params and moments bit for bit, gathered on the params'
    device, and leave the params given untouched; a run stopped after one
    step and resumed from its checkpoint by a trainer on another mesh
    ((2, 2) after (1, 2)) gives the run that re-placed its state onto
    (2, 2) in memory, bit for bit."""
    from repro_torch.data import SyntheticDataset
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    qc = tlut.QuantConfig(mode="lut_train")
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(4), qc)
    keep = tree_map(lambda t: t.clone(), params)
    ds = SyntheticDataset(cfg, 4, 16, seed=5, device="cpu")
    tc = TrainConfig(**KW, checkpoint_every=100, log_every=100)
    m12 = make_test_mesh((1, 2), device="cpu")
    m22 = make_test_mesh((2, 2), device="cpu")
    quiet = dict(log_fn=lambda _: None)
    p_t, o_t, hist = Trainer(tm, ds, qc, tc, mesh=m12, **quiet).run(
        params, num_steps=2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten_with_path(params), tree_flatten_with_path(keep)))
    layout = tsh.serving_layout(params, cfg, 2)
    o_layout = tsh.opt_pspecs(layout, tc)
    shards = tsh.shard_tree(params, layout, m12, copy=True)
    opt = init_opt_state(shards, tc, mesh=m12)
    fn = make_train_step(tm, qc, tc, 3, mesh=m12, layout=layout)
    for i in range(2):
        shards, opt, met = fn(shards, opt, ds.batch(i), i)
        assert float(met["loss"]) == hist["loss"][i]
    want = tsh.unshard_tree(list(zip(shards, opt)), (layout, o_layout), m12)
    _equal(want, (p_t, o_t))

    ck = str(tmp_path / "run")
    Trainer(tm, ds, qc, tc, checkpoint_dir=ck, mesh=m12, **quiet).run(
        params, num_steps=1)
    p_r, o_r, _ = Trainer(tm, ds, qc, tc, checkpoint_dir=ck, mesh=m22,
                          **quiet).run(params, num_steps=1)
    shards = tsh.shard_tree(params, layout, m12, copy=True)
    opt = init_opt_state(shards, tc, mesh=m12)
    shards, opt, _ = fn(shards, opt, ds.batch(0), 0)
    mid = tsh.unshard_tree(list(zip(shards, opt)), (layout, o_layout), m12)
    s22 = tsh.shard_tree(mid, (layout, o_layout), m22, copy=True)
    fn22 = make_train_step(tm, qc, tc, 3, mesh=m22, layout=layout)
    shards, opt, _ = fn22([p for p, _ in s22], [o for _, o in s22],
                          ds.batch(1), 1)
    _equal(tsh.unshard_tree(list(zip(shards, opt)), (layout, o_layout),
                            m22), (p_r, o_r))


def test_trainer_resumes_a_sharded_checkpoint_unsharded(tmp_path):
    """A run stopped after one step of ``Trainer(mesh=(1, 2))`` and
    resumed from its checkpoint by an unsharded ``Trainer`` gives the
    unsharded trainer that takes the second step from the first run's
    state handed over in memory, bit for bit; the unsharded trainer is
    the sharded step on one rank, in place."""
    from repro_torch.data import SyntheticDataset
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    qc = tlut.QuantConfig(mode="lut_train")
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(6), qc)
    ds = SyntheticDataset(cfg, 4, 16, seed=7, device="cpu")
    tc = TrainConfig(**KW, checkpoint_every=100, log_every=100)
    m12 = make_test_mesh((1, 2), device="cpu")
    quiet = dict(log_fn=lambda _: None)
    ck = str(tmp_path / "run")
    first = Trainer(tm, ds, qc, tc, checkpoint_dir=ck, mesh=m12,
                    **quiet).run(params, num_steps=1)[:2]
    got = Trainer(tm, ds, qc, tc, checkpoint_dir=ck, **quiet).run(
        tree_map(lambda t: t.clone(), params), num_steps=1)[:2]
    handed = tree_map(lambda t: t.clone(), first)
    p_w, o_w, _ = Trainer(tm, ds, qc, tc, **quiet).run(
        *handed, start_step=1, num_steps=1)
    assert p_w is handed[0]                       # trained in place
    _equal(got, (p_w, o_w))
    assert int(o_w["adam"]["count"]) == 2


def _equal(a, b):
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_elastic_restore_across_meshes_resumes_bit_for_bit(tmp_path):
    """A (1, 2) state after one sharded step, saved as global arrays,
    restored unsharded, on (1, 2) and on (2, 2): each equal bit for bit
    to the saved state (``unshard_tree`` of the shards), and each
    resuming bit for bit as the run that kept its state in memory (on
    (1, 2) the uninterrupted run; unsharded and on (2, 2) the state
    re-placed in memory)."""
    cfg = tconfigs.get_smoke_config("mamba2-2.7b")
    qc = tlut.QuantConfig(mode="lut_train")
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(6), qc)
    tc = TrainConfig(**KW)
    toks = [torch.from_numpy(t) for t in _tokens(cfg, 2, seed=8)]
    layout = tsh.serving_layout(params, cfg, 2)
    o_layout = tsh.opt_pspecs(layout, tc)
    state_layout = (layout, o_layout)
    m12 = make_test_mesh((1, 2), device="cpu")
    fn = make_train_step(tm, qc, tc, 3, mesh=m12, layout=layout)
    shards = tsh.shard_tree(params, layout, m12, copy=True)
    opt = init_opt_state(shards, tc, mesh=m12)
    shards, opt, _ = fn(shards, opt, {"tokens": toks[0]}, 0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, list(zip(shards, opt)), mesh=m12, layout=state_layout)
    saved = tsh.unshard_tree(list(zip(shards, opt)), state_layout, m12)
    like = tree_map(lambda t: t.to("meta"), saved)
    p_a, o_a, _ = fn(shards, opt, {"tokens": toks[1]}, 1)
    uninterrupted = tsh.unshard_tree(list(zip(p_a, o_a)), state_layout, m12)

    flat, step, _ = mgr.restore(like)
    assert step == 1
    _equal(flat, saved)
    p_u, o_u, _ = make_train_step(tm, qc, tc, 3)(
        flat[0], flat[1], {"tokens": toks[1]}, 1)
    mem = tree_map(lambda t: t.clone(), saved)
    p_m, o_m, _ = make_train_step(tm, qc, tc, 3)(
        mem[0], mem[1], {"tokens": toks[1]}, 1)
    _equal((p_u, o_u), (p_m, o_m))

    for shape in ((1, 2), (2, 2)):
        mesh = make_test_mesh(shape, device="cpu")
        back, _, _ = mgr.restore(like, mesh=mesh, layout=state_layout)
        _equal(tsh.unshard_tree(back, state_layout, mesh), saved)
        fn_s = make_train_step(tm, qc, tc, 3, mesh=mesh, layout=layout)
        p_r, o_r, _ = fn_s([p for p, _ in back], [o for _, o in back],
                           {"tokens": toks[1]}, 1)
        got = tsh.unshard_tree(list(zip(p_r, o_r)), state_layout, mesh)
        if shape == (1, 2):
            _equal(got, uninterrupted)
        else:
            s = tsh.shard_tree(saved, state_layout, mesh, copy=True)
            p_w, o_w, _ = fn_s([p for p, _ in s], [o for _, o in s],
                               {"tokens": toks[1]}, 1)
            _equal(got, tsh.unshard_tree(list(zip(p_w, o_w)), state_layout,
                                         mesh))


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    """The JAX ``psum_hierarchical`` inside ``shard_map`` on a (2, 1, 2)
    (pod, data, model) mesh and the JAX ``run_pipeline`` over 4 stages,
    in one subprocess with four host devices, on inputs from numpy."""
    d = tmp_path_factory.mktemp("jax_mesh")
    rng = np.random.default_rng(21)
    g = {"a": rng.standard_normal((4, 6)).astype(np.float32),
         "b": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    ws = (rng.standard_normal((4, 32, 32)) / 32 ** 0.5).astype(np.float32)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    np.savez(d / "in.npz", ws=ws, x=x, **g)
    run_in_devices(f"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.compression import psum_hierarchical
from repro.parallel.pipeline import _shard_map, run_pipeline
from repro.launch.mesh import make_test_mesh
inp = np.load({str(d / "in.npz")!r})
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 1, 2),
            ("pod", "data", "model"))
spec = P(("pod", "data", "model"))
f = _shard_map(lambda a, b: psum_hierarchical({{"a": a, "b": b}}), mesh,
               in_specs=(spec, spec), out_specs={{"a": spec, "b": spec}})
out = f(jnp.asarray(inp["a"]), jnp.asarray(inp["b"]))
block = lambda w, x: jax.nn.gelu(x @ w)
pipe = run_pipeline(make_test_mesh((4,), ("stage",)), block,
                    jnp.asarray(inp["ws"]), jnp.asarray(inp["x"]), n_micro=8)
np.savez({str(d / "out.npz")!r}, a=np.asarray(out["a"]),
         b=np.asarray(out["b"]), pipe=np.asarray(pipe))
""")
    return dict(np.load(d / "in.npz")), dict(np.load(d / "out.npz"))


def test_psum_hierarchical_matches_jax_and_the_plain_sum(jax_mesh_runs):
    """Each rank of a (2, 1, 2) (pod, data, model) runner sums its leaves
    over data, then pod: bit for bit the JAX ``psum_hierarchical`` inside
    ``shard_map``, and the plain sum over the ranks that share its model
    coordinate; the same rank order on every rank; outside a runner the
    tree comes back as it is."""
    inp, want = jax_mesh_runs
    mesh = make_test_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    runner = tcol.RankRunner(mesh=mesh)
    outs = runner.run(lambda tp: psum_hierarchical(
        {"a": torch.from_numpy(inp["a"][tp.me]),
         "b": torch.from_numpy(inp["b"][tp.me])}))
    assert runner.collectives == 2          # data has one rank: pod only
    for key in ("a", "b"):
        got = np.stack([o[key].numpy() for o in outs])
        np.testing.assert_array_equal(got, want[key])
        for r in range(4):
            m = r % 2
            np.testing.assert_array_equal(got[r],
                                          inp[key][m] + inp[key][2 + m])
    t = {"a": torch.ones(3)}
    assert psum_hierarchical(t)["a"] is t["a"]
    mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    vals = [torch.tensor([1e8, 1.0, 0.5, 3.0])[None] * (r + 1) ** 3
            for r in range(4)]
    outs = tcol.RankRunner(mesh=mesh).run(
        lambda tp: psum_hierarchical({"v": vals[tp.me]})["v"])
    want = (vals[0] + vals[1]) + (vals[2] + vals[3])
    for o in outs:
        assert torch.equal(o, want)


def test_run_pipeline_matches_jax_and_the_sequential_loop(jax_mesh_runs):
    """GPipe over 4 stage ranks, 8 microbatches: the JAX ``run_pipeline``'s
    output and the sequential loop of the four blocks, within 2e-5."""
    inp, want = jax_mesh_runs
    ws, x = torch.from_numpy(inp["ws"]), torch.from_numpy(inp["x"])

    def block(w, h):
        return torch.nn.functional.gelu(h @ w, approximate="tanh")
    mesh = make_test_mesh((4,), ("stage",), device="cpu")
    out = run_pipeline(mesh, block, ws, x, n_micro=8)
    np.testing.assert_allclose(out.numpy(), want["pipe"], rtol=2e-5,
                               atol=2e-5)
    seq = x
    for i in range(4):
        seq = block(ws[i], seq)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        run_pipeline(mesh, block, ws, x, n_micro=3)


def test_a_failing_rank_raises_and_nothing_hangs():
    """Rank 1's shard of one projection has a wrong shape: the sharded
    step raises that rank's error in the caller within the test's own
    timeout (not the abort of the waiting ranks), and the runner trains
    again once the shard is repaired."""
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    qc = tlut.QuantConfig(mode="lut_train")
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(2), qc)
    mesh = make_test_mesh((2, 2), device="cpu")
    layout = tsh.serving_layout(params, cfg, 2)
    tc = TrainConfig(**KW)
    fn = make_train_step(tm, qc, tc, 3, mesh=mesh, layout=layout)
    shards = tsh.shard_tree(params, layout, mesh, copy=True)
    opt = init_opt_state(shards, tc, mesh=mesh)
    wd = shards[1]["blocks"][1]["mlp"]["wd"]
    good = wd["w"]
    wd["w"] = good[:3]
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 1)[0])}
    box = {}

    def go():
        try:
            fn(shards, opt, batch, 0)
        except BaseException as e:            # noqa: BLE001
            box["err"] = e
    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the sharded step hung on a failed rank"
    assert "err" in box and not isinstance(box["err"], tcol._Aborted)
    wd["w"] = good
    _, _, met = fn(shards, opt, batch, 0)
    assert np.isfinite(float(met["loss"]))


def test_refusals_under_a_mesh_name_item_11():
    """No sharded step runs what the rank code cannot: a head_dim that
    does not divide the model axis (where the kv heads do not either);
    shards that share storage across ranks are refused too (each rank
    updates its own). ``remat`` under a mesh, refused before, now runs
    (every rank recomputes a layer together: ``test_torch_fallbacks``).
    The vlm and audio families, refused before, now take a sharded step
    (held against the JAX package in ``test_torch_scaleout``)."""
    qc = tlut.QuantConfig(mode="lut_train")
    tc = TrainConfig(**KW)
    mesh = make_test_mesh((1, 2), device="cpu")
    cfg = tconfigs.get_smoke_config("qwen1.5-4b").replace(remat=True)
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0), qc)
    layout = tsh.serving_layout(params, cfg, 2)
    fn = make_train_step(tm, qc, tc, 3, mesh=mesh, layout=layout)
    shards = tsh.shard_tree(params, layout, mesh, copy=True)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 1)[0])}
    _, _, met = fn(shards, init_opt_state(shards, tc, mesh=mesh), batch, 0)
    assert np.isfinite(float(met["loss"]))
    shared = tsh.shard_tree(params, layout, mesh)
    with pytest.raises(ValueError, match="copy=True"):
        fn(shared, init_opt_state(shared, tc, mesh=mesh), batch, 0)
    c = tconfigs.get_smoke_config("yi-9b")
    with pytest.raises(NotImplementedError, match="head_dim=8.*item 11"):
        make_train_step(TModel(c, device="cpu"), qc, tc, 3,
                        mesh=make_test_mesh((1, 16), device="cpu"),
                        layout={})
    rng = np.random.default_rng(0)
    for arch in ("paligemma-3b", "musicgen-large"):
        c = tconfigs.get_smoke_config(arch)
        tm = TModel(c, device="cpu")
        params = tm.init(torch.Generator().manual_seed(0), qc)
        layout = tsh.serving_layout(params, c, 2)
        fn = make_train_step(tm, qc, tc, 3, mesh=mesh, layout=layout)
        shards = tsh.shard_tree(params, layout, mesh, copy=True)
        if c.family == "audio":
            batch = {"embeds": torch.from_numpy(rng.standard_normal(
                         (4, 8, c.d_model)).astype(np.float32)),
                     "labels": torch.from_numpy(rng.integers(
                         0, c.vocab_size, (4, 8, c.num_codebooks)
                     ).astype(np.int32))}
        else:
            batch = {"patch_embeds": torch.from_numpy(rng.standard_normal(
                         (4, c.num_patches, c.d_model)).astype(np.float32)),
                     "tokens": torch.from_numpy(_tokens(c, 1, b=4,
                                                        s=8)[0])}
        _, _, met = fn(shards, init_opt_state(shards, tc, mesh=mesh), batch,
                       0)
        assert np.isfinite(float(met["loss"]))


def test_rank_runner_carries_grad_and_inference_mode():
    """Grad mode and inference mode are thread-local: every rank runs
    under the caller's."""
    runner = tcol.RankRunner([torch.device("cpu")] * 3)

    def modes(tp):
        return torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    assert runner.run(modes) == [(True, False)] * 3
    with torch.no_grad():
        assert runner.run(modes) == [(False, False)] * 3
    with torch.inference_mode():
        assert runner.run(modes) == [(False, True)] * 3


def test_rank_runner_starts_rank_threads_for_a_training_forward_only():
    """With grad enabled (a training forward) every rank runs on a thread
    started for the call, rank 0 included; under ``no_grad`` or inference
    mode (serving) rank 0 runs on the calling thread and the others on the
    runner's persistent workers."""
    runner = tcol.RankRunner([torch.device("cpu")] * 2)

    def threads():
        return runner.run(lambda tp: threading.current_thread())
    for off in (torch.no_grad, torch.inference_mode):
        with off():
            a, b = threads(), threads()
        assert a[0] is b[0] is threading.current_thread()
        assert a[1] is b[1] and a[1] is not a[0]
    a, b = threads(), threads()
    assert threading.current_thread() not in a + b
    assert len({id(t) for t in a + b}) == 4
