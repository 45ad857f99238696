"""Port parity for the scale-out paths a model axis adds to the vlm and
audio families and to the paged engines, against the JAX package on the
CPU (every rank on the CPU, ``make_test_mesh(..., device="cpu")``):

* paligemma-3b (1 kv head: the head_dim layout) and musicgen-large
  (heads; its ``heads`` (Q, D, V) sharded on V, its stub ``in_proj``
  replicated) smoke on (1, 2): ``forward`` / ``loss`` in lut_train and a
  dense-cache ``prefill`` plus 3 ``decode`` steps in int8 lut_infer
  against the JAX single-device results; one sharded stage-3 step
  against the JAX step jitted over a (1, 2) mesh of host devices
  (GSPMD), with its gradient;
* the vocab-parallel cross-entropy (``models.model.cross_entropy``: each
  rank's vocab columns, the sums all-reduced) against the JAX
  ``Model.loss``, and its gradient against one ``log_softmax``'s;
* the head_dim layout's decode kernels' plain versions
  (``flash_decode_hd_scores_plain``, the scores summed over the ranks in
  rank order, then ``flash_decode_hd_attend_plain``) on random pools
  against the JAX ``flash_decode_paged`` over the whole pool (GQA,
  window, ``kv_start``, a ``pos = -1`` lane, trash pages);
* ``Engine(mesh=(1, 4))`` over yi-9b and gemma3-4b smoke (2 kv heads:
  each rank's fp pool the head_dim slice of both, a code pool
  replicated), fused, two-pass and vq-kv, against the JAX
  ``Engine(mesh=(1, 4))`` (four host devices): greedy tokens, finish
  reasons and preemptions, with a repeated prompt, a mid-decode
  admission and an oversubscribed pool; an ngram speculative engine
  (``verify_paged`` in the layout) against the one-device engine.

The JAX sharded runs (six engines, two train steps) run once, in one
subprocess with four host devices (``conftest.run_in_devices``), which
also writes their params and the engines' KV codebooks.

Tolerances: logits within 1e-4 of their scale of the JAX package's
(``test_torch_fallbacks``' JAX_TOL), argmax equal; the step's loss,
grad_norm and params at ``test_torch_train_scale``'s STEP_TOL, its
gradients at GRAD_TOL; the cross-entropy within 1e-5, its gradient
within 1e-6; the decode kernels within 1e-5 (float32: sums in another
order); greedy tokens identical.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import run_in_devices  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (kv_codebook_from_numpy,  # noqa: E402
                                 params_from_numpy, params_to_numpy)
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.layers import hd_fallback  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.model import cross_entropy  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.parallel.collectives import RankRunner  # noqa: E402
from repro_torch.serve import Engine, Request, SpecConfig  # noqa: E402
from repro_torch.train.trainer import (TrainConfig,  # noqa: E402
                                       init_opt_state, make_train_step,
                                       reduce_grads, shared_entries,
                                       sharded_loss_and_grads)

JAX_TOL = 1e-4
STEP_TOL = 1e-4
GRAD_TOL = 1e-4
CE_TOL = 1e-5
KERNEL_TOL = 1e-5
FAMILIES = ["paligemma-3b", "musicgen-large"]
ENGINE_ARCHS = ["yi-9b", "gemma3-4b"]
RUNS = ["fused", "two-pass", "vq-kv"]
PS, MAX_SEQ, CHUNK = 8, 32, 4
ENGINE_KW = dict(batch_size=2, max_seq=MAX_SEQ, page_size=PS,
                 prefill_chunk=CHUNK)
#: prompt lengths and budgets; the fourth repeats the third's prompt; one
#: more request joins after 6 steps; 5 pages for 2 slots preempt
PLAN = ((11, 8), (3, 6), (16, 5), (16, 5), (6, 7))
LATE = (9, 6)
NUM_PAGES = 5
STEP_KW = dict(total_steps=10, lr=3e-3, warmup=2, weight_decay=0.01,
               grad_clip=1.0)
SEEDS = {"engine": 12, "step": 4}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (each mesh adds rank threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-6))


def _plan(vocab):
    rng = np.random.default_rng(11)
    plan = [(rng.integers(0, vocab, n).tolist(), m) for n, m in PLAN]
    plan[3] = (plan[2][0], plan[3][1])             # the repeated prompt
    late = (rng.integers(0, vocab, LATE[0]).tolist(), LATE[1])
    return plan, late


def _family_batch(cfg, seed=7, b=4, s=8):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"embeds": rng.standard_normal((b, s, cfg.d_model)
                                              ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (b, s, cfg.num_codebooks)
                                       ).astype(np.int32)}
    return {"patch_embeds": rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                   ).astype(np.int32)}


_CHILD = f"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro import configs as jconfigs
from repro.core import precompute_model
from repro.core.lut import QuantConfig as JQC
from repro.launch.mesh import make_test_mesh, mesh_context
from repro.models.model import Model as JModel
from repro.parallel.sharding import (batch_pspecs, logical_to_sharding,
                                     param_pspecs)
from repro.serve import Engine, Request
from repro.train import trainer as jtrainer

PLAN, LATE = {PLAN!r}, {LATE!r}
KW = {ENGINE_KW!r}
arrays, res = {{}}, {{}}

def keep(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

def plan(vocab):
    rng = np.random.default_rng(11)
    p = [(rng.integers(0, vocab, n).tolist(), m) for n, m in PLAN]
    p[3] = (p[2][0], p[3][1])
    return p, (rng.integers(0, vocab, LATE[0]).tolist(), LATE[1])

mesh = make_test_mesh((1, 4), ("data", "model"))
for arch in {ENGINE_ARCHS!r}:
    cfg = jconfigs.get_smoke_config(arch)
    jm = JModel(cfg)
    base = jm.init(jax.random.PRNGKey({SEEDS["engine"]}),
                   JQC(mode="lut_train"))
    for run in {RUNS!r}:
        kw = {{"two-pass": dict(fuse=False),
               "vq-kv": dict(kv_quant="vq")}}.get(run, {{}})
        qc = JQC(mode="lut_infer", lut_dtype="int8", **kw)
        params = precompute_model(base, qc)
        keep(f"{{arch}}|{{run}}|", params)
        eng = Engine(jm, params, qc, mesh=mesh, num_pages={NUM_PAGES},
                     **KW)
        if run == "vq-kv":
            keep(f"{{arch}}|{{run}}|cb", eng.kv_codebook.tree())
        reqs, late = plan(cfg.vocab_size)
        reqs = [Request(tokens=p, max_new_tokens=m) for p, m in reqs]
        for r in reqs:
            eng.submit(r)
        for _ in range(6):
            eng.step()
        reqs.append(Request(tokens=late[0], max_new_tokens=late[1]))
        eng.submit(reqs[-1])
        eng.run_until_idle()
        res[f"{{arch}}|{{run}}"] = dict(
            tokens=[r.out_tokens for r in reqs],
            reasons=[r.finish_reason.name for r in reqs],
            preemptions=eng.scheduler.preemptions)

mesh2 = make_test_mesh((1, 2), ("data", "model"))
for arch in {FAMILIES!r}:
    cfg = jconfigs.get_smoke_config(arch)
    jm, qj = JModel(cfg), JQC(mode="lut_train")
    params = jm.init(jax.random.PRNGKey({SEEDS["step"]}), qj)
    keep(f"{{arch}}|p0|", params)
    batch = dict(np.load(f"batch-{{arch}}.npz"))
    tc = jtrainer.TrainConfig(**{STEP_KW!r})
    step = jtrainer.make_train_step(jm, qj, tc, 3)
    ps = logical_to_sharding(param_pspecs(params, cfg, model_axis_size=2),
                             mesh2)
    bs = logical_to_sharding({{k: v for k, v in batch_pspecs(
        cfg, ("data",)).items() if k in batch}}, mesh2)
    params = jax.device_put(params, ps)
    batch = jax.device_put({{k: jnp.asarray(v) for k, v in batch.items()}},
                           bs)
    opt = jtrainer.init_opt_state(params, tc)
    # the lowest XLA backend optimization level: the same program in
    # less compile time
    low = {{"xla_backend_optimization_level": 0}}
    i0 = jnp.asarray(0, jnp.int32)
    with mesh_context(mesh2):
        grad = jax.jit(jax.grad(lambda p: jm.loss(p, batch, qj)[0]))
        grads = grad.lower(params).compile(low)(params)
        p1, _, met = jax.jit(step).lower(params, opt, batch, i0).compile(
            low)(params, opt, batch, i0)
    keep(f"{{arch}}|grads|", grads)
    keep(f"{{arch}}|p1|", p1)
    res[arch] = {{k: float(v) for k, v in met.items()}}
np.savez("out.npz", **arrays)
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's sharded runs: six ``Engine(mesh=(1, 4))`` runs
    and a stage-3 step of each family over (1, 2), in one subprocess
    with four host devices. Returns (results, arrays by key)."""
    d = tmp_path_factory.mktemp("jax_sharded")
    for arch in FAMILIES:
        np.savez(d / f"batch-{arch}.npz",
                 **_family_batch(jconfigs.get_smoke_config(arch)))
    out = run_in_devices(f"import os; os.chdir({str(d)!r})\n" + _CHILD,
                         n_devices=4, timeout=900)
    res = json.loads(out.split("RESULT ", 1)[1])
    return res, dict(np.load(d / "out.npz"))


def _tree_from(arrays, prefix, like):
    """The tree of ``like`` (a JAX tree) with its leaves read from
    ``arrays`` by their key paths under ``prefix``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [arrays[prefix + jax.tree_util.keystr(p)] for p, _ in flat])


# ------------------------------------------------------------ families
def _family_params(arch, seed=1):
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    tm, jm = TModel(ct, device="cpu"), JModel(cj)
    qt = TQC(mode="lut_train")
    params_t = tm.init(torch.Generator().manual_seed(seed), qt)
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params_t, ct))
    return ct, tm, jm, params_t, params_j


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_and_loss_match_jax_single_device(arch):
    """lut_train ``forward`` (the whole logits, gathered) and ``loss``
    (the vocab-parallel cross-entropy) of every rank on (1, 2): paligemma
    in the head_dim layout (its P + S = 24 rows re-sharded by sequence),
    musicgen in the heads layout with V-sharded heads."""
    ct, tm, jm, params_t, params_j = _family_params(arch)
    assert hd_fallback(ct, 2) == (arch == "paligemma-3b")
    qt, qj = TQC(mode="lut_train"), JQC(mode="lut_train")
    batch = _family_batch(ct)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lg_j, _ = jm.forward(params_j, jb, qj)
    loss_j, met_j = jm.loss(params_j, jb, qj)
    mesh = make_test_mesh((1, 2), device="cpu")
    layout = tsh.serving_layout(params_t, ct, 2)
    if arch == "musicgen-large":
        assert tuple(layout["heads"]) == (None, None, "model")
        assert tuple(layout["in_proj"]) == ()
    shards = tsh.shard_tree(params_t, layout, mesh)
    parts = tsh.shard_batch({k: torch.from_numpy(v)
                             for k, v in batch.items()}, ct, mesh)
    with torch.no_grad():
        outs = RankRunner(mesh=mesh).run(lambda tp: (
            tm.forward(shards[tp.me], parts[tp.me], qt)[0],
            tm.loss(shards[tp.me], parts[tp.me], qt)))
    for lg, (loss, met) in outs:
        _close(lg.numpy(), np.asarray(lg_j), JAX_TOL)
        _close(float(loss), float(loss_j), JAX_TOL)
        _close(float(met["ce"]), float(met_j["ce"]), JAX_TOL)
        _close(float(met["recon"]), float(met_j["recon"]), JAX_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_dense_cache_chain_matches_jax_single_device(arch):
    """int8 lut_infer on (1, 2): the dense-cache prefill (paligemma: 16
    patches attended both ways, then the text) and 3 decode steps fed the
    JAX run's greedy tokens (musicgen: fixed frame embeddings); each
    call's logits (gathered: paligemma's vocab, musicgen's V of each
    codebook) against the JAX package's."""
    ct, tm, jm, _, params_j = _family_params(arch, seed=2)
    qi_j = JQC(mode="lut_infer", lut_dtype="int8")
    qi_t = TQC(mode="lut_infer", lut_dtype="int8")
    pj = precompute_model(params_j, qi_j)
    pt = params_from_numpy(_np(pj), ct, device="cpu")
    batch = _family_batch(ct, seed=8, b=2, s=6)
    batch.pop("labels", None)
    rows = (ct.num_patches if ct.family == "vlm" else 0) + 6 + 4
    rng = np.random.default_rng(9)
    lg, cache = jm.prefill(pj, {k: jnp.asarray(v) for k, v in batch.items()},
                           jm.init_cache(2, rows), qi_j)
    want, nexts = [np.asarray(lg)], []
    for _ in range(3):
        if ct.family == "audio":
            nxt = rng.standard_normal((2, 1, ct.d_model)).astype(np.float32)
        else:
            nxt = want[-1].argmax(-1).astype(np.int32)[:, None]
        nexts.append(torch.from_numpy(nxt))
        lg, cache = jm.decode(pj, jnp.asarray(nxt), cache, qi_j)
        want.append(np.asarray(lg))
    mesh = make_test_mesh((1, 2), device="cpu")
    shards = tsh.shard_tree(pt, tsh.serving_layout(pt, ct, 2), mesh)
    caches = tsh.shard_cache(tm.init_cache(2, rows), ct, 2, mesh)
    runner = RankRunner(mesh=mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        outs = runner.run(lambda tp: tm.prefill(shards[tp.me], tb,
                                                caches[tp.me], qi_t))
        got, caches = [outs[0][0]], [o[1] for o in outs]
        for t in nexts:
            outs = runner.run(lambda tp: tm.decode(shards[tp.me], t,
                                                   caches[tp.me], qi_t))
            got.append(outs[0][0])
            caches = [o[1] for o in outs]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w, JAX_TOL)
        assert (g.numpy().argmax(-1) == w.argmax(-1)).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sharded_step_matches_jax_sharded_step(arch, jax_sharded):
    """A stage-3 step of the port's sharded step on (1, 2) from the JAX
    run's params and batch: the gathered gradient against the JAX
    gradient jitted over a (1, 2) mesh of host devices, and the loss,
    grad_norm and updated params against the JAX sharded step's."""
    res, arrays = jax_sharded
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jm, qt = JModel(cj), TQC(mode="lut_train")
    like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          JQC(mode="lut_train")))
    p0 = params_from_numpy(_tree_from(arrays, f"{arch}|p0|", like), ct,
                           device="cpu")
    tm = TModel(ct, device="cpu")
    mesh = make_test_mesh((1, 2), device="cpu")
    layout = tsh.serving_layout(p0, ct, 2)
    tc = TrainConfig(**STEP_KW)
    batch = {k: torch.from_numpy(v) for k, v in
             _family_batch(ct).items()}
    step = make_train_step(tm, qt, tc, 3, mesh=mesh, layout=layout)
    runner = step.runner
    _, _, parts = sharded_loss_and_grads(
        tm, runner, tsh.shard_tree(p0, layout, mesh, copy=True),
        tsh.shard_batch(batch, ct, mesh), qt)
    with torch.no_grad():
        reduced = runner.run(lambda tp: reduce_grads(
            parts[tp.me], shared_entries(layout)))
    got = params_to_numpy(tsh.unshard_tree(reduced, layout, mesh), ct)
    want = _np(_tree_from(arrays, f"{arch}|grads|", like))
    _walk(got, want, GRAD_TOL)
    shards = tsh.shard_tree(p0, layout, mesh, copy=True)
    shards, _, met = step(shards, init_opt_state(shards, tc, mesh=mesh),
                          batch, 0)
    for key in ("loss", "grad_norm"):
        _close(float(met[key]), res[arch][key], STEP_TOL)
    p1 = params_to_numpy(tsh.unshard_tree(shards, layout, mesh), ct)
    _walk(p1, _np(_tree_from(arrays, f"{arch}|p1|", like)), STEP_TOL,
          lr=STEP_KW["lr"])


def _walk(got, want, tol, lr=None):
    """Every leaf against the JAX one; with ``lr`` (params after AdamW)
    as ``test_torch_train_scale`` holds them: at most 1 element in 1000
    of a leaf may miss the tolerance, none by more than 3 lr."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _walk(got[k], want[k], tol, lr)
    elif lr is None:
        _close(got, want, tol)
    else:
        w = np.asarray(want, np.float64)
        diff = np.abs(np.asarray(got, np.float64) - w)
        scale = max(float(np.abs(w).max()), 1e-6)
        off = diff > tol * np.abs(w) + tol * scale
        assert off.sum() <= max(1, off.size // 1000), off.sum()
        assert diff.max() <= 3 * lr, diff.max()


@pytest.mark.parametrize("arch,size", [("qwen1.5-4b", 2),
                                       ("paligemma-3b", 4),
                                       ("musicgen-large", 4)])
def test_vocab_parallel_cross_entropy_matches_jax_loss(arch, size):
    """The dense loss of every rank over (1, size) (each rank's vocab
    columns; vlm: the text positions; audio: every codebook) against the
    JAX ``Model.loss`` within 1e-5; the cross-entropy's gradient with
    respect to the logits, sharded, against one ``log_softmax``'s within
    1e-6."""
    ct, tm, jm, _, _ = _family_params(arch)
    qc = TQC(mode="dense")
    params = tm.init(torch.Generator().manual_seed(5), qc)
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params, ct))
    if ct.family in ("vlm", "audio"):
        batch = _family_batch(ct)
    else:
        batch = {"tokens": np.random.default_rng(3).integers(
            0, ct.vocab_size, (4, 8)).astype(np.int32)}
    _, met_j = jm.loss(params_j, {k: jnp.asarray(v)
                                  for k, v in batch.items()},
                        JQC(mode="dense"))
    mesh = make_test_mesh((1, size), device="cpu")
    shards = tsh.shard_tree(params, tsh.serving_layout(params, ct, size),
                            mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        outs = RankRunner(mesh=mesh).run(
            lambda tp: tm.loss(shards[tp.me], tb, qc)[1]["ce"])
    for ce in outs:
        _close(float(ce), float(met_j["ce"]), CE_TOL)

    g = torch.Generator().manual_seed(6)
    logits = torch.randn((3, 5, 2, 64 * size), generator=g) * 4
    labels = torch.randint(0, 64 * size, (3, 5, 2), generator=g)
    whole = logits.clone().requires_grad_(True)
    want = cross_entropy(whole, labels, 64 * size, None)
    want.backward()
    cols = [c.detach().clone().requires_grad_(True)
            for c in logits.chunk(size, -1)]
    losses = RankRunner([torch.device("cpu")] * size).run(
        lambda tp: cross_entropy(cols[tp.rank], labels, 64 * size, tp))
    grads = torch.autograd.grad(losses[0], cols)
    for loss in losses:
        assert abs(float(loss) - float(want)) <= CE_TOL * float(want)
    np.testing.assert_allclose(torch.cat(grads, -1).numpy(),
                               whole.grad.numpy(), rtol=0, atol=1e-6)


# --------------------------------------------- the head_dim decode kernels
def _hd_problem(seed, b, h, kvh, d, ps, n_pages, np_, positions, dtype):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    kp[-1] = 1e4                   # the trash page: never attended
    vp[-1] = 1e4
    phys = np.stack([rng.permutation(n_pages)[:np_] for _ in range(b)])
    pos = np.asarray(positions, np.int32)
    for i, p in enumerate(pos):
        phys[i, max(0, -(-int(p) // ps)):] = n_pages
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
    vn = rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
    if dtype == "bfloat16":        # values a bf16 pool holds exactly
        kp, vp, kn, vn = (torch.from_numpy(a).bfloat16().float().numpy()
                          for a in (kp, vp, kn, vn))
    return q, kp, vp, kn, vn, phys.astype(np.int32), pos


@pytest.mark.parametrize("h,kvh,d,ranks,window,kv_start,dtype", [
    (4, 2, 16, 2, 0, 0, "float32"),       # GQA G = 2
    (8, 2, 32, 4, 5, 3, "float32"),       # G = 4, window, kv_start
    (8, 1, 64, 8, 0, 2, "float32"),       # one kv head, D / m = 8
    (4, 4, 16, 4, 6, 0, "bfloat16"),      # a bf16 pool, window
])
def test_hd_decode_plain_matches_jax_flash_decode(h, kvh, d, ranks, window,
                                                  kv_start, dtype):
    """The pool cut into ``ranks`` head_dim slices: each rank's partial
    scores (``flash_decode_hd_scores``, on the CPU the plain version),
    summed in rank order, then each rank's attend on its V slice; the
    slices concatenated against the JAX ``flash_decode_paged`` over the
    whole pool. Trash pages (poisoned) and dead keys give 0 scores and
    are never attended; the ``pos = -1`` lane gives exactly its v_new."""
    q, kp, vp, kn, vn, phys, pos = _hd_problem(
        h + d + ranks, 3, h, kvh, d, 4, 14, 5, (7, -1, 19), dtype)
    want = np.asarray(jfd.flash_decode_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, kn, vn, phys, pos)),
        window=window, kv_start=kv_start, impl="ref"))
    tdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(a) for k, a in zip(
        ("q", "kp", "vp", "kn", "vn", "phys", "pos"),
        (q, kp, vp, kn, vn, phys, pos))}
    w = d // ranks

    def cut(a, r):
        return a[..., r * w:(r + 1) * w].contiguous()
    before = (tfd.flash_decode_hd_scores_plain.calls,
              tfd.flash_decode_hd_attend_plain.calls)
    sc = None
    for r in range(ranks):
        part = tfd.flash_decode_hd_scores(
            cut(t["q"], r), cut(t["kp"], r).to(tdt), cut(t["kn"], r).to(tdt),
            t["phys"], t["pos"], window=window, kv_start=kv_start)
        assert part.shape == (3, h, 5 * 4 + 1)
        assert (part[1, :, :-1] == 0).all()          # the pos = -1 lane
        sc = part if sc is None else sc + part
    outs = [tfd.flash_decode_hd_attend(
        sc, cut(t["vp"], r).to(tdt), cut(t["vn"], r).to(tdt), t["phys"],
        t["pos"], d ** -0.5, torch.float32, window=window,
        kv_start=kv_start) for r in range(ranks)]
    assert (tfd.flash_decode_hd_scores_plain.calls,
            tfd.flash_decode_hd_attend_plain.calls) == (
                before[0] + ranks, before[1] + ranks)
    got = torch.cat(outs, -1).reshape(3, 1, h * d).numpy()
    live = pos >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=KERNEL_TOL)
    g = h // kvh
    assert np.array_equal(got[1, 0].reshape(kvh, g, d),
                          np.repeat(vn[1, 0][:, None], g, 1))


# --------------------------------------------------------------- engines
def _engine_params(arch, run, arrays):
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jm = JModel(cj)
    kw = {"two-pass": dict(fuse=False), "vq-kv": dict(kv_quant="vq")}.get(
        run, {})
    qj = JQC(mode="lut_infer", lut_dtype="int8", **kw)
    like = jax.eval_shape(lambda: precompute_model(
        jm.init(jax.random.PRNGKey(0), JQC(mode="lut_train")), qj))
    params = params_from_numpy(_tree_from(arrays, f"{arch}|{run}|", like),
                               ct, device="cpu")
    t_kw = dict(num_pages=NUM_PAGES)
    if run == "vq-kv":
        cb = {k: arrays[f"{arch}|{run}|cb['{k}']"]
              for k in ("zk", "zv", "sk", "sv")}
        t_kw["kv_codebook"] = kv_codebook_from_numpy(cb, device="cpu")
    return ct, params, TQC(mode="lut_infer", lut_dtype="int8", **kw), t_kw


def _serve(eng, vocab):
    plan, late = _plan(vocab)
    reqs = [Request(tokens=p, max_new_tokens=m) for p, m in plan]
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    reqs.append(Request(tokens=late[0], max_new_tokens=late[1]))
    eng.submit(reqs[-1])
    eng.run_until_idle()
    return reqs


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_head_dim_engine_matches_jax_sharded_engine(arch, run, jax_sharded):
    """``Engine(mesh=(1, 4))`` where the 2 kv heads do not divide the 4
    ranks: the JAX ``Engine(mesh=(1, 4))``'s greedy tokens, finish
    reasons and preemptions; each rank's fp pool holds the head_dim slice
    of both kv heads, a code pool every kv head's codes."""
    res, arrays = jax_sharded
    ct, params, qc, t_kw = _engine_params(arch, run, arrays)
    assert hd_fallback(ct, 4)
    eng = Engine(TModel(ct, device="cpu"), params, qc,
                 mesh=make_test_mesh((1, 4), device="cpu"), **t_kw,
                 **ENGINE_KW)
    pool = eng.kv.pools[0]
    if run == "vq-kv":
        assert pool["k"].dtype == torch.uint8
        assert pool["k"].shape[-2] == ct.num_kv_heads
    else:
        assert tuple(pool["k"].shape[-2:]) == (ct.num_kv_heads,
                                               ct.head_dim // 4)
    reqs = _serve(eng, ct.vocab_size)
    want = res[f"{arch}|{run}"]
    assert [r.out_tokens for r in reqs] == want["tokens"]
    assert [r.finish_reason.name for r in reqs] == want["reasons"]
    assert eng.scheduler.preemptions == want["preemptions"] >= 1
    assert eng.collectives[0] > 0


def test_head_dim_engine_speculative_verify_matches_one_device():
    """An ngram speculative engine (k = 3: ``verify_paged`` over the
    head_dim slices, partial scores all-reduced) on (1, 4) gives the
    one-device speculative engine's tokens, and the plain engine's."""
    ct = tconfigs.get_smoke_config("yi-9b")
    tm = TModel(ct, device="cpu")
    qc = TQC(mode="lut_infer", lut_dtype="int8")
    from repro_torch.core.lutboost import precompute_model as tpre
    params = tpre(tm.init(torch.Generator().manual_seed(7),
                          TQC(mode="lut_train")), qc)
    prompt = [5, 6, 7, 5, 6, 7, 5, 6]
    outs = []
    for mesh, spec in ((None, None), (None, SpecConfig(k=3)),
                       (make_test_mesh((1, 4), device="cpu"),
                        SpecConfig(k=3))):
        eng = Engine(tm, params, qc, mesh=mesh, spec_decode=spec,
                     **ENGINE_KW)
        reqs = [Request(tokens=prompt, max_new_tokens=10),
                Request(tokens=[9, 3, 9, 3], max_new_tokens=8)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        outs.append([r.out_tokens for r in reqs])
        if spec is not None:
            assert eng.spec_rounds > 0
    assert outs[0] == outs[1] == outs[2]
