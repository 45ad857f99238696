"""Port parity for the sharded layouts the dry run's cells need, against
the JAX package (single device) and the port's own unsharded runs, on
the CPU (every rank on the CPU, ``make_test_mesh(..., device="cpu")``):

* the head_dim layout, where the kv heads do not divide the model axis
  (``models.layers._attention_hd``: q / k / v gathered to whole heads,
  the dense cache holding each rank's head_dim slice, decode's partial
  scores all-reduced, a whole sequence re-sharded by sequence with an
  all-to-all): gemma3-4b, yi-9b and dbrx-132b smoke (2 kv heads) over a
  (1, 4) mesh, ``forward`` / ``loss`` in lut_train and the dense-cache
  ``prefill`` and 3 ``decode`` steps in int8 lut_infer, against the JAX
  single-device results; plus the replicated MLP (a d_ff that does not
  divide the model axis);
* the sequence-parallel dense cache (a batch smaller than the data
  axes: each data rank holds a slice of the rows, decode combines the
  ranks' softmax triples in rank order): batch 1 on (2, 2), and with the
  head_dim layout on (2, 4), against the unsharded run over decode steps
  that cross from one data rank's rows to the next;
* ``remat`` under a mesh (every rank recomputes a layer together in the
  backward, its collectives run again): the sharded lut_train gradients
  with and without it, and against ``jax.grad``; no collective result of
  a layer outlives its backward;
* the paged ``Engine(mesh=)`` under the head_dim layout (refused before
  this layout had its paged form), against the one-device engine.

Tolerances: logits within 1e-4 of their scale of the JAX package's
(float32; the same int8 sums; attention sums in another order), argmax
equal; against the port's unsharded run 1e-5 of the scale; gradients
with and without remat bit for bit, against JAX at 1e-4 of each leaf's
largest value (``test_torch_train_scale``'s tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.launch.mesh import data_axes, make_test_mesh  # noqa: E402
from repro_torch.models.layers import hd_fallback  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.parallel.collectives import RankRunner  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.train.trainer import (reduce_grads,  # noqa: E402
                                       shared_entries,
                                       sharded_loss_and_grads)
from repro_torch.tree import tree_leaves  # noqa: E402

FALLBACK_ARCHS = ["gemma3-4b", "yi-9b", "dbrx-132b"]
JAX_TOL = 1e-4
SELF_TOL = 1e-5
GRAD_TOL = 1e-4


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
                               atol=tol * float(np.abs(want).max()))


def _rank_rows(t, mesh, me):
    """Rank ``me``'s rows of a per-row input: its data group's when the
    batch covers the data axes (the cache's layout), else every row."""
    da = data_axes(mesh)
    dp = int(np.prod([mesh.shape[a] for a in da]))
    b = t.shape[0]
    if not (b % dp == 0 and b >= dp):
        return t
    lead = da if len(da) > 1 else da[0]
    return tsh.shard_tree(t, tsh.P(lead), mesh, only=[me])[0]


def _gather_rows(outs, mesh, b):
    """The global logits from every rank's: rank 0 of each data group's
    rows in batch order (or rank 0's, when every rank has every row)."""
    da = data_axes(mesh)
    dp = int(np.prod([mesh.shape[a] for a in da]))
    if not (b % dp == 0 and b >= dp):
        return outs[0]
    msize = mesh.shape["model"]
    return torch.cat([outs[i] for i in range(0, len(outs), msize)], 0)


def _sharded_chain(tm, params, qc, mesh, prompt, nexts):
    """Prefill ``prompt`` then decode ``nexts`` (one (B, 1) token batch a
    step) with the params and a dense cache laid out over ``mesh``;
    returns the logits of each call and rank 0's last cache."""
    cfg = tm.cfg
    b, s = prompt.shape
    layout = tsh.serving_layout(params, cfg, mesh.shape["model"])
    shards = tsh.shard_tree(params, layout, mesh)
    rows = -(-(s + len(nexts) + 1) // 8) * 8      # divides over data
    caches = tsh.shard_cache(tm.init_cache(b, rows), cfg, b, mesh)
    runner = RankRunner(mesh=mesh)
    with torch.no_grad():
        outs = runner.run(lambda tp: tm.prefill(
            shards[tp.me], {"tokens": _rank_rows(prompt, mesh, tp.me)},
            caches[tp.me], qc))
        logits = [_gather_rows([o[0] for o in outs], mesh, b)]
        caches = [o[1] for o in outs]
        for t in nexts:
            outs = runner.run(lambda tp: tm.decode(
                shards[tp.me], _rank_rows(t, mesh, tp.me), caches[tp.me],
                qc))
            logits.append(_gather_rows([o[0] for o in outs], mesh, b))
            caches = [o[1] for o in outs]
    return logits, caches[0]


@pytest.mark.parametrize("arch", FALLBACK_ARCHS)
def test_head_dim_layout_matches_jax_single_device(arch):
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    mesh = make_test_mesh((1, 4), device="cpu")
    assert hd_fallback(ct, 4)
    tm, jm = TModel(ct, device="cpu"), JModel(cj)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, ct.vocab_size, (2, 8)).astype(np.int32)

    # forward and loss in lut_train (Ulysses: 8 rows over 4 ranks)
    qt, qj = TQC(mode="lut_train"), JQC(mode="lut_train")
    params_t = tm.init(torch.Generator().manual_seed(1), qt)
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params_t, ct))
    batch_t = {"tokens": torch.from_numpy(toks)}
    lg_j, _ = jm.forward(params_j, {"tokens": jnp.asarray(toks)}, qj)
    loss_j, met_j = jm.loss(params_j, {"tokens": jnp.asarray(toks)}, qj)
    layout = tsh.serving_layout(params_t, ct, 4)
    shards = tsh.shard_tree(params_t, layout, mesh)
    runner = RankRunner(mesh=mesh)
    with torch.no_grad():
        fwd = runner.run(lambda tp: tm.forward(shards[tp.me], batch_t, qt))
        loss = runner.run(lambda tp: tm.loss(shards[tp.me], batch_t, qt))
    _close(fwd[0][0].numpy(), np.asarray(lg_j), JAX_TOL)
    _close(float(loss[0][0]), float(loss_j), JAX_TOL)
    _close(float(loss[0][1]["recon"]), float(met_j["recon"]), JAX_TOL)

    # dense-cache prefill + 3 decode steps in int8 lut_infer
    qi_j = JQC(mode="lut_infer", lut_dtype="int8")
    qi_t = TQC(mode="lut_infer", lut_dtype="int8")
    pj = precompute_model(params_j, qi_j)
    pt = params_from_numpy(_np(pj), ct, device="cpu")
    lg, cache = jm.prefill(pj, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(2, 12), qi_j)
    want, nexts = [np.asarray(lg)], []
    for _ in range(3):
        nxt = want[-1].argmax(-1).astype(np.int32)[:, None]
        nexts.append(torch.from_numpy(nxt))
        lg, cache = jm.decode(pj, jnp.asarray(nxt), cache, qi_j)
        want.append(np.asarray(lg))
    got, last = _sharded_chain(tm, pt, qi_t, mesh, torch.from_numpy(toks),
                               nexts)
    for g, w in zip(got, want):
        _close(g.numpy(), w, JAX_TOL)
        assert (g.numpy().argmax(-1) == w.argmax(-1)).all()
    # the cache holds the rank's head_dim slice of every kv head
    assert tuple(last["layers"]["k"].shape[-2:]) == (
        ct.num_kv_heads, ct.head_dim // 4)


def test_replicated_mlp_where_d_ff_does_not_divide():
    """qwen1.5-4b smoke with d_ff 36 over a model axis of 8 (its 4 kv
    heads take the head_dim layout too): a d_ff that does not divide the
    axis replicates wg / wu / wd (the JAX rule drops the axis); the
    sharded forward equals the unsharded one."""
    cfg = tconfigs.get_smoke_config("qwen1.5-4b").replace(d_ff=36)
    tm = TModel(cfg, device="cpu")
    qc = TQC(mode="dense")
    params = tm.init(torch.Generator().manual_seed(2), qc)
    mesh = make_test_mesh((1, 8), device="cpu")
    tsh.check_tensor_parallel(cfg, 8, qc)
    layout = tsh.serving_layout(params, cfg, 8)
    assert tuple(layout["blocks"][0]["mlp"]["wd"]["w"]) == (None, None)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    want, _ = tm.forward(params, {"tokens": toks}, qc)
    shards = tsh.shard_tree(params, layout, mesh)
    with torch.no_grad():
        got = RankRunner(mesh=mesh).run(lambda tp: tm.forward(
            shards[tp.me], {"tokens": toks}, qc)[0])
    _close(got[0].numpy(), want.detach().numpy(), SELF_TOL)


@pytest.mark.parametrize("arch,shape", [("qwen1.5-4b", (2, 2)),
                                        ("gemma3-4b", (2, 2)),
                                        ("yi-9b", (2, 4))])
def test_sequence_parallel_decode_matches_the_unsharded_run(arch, shape):
    """Batch 1 (smaller than the data axis): the cache's rows are cut
    over ``data``; 6 prompt rows and 6 decode steps in a 16-row cache
    cross from data rank 0's rows (0-7) to rank 1's (gemma3-4b: its
    8-row window too; yi-9b on (2, 4): with the head_dim layout)."""
    cfg = tconfigs.get_smoke_config(arch)
    tm = TModel(cfg, device="cpu")
    qc = TQC(mode="lut_infer", lut_dtype="int8")
    params = tm.init(torch.Generator().manual_seed(3), qc)
    mesh = make_test_mesh(shape, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32))
    with torch.no_grad():
        lg, cache = tm.prefill(params, {"tokens": prompt},
                               tm.init_cache(1, 13), qc)
        want, nexts = [lg], []
        for _ in range(6):
            nexts.append(want[-1].argmax(-1)[:, None].int())
            lg, cache = tm.decode(params, nexts[-1], cache, qc)
            want.append(lg)
    got, last = _sharded_chain(tm, params, qc, mesh, prompt, nexts)
    assert last["seq_rows"] == 0 and last["layers"]["k"].shape[2] == 8
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), SELF_TOL)
        assert torch.equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("arch,shape", [("qwen1.5-4b", (2, 2)),
                                        ("gemma3-4b", (1, 4))])
def test_remat_under_a_mesh_gives_the_same_gradients(arch, shape):
    """The sharded lut_train gradients with ``remat`` equal those without
    it bit for bit (every rank's), and, summed over each entry's copies,
    ``jax.grad`` of the JAX loss."""
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    qt, qj = TQC(mode="lut_train"), JQC(mode="lut_train")
    params = TModel(ct, device="cpu").init(torch.Generator().manual_seed(4),
                                           qt)
    mesh = make_test_mesh(shape, device="cpu")
    toks = np.random.default_rng(2).integers(
        0, ct.vocab_size, (4, 8)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    layout = tsh.serving_layout(params, ct, mesh.shape["model"])
    runs = {}
    for remat in (False, True):
        tm = TModel(ct.replace(remat=remat), device="cpu")
        runner = RankRunner(mesh=mesh)
        loss, _, parts = sharded_loss_and_grads(
            tm, runner, tsh.shard_tree(params, layout, mesh, copy=True),
            tsh.shard_batch(batch, ct, mesh), qt)
        runs[remat] = (loss, parts, runner)
    assert torch.equal(runs[False][0], runs[True][0])
    for a, b in zip(runs[False][1], runs[True][1]):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    loss, parts, runner = runs[True]
    shared = shared_entries(layout)
    with torch.no_grad():
        reduced = runner.run(lambda tp: reduce_grads(parts[tp.me], shared))
    got = params_to_numpy(tsh.unshard_tree(reduced, layout, mesh), ct)
    jm = JModel(cj)
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params, ct))
    # the data groups' mean loss is the global batch's mean loss
    grads = jax.jit(jax.grad(lambda p: jm.loss(
        p, {"tokens": jnp.asarray(toks)}, qj)[0])).lower(params_j).compile(
            {"xla_backend_optimization_level": 0})(params_j)
    want = _np(grads)

    def walk(g, w):
        if isinstance(g, dict):
            assert set(g) == set(w)
            for k in g:
                walk(g[k], w[k])
        else:
            _close(g, w, GRAD_TOL)
    walk(got, want)


def test_remat_holds_at_most_one_layers_collective_results():
    """Under ``remat`` on (1, 2) every collective result (weak references
    to what ``all_reduce`` / ``all_gather`` / ``all_to_all`` return, by
    layer, forward and recompute) of a layer is dead by the time the
    backward recomputes the layer two below it, none is alive when the
    forward returns or after the backward, and every layer is recomputed
    once, every rank together (its collectives run again)."""
    import threading
    import weakref

    from repro_torch.parallel import collectives as tcol

    cfg = tconfigs.get_smoke_config("qwen1.5-4b").replace(remat=True,
                                                          num_layers=4)
    qt = TQC(mode="lut_train")
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(4), qt)
    mesh = make_test_mesh((1, 2), device="cpu")
    layout = tsh.serving_layout(params, cfg, 2)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    here = threading.local()
    results = []                           # (layer, weakref)
    seen = []                              # (layer recomputed, live layers)
    own = {name: getattr(tcol.TP, name)
           for name in ("all_reduce", "all_gather", "all_to_all")}
    own_layer, own_recompute = TModel._train_layer, tcol._Layer.recompute

    def wrap(name):
        def call(self, *args, **kw):
            out = own[name](self, *args, **kw)
            li = getattr(here, "layer", None)
            if li is not None and self.size > 1:
                results.append((li, weakref.ref(out)))
            return out
        return call

    def layer(self, p_l, li, *args, **kw):
        here.layer = li
        try:
            return own_layer(self, p_l, li, *args, **kw)
        finally:
            here.layer = None

    def recompute(self):
        li = self.frames[0].fn.args[1]
        seen.append((li, sorted({i for i, r in results
                                 if r() is not None})))
        return own_recompute(self)

    for name in own:
        setattr(tcol.TP, name, wrap(name))
    TModel._train_layer, tcol._Layer.recompute = layer, recompute
    try:
        runner = RankRunner(mesh=mesh)
        shards = tsh.shard_tree(params, layout, mesh, copy=True)
        lives = [[t.detach().requires_grad_(True) for t in tree_leaves(sh)]
                 for sh in shards]
        from repro_torch.tree import tree_map
        tracked = []
        for sh, live in zip(shards, lives):
            it = iter(live)
            tracked.append(tree_map(lambda _: next(it), sh))
        outs = runner.run(lambda tp: tm.loss(tracked[tp.me],
                                             {"tokens": toks}, qt)[0])
        forward = len(results)
        assert forward > 0
        assert not [li for li, r in results if r() is not None]
        torch.autograd.grad(outs[0], [t for live in lives for t in live],
                            allow_unused=True)
    finally:
        for name, fn in own.items():
            setattr(tcol.TP, name, fn)
        TModel._train_layer, tcol._Layer.recompute = own_layer, own_recompute
    assert [li for li, _ in seen] == [3, 2, 1, 0]
    for li, live in seen:
        assert all(i == li + 1 for i in live), (li, live)
    assert len(results) == 2 * forward        # every collective ran again
    assert not [li for li, r in results if r() is not None]


def test_paged_engine_still_refuses_the_head_dim_layout():
    """The paged engine, refused under the head_dim layout before, now
    serves it (the name is kept): yi-9b smoke's 2 kv heads over (1, 4),
    each rank's pool the head_dim slice of every kv head, greedy tokens
    equal to the one-device engine's (held against the JAX
    ``Engine(mesh=)`` in ``test_torch_scaleout``). What stays refused:
    a head_dim that does not divide either (16 ranks), naming ROADMAP.md
    queue A item 11."""
    cfg = tconfigs.get_smoke_config("yi-9b")
    tm = TModel(cfg, device="cpu")
    qc = TQC(mode="dense")
    params = tm.init(torch.Generator().manual_seed(0), qc)
    kw = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)
    tsh.check_tensor_parallel(cfg, 4, qc)
    sharded = Engine(tm, params, qc, mesh=make_test_mesh((1, 4), device="cpu"),
                     **kw)
    assert tuple(sharded.kv.pools[0]["k"].shape[-2:]) == (
        cfg.num_kv_heads, cfg.head_dim // 4)
    outs = []
    for eng in (Engine(tm, params, qc, **kw), sharded):
        reqs = [Request(tokens=[3, 4, 5, 6, 7], max_new_tokens=6),
                Request(tokens=[9, 2], max_new_tokens=5)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    with pytest.raises(NotImplementedError, match="head_dim=8.*item 11"):
        tsh.check_tensor_parallel(cfg, 16, qc)
