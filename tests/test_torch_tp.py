"""Port parity for tensor-parallel serving (``Engine(mesh=)``,
``ReplicaRouter.from_mesh``, ``parallel/collectives.py``) against the JAX
package's single-device engine, on the CPU: the port's counterpart of
``tests/test_serve_sharded.py``.

Every rank of a mesh lies on the CPU here (``make_test_mesh(...,
device="cpu")``), as the JAX tests run four host devices on one CPU: the
sharded program runs at the shard shapes, its collectives reduced to adds
and concatenations on one device.

Covered: greedy tokens of ``Engine(mesh=(1, 2))`` and ``((2, 2))`` equal
the JAX single-device engine's for qwen1.5-4b dense, int8 lut_infer fused,
two-pass and on a VQ code pool, deepseek-moe-16b (expert parallel),
mamba2-2.7b and zamba2-1.2b (prefix caching on, a repeated prompt that
forks a page in every shard, slots recycled, a late admission, and for
the attention families an oversubscribed pool that preempts); sharded
prefill logits against the JAX ``forward``; a row-parallel int8
projection over 2 and 4 shards against the unsharded ``vq_amm`` bit for
bit (fused, two-pass, grouped); capacity errors and preemption, sharded
and routed; ``from_mesh`` over (2, 2); ngram and model-drafter
speculation under TP-2; a temperature request under TP; the collectives'
order, counts and failure (an error in one rank surfaces in the caller
and nothing hangs); the sync guard over a TP-2 engine, which sees every
rank's ops.

Tolerance: greedy tokens identical; int8 logits bit for bit against the
one-device port; logits within 1e-5 of the JAX forward (float32).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import run_sync_guard  # noqa: E402
from repro_torch.convert import (kv_codebook_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.launch.mesh import (make_test_mesh,  # noqa: E402
                                     replica_submeshes)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.parallel import collectives as tcol  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serve import (Engine, PagePoolExhausted,  # noqa: E402
                               ReplicaRouter, Request, SpecConfig)
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

PS, MAX_SEQ, CHUNK = 8, 32, 4
ENGINE_KW = dict(batch_size=2, max_seq=MAX_SEQ, page_size=PS,
                 prefill_chunk=CHUNK)
PLAN = ((11, 8), (3, 6), (16, 5), (16, 5), (6, 7))
LATE = (9, 6)
MESHES = [(1, 2), (2, 2)]
RUNS = [("qwen1.5-4b", "dense"), ("qwen1.5-4b", "fused"),
        ("qwen1.5-4b", "two-pass"), ("qwen1.5-4b", "vq-kv"),
        ("deepseek-moe-16b", "fused"), ("mamba2-2.7b", "fused"),
        ("zamba2-1.2b", "fused")]
RECURRENT = ("mamba2-2.7b", "zamba2-1.2b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (the tier-1 run puts several test processes on
    the machine's cores; each TP engine adds a rank thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(arch, run, seed=12):
    """A JAX smoke model of ``arch`` (dense, or int8 lut_infer: its Pallas
    kernels through the reference path) and the port's model on the CPU
    with the same params; the qc of ``run`` for each."""
    jm = JModel(jconfigs.get_smoke_config(arch))
    tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    if run == "dense":
        qc_j, qc_t = JQC(mode="dense"), TQC(mode="dense")
        params_j = jm.init(jax.random.PRNGKey(seed), qc_j)
    else:
        kw = {"two-pass": dict(fuse=False),
              "vq-kv": dict(kv_quant="vq")}.get(run, {})
        qc_j = JQC(mode="lut_infer", lut_dtype="int8", **kw)
        qc_t = TQC(mode="lut_infer", lut_dtype="int8", **kw)
        params_j = precompute_model(
            jm.init(jax.random.PRNGKey(seed), JQC(mode="lut_train")), qc_j)
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, qc_t


def _serve(engine, make_req, vocab):
    rng = np.random.default_rng(11)
    plan = [(rng.integers(0, vocab, n).tolist(), m) for n, m in PLAN]
    plan[3] = (plan[2][0], plan[3][1])               # the repeated prompt
    reqs = [make_req(p, m) for p, m in plan]
    for r in reqs:
        engine.submit(r)
    for _ in range(6):
        engine.step()
    late = make_req(rng.integers(0, vocab, LATE[0]).tolist(), LATE[1])
    engine.submit(late)
    engine.run_until_idle()
    return reqs + [late]


_JAX_RUNS = {}


def _jax_run(arch, run):
    """The carried models, the JAX engine's requests and (vq-kv) the
    codebook both engines use; computed once a case."""
    if (arch, run) not in _JAX_RUNS:
        jm, params_j, qc_j, tm, params_t, qc_t = _carry(arch, run)
        j_kw, t_kw = {}, {}
        if arch not in RECURRENT:
            j_kw = t_kw = dict(num_pages=5)
        if run == "vq-kv":
            cb_j = JEngine(jm, params_j, qc_j, batch_size=1,
                           max_seq=MAX_SEQ, page_size=PS,
                           prefill_chunk=CHUNK,
                           prefix_cache=False).kv_codebook
            j_kw = dict(j_kw, kv_codebook=cb_j)
            t_kw = dict(t_kw, kv_codebook=kv_codebook_from_numpy(
                jax.tree_util.tree_map(np.asarray, cb_j.tree()),
                device="cpu"))
        j_eng = JEngine(jm, params_j, qc_j, **j_kw, **ENGINE_KW)
        j_reqs = _serve(j_eng, lambda p, n: JRequest(tokens=p,
                                                     max_new_tokens=n),
                        tm.cfg.vocab_size)
        _JAX_RUNS[arch, run] = (tm, params_t, qc_t, t_kw, j_eng, j_reqs)
    return _JAX_RUNS[arch, run]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch,run", RUNS)
def test_sharded_engine_greedy_tokens_match_jax_engine(arch, run, shape):
    """The JAX single-device engine's greedy tokens and finish reasons
    from the port's tensor-parallel engine, preemptions included; every
    shard of the pool holds the forked pages."""
    tm, params_t, qc_t, t_kw, j_eng, j_reqs = _jax_run(arch, run)
    mesh = make_test_mesh(shape, device="cpu")
    t_eng = Engine(tm, params_t, qc_t, mesh=mesh, **t_kw, **ENGINE_KW)
    assert len(t_eng.kv.pools) == shape[1]
    assert len(t_eng.params) == shape[1]
    t_reqs = _serve(t_eng, lambda p, n: Request(tokens=p, max_new_tokens=n),
                    tm.cfg.vocab_size)
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.done and rt.finish_reason.name == rj.finish_reason.name
        assert rt.out_tokens == rj.out_tokens
    if arch not in RECURRENT:
        assert j_eng.scheduler.preemptions >= 1
        assert t_eng.scheduler.preemptions == j_eng.scheduler.preemptions
        if run == "vq-kv":
            assert all(p["k"].dtype == torch.uint8 for p in t_eng.kv.pools)
    n_col, n_bytes = t_eng.collectives
    assert n_col > 0 and n_bytes > 0


def _forward_case(arch, run, shape):
    jm, params_j, qc_j, tm, params_t, qc_t = _carry(arch, run, seed=3)
    toks = np.array([[3, 4, 5, 6, 7, 8, 9, 10]], np.int32)
    full, _ = jm.forward(params_j, {"tokens": jnp.asarray(toks)}, qc_j)
    eng = Engine(tm, params_t, qc_t, mesh=make_test_mesh(shape, device="cpu"),
                 batch_size=2, max_seq=MAX_SEQ, page_size=PS,
                 prefill_chunk=8)
    eng.kv.ensure(0, 8)
    tab, t = eng.kv.table_device(), torch.from_numpy(toks)
    lg = eng._run(lambda p, kv, loc: tm.prefill_paged(
        p, loc(t), kv, loc(tab), 0, 0, 8, qc_t))
    return np.asarray(full)[0, -1], lg[0].numpy(), (tm, params_t, qc_t, t)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch,run", [("qwen1.5-4b", "dense"),
                                      ("qwen1.5-4b", "fused"),
                                      ("deepseek-moe-16b", "fused"),
                                      ("mamba2-2.7b", "fused"),
                                      ("zamba2-1.2b", "two-pass")])
def test_sharded_prefill_logits_match_jax_forward(arch, run, shape):
    """One 8-token prefill chunk through the sharded entry point: the JAX
    forward's last-position logits within 1e-5; with int8 LUTs, the
    one-device port's logits bit for bit."""
    want, got, (tm, params_t, qc_t, t) = _forward_case(arch, run, shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if run != "dense":
        eng = Engine(tm, params_t, qc_t, batch_size=2, max_seq=MAX_SEQ,
                     page_size=PS, prefill_chunk=8)
        eng.kv.ensure(0, 8)
        one = tm.prefill_paged(params_t, t, eng.kv.pools[0],
                               eng.kv.table_device(), 0, 0, 8, qc_t)
        assert torch.equal(one[0], torch.from_numpy(got))


def _row_shards(p, ranks, grouped):
    """A row-parallel projection's shards: subspaces of z / lut (rows of
    w), the scale whole."""
    spec = {"z": tsh.P(None, "model", None, None) if grouped
            else tsh.P("model", None, None),
            "lut": tsh.P(None, "model", None, None) if grouped
            else tsh.P("model", None, None),
            "lut_scale": tsh.P(None, None) if grouped else tsh.P(None)}
    return tsh.shard_tree(p, {k: spec[k] for k in p},
                          make_test_mesh((1, ranks), device="cpu"))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("grouped", [False, True])
def test_row_parallel_int8_projection_is_bit_for_bit(ranks, fuse, grouped):
    """``lut_linear_row`` (and the grouped ``expert_proj_row``) over 2 and
    4 rank shards: partial integer sums without the scale, all-reduced,
    then the scale once, equal the unsharded projection bit for bit."""
    g = torch.Generator().manual_seed(ranks)
    qc = TQC(mode="lut_infer", lut_dtype="int8", v=4, c=16, fuse=fuse)
    k, n, m = 128, 48, 5
    lead = (3,) if grouped else ()
    w = torch.randn(lead + (k, n), generator=g) / k ** 0.5
    z = torch.randn(lead + (k // 4, 16, 4), generator=g)
    p = tlut.strip_for_inference(tlut.precompute_layer({"w": w, "z": z},
                                                       qc))
    x = torch.randn(lead + (m, k), generator=g)
    if grouped:
        want = tmoe.expert_proj(p, x, qc)
    else:
        want = tlut.lut_linear_apply(p, x, qc)
    shards = _row_shards(p, ranks, grouped)
    runner = tcol.RankRunner([torch.device("cpu")] * ranks)
    fn = tmoe.expert_proj_row if grouped else tlut.lut_linear_row
    outs = runner.run(lambda tp: fn(shards[tp.rank],
                                    tp.shard(x, -1).contiguous(), qc))
    for out in outs:
        assert torch.equal(out, want)
    assert runner.collectives == 1


def test_capacity_errors_and_preemption_sharded_and_routed():
    """An oversized request is refused at submit by the sharded engine and
    by the router; an oversubscribed pool preempts under TP with the
    one-device (and JAX) engine's tokens."""
    jm, params_j, qc_j, tm, params_t, qc_t = _carry("qwen1.5-4b", "dense")
    mesh = make_test_mesh((2, 2), device="cpu")
    eng = Engine(tm, params_t, qc_t, mesh=mesh, **ENGINE_KW)
    with pytest.raises(PagePoolExhausted):
        eng.submit(Request(tokens=list(range(40)), max_new_tokens=2))
    router = ReplicaRouter.from_mesh(tm, params_t, qc_t, mesh=mesh,
                                     **ENGINE_KW)
    with pytest.raises(PagePoolExhausted):
        router.submit(Request(tokens=list(range(40)), max_new_tokens=2))

    def mk(make):
        return [make(tokens=[3, 4, 5], max_new_tokens=20),
                make(tokens=[6, 7, 8], max_new_tokens=20)]
    ref, sh, jr = mk(Request), mk(Request), mk(JRequest)
    JEngine(jm, params_j, qc_j, num_pages=5, **ENGINE_KW).run(jr)
    Engine(tm, params_t, qc_t, num_pages=5, **ENGINE_KW).run(ref)
    tp = Engine(tm, params_t, qc_t, num_pages=5, mesh=mesh, **ENGINE_KW)
    tp.run(sh)
    assert tp.scheduler.preemptions >= 1
    assert all(r.done and len(r.out_tokens) == 20 for r in sh)
    assert [r.out_tokens for r in ref] == [r.out_tokens for r in sh] == \
        [r.out_tokens for r in jr]


@pytest.mark.parametrize("arch,run", [("qwen1.5-4b", "vq-kv"),
                                      ("zamba2-1.2b", "fused")])
def test_tp_engine_makes_pool_and_codebook_shard_by_shard(arch, run,
                                                          monkeypatch):
    """The TP engine never makes its whole pool on a device (the pool's
    call to ``init_paged_cache`` is on the meta device; each rank's shard
    is made zeroed on its device), and a code pool's codebook, fit from
    the ranks' calibration rows, equals the one-device engine's bit for
    bit."""
    *_, tm, params_t, qc_t = _carry(arch, run)
    made = []
    init = TModel.init_paged_cache

    def spy(self, max_seq, page_size, num_pages, **kw):
        made.append((num_pages, torch.device(kw.get("device") or "cpu")))
        return init(self, max_seq, page_size, num_pages, **kw)
    monkeypatch.setattr(TModel, "init_paged_cache", spy)
    one = Engine(tm, params_t, qc_t, **ENGINE_KW)
    made.clear()
    mesh = make_test_mesh((1, 2), device="cpu")
    tp = Engine(tm, params_t, qc_t, mesh=mesh, **ENGINE_KW)
    pool_pages = tp.kv.table.allocator.num_pages
    assert [d.type for n, d in made if n == pool_pages] == ["meta"]
    for pool, want in zip(tp.kv.pools, tsh.shard_tree(
            one.kv.pools[0], tsh.serving_cache_layout(tm.cfg, mesh,
                                                      quantized=run ==
                                                      "vq-kv"), mesh)):
        for (path, a), (_, b) in zip(tree_flatten_with_path(pool),
                                     tree_flatten_with_path(want)):
            assert a.device.type == "cpu" and a.shape == b.shape, path
            assert torch.equal(a, b), path
    if run == "vq-kv":
        for key, leaf in one.kv_codebook.tree().items():
            assert torch.equal(tp.kv_codebook.tree()[key], leaf), key


def test_from_mesh_gives_two_tp_replicas_with_solo_tokens():
    """(2, 2) carves into 2 replicas of TP-2, each on its own data
    group's ranks; routed greedy outputs match solo runs and both
    replicas receive work; ``build(mesh=)`` passes its mesh on."""
    *_, tm, params_t, qc_t = _carry("qwen1.5-4b", "fused")
    kw = dict(batch_size=1, max_seq=MAX_SEQ, page_size=PS,
              prefill_chunk=CHUNK)
    solo = [Request(tokens=[i + 2, i + 3], max_new_tokens=5)
            for i in range(4)]
    for r in solo:
        Engine(tm, params_t, qc_t, **kw).run([r])
    mesh = make_test_mesh((2, 2), device="cpu")
    router = ReplicaRouter.from_mesh(tm, params_t, qc_t, mesh=mesh, **kw)
    assert len(router.engines) == 2
    assert [e._tp.size for e in router.engines] == [2, 2]
    routed = [Request(tokens=[i + 2, i + 3], max_new_tokens=5)
              for i in range(4)]
    served = {id(router.submit(r)) for r in routed}
    assert len(served) == 2
    router.run_until_idle()
    assert [a.out_tokens for a in solo] == [b.out_tokens for b in routed]
    sub = replica_submeshes(mesh)[1]
    built = ReplicaRouter.build(tm, params_t, qc_t, replicas=2, mesh=sub,
                                **kw)
    assert all(e.mesh is sub and e._tp.size == 2 for e in built.engines)


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculative_engine_under_tp_gives_plain_greedy_tokens(drafter):
    """Speculative decoding under TP-2 (ngram lookup; the target's first
    layer as drafter, its draft rows written in every shard) emits the
    plain one-device engine's greedy tokens."""
    *_, tm, params_t, qc_t = _carry("qwen1.5-4b", "fused")
    spec = SpecConfig(k=3, drafter="ngram") if drafter == "ngram" else \
        SpecConfig(k=2, drafter="model", draft_layers=1)

    def mk():
        return [Request(tokens=[3, 4, 5, 3, 4, 5, 3, 4], max_new_tokens=10),
                Request(tokens=[9, 8, 7, 9, 8], max_new_tokens=8)]
    plain, sp = mk(), mk()
    Engine(tm, params_t, qc_t, **ENGINE_KW).run(plain)
    eng = Engine(tm, params_t, qc_t, spec_decode=spec,
                 mesh=make_test_mesh((1, 2), device="cpu"), **ENGINE_KW)
    eng.run(sp)
    assert eng.spec_rounds > 0
    assert [r.out_tokens for r in plain] == [r.out_tokens for r in sp]


def test_temperature_request_under_tp_is_reproducible():
    *_, tm, params_t, qc_t = _carry("qwen1.5-4b", "fused")
    mesh = make_test_mesh((1, 2), device="cpu")

    def go():
        reqs = [Request(tokens=[3, 4, 5], max_new_tokens=6,
                        temperature=1.0),
                Request(tokens=[6, 7, 8], max_new_tokens=6)]
        Engine(tm, params_t, qc_t, mesh=mesh, seed=7, **ENGINE_KW).run(reqs)
        return reqs
    a, b = go(), go()
    assert all(r.done and len(r.out_tokens) == 6 for r in a)
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]
    plain = [Request(tokens=[6, 7, 8], max_new_tokens=6)]
    Engine(tm, params_t, qc_t, **ENGINE_KW).run(plain)
    assert a[1].out_tokens == plain[0].out_tokens        # the greedy one


def test_collectives_sum_in_rank_order_and_count():
    """all_reduce adds in rank order (every rank the same bits),
    all_gather concatenates in rank order, ``shard`` takes the rank's
    slice; one collective per call of all ranks, bytes summed over
    ranks; a group of one returns its input."""
    runner = tcol.RankRunner([torch.device("cpu")] * 3)
    vals = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
            torch.tensor([1.0, 3.0])]
    outs = runner.run(lambda tp: (tp.all_reduce(vals[tp.rank]),
                                  tp.all_gather(vals[tp.rank][None], 0),
                                  tp.shard(torch.arange(6.0), 0)))
    want = (vals[0] + vals[1]) + vals[2]
    for r, (s, g, sh) in enumerate(outs):
        assert torch.equal(s, want)
        assert torch.equal(g, torch.stack(vals))
        assert sh.tolist() == [2.0 * r, 2.0 * r + 1]
    assert runner.collectives == 2
    assert runner.bytes == 2 * 3 * 2 * 4
    solo = tcol.current()
    assert solo is tcol.SOLO and solo.size == 1
    t = torch.ones(2)
    assert solo.all_reduce(t) is t and solo.all_gather(t) is t


def test_an_error_in_one_rank_surfaces_and_nothing_hangs():
    """Rank 1's projection fails (a corrupt shard) while rank 0 waits in
    its all-reduce: the engine's step raises the rank's error in the
    caller within the test's own timeout, and the runner serves again
    once the shard is repaired."""
    *_, tm, params_t, qc_t = _carry("qwen1.5-4b", "fused")
    eng = Engine(tm, params_t, qc_t, mesh=make_test_mesh((1, 2),
                                                         device="cpu"),
                 **ENGINE_KW)
    wd = eng.params[1]["blocks"][1]["mlp"]["wd"]
    good = wd["lut"]
    wd["lut"] = good[:3]                          # a wrong shape, rank 1
    box = {}

    def go():
        try:
            eng.run([Request(tokens=[3, 4, 5], max_new_tokens=4)])
        except BaseException as e:               # noqa: BLE001
            box["err"] = e
    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the engine hung on a failed rank"
    assert "err" in box and not isinstance(box["err"], tcol._Aborted)
    wd["lut"] = good
    reqs = [Request(tokens=[6, 7, 8], max_new_tokens=4)]
    plain = [Request(tokens=[6, 7, 8], max_new_tokens=4)]
    fresh = Engine(tm, params_t, qc_t, **ENGINE_KW)
    fresh.run(plain)
    eng2 = Engine(tm, params_t, qc_t, mesh=eng.mesh, **ENGINE_KW)
    eng2._tp = eng._tp                            # the runner that failed
    eng2.run(reqs)
    assert reqs[0].out_tokens == plain[0].out_tokens


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-2.7b"])
def test_sync_guard_over_a_tp_engine(arch):
    """The sync guard over a TP-2 engine: one host read a decode step and
    a finished prefill, nothing in the model (on any rank) or the step
    loop; its recorder sees rank 1's ops (a seeded ``.item()`` in rank 1
    only is a ``sync-model`` finding)."""
    *_, tm, params_t, qc_t = _carry(arch, "fused")
    mesh = make_test_mesh((1, 2), device="cpu")

    def mixed(b):
        return [Request(tokens=[b, b + 1, b + 2], max_new_tokens=6),
                Request(tokens=[b + 3, b + 4], max_new_tokens=4)]
    eng = Engine(tm, params_t, qc_t, mesh=mesh, **ENGINE_KW)
    rep = run_sync_guard(eng, mixed(3),
                         [Request(tokens=[3, 4, 5], max_new_tokens=6)])
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    c = rep.counts
    assert (c["device_reads"], c["reads_decode"], c["reads_prefill"]) == \
        (6, 5, 1)
    assert c["model_records"] == 0 and c["step_syncs"] == 0

    head = TModel._head

    def syncing_head(self, p, x):
        if tcol.current().rank == 1 and float(x.abs().sum().item()) < 0:
            raise AssertionError
        return head(self, p, x)
    TModel._head = syncing_head
    try:
        eng = Engine(tm, params_t, qc_t, mesh=mesh, **ENGINE_KW)
        rep = run_sync_guard(eng, mixed(3),
                             [Request(tokens=[3, 4, 5], max_new_tokens=6)])
    finally:
        TModel._head = head
    assert not rep.ok and rep.counts["model_records"] == 6
    assert {f.rule for f in rep.findings} == {"sync-model"}


def test_engine_refuses_a_layout_the_rank_code_cannot_run():
    """A sharded dim that does not divide the model axis (yi-9b smoke's 2
    kv heads over 16 ranks, where its head_dim of 8 does not divide
    either: the head_dim layout has no slice to give) raises, naming it;
    so does a mesh without a ``model`` axis."""
    tm = TModel(tconfigs.get_smoke_config("yi-9b"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0), TQC(mode="dense"))
    with pytest.raises(NotImplementedError, match="head_dim=8.*item 11"):
        Engine(tm, params, TQC(mode="dense"),
               mesh=make_test_mesh((1, 16), device="cpu"), **ENGINE_KW)
    with pytest.raises(ValueError, match="model"):
        Engine(tm, params, TQC(mode="dense"),
               mesh=make_test_mesh((2,), ("data",), device="cpu"),
               **ENGINE_KW)


def test_launch_counters_and_collectives_under_thread_stress():
    """More threads than cores, a shortened switch interval: the kernel
    wrappers' counters (``_build.bump``, under one lock) lose no update,
    and a 16-rank runner's all-reduces give every rank the rank-order
    sum, one collective counted per call of all ranks."""
    import sys

    from repro_torch.kernels import _build, ref

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = ref.vq_amm_ref.calls
        n_threads, n_bumps = 32, 500
        workers = [threading.Thread(target=lambda: [
            _build.bump(ref.vq_amm_ref, "calls") for _ in range(n_bumps)])
            for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert ref.vq_amm_ref.calls - before == n_threads * n_bumps

        ranks, rounds = 16, 50
        runner = tcol.RankRunner([torch.device("cpu")] * ranks)

        def fn(tp):
            out = []
            for i in range(rounds):
                out.append(tp.all_reduce(torch.tensor([float(tp.rank + i)])))
            return out
        box = {}
        th = threading.Thread(target=lambda: box.update(out=runner.run(fn)),
                              daemon=True)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive(), "the runner hung"
        for outs in box["out"]:
            assert [float(o) for o in outs] == \
                [float(sum(range(ranks)) + ranks * i) for i in range(rounds)]
        assert runner.collectives == rounds
    finally:
        sys.setswitchinterval(old)
