"""Port parity at serving level: the port's continuous-batching Engine
against the JAX Engine on the same lut_infer (int8) smoke params (qwen1.5-4b,
and yi-9b and gemma3-4b: GQA, an untied head, sliding-window layers), plus
host-side units of the page allocator, page table and scheduler; and the
dense-cache serving API (``Model.init_cache`` / ``prefill`` / ``decode``
with ``pad_lens``), ``BatchToCompletionEngine`` and ``greedy_generate``
against the JAX package (logits within 1e-4 of their scale: float32, the
same int8 sums, attention sums in another order; tokens identical).

Greedy requests must give identical tokens: mixed prompt lengths, a
request admitted mid-decode, and a page pool small enough to preempt.
Sampling streams differ between the frameworks by design, so temperature
requests are checked for reproducibility and slot independence only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import BatchToCompletionEngine as JBatch  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import greedy_generate as j_greedy_generate  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.kv_cache import (PageAllocator,  # noqa: E402
                                        PagedKVCache, PagePoolExhausted,
                                        PageTable)
from repro_torch.serve.engine import (  # noqa: E402
    BatchToCompletionEngine, greedy_generate)
from repro_torch.serve.scheduler import Request, SlotScheduler  # noqa: E402

ENGINE_KW = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)


# ---------------------------------------------------------------------------
# host-side units (mirror tests/test_serve_paged.py)
# ---------------------------------------------------------------------------

def test_page_allocator_exhaustion_is_clean():
    a = PageAllocator(3)
    got = a.alloc(2)
    assert len(got) == 2 and a.available == 1
    with pytest.raises(PagePoolExhausted) as ei:
        a.alloc(2)
    assert "2 page(s)" in str(ei.value) and "1 of 3" in str(ei.value)
    assert a.available == 1          # failed alloc took nothing
    a.free(got)
    assert a.available == 3
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1])


def test_page_table_grow_release_reuse():
    pt = PageTable(num_slots=2, max_seq=32, page_size=8)   # 4 pages/slot
    pt.ensure(0, 9)                  # 2 pages
    pt.ensure(1, 1)                  # 1 page
    assert pt.live_pages == 3
    assert (pt.table[0, :2] >= 0).all() and pt.table[0, 2] == -1
    dev = pt.device("cpu")
    assert tuple(dev.shape) == (2, 4) and dev.dtype == torch.int32
    pt.ensure(0, 9)                  # idempotent
    assert pt.live_pages == 3
    pt.release(0)
    assert pt.live_pages == 1 and (pt.table[0] == -1).all()
    pt.ensure(0, 32)                 # freed pages are reusable
    assert pt.live_pages == 5
    with pytest.raises(PagePoolExhausted):
        pt.ensure(1, 33)             # beyond max_seq


def test_scheduler_admission_is_fifo_and_page_aware():
    m = TModel(tcfg.smoke_config(), device="cpu")
    kv = PagedKVCache(m, num_slots=2, max_seq=32, page_size=8, num_pages=3)
    sched = SlotScheduler(2)
    sched.submit(Request(tokens=list(range(16))))   # 2 pages
    sched.submit(Request(tokens=list(range(8))))    # 1 page
    sched.submit(Request(tokens=list(range(8))))    # must wait
    admitted = sched.admit(kv)
    assert [s.idx for s in admitted] == [0, 1]
    assert kv.table.live_pages == 3 and len(sched.waiting) == 1
    assert sched.admit(kv) == []                    # pool full -> deferred
    sched.evict(admitted[1], kv)                    # slot frees mid-flight
    assert [s.idx for s in sched.admit(kv)] == [1]
    assert len(sched.waiting) == 0


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg_j = jcfg.smoke_config()
    jm = JModel(cfg_j)
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(1), JQC(mode="lut_train")), qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, TQC(mode="lut_infer",
                                                 lut_dtype="int8")


# (prompt, max_new): 6 pages of demand against a 5-page pool
PLAN = [(list(range(3, 14)), 12), ([40, 41, 42, 43, 44, 45], 12),
        ([7, 8, 9], 6)]
LATE = ([100, 101], 5)               # submitted mid-decode


def _serve(engine, make_req):
    reqs = [make_req(p, n) for p, n in PLAN]
    for r in reqs:
        engine.submit(r)
    for _ in range(5):               # the first requests reach decode
        engine.step()
    late = make_req(*LATE)
    engine.submit(late)
    engine.run_until_idle()
    return reqs + [late]


def test_engine_greedy_tokens_match_jax_engine(models):
    jm, params_j, qc_j, tm, params_t, qc_t = models
    j_eng = JEngine(jm, params_j, qc_j, num_pages=5, prefix_cache=False,
                    degradation=None, **ENGINE_KW)
    t_eng = TEngine(tm, params_t, qc_t, num_pages=5, **ENGINE_KW)
    j_reqs = _serve(j_eng, lambda p, n: JRequest(tokens=p, max_new_tokens=n))
    t_reqs = _serve(t_eng, lambda p, n: Request(tokens=p, max_new_tokens=n))
    assert j_eng.scheduler.preemptions >= 1
    assert t_eng.scheduler.preemptions == j_eng.scheduler.preemptions
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.done and rt.finish_reason.name == rj.finish_reason.name
        assert rt.out_tokens == rj.out_tokens
    assert t_eng.kv.table.live_pages == 0
    assert all(s.free for s in t_eng.scheduler.slots)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b"])
def test_gqa_and_window_engine_greedy_tokens_match_jax_engine(arch):
    """yi-9b (G=4, untied head) and gemma3-4b (G=2, window 8) smoke: the
    port's engine emits the JAX engine's greedy tokens, with prompts and
    generations past the window, mid-decode admission and preemption."""
    jm = JModel(jconfigs.get_smoke_config(arch))
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(2), JQC(mode="lut_train")), qc_j)
    tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                 tm.cfg, device="cpu")
    qc_t = TQC(mode="lut_infer", lut_dtype="int8")
    rng = np.random.default_rng(3)
    vocab = tm.cfg.vocab_size
    plan = [(rng.integers(0, vocab, n).tolist(), m)
            for n, m in ((13, 12), (10, 11), (9, 6))]
    late_plan = (rng.integers(0, vocab, 11).tolist(), 7)

    def serve(engine, make_req):
        reqs = [make_req(p, n) for p, n in plan]
        for r in reqs:
            engine.submit(r)
        for _ in range(6):
            engine.step()
        late = make_req(*late_plan)
        engine.submit(late)
        engine.run_until_idle()
        return reqs + [late]
    j_eng = JEngine(jm, params_j, qc_j, num_pages=5, prefix_cache=False,
                    degradation=None, **ENGINE_KW)
    t_eng = TEngine(tm, params_t, qc_t, num_pages=5, **ENGINE_KW)
    j_reqs = serve(j_eng, lambda p, n: JRequest(tokens=p, max_new_tokens=n))
    t_reqs = serve(t_eng, lambda p, n: Request(tokens=p, max_new_tokens=n))
    assert j_eng.scheduler.preemptions >= 1
    assert t_eng.scheduler.preemptions == j_eng.scheduler.preemptions
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.done and rt.finish_reason.name == rj.finish_reason.name
        assert rt.out_tokens == rj.out_tokens
    assert max(len(r.tokens) + len(r.out_tokens) for r in t_reqs) > 16


def test_one_device_read_per_decode_step(models):
    *_, tm, params_t, qc_t = models
    eng = TEngine(tm, params_t, qc_t, **ENGINE_KW)
    req = Request(tokens=[5, 6, 7], max_new_tokens=6)
    eng.run([req])
    assert len(req.out_tokens) == 6
    assert eng.device_reads == 6     # 1 after prefill + 5 decode steps


def test_temperature_reproducible_and_slots_diverge(models):
    *_, tm, params_t, qc_t = models

    def run(seed):
        eng = TEngine(tm, params_t, qc_t, seed=seed, **ENGINE_KW)
        reqs = [Request(tokens=[9, 10, 11], max_new_tokens=12,
                        temperature=5.0) for _ in range(2)]
        eng.run(reqs)
        return [r.out_tokens for r in reqs]

    a, b = run(0), run(0)
    assert a == b                    # fixed seed: same tokens
    assert a[0] != a[1]              # identical hot requests, two slots
    assert run(1) != a


def test_engine_rejects_impossible_requests(models):
    *_, tm, params_t, qc_t = models
    eng = TEngine(tm, params_t, qc_t, **ENGINE_KW)
    with pytest.raises(PagePoolExhausted, match="max_seq"):
        eng.submit(Request(tokens=list(range(40)), max_new_tokens=2))


# ---------------------------------------------------------------------------
# dense-cache serving: the batch-to-completion baseline
# ---------------------------------------------------------------------------

def _left_padded(prompts, width):
    toks = np.zeros((len(prompts), width), np.int32)
    pads = np.zeros((len(prompts),), np.int32)
    for j, p in enumerate(prompts):
        toks[j, width - len(p):] = p
        pads[j] = width - len(p)
    return toks, pads


def test_dense_prefill_and_decode_logits_match_jax(models):
    """Left-padded prompts of three lengths (and a uniform batch, no
    mask) through prefill and three decode steps: logits within 1e-4 of
    their scale of the JAX package's, and the same argmax."""
    jm, params_j, qc_j, tm, params_t, qc_t = models
    prompts = [[5, 6, 7, 8, 9, 10], [11, 12, 13], [14]]
    for batch, mask in ((prompts, True), ([p[:3] for p in prompts[:2]],
                                          False)):
        toks, pads = _left_padded(batch, max(map(len, batch)))
        pl_j = jnp.asarray(pads) if mask else None
        pl_t = torch.from_numpy(pads) if mask else None
        lg_j, c_j = jm.prefill(params_j, {"tokens": jnp.asarray(toks)},
                               jm.init_cache(len(batch), 16), qc_j,
                               pad_lens=pl_j)
        lg_t, c_t = tm.prefill(params_t, {"tokens": torch.from_numpy(toks)},
                               tm.init_cache(len(batch), 16), qc_t,
                               pad_lens=pl_t)
        for _ in range(4):
            a, b = np.asarray(lg_j), lg_t.numpy()
            np.testing.assert_allclose(b, a, atol=1e-4 * np.abs(a).max())
            assert (a.argmax(-1) == b.argmax(-1)).all()
            nxt = a.argmax(-1).astype(np.int32)[:, None]
            lg_j, c_j = jm.decode(params_j, jnp.asarray(nxt), c_j, qc_j,
                                  pad_lens=pl_j)
            lg_t, c_t = tm.decode(params_t, torch.from_numpy(nxt), c_t,
                                  qc_t, pad_lens=pl_t)
        assert c_t["pos"] == int(c_j["pos"]) == toks.shape[1] + 4


def test_batch_engine_tokens_match_jax_and_the_continuous_engine(models):
    """Mixed-length prompts in two batches (the second one short of a
    full batch): the port's batch engine gives the JAX batch engine's
    tokens, step stamps and finish reasons, and the continuous engine's
    tokens (the JAX package's test_lut_infer_engine_matches_dense_cache_
    engine, for the port)."""
    jm, params_j, qc_j, tm, params_t, qc_t = models
    rng = np.random.default_rng(9)
    plan = [(rng.integers(0, 256, n).tolist(), m)
            for n, m in ((7, 6), (3, 9), (11, 4), (5, 5), (2, 7))]

    def stamps(reqs):
        return [(r.finish_reason.name, r.out_tokens, r.first_token_step,
                 r.finish_step) for r in reqs]
    t_reqs = [Request(tokens=p, max_new_tokens=n) for p, n in plan]
    eng = BatchToCompletionEngine(tm, params_t, qc_t, batch_size=2,
                                  max_seq=32)
    eng.run(t_reqs)
    j_reqs = [JRequest(tokens=p, max_new_tokens=n) for p, n in plan]
    JBatch(jm, params_j, qc_j, batch_size=2, max_seq=32).run(j_reqs)
    assert stamps(t_reqs) == stamps(j_reqs)
    c_reqs = [Request(tokens=p, max_new_tokens=n) for p, n in plan]
    TEngine(tm, params_t, qc_t, **ENGINE_KW).run(c_reqs)
    assert [r.out_tokens for r in t_reqs] == [r.out_tokens for r in c_reqs]
    assert eng.obs.metrics.counters()["req.finish.completed"] == len(plan)


def test_batch_engine_truncates_at_max_seq(models):
    *_, tm, params_t, qc_t = models
    big = Request(tokens=list(range(2, 14)), max_new_tokens=12)
    BatchToCompletionEngine(tm, params_t, qc_t, batch_size=1,
                            max_seq=64).run([big])
    small = Request(tokens=list(range(2, 14)), max_new_tokens=12)
    BatchToCompletionEngine(tm, params_t, qc_t, batch_size=1,
                            max_seq=16).run([small])
    n = len(small.out_tokens)
    assert 0 < n < 12 and small.finish_reason.name == "TRUNCATED"
    assert small.out_tokens == big.out_tokens[:n]
    assert small.finish_step is not None


def test_greedy_generate_matches_jax(models):
    jm, params_j, qc_j, tm, params_t, qc_t = models
    prompt = [3, 4, 5, 6, 7]
    assert greedy_generate(tm, params_t, prompt, 8, qc_t, max_seq=32) == \
        j_greedy_generate(jm, params_j, prompt, 8, qc_j, max_seq=32)
