"""Port parity: prefix caching and copy-on-write (``serve/kv_cache.py``:
the ref-counted ``PageAllocator``, ``PrefixCache``, ``PageTable``'s
prefix index, ``PagedKVCache``'s page fork; ``Engine(prefix_cache=)``)
against the JAX package.

Mirrors ``tests/test_prefix_cache.py`` (host-side refcount and index
invariants, warm == cold, the fork's page contents, an oversubscribed
shared prefix), and adds: the port's content keys equal the JAX
package's for the same tokens and salt (a code pool's salt is its
codebook's fingerprint, equal on both sides for a carried-over
codebook); the same host-side operations leave equal tables and
refcounts; on int8 ``lut_infer`` (fp and code pools) the port's warm
tokens equal its cold tokens and the JAX warm engine's, with equal
``cached_tokens``; speculative rollback over shared pages; and the
resumed chunk that runs past ``max_seq``, where the port's warm tokens
must equal the JAX *cold* engine's.

Tolerances: greedy tokens identical; page contents bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import PageTable as JPageTable  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.kv_cache import _chunk_keys as j_chunk_keys  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import (kv_codebook_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import (Engine, PageAllocator,  # noqa: E402
                               PagePoolExhausted, PageTable, Request,
                               SpecConfig)
from repro_torch.serve.kv_cache import _chunk_keys  # noqa: E402

# a 16-token "system prompt" shared across requests (2 pages at page 8)
SYS = [(3 * j) % 40 + 2 for j in range(16)]
ENGINE_KW = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)


# ---------------------------------------------------------------------------
# allocator refcount invariants (host-side)
# ---------------------------------------------------------------------------

def test_allocator_double_free_rejected():
    a = PageAllocator(4)
    (p,) = a.alloc(1)
    a.free([p])
    with pytest.raises(ValueError, match="double free"):
        a.free([p])
    assert a.available == 4          # the failed free corrupted nothing


def test_decref_to_zero_frees_exactly_once():
    a = PageAllocator(4)
    (p,) = a.alloc(1)
    assert a.refcount(p) == 1
    a.incref(p)                      # shared by a second slot
    assert a.refcount(p) == 2
    a.free([p])                      # first holder evicts
    assert a.refcount(p) == 1 and a.available == 3
    a.free([p])                      # last holder evicts
    assert a.refcount(p) == 0 and a.available == 4
    with pytest.raises(ValueError):
        a.incref(p)                  # refcount-0 pages cannot be increfed
    with pytest.raises(ValueError):
        a.decref(p)


def test_revive_and_restore_guard_refcounts():
    a = PageAllocator(2)
    (p,) = a.alloc(1)
    with pytest.raises(ValueError):
        a.revive(p)                  # live page: revive is invalid
    with pytest.raises(ValueError):
        a.restore(p)                 # live page: restore is invalid
    a.decref(p)                      # parked (caller kept it off the list)
    a.revive(p)
    assert a.refcount(p) == 1


# ---------------------------------------------------------------------------
# page-table prefix index (host-side)
# ---------------------------------------------------------------------------

def test_register_match_park_and_lru_reclaim():
    pt = PageTable(num_slots=2, max_seq=32, page_size=8, num_pages=4)
    pt.ensure(0, 16)
    pt.register_prefix(0, SYS, 16)
    assert pt.cached_pages == 2
    m = pt.match_prefix(SYS + [77, 78, 79])
    assert m.tokens == 16 and m.reused_pages == 2 and m.cow_page is None
    pt.release(0)                          # unreferenced but indexed: parked
    assert pt.live_pages == 0
    assert pt.available_pages == 4 and pt.allocator.available == 2
    assert pt.pressure == 0.0              # parked pages count as capacity
    assert pt.match_prefix(SYS + [77]).tokens == 16
    pt.ensure(1, 32)                       # needs all 4 pages: reclaims LRU
    assert pt.allocator.available == 0 and pt.cached_pages == 0
    assert pt.pressure == 1.0
    assert pt.match_prefix(SYS + [77]).tokens == 0   # index dropped


def test_full_prompt_match_becomes_cow_fork():
    pt = PageTable(num_slots=2, max_seq=32, page_size=8, num_pages=4)
    pt.ensure(0, 16)
    pt.register_prefix(0, SYS, 16)
    m = pt.match_prefix(list(SYS))         # identical prompt, page-aligned
    assert m.tokens == 15                  # the last token must run prefill
    assert m.reused_pages == 1 and m.cow_page is not None
    src, dst = pt.adopt_prefix(1, m)
    assert src == m.cow_page and dst not in (m.pages + [src])
    assert pt.table[1, 0] == m.pages[0] and pt.table[1, 1] == dst
    assert pt.allocator.refcount(m.pages[0]) == 2
    assert pt.allocator.refcount(src) == 1         # only slot 0 holds it
    pt.release(1)
    assert pt.allocator.refcount(m.pages[0]) == 1  # shared decref, not free


def test_eviction_never_frees_pages_shared_with_another_slot():
    pt = PageTable(num_slots=2, max_seq=32, page_size=8, num_pages=4)
    pt.ensure(0, 16)
    pt.register_prefix(0, SYS, 16)
    pt.adopt_prefix(1, pt.match_prefix(SYS + [77, 78]))
    pt.ensure(1, 18)                       # + its own tail page
    free_before = pt.allocator.available
    pt.release(0)                          # the donor evicts
    assert pt.allocator.available == free_before
    for lp in range(2):
        assert pt.allocator.refcount(pt.table[1, lp]) == 1
    pt.release(1)                          # the pair parks, the tail frees
    assert pt.live_pages == 0
    assert pt.allocator.available == free_before + 1
    assert pt.cached_pages == 2 and pt.available_pages == 4


def test_adopt_rolls_back_when_cow_fork_cannot_allocate():
    pt = PageTable(num_slots=3, max_seq=32, page_size=8, num_pages=3)
    pt.ensure(0, 16)
    pt.register_prefix(0, SYS, 16)
    pt.ensure(2, 8)                        # burn the last free page
    m = pt.match_prefix(list(SYS))
    assert m.cow_page is not None
    with pytest.raises(PagePoolExhausted):
        pt.adopt_prefix(1, m)
    assert pt.table[1, 0] == -1            # row rolled back
    assert pt.allocator.refcount(m.pages[0]) == 1    # retain undone


def test_trim_only_drops_this_slots_reference_to_a_shared_page():
    """Speculative rollback over a shared row: ``trim`` goes through the
    same release as eviction, so a page another slot holds stays live and
    an indexed page parks instead of returning to the free list."""
    pt = PageTable(num_slots=2, max_seq=32, page_size=8, num_pages=4)
    pt.ensure(0, 16)
    pt.register_prefix(0, SYS, 16)
    pt.adopt_prefix(1, pt.match_prefix(SYS + [77]))
    shared = int(pt.table[1, 1])
    assert pt.trim(1, 8) == 1              # drops logical page 1 of slot 1
    assert pt.allocator.refcount(shared) == 1 and pt.table[1, 1] == -1
    assert pt.table[0, 1] == shared        # the donor's row is untouched
    pt.release(0)
    assert pt.trim(1, 0) == 1              # the last reference: it parks
    assert pt.live_pages == 0 and pt.cached_pages == 2
    assert pt.allocator.available == 2


@pytest.mark.parametrize("salt", [0, 12345, -(1 << 62)])
def test_chunk_keys_equal_jax(salt):
    rng = np.random.default_rng(0)
    for n in (0, 7, 8, 23, 64):
        toks = rng.integers(0, 50000, n).tolist()
        assert _chunk_keys(toks, 8, salt) == j_chunk_keys(toks, 8, salt)
        arr = np.asarray(toks, np.int32)            # numpy ids hash alike
        assert _chunk_keys(arr, 8, salt) == j_chunk_keys(toks, 8, salt)


def test_host_tables_match_jax_over_one_sequence_of_operations():
    """Admission, sharing, a fork, eviction, trim and LRU reclaim on both
    packages' page tables: equal rows, refcounts and accounting."""
    tables = [JPageTable(3, 32, 8, num_pages=6, content_salt=7),
              PageTable(3, 32, 8, num_pages=6, content_salt=7)]
    seen = []
    for pt in tables:
        log = []
        pt.ensure(0, 17)
        pt.register_prefix(0, SYS + [5], 17)
        log.append(pt.adopt_prefix(1, pt.match_prefix(list(SYS))))
        pt.ensure(1, 16)
        pt.ensure(2, 9)
        pt.release(0)
        log.append(pt.trim(1, 8))
        pt.release(2)
        pt.ensure(0, 32)
        log.append(pt.match_prefix(SYS + [9]).tokens)
        seen.append((pt.table.tolist(), list(pt.allocator._ref),
                     pt.live_pages, pt.cached_pages, pt.available_pages,
                     pt.pressure, log))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# engine level: int8 lut_infer, fp and code pools, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lut():
    """qwen1.5-4b smoke with int8 LUTs, carried over; the JAX engine's own
    KV codebook fit, carried over too."""
    jm = JModel(jcfg.smoke_config())
    qc_j = JQC(mode="lut_infer", lut_dtype="int8")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(1), JQC(mode="lut_train")), qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                 tm.cfg, device="cpu")
    qc_t = TQC(mode="lut_infer", lut_dtype="int8")
    cb_j = JEngine(jm, params_j, qc_j.replace(kv_quant="vq"), batch_size=1,
                   max_seq=32, page_size=8, prefill_chunk=4).kv_codebook
    cb_t = kv_codebook_from_numpy(
        jax.tree_util.tree_map(np.asarray, cb_j.tree()), device="cpu")
    return jm, params_j, qc_j, tm, params_t, qc_t, cb_j, cb_t


def _pools(lut):
    """(name, JAX engine kwargs, port engine kwargs) of the fp pool and
    the code pool."""
    jm, params_j, qc_j, tm, params_t, qc_t, cb_j, cb_t = lut
    return {"fp": ((jm, params_j, qc_j), {}, (tm, params_t, qc_t), {}),
            "codes": ((jm, params_j, qc_j.replace(kv_quant="vq")),
                      {"kv_codebook": cb_j},
                      (tm, params_t, qc_t.replace(kv_quant="vq")),
                      {"kv_codebook": cb_t})}


def _serve_sequence(eng, reqs):
    """Submit and drain one at a time (earlier requests warm the cache)."""
    for r in reqs:
        eng.submit(r)
        eng.run_until_idle()
    return reqs


# three shared-prefix prompts, then a whole-prompt repeat (the fork)
SEQ_PROMPTS = [SYS + [50], SYS + [51], SYS + [52], list(SYS)]


@pytest.mark.parametrize("pool", ["fp", "codes"])
def test_warm_equals_cold_and_jax_warm(lut, pool):
    (jargs, jkw, targs, tkw) = _pools(lut)[pool]
    mk = (lambda: [Request(tokens=list(p), max_new_tokens=4)
                   for p in SEQ_PROMPTS])
    cold = _serve_sequence(Engine(*targs, prefix_cache=False, **tkw,
                                  **ENGINE_KW), mk())
    eng = Engine(*targs, **tkw, **ENGINE_KW)
    warm = _serve_sequence(eng, mk())
    jeng = JEngine(*jargs, **jkw, **ENGINE_KW)
    jwarm = _serve_sequence(jeng, [JRequest(tokens=list(p), max_new_tokens=4)
                                   for p in SEQ_PROMPTS])
    for c, w, j in zip(cold, warm, jwarm):
        assert w.out_tokens == c.out_tokens == j.out_tokens
        assert w.cached_tokens == j.cached_tokens
    assert [r.cached_tokens for r in warm] == [0, 16, 16, 15]
    assert eng.cached_tokens == jeng.cached_tokens == 47
    assert eng.prefilled_tokens == eng.prompt_tokens - eng.cached_tokens
    assert eng.kv.cow_forks == jeng.kv.cow_forks == 1
    assert 0.5 < eng.prefix_hit_rate < 1.0
    assert eng.kv.live_pages == 0              # everything evicted or parked
    if pool == "codes":                        # the salt is the codebook's
        assert eng.kv.table.content_salt == jeng.kv.table.content_salt != 0


@pytest.mark.parametrize("pool", ["fp", "codes"])
@pytest.mark.parametrize("n", [29, 32])
def test_resumed_chunk_past_max_seq_gives_the_cold_tokens(lut, pool, n):
    """A prompt served twice at page 4, chunk 8, max_seq 32. 29 tokens:
    the repeat maps 7 pages and resumes prefill at 28; 32 tokens: it maps
    7 pages, forks the 8th and resumes at 31. Either way its chunk runs
    past max_seq. The port computes the real rows as a cold prefill does;
    its warm tokens must equal the JAX *cold* engine's. The JAX warm
    engine is wrong here (its prefill_paged clamps the chunk's slice
    start; ROADMAP.md queue C lists the fault), so it is not the
    reference."""
    (jargs, jkw, targs, tkw) = _pools(lut)[pool]
    kw = dict(batch_size=2, max_seq=32, page_size=4, prefill_chunk=8)
    prompt = np.random.default_rng(0).integers(0, 256, n).tolist()
    jcold = JRequest(tokens=list(prompt), max_new_tokens=3)
    JEngine(*jargs, prefix_cache=False, **jkw, **kw).run([jcold])
    eng = Engine(*targs, **tkw, **kw)
    first = Request(tokens=list(prompt), max_new_tokens=3)
    again = Request(tokens=list(prompt), max_new_tokens=3)
    _serve_sequence(eng, [first, again])
    assert (again.cached_tokens, eng.kv.cow_forks) == \
        ((28, 0) if n == 29 else (31, 1))
    assert again.out_tokens == first.out_tokens == jcold.out_tokens
    assert again.finish_reason.name == jcold.finish_reason.name


def test_cow_fork_preserves_donor_page_contents(lut):
    *_, tm, params_t, qc_t, _, _ = lut
    eng = Engine(tm, params_t, qc_t, **ENGINE_KW)
    a = Request(tokens=list(SYS), max_new_tokens=3)
    eng.run([a])
    match = eng.kv.match_prefix(list(SYS))
    assert match.cow_page is not None
    src = match.cow_page
    before = {k: eng.kv.data[k][:, src].clone() for k in ("k", "v")}
    assert eng.kv.adopt_prefix(1, match) == 15     # slot 1 is free
    dst = int(eng.kv.table.table[1, 1])
    for k in ("k", "v"):
        assert torch.equal(eng.kv.data[k][:, dst], before[k])
        assert torch.equal(eng.kv.data[k][:, src], before[k])
    assert eng.kv.cow_forks == 1
    eng.kv.release(1)
    b = Request(tokens=list(SYS), max_new_tokens=3)
    eng.run([b])
    assert b.out_tokens == a.out_tokens and b.cached_tokens == 15


def test_oversubscribed_shared_prefix_completes_with_parity(lut):
    """Preemption under pool pressure drops references to shared pages
    (never a double free); re-admission may rejoin through the cache;
    tokens equal solo runs and the JAX engine's."""
    jm, params_j, qc_j, tm, params_t, qc_t, _, _ = lut
    prompts = [SYS + [60 + i] for i in range(2)]
    reqs = [Request(tokens=p, max_new_tokens=10) for p in prompts]
    eng = Engine(tm, params_t, qc_t, num_pages=5, **ENGINE_KW)
    eng.run(reqs)
    jreqs = [JRequest(tokens=p, max_new_tokens=10) for p in prompts]
    JEngine(jm, params_j, qc_j, num_pages=5, **ENGINE_KW).run(jreqs)
    for r, jr in zip(reqs, jreqs):
        assert r.done and len(r.out_tokens) == 10
        solo = Request(tokens=list(r.tokens), max_new_tokens=10)
        Engine(tm, params_t, qc_t, **dict(ENGINE_KW, batch_size=1)).run(
            [solo])
        assert r.out_tokens == solo.out_tokens == jr.out_tokens
    assert eng.kv.live_pages == 0


def test_prefix_cache_disabled_knob(lut):
    *_, tm, params_t, qc_t, _, _ = lut
    eng = Engine(tm, params_t, qc_t, prefix_cache=False, **ENGINE_KW)
    assert eng.kv.table.prefix is None
    _serve_sequence(eng, [Request(tokens=list(p), max_new_tokens=2)
                          for p in SEQ_PROMPTS[:3]])
    assert eng.cached_tokens == 0 and eng.prefix_hit_rate == 0.0


def test_speculative_rollback_over_shared_pages(lut):
    """Speculation with the prefix cache: rejected rounds trim tail pages
    of slots whose prefix pages are shared; streams equal the
    non-speculative engine's and no page leaks."""
    *_, tm, params_t, qc_t, _, _ = lut
    kw = dict(ENGINE_KW, max_seq=64)
    mk = (lambda: [Request(tokens=SYS + [70 + i], max_new_tokens=12)
                   for i in range(3)])
    base = _serve_sequence(Engine(tm, params_t, qc_t, **kw), mk())
    eng = Engine(tm, params_t, qc_t, spec_decode=SpecConfig(k=3),
                 **kw)
    got = _serve_sequence(eng, mk())
    assert [r.out_tokens for r in got] == [r.out_tokens for r in base]
    assert [r.cached_tokens for r in got] == [0, 16, 16]
    assert eng.spec_rounds > 0
    assert eng.kv.live_pages == 0
    assert all(c == 0 for c in eng.kv.table.allocator._ref)
