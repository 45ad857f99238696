"""Port parity: self-speculative decoding (``serve/speculative.py``,
``Model.verify_paged``, ``layers._sdpa_verify``, ``PageTable.trim``,
``Engine(spec_decode=)``) against the JAX package on the same numpy
inputs and carried-over params (float32, CPU).

Ported from ``tests/test_speculative.py``, without the tests that need
the prefix cache (ROADMAP.md queue A item 5) or a mesh (item 11).

Tolerances: ``accept_tokens`` and the ngram lookup equal the JAX
package's exactly (same inputs, same numpy seed); ``verify_paged`` logits
at 1e-4 and fp pools at 1e-5 (attention and norm sums in another order;
int8 projections are exact sums), code pools equal; greedy streams
identical: to the port's non-speculative engine and to the JAX
speculative engine. Sampling streams differ between the frameworks by
design, so temperature spec streams are checked for reproducibility.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import DENSE as JDENSE  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import NgramDrafter as JNgramDrafter  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve import accept_tokens as j_accept_tokens  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (kv_codebook_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core.lut import DENSE as TDENSE  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.kv_cache import PageTable  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.serve.speculative import (Drafter, NgramDrafter,  # noqa
                                           SpecConfig, accept_tokens)

KEY = jax.random.PRNGKey(0)
ENGINE_KW = dict(batch_size=2, max_seq=64, page_size=8, prefill_chunk=4)


def _carry(arch, params_j):
    """The port's CPU smoke model of ``arch`` and the JAX params carried
    over to it."""
    tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    return tm, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")


@pytest.fixture(scope="module")
def dense():
    """qwen1.5-4b smoke in dense mode, as tests/test_speculative.py."""
    jm = JModel(jconfigs.get_smoke_config("qwen1.5-4b"))
    params_j = jm.init(KEY, JDENSE)
    return (jm, params_j) + _carry("qwen1.5-4b", params_j)


@pytest.fixture(scope="module")
def lut():
    """The same smoke model with int8 LUTs (v=4, c=8) beside its dense
    weights: a lut_infer target, or a dense target with a lut_infer
    drafter over the same params."""
    jm = JModel(jconfigs.get_smoke_config("qwen1.5-4b"))
    qc_j = JQC(mode="lut_infer", v=4, c=8, lut_dtype="int8",
               flash="pallas")
    params_j = precompute_model(
        jm.init(KEY, JQC(mode="lut_train", v=4, c=8)), qc_j)
    qc_t = TQC(mode="lut_infer", v=4, c=8, lut_dtype="int8")
    return (jm, params_j, qc_j) + _carry("qwen1.5-4b", params_j) + (qc_t,)


def mixed_requests(make=Request, temperature: float = 0.0):
    """More requests than slots: admission mid-decode is exercised."""
    return [make(tokens=[3, 4, 5, 6], max_new_tokens=18,
                 temperature=temperature),
            make(tokens=[9, 8, 7], max_new_tokens=10,
                 temperature=temperature),
            make(tokens=[1, 2], max_new_tokens=14, temperature=temperature),
            make(tokens=[4, 4, 4, 4, 4], max_new_tokens=6,
                 temperature=temperature)]


def streams(reqs):
    return [r.out_tokens for r in reqs]


# ---------------------------------------------------------------------------
# acceptance math and the ngram lookup (host units)
# ---------------------------------------------------------------------------

def _logits_for(targets, v=16):
    out = np.full((len(targets), v), -5.0, np.float32)
    for i, t in enumerate(targets):
        out[i, t] = 5.0
    return out


def test_accept_greedy_prefix_bonus_and_correction():
    rng = np.random.default_rng(0)
    assert accept_tokens([7, 8, 9], _logits_for([7, 8, 9, 3]), 0.0,
                         rng) == (3, [7, 8, 9, 3])
    assert accept_tokens([7, 8, 9], _logits_for([7, 2, 9, 3]), 0.0,
                         rng) == (1, [7, 2])
    assert accept_tokens([5], _logits_for([7, 1]), 0.0, rng) == (0, [7])
    assert accept_tokens([7, 8], None, 0.0, rng,
                         targets=np.array([7, 8, 4])) == (2, [7, 8, 4])
    with pytest.raises(ValueError):
        accept_tokens([7, 8], None, 0.0, rng, targets=np.array([7]))


def test_accept_tokens_equal_jax_on_the_same_inputs_and_seed():
    """Greedy, one-hot and drafted-distribution temperature cases: the
    port's accept_tokens gives the JAX package's (accepted, tokens) on
    every case, each side with its own numpy generator of one seed."""
    data = np.random.default_rng(11)
    cases = []
    for _ in range(60):
        n, v = int(data.integers(1, 5)), int(data.integers(3, 9))
        logits = (2.0 * data.standard_normal((n + 1, v))).astype(
            np.float32)
        draft = data.integers(0, v, n).tolist()
        temp = float(data.choice([0.0, 0.5, 1.0, 2.0]))
        q = None
        if data.random() < 0.5:
            q = [data.dirichlet(np.ones(v)) for _ in range(n)]
        cases.append((draft, logits, temp, q))
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for draft, logits, temp, q in cases:
        got = accept_tokens(draft, logits, temp, rng_t, q)
        want = j_accept_tokens(draft, logits, temp, rng_j, q)
        assert got == want


def test_accept_rejection_preserves_target_distribution():
    rng = np.random.default_rng(1)
    logits = np.array([[1.0, 0.5, -0.5, 0.0], [0.0] * 4], np.float32)
    temp = 0.7
    p = np.exp(logits[0] / temp)
    p /= p.sum()
    q = np.array([0.55, 0.05, 0.3, 0.1])       # deliberately miscalibrated
    counts = np.zeros(4)
    trials = 6000
    for _ in range(trials):
        g = int(rng.choice(4, p=q))
        _, out = accept_tokens([g], logits, temp, rng, [q])
        counts[out[0]] += 1
    np.testing.assert_allclose(counts / trials, p, atol=0.03)


def test_ngram_lookup():
    look = NgramDrafter._lookup
    hist = [1, 2, 3, 9, 1, 2, 3]
    assert look(hist, 3, 3) == [9, 1, 2]
    assert look(hist, 8, 3) == [9, 1, 2, 3]
    assert look([1, 2, 3, 4], 4, 3) == []
    assert look([5, 1, 5, 2, 5], 2, 1) == [1, 5]
    assert look([7, 4, 4, 4, 4], 3, 3) == [4, 4, 4]
    rng = np.random.default_rng(2)
    for _ in range(200):
        hist = rng.integers(0, 4, int(rng.integers(1, 24))).tolist()
        k, nmax = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        assert look(hist, k, nmax) == JNgramDrafter._lookup(hist, k, nmax)
    with pytest.raises(ValueError):
        NgramDrafter(0)


# ---------------------------------------------------------------------------
# verify_paged against the JAX package's
# ---------------------------------------------------------------------------

PS, MAX_SEQ, N_PAGES, CHUNK = 8, 32, 10, 4


@pytest.mark.parametrize("pool", ["fp", "codes"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma3-4b"])
def test_verify_paged_matches_jax(arch, pool):
    """Three slots prefilled, then one verify of 4 columns: slot 0 with
    all columns live, slot 1 with two dead columns, slot 2 a pos = -1
    lane. Live logits to 1e-4, the written pool equal to JAX's outside
    the trash page (codes exactly); gemma3-4b's window of 8 masks rows
    of its 13-token context."""
    jm = JModel(jconfigs.get_smoke_config(arch))
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas",
               kv_quant="vq" if pool == "codes" else "none")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(4), JQC(mode="lut_train")), qc_j)
    tm, params_t = _carry(arch, params_j)
    qc_t = TQC(mode="lut_infer", lut_dtype="int8", kv_quant=qc_j.kv_quant)
    cb_j = cb_t = None
    if pool == "codes":
        cb_j = JEngine(jm, params_j, qc_j, batch_size=1, max_seq=MAX_SEQ,
                       page_size=PS, prefill_chunk=CHUNK,
                       prefix_cache=False).kv_codebook
        cb_t = kv_codebook_from_numpy(
            jax.tree_util.tree_map(np.asarray, cb_j.tree()), device="cpu")
    table = np.full((3, MAX_SEQ // PS), -1, np.int32)
    table[0, :3] = [5, 2, 8]
    table[1, :2] = [0, 7]
    table[2, :1] = [9]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).tolist()
               for n in (13, 9, 3)]
    kv_j = jm.init_paged_cache(3, MAX_SEQ, PS, num_pages=N_PAGES,
                               codebook=cb_j)
    kv_t = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES, codebook=cb_t)
    pf_j = jax.jit(lambda p, t, kv, pt, s, pos, v: jm.prefill_paged(
        p, t, kv, pt, s, pos, v, qc_j))
    table_t = torch.from_numpy(table)
    for slot, prompt in enumerate(prompts):
        for pos in range(0, len(prompt), CHUNK):
            chunk = prompt[pos:pos + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :len(chunk)] = chunk
            _, kv_j = pf_j(params_j, jnp.asarray(toks), kv_j,
                           jnp.asarray(table), slot, pos, len(chunk))
            tm.prefill_paged(params_t, torch.from_numpy(toks), kv_t, table_t,
                             slot, pos, len(chunk), qc_t)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, 4)).astype(np.int32)
    positions = np.array([13, 9, -1], np.int32)
    n_live = np.array([4, 2, 0], np.int32)
    slot2 = kv_t["k"][:, 9].clone()
    lg_j, kv_j = jax.jit(lambda p, t, kv, pt, pos, nl: jm.verify_paged(
        p, t, kv, pt, pos, nl, qc_j))(
            params_j, jnp.asarray(toks), kv_j, jnp.asarray(table),
            jnp.asarray(positions), jnp.asarray(n_live))
    lg_t = tm.verify_paged(params_t, torch.from_numpy(toks), kv_t, table_t,
                           torch.from_numpy(positions),
                           torch.from_numpy(n_live), qc_t)
    lg_j = np.asarray(lg_j)
    assert tuple(lg_t.shape) == lg_j.shape == (3, 4, tm.cfg.vocab_size)
    np.testing.assert_allclose(lg_t.numpy()[0], lg_j[0], atol=1e-4)
    np.testing.assert_allclose(lg_t.numpy()[1, :2], lg_j[1, :2], atol=1e-4)
    assert (lg_t.numpy()[:2].argmax(-1)[[0, 0, 0, 0, 1, 1],
                                        [0, 1, 2, 3, 0, 1]]
            == lg_j[:2].argmax(-1)[[0, 0, 0, 0, 1, 1],
                                   [0, 1, 2, 3, 0, 1]]).all()
    live = np.ones(N_PAGES + 1, bool)
    live[-1] = False                             # trash contents are free
    for key in ("k", "v"):
        got, want = kv_t[key].numpy()[:, live], np.asarray(kv_j[key])[:,
                                                                      live]
        if pool == "codes":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)
    assert torch.equal(kv_t["k"][:, 9], slot2)  # the pos = -1 lane's page


# ---------------------------------------------------------------------------
# engine: greedy streams against the port's non-speculative engine and
# the JAX speculative engine
# ---------------------------------------------------------------------------

def _jax_spec_streams(jm, params_j, qc_j, spec):
    reqs = mixed_requests(JRequest)
    JEngine(jm, params_j, qc_j, prefix_cache=False, degradation=None,
            spec_decode=spec, **ENGINE_KW).run(reqs)
    return streams(reqs)


@pytest.mark.parametrize("drafter_kw", [
    dict(drafter="ngram"), dict(drafter="model"),
    dict(drafter="model", draft_layers=2)],
    ids=["ngram", "model", "model-draft_layers=2"])
def test_spec_greedy_identical_dense(dense, drafter_kw):
    jm, params_j, tm, params_t = dense
    base = mixed_requests()
    TEngine(tm, params_t, TDENSE, **ENGINE_KW).run(base)
    sp = mixed_requests()
    eng = TEngine(tm, params_t, TDENSE,
                  spec_decode=SpecConfig(k=3, **drafter_kw), **ENGINE_KW)
    eng.run(sp)
    assert streams(sp) == streams(base)
    assert streams(sp) == _jax_spec_streams(
        jm, params_j, JDENSE, JSpecConfig(k=3, **drafter_kw))
    assert eng.spec_rounds > 0 and eng.spec_emitted > 0
    if drafter_kw == dict(drafter="model"):
        # the full-depth self-drafter proposes the target's argmax chain
        assert eng.acceptance_rate == 1.0
        assert eng.tokens_per_verify > 2.0


@pytest.mark.parametrize("pairing", ["lut_infer target",
                                     "dense target, lut_infer drafter"])
def test_spec_greedy_identical_lut_infer(lut, pairing):
    """A lut_infer target drafting at its own operating point, and the
    LUT-DLA pairing: a dense target verified while the lut_infer path
    drafts over the same params (shared codebooks)."""
    jm, params_j, qc_j, tm, params_t, qc_t = lut
    if pairing == "lut_infer target":
        t_qc, t_spec = qc_t, SpecConfig(k=3)
        j_qc, j_spec = qc_j, JSpecConfig(k=3)
    else:
        t_qc, t_spec = TDENSE, SpecConfig(k=3, draft_qc=qc_t)
        j_qc, j_spec = JDENSE, JSpecConfig(k=3, draft_qc=qc_j)
    base = mixed_requests()
    TEngine(tm, params_t, t_qc, **ENGINE_KW).run(base)
    sp = mixed_requests()
    eng = TEngine(tm, params_t, t_qc, spec_decode=t_spec, **ENGINE_KW)
    eng.run(sp)
    assert streams(sp) == streams(base)
    assert streams(sp) == _jax_spec_streams(jm, params_j, j_qc, j_spec)
    assert eng.spec_rounds > 0 and eng.spec_accepted > 0


class WrongDrafter(Drafter):
    """Proposes a constant (almost always wrong) token: verify rejects
    nearly everything, the rollback stress case."""

    def __init__(self, tok: int = 1):
        self.tok = tok

    def propose(self, engine, dslots, k_slot, k):
        b = engine.num_slots
        g = np.full((b, k), self.tok, np.int32)
        n_prop = np.zeros((b,), np.int32)
        for s in dslots:
            n_prop[s.idx] = k_slot[s.idx]
        return g, n_prop, None


def test_verify_reject_rollback_identical_stream(dense):
    """Rejected rows are rolled back, overwritten and never attended: the
    stream equals a never-speculated one, and a tight pool gets its
    trimmed tail pages back."""
    *_, tm, params_t = dense
    base = mixed_requests()
    TEngine(tm, params_t, TDENSE, **ENGINE_KW).run(base)
    sp = mixed_requests()
    eng = TEngine(tm, params_t, TDENSE, spec_decode=SpecConfig(k=3),
                  **ENGINE_KW)
    eng.drafter = WrongDrafter()
    eng.drafter.bind(eng)
    trims = []
    trim = eng.kv.trim
    eng.kv.trim = lambda slot, n: trims.append(trim(slot, n)) or trims[-1]
    eng.run(sp)
    assert streams(sp) == streams(base)
    assert eng.spec_drafted > 0
    assert eng.spec_accepted < eng.spec_drafted   # rejections happened
    assert sum(trims) > 0                         # tail pages came back
    assert eng.kv.table.live_pages == 0


def test_trim_releases_only_tail_pages():
    pt = PageTable(num_slots=2, max_seq=64, page_size=8, num_pages=8)
    pt.ensure(0, 40)                    # 5 pages
    head = pt.table[0, :3].copy()
    assert pt.live_pages == 5
    assert pt.trim(0, 18) == 2          # keep ceil(18/8) = 3
    assert pt.live_pages == 3 and pt.allocator.available == 5
    assert (pt.table[0, :3] == head).all() and (pt.table[0, 3:] == -1).all()
    assert pt.trim(0, 18) == 0          # idempotent
    pt.ensure(0, 40)                    # freed pages are reusable
    assert pt.live_pages == 5
    assert pt.trim(0, 0) == 5 and pt.live_pages == 0


def test_spec_config_validation(dense):
    *_, tm, params_t = dense
    with pytest.raises(ValueError, match="k must be"):
        TEngine(tm, params_t, TDENSE, batch_size=2, max_seq=32,
                spec_decode=SpecConfig(k=0))
    with pytest.raises(ValueError, match="unknown drafter"):
        SpecConfig(drafter="oracle").build_drafter()
    with pytest.raises(ValueError, match="draft_layers"):
        TEngine(tm, params_t, TDENSE, batch_size=2, max_seq=32,
                spec_decode=SpecConfig(k=2, draft_layers=99))


@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_greedy_round_reads_only_token_ids(dense, drafter):
    """A greedy round reads from the device at most twice (the model
    drafter's ids, the verify ids; the ngram drafter's are on the host),
    and never the logits."""
    *_, tm, params_t = dense
    eng = TEngine(tm, params_t, TDENSE,
                  spec_decode=SpecConfig(k=3, drafter=drafter), **ENGINE_KW)
    reads = []
    read = eng._device_read

    def spy(t):
        reads.append(t)
        return read(t)
    eng._device_read = spy
    reqs = mixed_requests()
    eng.run(reqs)
    assert eng.spec_rounds > 0
    assert not any(r.is_floating_point() for r in reads)
    per_round = 2 if drafter == "model" else 1
    prefills = len(reqs)
    assert eng.device_reads == len(reads)
    assert prefills + eng.spec_rounds <= len(reads) \
        <= prefills + per_round * eng.spec_rounds


@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_temperature_spec_streams_reproducible(dense, drafter):
    *_, tm, params_t = dense

    def run(seed):
        eng = TEngine(tm, params_t, TDENSE, seed=seed,
                      spec_decode=SpecConfig(k=3, drafter=drafter),
                      **ENGINE_KW)
        reqs = mixed_requests(temperature=2.0)
        eng.run(reqs)
        assert all(r.done for r in reqs)
        return streams(reqs)

    a = run(0)
    assert run(0) == a
    assert run(1) != a
