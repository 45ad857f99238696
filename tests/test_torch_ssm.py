"""Port parity for the SSM (mamba2) and hybrid (zamba2) families:
``models/mamba2.py``, the slot-state paths of ``models/model.py``, the
hybrid's slot-dense decode attention (``layers._sdpa_decode_combine``),
``PagedKVCache`` without pages, and the continuous engine and router
over both families, against the JAX package on the same numpy inputs,
on the CPU.

Covered: ``_segsum``, ``_causal_conv`` (with and without ``valid_len``)
and ``ssd_chunked`` at several (s, chunk), with ``h0``, s not a multiple
of chunk, and G = 1 and 2; ``mamba2_block`` / ``mamba2_decode`` in dense
and int8 ``lut_infer`` (fused: the JAX Pallas kernel in interpret mode;
two-pass), states compared too; ``prefill_paged`` / ``decode_paged``
chains with one slot mid-prefill while the others decode and a recycled
slot; the hybrid's decode attention and, past a small ``attn_chunk``,
its chunked prefill; engine greedy tokens (fused and two-pass, more
requests than slots, a multi-chunk prompt, prefix caching inert); the
refusals (``kv_quant="vq"``, ``spec_decode``, the batch engine,
``verify_paged``, the dense cache); a router over an SSM model;
``params_from_numpy`` and ``precompute_model`` leaf for leaf.

Tolerances (float32): the scan, conv and attention pieces at 1e-5; block
outputs and logits at 1e-4 (every projection is an exact int8 sum or a
float32 sum in another order; norms and the scan sum in another order);
states and attention rows at 1e-5; greedy tokens identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model as jprecompute  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lutboost import precompute_model  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import (BatchToCompletionEngine, Engine,  # noqa
                               ReplicaRouter, Request, SpecConfig)

TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
PS, MAX_SEQ, CHUNK = 8, 32, 4
NONPROJ = ("norm", "conv_w", "conv_b", "dt_bias", "A_log", "D", "gate_norm")


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch(tree):
    """A JAX param (sub)tree as CPU tensors, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return _t(tree)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# the scan pieces
# ---------------------------------------------------------------------------

def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 9)).astype(
        np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(x)))
    got = _np(tm2._segsum(_t(x)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **STATE_TOL)


@pytest.mark.parametrize("valid_len", [None, 3])
def test_causal_conv_matches_jax(valid_len):
    """With a carried state, and with a right-padded chunk whose carried
    state must be the window ending at its last real input."""
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    b = rng.standard_normal((10,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 10)).astype(np.float32)
    for st in (None, state):
        out_j, new_j = jm2._causal_conv(
            jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
            None if st is None else jnp.asarray(st), valid_len=valid_len)
        out_t, new_t = tm2._causal_conv(
            _t(xbc), _t(w), _t(b), None if st is None else _t(st),
            valid_len=valid_len)
        np.testing.assert_allclose(_np(out_t), np.asarray(out_j),
                                   **STATE_TOL)
        np.testing.assert_array_equal(_np(new_t), np.asarray(new_j))


@pytest.mark.parametrize("s,chunk,g,with_h0", [
    (7, 4, 1, True), (16, 8, 2, False), (5, 128, 2, True),
    (20, 8, 1, True)])
def test_ssd_chunked_matches_jax(s, chunk, g, with_h0):
    """Several chunks (the inter-chunk recurrence), s not a multiple of
    chunk (padding), one chunk larger than s, G = 1 and 2 (B and C
    repeated over the heads), with and without an initial state."""
    rng = np.random.default_rng(2)
    b, h, p, n = 2, 4, 3, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    d_skip = rng.standard_normal((h,)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_h0 else None)
    y_j, hf_j = jm2.ssd_chunked(
        *map(jnp.asarray, (x, dt, a_log, bm, cm, d_skip)), chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    y_t, hf_t = tm2.ssd_chunked(
        *map(_t, (x, dt, a_log, bm, cm, d_skip)), chunk=chunk,
        h0=None if h0 is None else _t(h0))
    assert y_t.dtype == torch.float32 and hf_t.dtype == torch.float32
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), **STATE_TOL)
    np.testing.assert_allclose(_np(hf_t), np.asarray(hf_j), **STATE_TOL)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

QC_RUNS = {
    "dense": (JQC(mode="dense"), TQC(mode="dense")),
    # the JAX package's Pallas kernels in interpret mode
    "fused": (JQC(mode="lut_infer", lut_dtype="int8", impl="fused"),
              TQC(mode="lut_infer", lut_dtype="int8")),
    "two-pass": (JQC(mode="lut_infer", lut_dtype="int8", impl="pallas",
                     fuse=False),
                 TQC(mode="lut_infer", lut_dtype="int8", fuse=False)),
}


@pytest.mark.parametrize("run,ngroups", [("dense", 1), ("dense", 2),
                                         ("fused", 1), ("two-pass", 1)])
def test_mamba2_block_and_decode_match_jax(run, ngroups):
    """mamba2-smoke's block on a right-padded chunk (valid_len 5 of 7)
    with a carried state, then two decode steps on the state it leaves:
    outputs within 1e-4, conv and h states within 1e-5."""
    cfg_j = jconfigs.get_smoke_config("mamba2-2.7b").replace(
        ssm_ngroups=ngroups)
    cfg_t = tconfigs.get_smoke_config("mamba2-2.7b").replace(
        ssm_ngroups=ngroups)
    qc_j, qc_t = QC_RUNS[run]
    init_qc = JQC(mode="lut_train") if qc_j.is_lut else JQC()
    p_j = jm2.init_mamba2(jax.random.PRNGKey(3), cfg_j, init_qc, jnp.float32)
    if qc_j.is_lut:
        p_j = jprecompute(p_j, qc_j)
    p_t = _torch(jax.tree_util.tree_map(np.asarray, p_j))
    rng = np.random.default_rng(4)
    b, s = 2, 7
    conv_dim = cfg_t.d_inner + 2 * ngroups * cfg_t.ssm_state
    cache = {
        "conv": rng.standard_normal((b, cfg_t.ssm_conv - 1, conv_dim)
                                    ).astype(np.float32),
        "h": 0.1 * rng.standard_normal(
            (b, cfg_t.ssm_nheads, cfg_t.ssm_headdim, cfg_t.ssm_state)
        ).astype(np.float32)}
    x = rng.standard_normal((b, s, cfg_t.d_model)).astype(np.float32)
    out_j, _, c_j = jm2.mamba2_block(
        p_j, jnp.asarray(x), cfg_j, qc_j,
        jax.tree_util.tree_map(jnp.asarray, cache), valid_len=5)
    out_t, c_t = tm2.mamba2_block(p_t, _t(x), cfg_t, qc_t, _torch(cache),
                                  valid_len=5)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(c_t[key]), np.asarray(c_j[key]),
                                   **STATE_TOL)
    for step in range(2):
        x1 = rng.standard_normal((b, 1, cfg_t.d_model)).astype(np.float32)
        out_j, _, c_j = jm2.mamba2_decode(p_j, jnp.asarray(x1), cfg_j, qc_j,
                                          c_j)
        out_t, c_t = tm2.mamba2_decode(p_t, _t(x1), cfg_t, qc_t, c_t)
        np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **TOL)
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(c_t[key]), np.asarray(c_j[key]),
                                       **STATE_TOL)


@pytest.mark.parametrize("window", [0, 3])
def test_sdpa_decode_combine_matches_jax(window):
    """The hybrid's slot-dense decode: per-row positions (one lane at -1,
    which attends only its fresh token), GQA, a window."""
    rng = np.random.default_rng(5)
    b, t, h, kvh, d = 4, 9, 4, 2, 8
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, t, kvh, d)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
              for _ in range(2))
    pos = np.array([5, -1, 0, 8], np.int32)
    want = jlayers._sdpa_decode_combine(
        *map(jnp.asarray, (q, kc, vc, kn, vn, pos)), window)
    got = tlayers._sdpa_decode_combine(*map(_t, (q, kc, vc, kn, vn, pos)),
                                       window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **STATE_TOL)


# ---------------------------------------------------------------------------
# the paged entry points over slot state
# ---------------------------------------------------------------------------

def _carry(arch, seed, qc_kw=None, cfg_kw=None):
    """A JAX smoke model of ``arch`` in int8 lut_infer (its Pallas kernels
    through the reference path on the CPU), its params carried over to
    the port's model on the CPU."""
    qc_kw, cfg_kw = qc_kw or {}, cfg_kw or {}
    jm = JModel(jconfigs.get_smoke_config(arch).replace(**cfg_kw))
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", **qc_kw)
    params_j = jprecompute(
        jm.init(jax.random.PRNGKey(seed), JQC(mode="lut_train")), qc_j)
    tm = TModel(tconfigs.get_smoke_config(arch).replace(**cfg_kw),
                device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, TQC(mode="lut_infer",
                                                 lut_dtype="int8", **qc_kw)


def _compare_state(kv_t, kv_j, pos):
    """The conv / h states of every slot, and the hybrid's attention rows
    below each slot's position, within 1e-5."""
    if "attn" in kv_t:
        for key in ("k", "v"):
            a_t, a_j = _np(kv_t["attn"][key]), np.asarray(kv_j["attn"][key])
            for slot, n in enumerate(pos):
                np.testing.assert_allclose(a_t[:, slot, :n],
                                           a_j[:, slot, :n], **STATE_TOL)
        kv_t, kv_j = kv_t["mamba"], kv_j["mamba"]
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(kv_t[key]), np.asarray(kv_j[key]),
                                   **STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_chain_match_jax(arch):
    """Three slots: slots 0 and 1 prefilled in full (11 and 6 tokens, so
    chunks of 4 with pads), slot 2 stopped after its first chunk while
    the others decode (positions -1: its state must not move), then its
    prefill resumes and all three decode; last, slot 1 is recycled by a
    new prompt from position 0 (it must read zeros, not its last state).
    The hybrid runs with attn_chunk 8, so the JAX package's prefill and
    the port's take the chunked online softmax over the slot's 33 rows."""
    cfg_kw = {"attn_impl": "chunked", "attn_chunk": 8} \
        if arch == "zamba2-1.2b" else {}
    jm, params_j, qc_j, tm, params_t, qc_t = _carry(arch, 6, cfg_kw=cfg_kw)
    vocab = tm.cfg.vocab_size
    kv_j = jm.init_paged_cache(3, MAX_SEQ, PS, num_pages=12)
    kv_t = tm.init_paged_cache(MAX_SEQ, PS, 12, num_slots=3)
    table = np.full((3, MAX_SEQ // PS), -1, np.int32)
    pf_j = jax.jit(lambda p, t, kv, pt, s, pos, v: jm.prefill_paged(
        p, t, kv, pt, s, pos, v, qc_j))
    dec_j = jax.jit(lambda p, t, kv, pt, pos: jm.decode_paged(
        p, t, kv, pt, pos, qc_j))
    table_t = torch.from_numpy(table)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (11, 6, 9)]
    pos = [0, 0, 0]
    nxt = [0, 0, 0]

    def prefill(slot, upto):
        nonlocal kv_j
        while pos[slot] < upto:
            chunk = prompts[slot][pos[slot]:pos[slot] + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :len(chunk)] = chunk
            lg_j, kv_j = pf_j(params_j, jnp.asarray(toks), kv_j,
                              jnp.asarray(table), slot, pos[slot],
                              len(chunk))
            lg_t = tm.prefill_paged(params_t, torch.from_numpy(toks), kv_t,
                                    table_t, slot, pos[slot], len(chunk),
                                    qc_t)
            np.testing.assert_allclose(_np(lg_t), np.asarray(lg_j), **TOL)
            pos[slot] += len(chunk)
        nxt[slot] = int(np.argmax(np.asarray(lg_j)[0]))
        assert int(lg_t.argmax()) == nxt[slot]

    def decode(lanes, steps):
        nonlocal kv_j
        for _ in range(steps):
            positions = np.array([pos[i] if i in lanes else -1
                                  for i in range(3)], np.int32)
            toks = np.array([[nxt[i]] for i in range(3)], np.int32)
            lg_j, kv_j = dec_j(params_j, jnp.asarray(toks), kv_j,
                               jnp.asarray(table), jnp.asarray(positions))
            lg_t = tm.decode_paged(params_t, torch.from_numpy(toks), kv_t,
                                   table_t, torch.from_numpy(positions),
                                   qc_t)
            lg_j = np.asarray(lg_j)
            np.testing.assert_allclose(_np(lg_t)[lanes], lg_j[lanes], **TOL)
            np.testing.assert_array_equal(_np(lg_t)[lanes].argmax(-1),
                                          lg_j[lanes].argmax(-1))
            for i in lanes:
                nxt[i] = int(lg_j[i].argmax())
                pos[i] += 1

    prefill(0, 11)
    prefill(1, 6)
    prefill(2, 4)                                    # one chunk of 9
    _compare_state(kv_t, kv_j, pos)
    mamba = kv_t["mamba"] if "mamba" in kv_t else kv_t
    slot2 = {key: mamba[key][:, 2].clone() for key in ("conv", "h")}
    decode([0, 1], 3)
    for key in ("conv", "h"):                        # untouched mid-prefill
        assert torch.equal(mamba[key][:, 2], slot2[key])
    _compare_state(kv_t, kv_j, pos)
    prefill(2, 9)
    decode([0, 1, 2], 3)
    _compare_state(kv_t, kv_j, pos)
    prompts[1] = rng.integers(0, vocab, 7).tolist()  # a new occupant
    pos[1] = 0
    prefill(1, 7)
    decode([0, 1, 2], 2)
    _compare_state(kv_t, kv_j, pos)


# ---------------------------------------------------------------------------
# the engine, the router, the refusals
# ---------------------------------------------------------------------------

ENGINE_KW = dict(batch_size=2, max_seq=MAX_SEQ, page_size=PS,
                 prefill_chunk=CHUNK)
# (prompt length, max_new): five requests for two slots, a multi-chunk
# prompt, and two requests with one 16-token (two-page) prompt that a
# paged family's prefix cache would share
PLAN = ((11, 8), (3, 6), (16, 5), (16, 5), (6, 7))
LATE = (9, 6)                                        # submitted mid-decode


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ["fused", "two-pass"])
def test_engine_greedy_tokens_match_jax_engine(arch, run):
    """Both smoke models through the continuous engines (prefix caching
    on, as by default): six requests for two slots (slots recycle), an
    11-token prompt over three chunks, a request admitted mid-decode, and
    a repeated prompt that finds no cached prefix: the JAX engine's
    greedy tokens, and no page is touched."""
    qc_kw = {"two-pass": {"fuse": False}}.get(run)
    jm, params_j, qc_j, tm, params_t, qc_t = _carry(arch, 12, qc_kw)
    j_eng = JEngine(jm, params_j, qc_j, **ENGINE_KW)
    t_eng = Engine(tm, params_t, qc_t, **ENGINE_KW)
    vocab = tm.cfg.vocab_size
    j_reqs = _serve(j_eng, lambda p, n: JRequest(tokens=p, max_new_tokens=n),
                    vocab)
    t_reqs = _serve(t_eng, lambda p, n: Request(tokens=p, max_new_tokens=n),
                    vocab)
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.done and rt.finish_reason.name == rj.finish_reason.name
        assert rt.out_tokens == rj.out_tokens
    assert not t_eng.kv.paged and t_eng.cached_tokens == 0
    assert t_eng.kv.live_pages == 0 and t_eng.kv.bytes_per_token == 0
    assert t_eng.kv.table.allocator.in_use == 0
    assert t_eng.kv.match_prefix(t_reqs[2].tokens).tokens == 0


REFUSALS = ["kv_quant", "spec_decode", "batch_engine", "verify_paged",
            "dense_cache", "codebook"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", REFUSALS)
def test_recurrent_families_refuse_what_needs_pages(arch, what):
    """What needs paged, rewindable or left-padded KV refuses the SSM and
    hybrid families, as the JAX package does (the engine refusals are
    held against the JAX engine's)."""
    cfg = tconfigs.get_smoke_config(arch)
    tm = TModel(cfg, device="cpu")
    qc = TQC(mode="lut_infer", lut_dtype="int8")
    params = tm.init(torch.Generator().manual_seed(0), qc)
    if what in ("kv_quant", "spec_decode", "batch_engine"):
        jm = JModel(jconfigs.get_smoke_config(arch))
        t_kw, j_kw = {}, {}
        if what == "kv_quant":
            qc_t, qc_j = qc.replace(kv_quant="vq"), JQC(
                mode="lut_infer", lut_dtype="int8", kv_quant="vq")
        else:
            qc_t, qc_j = qc, JQC(mode="lut_infer", lut_dtype="int8")
        if what == "spec_decode":
            from repro.serve import SpecConfig as JSpecConfig
            t_kw["spec_decode"] = SpecConfig(k=2, drafter="ngram")
            j_kw["spec_decode"] = JSpecConfig(k=2, drafter="ngram")
        if what == "batch_engine":
            from repro.serve import BatchToCompletionEngine as JBatch
            make_t, make_j = BatchToCompletionEngine, JBatch
        else:
            make_t, make_j = Engine, JEngine
        with pytest.raises(ValueError) as ej:
            make_j(jm, {}, qc_j, **j_kw)
        with pytest.raises(ValueError) as et:
            make_t(tm, params, qc_t, **t_kw)
        assert str(et.value).split(";")[0] == str(ej.value).split(";")[0]
    elif what == "verify_paged":
        kv = tm.init_paged_cache(MAX_SEQ, PS, 4, num_slots=2)
        with pytest.raises(NotImplementedError, match="rewindable"):
            tm.verify_paged(params, torch.zeros((2, 3), dtype=torch.int32),
                            kv, torch.full((2, 4), -1, dtype=torch.int32),
                            torch.tensor([3, -1], dtype=torch.int32),
                            torch.tensor([3, 0], dtype=torch.int32), qc)
    elif what == "dense_cache":
        with pytest.raises(NotImplementedError, match="continuous Engine"):
            tm.init_cache(2, MAX_SEQ)
    else:
        from repro_torch.core.kv_codebook import KVCodebook
        cb = KVCodebook.fit(torch.randn(1, 8, 1, 8), torch.randn(1, 8, 1, 8),
                            v=4, c=2)
        with pytest.raises(NotImplementedError, match="recurrent state"):
            tm.init_paged_cache(MAX_SEQ, PS, 4, codebook=cb, num_slots=2)
        with pytest.raises(ValueError, match="num_slots"):
            tm.init_paged_cache(MAX_SEQ, PS, 4)


def test_router_serves_an_ssm_model():
    """Two replicas of mamba2-smoke behind the router: every request is
    served with the greedy tokens one engine gives it, both replicas take
    work, and prefix affinity reports no reuse (no pages)."""
    *_, tm, params_t, qc_t = _carry("mamba2-2.7b", 13)
    vocab = tm.cfg.vocab_size

    def make(p, n):
        return Request(tokens=p, max_new_tokens=n)
    router = ReplicaRouter([Engine(tm, params_t, qc_t, **ENGINE_KW)
                            for _ in range(2)])
    got = _serve(router, make, vocab)
    want = _serve(Engine(tm, params_t, qc_t, **ENGINE_KW), make, vocab)
    assert all(r.done for r in got)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(e.emitted_tokens > 0 for e in router.engines)
    assert all(e.kv.match_prefix(got[2].tokens).tokens == 0
               for e in router.engines)


# ---------------------------------------------------------------------------
# params: conversion, LUT precompute, init
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_blocks_and_shared_block(arch):
    """The stacked Mamba2 blocks become one dict a layer and the hybrid's
    unstacked shared block comes over as it is, every leaf bit for bit
    with its dtype; the port's own init gives the same tree (keys, shapes
    and dtypes; lut_infer: no dense weight)."""
    jm, params_j, _, tm, params_t, qc_t = _carry(arch, 14)
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    assert ("shared_attn" in params_t) == (arch == "zamba2-1.2b")
    for li, block in enumerate(params_t["blocks"]):
        for path, leaf in _leaves(block):
            ref = tree["blocks"]
            for k in path:
                ref = ref[k]
            assert leaf.dtype == {np.dtype(np.int8): torch.int8}.get(
                ref.dtype, torch.float32)
            np.testing.assert_array_equal(_np(leaf), ref[li])
    for key in params_t:
        if key == "blocks":
            continue
        for path, leaf in _leaves(params_t[key]):
            ref = tree[key]
            for k in path:
                ref = ref[k]
            np.testing.assert_array_equal(_np(leaf), ref)
    own = tm.init(torch.Generator().manual_seed(0), qc_t)

    def spec(t):
        return {p: (tuple(v.shape), v.dtype) for p, v in _leaves(t)
                if p[-1] != "w"}
    assert own.keys() == params_t.keys()
    for lt, lr in zip(own["blocks"], params_t["blocks"]):
        assert spec(lt) == spec(lr)
    if "shared_attn" in own:
        assert spec(own["shared_attn"]) == spec(params_t["shared_attn"])


@pytest.mark.parametrize("arch", ARCHS)
def test_precompute_model_walks_mamba2_leaves_like_jax(arch):
    """The port's ``precompute_model`` on a lut_train tree builds every
    Mamba2 and shared-block LUT as the JAX package's does (int8 tables
    and scales equal) and passes the other leaves through untouched."""
    jm = JModel(jconfigs.get_smoke_config(arch))
    train = jm.init(jax.random.PRNGKey(15), JQC(mode="lut_train"))
    qc_j = JQC(mode="lut_infer", lut_dtype="int8")
    want = jax.tree_util.tree_map(np.asarray, jprecompute(train, qc_j))
    cfg = tconfigs.get_smoke_config(arch)
    src = params_from_numpy(jax.tree_util.tree_map(np.asarray, train), cfg,
                            device="cpu")
    got = precompute_model(src, TQC(mode="lut_infer", lut_dtype="int8"))
    for li, block in enumerate(got["blocks"]):
        for name in NONPROJ:
            assert block[name] is src["blocks"][li][name]
        for name in ("in_proj", "out_proj"):
            for key in ("lut", "lut_scale"):
                np.testing.assert_array_equal(
                    _np(block[name][key]), want["blocks"][name][key][li])
    if "shared_attn" in got:
        for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                            ("mlp", ("wg", "wu", "wd"))):
            assert got["shared_attn"][part]["norm"] is \
                src["shared_attn"][part]["norm"]
            for name in names:
                np.testing.assert_array_equal(
                    _np(got["shared_attn"][part][name]["lut"]),
                    want["shared_attn"][part][name]["lut"])


def test_config_copies_and_derived_properties():
    for arch in ARCHS:
        for name in ("get_config", "get_smoke_config"):
            j = getattr(jconfigs, name)(arch)
            t = getattr(tconfigs, name)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            for prop in ("d_inner", "ssm_nheads", "is_attention_free",
                         "pure_full_attention"):
                assert getattr(t, prop) == getattr(j, prop), (arch, prop)
    full = tconfigs.get_config("mamba2-2.7b")
    # in_proj 2560 -> 10576 = 2 x 5120 + 2 x 128 + 80 (z, xBC, dt)
    assert (full.d_inner, full.ssm_nheads) == (5120, 80)
    assert 2 * full.d_inner + 2 * full.ssm_state + full.ssm_nheads == 10576
    assert TModel(tconfigs.get_config("zamba2-1.2b"),
                  device="cpu").num_attn_slots == 6
