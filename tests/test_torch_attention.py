"""Port parity for bounded-memory attention: ``layers._sdpa`` in its
chunked form (the reference's ``_sdpa_chunked``, an online softmax over
key chunks from row 0) and its backward, the block-local window path
(``_sdpa_local``), a dense cache's one-token decode over a view of its
rows (``_sdpa_decode``, the reference's naive ``_sdpa`` at S == 1), and
whole smoke models that take them, against the JAX package on the same
numpy inputs, on the CPU. The JAX functions are plain XLA here.

Cases: causal, a window, a prefix, left-padded ``kv_start``, queries
past row 0 (``q_offset``), GQA, T not a multiple of the chunk, and
leading chunks that every query's window leaves out (skipped: the
reference's ``alpha`` = 0 reset wipes them). Rows that see no key at
all (left padding before ``kv_start``) are garbage in both and are left
out of the comparison; the gradients' cotangent is zero there.

Tolerances (float32): outputs at 1e-5, gradients at 1e-4, model logits
and losses at 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK = 8

#: (name, b, s, t, h, kvh, d, q_offset, window, prefix_len, kv_start,
#:  chunk)
CASES = [
    ("causal, T = 40 over chunks of 16", 2, 40, 40, 4, 2, 16, 0, 0, 0,
     None, 16),
    ("window 10, chunks of 8", 2, 40, 40, 4, 2, 16, 0, 10, 0, None, 8),
    ("prefix 12", 2, 40, 40, 4, 4, 16, 0, 0, 12, None, 16),
    ("kv_start left padding", 2, 40, 40, 4, 2, 16, 0, 0, 0, [0, 13], 16),
    ("q_offset 20, T = 45 past the last query", 2, 8, 45, 4, 2, 16, 20, 0,
     0, None, 16),
    ("q_offset 32, window 6: three leading chunks masked", 2, 8, 40, 6, 2,
     16, 32, 6, 0, None, 8),
    ("GQA 8 / 2, window 5 and kv_start", 3, 24, 24, 8, 2, 8, 0, 5, 0,
     [0, 4, 9], 8),
]


def _np(t):
    return t.detach().cpu().numpy()


def _inputs(seed, b, s, t, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, d)).astype(np.float32)
    return q, k, v, rng


def _seen(b, s, q_offset, kv_start):
    """(B, S) rows that see at least one key."""
    qi = np.arange(s) + q_offset
    if kv_start is None:
        return np.ones((b, s), bool)
    return qi[None, :] >= np.asarray(kv_start)[:, None]


def _jax_sdpa(case):
    _, _, _, _, _, _, _, q_offset, window, prefix_len, kv_start, chunk = case
    ks = 0 if kv_start is None else jnp.asarray(kv_start, jnp.int32)
    return lambda q, k, v: jlayers._sdpa(q, k, v, q_offset, window,
                                         prefix_len, impl="chunked",
                                         chunk=chunk, kv_start=ks)


def _port_sdpa(case, q, k, v):
    _, _, _, _, _, _, _, q_offset, window, prefix_len, kv_start, chunk = case
    ks = None if kv_start is None else torch.tensor(kv_start)
    return tlayers._sdpa(q, k, v, q_offset, window, ks, prefix_len, chunk)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_chunked_forward_matches_jax(case):
    b, s, t, h, kvh, d, q_offset = case[1:8]
    q, k, v, _ = _inputs(1, b, s, t, h, kvh, d)
    want = np.asarray(jax.jit(_jax_sdpa(case))(*map(jnp.asarray,
                                                     (q, k, v))))
    got = _np(_port_sdpa(case, *map(torch.from_numpy, (q, k, v))))
    seen = _seen(b, s, q_offset, case[10])
    np.testing.assert_allclose(got[seen], want[seen], **OUT_TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_chunked_gradients_match_jax_grad(case):
    b, s, t, h, kvh, d, q_offset = case[1:8]
    q, k, v, rng = _inputs(2, b, s, t, h, kvh, d)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    w *= _seen(b, s, q_offset, case[10])[..., None, None]
    fj = _jax_sdpa(case)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fj(q, k, v) * w),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (_port_sdpa(case, tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(_np(got.grad), np.asarray(ref),
                                   **GRAD_TOL)


def test_chunked_backward_saves_no_score_tensor():
    """Under autograd the chunked form keeps its inputs, output and each
    row's max and sum, nothing of size S x T."""
    q, k, v, _ = _inputs(3, 1, 64, 64, 2, 2, 8)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tlayers._sdpa(tq, tk, tv, 0, 0, chunk=8)
    assert out.requires_grad
    assert max(saved) == 64 * 2 * 8           # q, k, v, out: S x H x D


LOCAL_CASES = [(2, 32, 4, 2, 16, 8), (1, 48, 4, 4, 8, 16),
               (2, 24, 6, 3, 8, 12)]


@pytest.mark.parametrize("b,s,h,kvh,d,w", LOCAL_CASES)
def test_local_forward_and_gradients_match_jax(b, s, h, kvh, d, w):
    q, k, v, rng = _inputs(4, b, s, s, h, kvh, d)
    ct = rng.standard_normal((b, s, h, d)).astype(np.float32)
    qkv = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(jax.jit(lambda q, k, v: jlayers._sdpa_local(
        q, k, v, w))(*qkv))
    gj = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jlayers._sdpa_local(q, k, v, w) * ct), argnums=(0, 1, 2)))(*qkv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tlayers._sdpa_local(tq, tk, tv, w)
    np.testing.assert_allclose(_np(got), want, **OUT_TOL)
    (got * torch.from_numpy(ct)).sum().backward()
    for g, ref in zip((tq, tk, tv), gj):
        np.testing.assert_allclose(_np(g.grad), np.asarray(ref), **GRAD_TOL)
    # a rank's rows of the sequence (the Ulysses split): the same rows
    row0 = s // 2 - (s // 2) % w
    part = tlayers._sdpa_local(torch.from_numpy(q[:, row0:]),
                               torch.from_numpy(k), torch.from_numpy(v), w,
                               row0)
    np.testing.assert_allclose(_np(part), want[:, row0:], **OUT_TOL)


@pytest.mark.parametrize("pos,window,kv_start,h,kvh", [
    (29, 0, None, 4, 4), (17, 6, None, 4, 2), (30, 0, [0, 5], 8, 2),
    (7, 3, [2, 0], 4, 1)])
def test_decode_over_a_cache_view_matches_jax_naive(pos, window, kv_start,
                                                    h, kvh):
    """One token at ``pos`` over the rows [0, pos] of a 32-row cache
    (scores 8 rows at a time) against the reference's naive ``_sdpa``
    over all 32 rows (rows past pos masked)."""
    b, t, d = 2, 32, 16
    q, k, v, _ = _inputs(5, b, 1, t, h, kvh, d)
    ks = 0 if kv_start is None else jnp.asarray(kv_start, jnp.int32)
    want = np.asarray(jax.jit(lambda q, k, v: jlayers._sdpa(
        q, k, v, pos, window, 0, impl="naive", kv_start=ks))(
            *map(jnp.asarray, (q, k, v))))
    got = tlayers._sdpa_decode(
        torch.from_numpy(q), torch.from_numpy(k)[:, :pos + 1],
        torch.from_numpy(v)[:, :pos + 1], pos, window,
        None if kv_start is None else torch.tensor(kv_start), CHUNK,
        torch.float32)
    np.testing.assert_allclose(_np(got), want, **OUT_TOL)


def test_peak_temp_grows_with_the_chunk_not_with_t():
    """A forward's peak temp on the meta device (``OpCost``): 64 queries
    at the end of T keys. The chunked form's is the same at T = 512 and
    2048 and grows with the chunk; one softmax's grows with T."""
    def peak(t, chunk):
        q = torch.empty((1, 64, 4, 16), device="meta")
        k = torch.empty((1, t, 4, 16), device="meta")
        with torch.no_grad(), OpCost() as cost:
            tlayers._sdpa(q, k, k, t - 64, 0, chunk=chunk)
        return cost.peak_temp_bytes
    assert peak(512, 64) == peak(2048, 64)
    assert peak(2048, 128) > 1.5 * peak(2048, 64)
    assert peak(2048, None) > 3 * peak(512, None) > 3 * peak(512, 64)


# ---------------------------------------------------------------------------
# whole smoke models
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    """A JAX and a port smoke model of ``arch`` at ``attn_impl="chunked"``
    with chunks of CHUNK rows, the port's dense params carried to JAX."""
    kw = {"attn_impl": "chunked", "attn_chunk": CHUNK, **kw}
    cfg = tconfigs.get_smoke_config(arch).replace(**kw)
    jm = JModel(jconfigs.get_smoke_config(arch).replace(**kw))
    tm = TModel(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(7), TQC(mode="dense"))
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      params_to_numpy(params, cfg))
    return jm, params_j, tm, params


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma3-4b"])
def test_model_forward_and_loss_match_jax(arch):
    """32 tokens, chunks of 8: qwen's layers take the online softmax;
    gemma3's five windowed layers the block-local path and its global
    layer the online softmax, as the JAX package's grouped layer loop
    does."""
    jm, params_j, tm, params = _pair(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 32)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(toks)}
    lj, loss_j = jax.jit(lambda p, b: (jm.forward(p, b, JQC())[0],
                                       jm.loss(p, b, JQC())[0]))(params_j,
                                                                 batch_j)
    lt, _ = tm.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **MODEL_TOL)
    loss_t, _ = tm.loss(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **MODEL_TOL)


@pytest.mark.parametrize("arch,pad", [("qwen1.5-4b", [0, 3]),
                                      ("gemma3-4b", None)])
def test_dense_cache_prefill_and_decode_chain_match_jax(arch, pad):
    """A 32-row dense cache (more rows than a chunk): a 16-token prefill
    (qwen left-padded: the online softmax with ``kv_start``; gemma3 the
    block-local path) and 6 decode steps, each over a view of the rows
    written so far."""
    jm, params_j, tm, params = _pair(arch)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    pad_j = None if pad is None else jnp.asarray(pad, jnp.int32)
    cj = jm.init_cache(2, 32)
    ct = tm.init_cache(2, 32)
    prefill = jax.jit(lambda p, b, c: jm.prefill(p, b, c, JQC(),
                                                 pad_lens=pad_j))
    decode = jax.jit(lambda p, t, c: jm.decode(p, t, c, JQC(),
                                               pad_lens=pad_j))
    lj, cj = prefill(params_j, {"tokens": jnp.asarray(toks)}, cj)
    lt, ct = tm.prefill(params, {"tokens": torch.from_numpy(toks)}, ct,
                        pad_lens=pad_t)
    for step in range(7):
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MODEL_TOL,
                                   err_msg=f"step {step}")
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        lj, cj = decode(params_j, jnp.asarray(nxt), cj)
        lt, ct = tm.decode(params, torch.from_numpy(nxt), ct,
                           pad_lens=pad_t)


def test_paged_prefill_chunks_past_attn_chunk_match_jax():
    """Three 8-token prefill chunks of one slot whose table spans 32 rows
    (the reference's T, past a chunk of 8): the online softmax over the
    slot's cached rows and the chunk, at positions 0, 8 and 16, the last
    one right-padded."""
    jm, params_j, tm, params = _pair("qwen1.5-4b")
    table = np.array([[3, 0, 2, 1], [-1, -1, -1, -1]], np.int32)
    kv_j = jm.init_paged_cache(2, 32, 8, num_pages=5)
    kv_t = tm.init_paged_cache(32, 8, 5)
    pf = jax.jit(lambda p, t, kv, pos, n: jm.prefill_paged(
        p, t, kv, jnp.asarray(table), 0, pos, n, JQC()))
    prompt = np.random.default_rng(10).integers(
        0, tm.cfg.vocab_size, 21).astype(np.int32)
    for pos in (0, 8, 16):
        chunk = prompt[pos:pos + 8]
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(chunk)] = chunk
        lj, kv_j = pf(params_j, jnp.asarray(toks), kv_j, pos, len(chunk))
        lt = tm.prefill_paged(params, torch.from_numpy(toks), kv_t,
                              torch.from_numpy(table), 0, pos, len(chunk))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MODEL_TOL,
                                   err_msg=f"chunk at {pos}")
