"""Model building blocks: RMSNorm, RoPE, paged attention, SwiGLU MLP
(port of ``repro.models.layers``, ``head_layout="heads"``; used by the
dense, MoE, audio and vlm families' blocks and by the hybrid family's
shared block).

Every projection routes through :func:`proj`, a LutLinear, so the paper's
VQ-AMM technique is a switch for every projection (``QuantConfig.mode``).
In ``lut_train`` each projection appends its reconstruction loss to the
``recon`` list the caller passes (the JAX package returns it beside each
output and sums ``r1 + r2 + r3 + r4``); serving passes none.
The whole-sequence path of training (no cache, ``q_offset`` 0: ``k_pages``
None) attends the fresh K/V alone. Attention is ported for the three
paths paged serving runs: a prefill chunk over the slot's cached rows
plus the chunk itself (plain torch, as the JAX package's ``_sdpa``);
single-token decode straight off the page pool
(``kernels.flash_decode.flash_decode_paged``, kernel B2, or B5 over a
pool of centroid codes); and the speculative verify, T proposed tokens
per slot at per-slot positions over the committed rows (``_sdpa_verify``,
plain torch as the JAX package's XLA form). The batch-to-completion
engine's dense cache (its projections still run B1) is written first and
then read as a view of its rows, as the JAX package's
``dynamic_update_slice``: its prefill attends like a whole sequence (a
``kv_start`` mask over the left padding of each row), its decode step
takes the JAX package's naive one softmax over the view
(:func:`_sdpa_decode`: float32 scores a chunk of keys at a time, no
float32 copy of the whole cache). The hybrid family's shared block reads
a slot-dense cache: its prefill chunk takes the same dense path, and its
decode step, one token a slot at per-slot positions, the two-part
softmax ``_sdpa_decode_combine`` (plain torch, as the JAX package's XLA
form).

Where the JAX package takes its chunked online softmax
(``attn_impl="chunked"``, more key rows than ``attn_chunk``, several
queries: :func:`attn_chunk`, with the JAX package's T for each path),
the port takes it too (:class:`_ChunkedAttention`: its arithmetic and
rounding, memory bounded by a chunk, and a backward that recomputes a
chunk at a time); where it takes its block-local window path
(``_sdpa_local``: a whole sequence from row 0 in a grouped local:global
layer loop, :func:`local_path`), the port takes it too. Elsewhere one
softmax (``_attend``). All of it is plain torch: no attention library
call. The vlm family's prefix-LM term (:func:`mask_tile`: its image
patches attend each other both ways) reaches training's whole-sequence
path and a dense cache's prefill; decode passes 0, as the JAX package's
does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.kv_codebook import kv_decode
from repro_torch.core.lut import QuantConfig, lut_linear_apply, lut_linear_row
from repro_torch.kernels.flash_decode import (combine_splits,
                                              flash_decode_hd_attend,
                                              flash_decode_hd_scores,
                                              flash_decode_paged,
                                              split_pages_for)
from repro_torch.parallel.collectives import current as tp_current

Params = Dict


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rms_norm_sharded(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                     tp) -> torch.Tensor:
    """:func:`rms_norm` of a full (all-gathered) ``x``, returning only the
    rank's even slice of the last dim, with ``gamma`` that slice's gain:
    bit for bit the slice of the one-device norm (its reduction runs over
    the same full row)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = tp.shard(xf * torch.rsqrt(var + eps), -1)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding (rotate-half). x (B, S, H, D), positions (B, S)."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(angles)[..., None, :]                    # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def proj(p: Params, x: torch.Tensor, qc: QuantConfig,
         recon: Optional[List[torch.Tensor]] = None,
         shared: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One LutLinear projection (its lut_train recon term into
    ``recon``); column-parallel under tensor parallelism (its output
    columns are the rank's; ``shared`` as ``lut_linear_apply`` takes
    it). The row-parallel projections (wo, wd, out_proj) call
    :func:`~repro_torch.core.lut.lut_linear_row`."""
    return lut_linear_apply(p, x, qc, recon, shared)


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, tp=None, hd: Optional[int] = None
            ) -> torch.Tensor:
    """Grouped queries qg (B,S,KVH,G,D) against k/v (B,T,KVH,D) in one
    softmax: scores in float32 scaled by D^-0.5, masked to -1e30 where
    ``mask`` (broadcast to (B,KVH,G,S,T)) is false, softmax, then
    probabilities in v's type. With ``tp`` D is the rank's slice of
    head_dim ``hd`` (the head_dim layout): the partial scores are
    all-reduced before the scale, hd^-0.5. Returns (B,S,KVH,G,D)."""
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    if tp is not None:
        scores = tp.all_reduce(scores)
    scores = scores * ((hd or qg.shape[-1]) ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def mask_tile(qi: torch.Tensor, kj: torch.Tensor, window: int,
              prefix_len: int) -> torch.Tensor:
    """(s, t) boolean attention mask from absolute positions qi (s,) and
    kj (t,): causal, within ``window`` when it is > 0, and ORed with the
    prefix-LM term: positions < ``prefix_len`` attend each other both
    ways (a vlm's image patches)."""
    m = kj[None, :] <= qi[:, None]
    if window > 0:
        m = m & (kj[None, :] > qi[:, None] - window)
    if prefix_len > 0:
        m = m | ((qi[:, None] < prefix_len) & (kj[None, :] < prefix_len))
    return m


def _key_mask(qi: torch.Tensor, kj: torch.Tensor, window: int,
              prefix_len: int, kv_start: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """:func:`mask_tile`, and keys before each row's ``kv_start`` (B,)
    masked after the prefix term: (s, t), or (B, 1, 1, s, t) with
    ``kv_start``, to broadcast over (B, KVH, G, s, t)."""
    mask = mask_tile(qi, kj, window, prefix_len)
    if kv_start is None:
        return mask
    return (mask[None] & (kj[None, None, :] >= kv_start[:, None, None])
            )[:, None, None]


def attn_chunk(cfg, s: int, t: int) -> Optional[int]:
    """The key chunk of the online softmax (``cfg.attn_chunk``) where the
    reference takes it: ``attn_impl="chunked"``, several queries, and
    more key rows ``t`` than a chunk, ``t`` being the reference's (the
    whole sequence; a dense cache's rows; a paged slot's table width x
    page). None: one softmax."""
    if cfg.attn_impl == "chunked" and s > 1 and t > cfg.attn_chunk:
        return cfg.attn_chunk
    return None


def local_path(cfg, s: int, q_offset, window: int, prefix_len: int,
               kv_start) -> bool:
    """Whether the reference takes its block-local path (``_sdpa_local``):
    a windowed layer of a whole sequence from row 0 (``s`` a multiple of
    the window, no prefix, no ``kv_start``) in a layer loop whose window
    is static, which is where its ``_run_blocks`` groups a local:global
    pattern (``global_every`` > 1 layers, a window, at least one
    group)."""
    grouped = (cfg.global_every > 1 and cfg.sliding_window > 0
               and cfg.num_layers >= cfg.global_every)
    return (grouped and window > 0 and s > 1 and not torch.is_tensor(q_offset)
            and q_offset == 0 and s % window == 0 and prefix_len == 0
            and kv_start is None)


def _copy(t: torch.Tensor, dtype: torch.dtype, *perm: int) -> torch.Tensor:
    """A ``dtype`` copy of ``t`` permuted by ``perm``, laid out
    contiguous: one copy op (a key or value chunk's only float32
    copy)."""
    t = t.permute(*perm)
    if t.dtype == dtype:
        return t.contiguous()
    return t.to(dtype, memory_format=torch.contiguous_format)



def _chunk_range(t: int, chunk: int, q_lo: int, q_hi: int, window: int,
                 prefix_len: int) -> range:
    """The key chunks (of ``chunk`` rows from row 0, the last one short)
    that hold a key some query at [q_lo, q_hi] sees. A chunk past the
    last query would add exact zeros; one before the first query's window
    is masked for every row, and the reference's ``alpha`` = 0 reset
    wipes what it adds once a row meets its first key. A row that sees no
    key at all (a left-padded row before its ``kv_start``) is garbage in
    both, and is not held to the reference."""
    first = q_lo - window + 1 if window > 0 and prefix_len <= 0 else 0
    last = min(t, max(q_hi + 1, prefix_len))
    return range(max(first, 0) // chunk, -(-last // chunk))


def _chunk_scores(qf, k, c0, c1, scale, qi, window, prefix_len, kv_start,
                  shape5):
    """Masked float32 scores of the queries qf (B,KVH,G*S,D) against key
    rows [c0, c1) of k (B,T,KVH,D), (B,KVH,G*S,C), and the chunk's mask
    and float32 keys (B,KVH,D,C)."""
    kc = _copy(k[:, c0:c1], torch.float32, 0, 2, 3, 1)
    sc = torch.matmul(qf, kc).mul_(scale)
    mask = _key_mask(qi, torch.arange(c0, c1, device=qf.device), window,
                     prefix_len, kv_start)
    sc.view(*shape5, c1 - c0).masked_fill_(~mask, -1e30)
    return sc, mask, kc


def _online_softmax(qf, k, v, scale, chunk, q_offset, window, prefix_len,
                    kv_start, shape5):
    """The reference's ``_sdpa_chunked`` on queries qf (B,KVH,G*S,D),
    float32: per chunk, m_new = max(m, max sc), alpha = exp(m - m_new),
    p = exp(sc - m_new), l = l alpha + sum p, acc = acc alpha + (p in V's
    type) @ V accumulated in float32. Returns (acc / max(l, 1e-30), m, l),
    each over (B,KVH,G*S)."""
    b, kvh, gs, d = qf.shape
    s = shape5[3]
    t = k.shape[1]
    qi = torch.arange(s, device=qf.device) + q_offset
    m = torch.full((b, kvh, gs), -1e30, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for ci in _chunk_range(t, chunk, q_offset, q_offset + s - 1, window,
                           prefix_len):
        c0, c1 = ci * chunk, min(t, (ci + 1) * chunk)
        sc, _, _ = _chunk_scores(qf, k, c0, c1, scale, qi, window,
                                 prefix_len, kv_start, shape5)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = sc.sub_(m_new[..., None]).exp_()
        l = l * alpha + p.sum(-1)
        pv = torch.matmul(p.to(v.dtype).float(),
                          _copy(v[:, c0:c1], torch.float32, 0, 2, 1, 3))
        acc = acc.mul_(alpha[..., None]).add_(pv)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None], m, l


class _ChunkedAttention(torch.autograd.Function):
    """The online softmax with a backward in bounded memory: the forward
    saves its output and each row's max and sum, the backward recomputes
    each chunk's probabilities P = exp(sc - m) / l (flash attention's
    backward): dV = P^T dO, dS = P (dO V^T - rowsum(dO O)) masked, dQ =
    dS K, dK = dS^T Q, each times the scale. Memory is a chunk's (B, KVH,
    G, S, chunk), never S x T."""

    @staticmethod
    def forward(ctx, qg, k, v, kv_start, chunk, q_offset, window,
                prefix_len):
        b, s, kvh, g, d = qg.shape
        shape5 = (b, kvh, g, s)
        qf = _copy(qg, torch.float32, 0, 2, 3, 1, 4).view(b, kvh, g * s, d)
        out, m, l = _online_softmax(qf, k, v, d ** -0.5, chunk, q_offset,
                                    window, prefix_len, kv_start, shape5)
        ctx.save_for_backward(qg, k, v, kv_start, out, m, l)
        ctx.args = (chunk, q_offset, window, prefix_len)
        return _copy(out.view(b, kvh, g, s, d), qg.dtype, 0, 3, 1, 2, 4)

    @staticmethod
    def backward(ctx, d_out):
        qg, k, v, kv_start, out, m, l = ctx.saved_tensors
        chunk, q_offset, window, prefix_len = ctx.args
        b, s, kvh, g, d = qg.shape
        shape5 = (b, kvh, g, s)
        scale = d ** -0.5
        qf = _copy(qg, torch.float32, 0, 2, 3, 1, 4).view(b, kvh, g * s, d)
        do = _copy(d_out, torch.float32, 0, 2, 3, 1,
                   4).view(b, kvh, g * s, d)
        delta = (do * out).sum(-1, keepdim=True)
        inv_l = 1.0 / l.clamp_min(1e-30)[..., None]
        qi = torch.arange(s, device=qg.device) + q_offset
        dq = torch.zeros_like(qf)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for ci in _chunk_range(k.shape[1], chunk, q_offset, q_offset + s - 1,
                               window, prefix_len):
            c0, c1 = ci * chunk, min(k.shape[1], (ci + 1) * chunk)
            sc, mask, kc = _chunk_scores(qf, k, c0, c1, scale, qi, window,
                                         prefix_len, kv_start, shape5)
            p = sc.sub_(m[..., None]).exp_().mul_(inv_l)
            vc = _copy(v[:, c0:c1], torch.float32, 0, 2, 1, 3)   # (B,KVH,C,D)
            dv[:, c0:c1] = torch.matmul(p.transpose(-1, -2),
                                        do).transpose(1, 2)
            ds = p.mul_(torch.matmul(do, vc.transpose(-1, -2)).sub_(delta))
            ds.view(*shape5, c1 - c0).masked_fill_(~mask, 0.0)
            ds.mul_(scale)
            dq.add_(torch.matmul(ds, kc.transpose(-1, -2)))
            dk[:, c0:c1] = torch.matmul(ds.transpose(-1, -2),
                                        qf).transpose(1, 2)
        dq = _copy(dq.view(b, kvh, g, s, d), qg.dtype, 0, 3, 1, 2, 4)
        return dq, dk, dv, None, None, None, None, None


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
          window: int, kv_start: Optional[torch.Tensor] = None,
          prefix_len: int = 0, chunk: Optional[int] = None, tp=None,
          hd: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention of a chunk: q (B,S,H,D) at absolute
    positions q_offset.., k/v (B,T,KVH,D) at positions 0..T-1, under
    :func:`mask_tile`. kv_start: optional (B,) first valid key position
    of each row; keys before it are masked after the prefix term (the
    left-padded prompts of the batch-to-completion engine).

    ``chunk`` None: one softmax (``_attend``, the reference's naive
    ``_sdpa``). Otherwise the reference's ``_sdpa_chunked``: an online
    softmax over key chunks of ``chunk`` rows from row 0, with a backward
    that recomputes a chunk at a time (:class:`_ChunkedAttention`); the
    output is then in q's type, as the reference's. ``tp`` / ``hd`` as
    :func:`_attend` takes them (a rank's head_dim slice: one softmax over
    the all-reduced scores)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    if kv_start is not None:
        kv_start = kv_start.to(q.device).long()
    if chunk is not None and tp is None:
        out = _ChunkedAttention.apply(qg, k, v, kv_start, chunk, q_offset,
                                      window, prefix_len)
        return out.reshape(b, s, h, d)
    qi = torch.arange(s, device=q.device) + q_offset
    mask = _key_mask(qi, torch.arange(t, device=q.device), window,
                     prefix_len, kv_start)
    return _attend(qg, k, v, mask, tp, hd).reshape(b, s, h, d)


def _sdpa_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, q_offset: int = 0) -> torch.Tensor:
    """The reference's block-local sliding-window attention: each query
    block of ``window`` rows attends its own key block and the one before
    it, S x 2W work and memory. q (B,S,H,D) at positions q_offset.. (a
    multiple of the window; S one too), k/v (B,T,KVH,D) the whole
    sequence from row 0. Scores and softmax in float32, probabilities in
    V's type, products accumulated in float32; the output in q's type."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g, w = h // kvh, window
    nb, n0 = s // w, q_offset // w
    qb = q.reshape(b, nb, w, kvh, g, d).float()

    def pairs(t):            # (b, nb, 2w, kvh, d): block n - 1, then n
        blocks = t.reshape(b, -1, w, kvh, d)
        padded = torch.cat([torch.zeros_like(blocks[:, :1]), blocks], 1)
        return torch.cat([padded[:, n0:n0 + nb],
                          padded[:, n0 + 1:n0 + nb + 1]], 2).float()
    scores = torch.einsum("bnwkgd,bntkd->bnkgwt", qb, pairs(k)) * d ** -0.5
    qi = torch.arange(w, device=q.device)[:, None]
    kt = torch.arange(2 * w, device=q.device)[None, :] - w
    rel = qi - kt
    mask = (rel >= 0) & (rel < w)                         # causal, in window
    first = (torch.arange(nb, device=q.device) + n0 == 0)[:, None, None]
    mask = mask[None] & ~(first & (kt < 0)[None])         # (nb, w, 2w)
    scores = torch.where(mask[None, :, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bnkgwt,bntkd->bnwkgd", probs, pairs(v))
    return out.reshape(b, s, h, d).to(q.dtype)


def _sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: int, window: int, kv_start: Optional[torch.Tensor],
                 chunk: int, dtype: torch.dtype, tp=None,
                 hd: Optional[int] = None) -> torch.Tensor:
    """One-token attention of every row at position ``pos`` over a view of
    a dense cache's rows [0, pos] (B, pos + 1, KVH, D'), the fresh row
    already written: the reference's naive arithmetic in one softmax,
    without a float32 copy of the whole cache in one op. The float32
    scores are taken ``chunk`` rows at a time (each chunk's keys copied
    to float32 alone) into one row; probabilities in ``dtype`` (the
    activations'), then one product with V in ``dtype`` over every row
    for each batch row (its kv heads a batch of strided views of the
    cache: no copy of V). With ``tp`` the last dim is the rank's slice of
    head_dim ``hd``: the partial scores are all-reduced before the scale
    (the head_dim layout). Returns (B, 1, H, D') in ``dtype``."""
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.reshape(b, kvh, g, d).float()
    sc = torch.cat([torch.matmul(qf, _copy(k[:, c0:c0 + chunk].to(dtype),
                                           torch.float32, 0, 2, 3, 1))
                    for c0 in range(0, t, chunk)], -1)      # (B,KVH,G,T)
    if tp is not None:
        sc = tp.all_reduce(sc)
    sc = sc * ((hd or d) ** -0.5)
    qi = torch.full((1,), pos, dtype=torch.long, device=q.device)
    if kv_start is not None:
        kv_start = kv_start.to(q.device).long()
    mask = _key_mask(qi, torch.arange(t, device=q.device), window, 0,
                     kv_start)[..., 0, :]
    sc.masked_fill_(~mask, -1e30)
    probs = torch.softmax(sc, dim=-1).to(dtype)
    vv = v.to(dtype)
    out = torch.stack([torch.matmul(probs[i], vv[i].transpose(0, 1))
                       for i in range(b)])                  # (B,KVH,G,D')
    return out.reshape(b, 1, h, d)


def _sdpa_verify(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: torch.Tensor,
                 window: int, tp=None, hd: Optional[int] = None
                 ) -> torch.Tensor:
    """Multi-token verify over a read-only cache plus the proposed tokens.

    Query t of row b sits at absolute position pos[b] + t and attends (a)
    the committed cache rows < pos[b], windowed against its own absolute
    position, and (b) the fresh tokens 0..t of its row, whose K/V are
    not in the cache yet. Cache rows >= pos[b] hold draft or stale KV and
    are masked. A pos = -1 lane masks every cache row and attends only
    its own fresh tokens (its output is discarded by the caller).

    q (B,S,H,D); k_cache/v_cache (B,T,KVH,D); k_new/v_new (B,S,KVH,D);
    pos (B,) int. Attends through ``_attend`` (``tp`` / ``hd`` as it
    takes them). Returns (B, S, H*D) in q's type.
    """
    b, s, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    qi = torch.arange(s, device=q.device)
    kj = torch.arange(t, device=q.device)
    pos = pos.to(q.device).long()
    mc = kj[None, None, :] < pos[:, None, None]                # (B, 1, T)
    if window > 0:
        q_abs = pos[:, None] + qi[None, :]                     # (B, S)
        mc = mc & (kj[None, None, :] > q_abs[:, :, None] - window)
    ms = qi[None, :] <= qi[:, None]                            # (S, S)
    if window > 0:
        ms = ms & (qi[None, :] > qi[:, None] - window)
    mask = torch.cat([mc.expand(b, s, t), ms[None].expand(b, s, s)], -1)
    out = _attend(q.reshape(b, s, kvh, h // kvh, d),
                  torch.cat([k_cache, k_new], 1),              # (B,T+S,..)
                  torch.cat([v_cache, v_new], 1), mask[:, None, None],
                  tp, hd)
    return out.reshape(b, s, h * d).to(q.dtype)


def _sdpa_decode_combine(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, pos: torch.Tensor,
                         window: int) -> torch.Tensor:
    """One-token decode over a read-only dense cache plus the new token.

    Row b attends its cache rows < pos[b] (windowed against pos[b]) and
    its own fresh token, in two parts combined by an online softmax: the
    cache is never updated here (the caller writes the new row). A pos =
    -1 lane masks every cache row and attends only its fresh token.

    q (B,1,H,D); k_cache/v_cache (B,T,KVH,D); k_new/v_new (B,1,KVH,D);
    pos (B,) int. Scores, probabilities times V and the combine are
    float32 (probabilities rounded to V's type first). Returns (B, 1,
    H*D) in q's type.
    """
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    scale = d ** -0.5
    kj = torch.arange(t, device=q.device)
    pos = pos.to(q.device).long()
    mask = kj[None, :] < pos[:, None]                            # (B, T)
    if window > 0:
        mask = mask & (kj[None, :] > pos[:, None] - window)
    sc = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale
    sc = torch.where(mask[:, None, None, :], sc, torch.full_like(sc, -1e30))
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].float()) * scale
    m = torch.maximum(sc.amax(-1), s_new)                        # (B,KVH,G)
    p_old = torch.exp(sc - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p_old.sum(-1) + p_new
    out = (torch.einsum("bkgt,btkd->bkgd",
                        p_old.to(v_cache.dtype).float(), v_cache.float())
           + p_new[..., None] * v_new[:, 0, :, None, :].float())
    out = out / denom[..., None]
    return out.reshape(b, 1, h * d).to(q.dtype)


def _paged_view(pages: torch.Tensor, phys: torch.Tensor,
                n_tokens: int) -> torch.Tensor:
    """Rows [0, n_tokens) of each slot, gathered from one layer's pool.
    pages (P+1, page, KVH, HD), phys (B, NP) -> (B, n_tokens, KVH, HD)."""
    ps = pages.shape[1]
    n_pages = -(-n_tokens // ps)
    view = pages[phys[:, :n_pages].long()]          # (B, n, page, KVH, HD)
    b = phys.shape[0]
    return view.reshape(b, n_pages * ps, *pages.shape[2:])[:, :n_tokens]


def hd_fallback(cfg, size: int) -> bool:
    """Whether attention over a model axis of ``size`` ranks takes the
    reference's head_dim layout: the kv heads do not divide the axis
    (``parallel.sharding._kv_model_axes``; ``check_tensor_parallel``
    requires head_dim to divide it then)."""
    return size > 1 and bool(cfg.num_kv_heads % size)


def _whole(t: torch.Tensor, n: int, tp) -> torch.Tensor:
    """A column-parallel projection's output, the rank's contiguous
    columns (..., n / ranks), all-gathered to all ``n`` columns; a
    replicated projection's (the JAX rule drops the model axis where
    ``n`` does not divide it) is whole already."""
    return t if t.shape[-1] == n else tp.all_gather(t, -1)


def _hd_slice(t: torch.Tensor, tp) -> torch.Tensor:
    """The rank's even slice of the last (head_dim) dim, contiguous."""
    return tp.shard(t, -1).contiguous()


def _decode_dense(q: torch.Tensor, k_rows: torch.Tensor,
                  v_rows: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, pos: int, window: int,
                  kv_start: Optional[torch.Tensor], row0: int, scale: float,
                  tp, dp) -> torch.Tensor:
    """One-token decode of every row at ``pos`` over a dense cache sharded
    by sequence over ``data`` (``dp``, the data handle): each data rank
    computes the softmax triple (max, sum, probabilities times V) of its
    rows (data rank 0 also the fresh row), and the triples are combined
    across ``data`` in rank order (``kernels.flash_decode.
    combine_splits``, the fold of B2's splits).

    q (B,1,H,D'), k_rows / v_rows (B,T',KVH,D'): this rank's rows of the
    cache (global rows [row0, row0 + T')), k_new / v_new (B,1,KVH,D') the
    fresh row. With the head_dim layout too (``tp`` given) D' is the
    rank's head_dim slice: its partial scores are all-reduced over
    ``model`` into the whole scores. Masks as the one-device decode: rows
    < pos, within ``window``, at or past ``kv_start``. Float32 throughout
    (the probabilities rounded to V's type first). Returns (B,1,H,D') in
    q's type."""
    b, _, h, d = q.shape
    t, kvh = k_rows.shape[1], k_rows.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()

    def scores(eq, keys):
        sc = torch.einsum(eq, qg, keys.float())
        return (sc if tp is None else tp.all_reduce(sc)) * scale

    j = row0 + torch.arange(t, device=q.device)
    mask = (j < pos)[None].expand(b, t)
    if window > 0:
        mask = mask & (j > pos - window)[None]
    if kv_start is not None:
        mask = mask & (j[None] >= kv_start.to(q.device).long()[:, None])
    sc = scores("bkgd,btkd->bkgt", k_rows)
    s_new = scores("bkgd,bkd->bkg", k_new[:, 0])   # every rank collects
    vs = v_rows
    if dp.rank == 0:                          # the fresh row, once
        sc = torch.cat([sc, s_new[..., None]], -1)
        mask = torch.cat([mask, torch.ones((b, 1), dtype=torch.bool,
                                           device=q.device)], -1)
        vs = torch.cat([v_rows, v_new.to(v_rows.dtype)], 1)
    live = mask[:, None, None, :]
    sc = torch.where(live, sc, torch.full_like(sc, -1e30))
    mx = sc.amax(-1)
    pr = torch.where(live, torch.exp(sc - mx[..., None]),
                     torch.zeros_like(sc))
    tri = (mx, pr.sum(-1), torch.einsum("bkgt,btkd->bkgd",
                                        pr.to(vs.dtype).float(),
                                        vs.float()))
    if dp.size > 1:
        packed = torch.cat([tri[0][..., None], tri[1][..., None], tri[2]],
                           -1)
        parts = dp.all_gather(packed[None], 0)
        tri = None
        for part in parts.unbind(0):
            one = (part[..., 0], part[..., 1], part[..., 2:])
            tri = one if tri is None else combine_splits(tri, one)
    out = tri[2] / tri[1][..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _attention_hd(p: Params, x: torch.Tensor, cfg, qc: QuantConfig,
                  q_offset, k_cache: Optional[torch.Tensor],
                  v_cache: Optional[torch.Tensor], window: int,
                  kv_start: Optional[torch.Tensor],
                  recon: Optional[List[torch.Tensor]], prefix_len: int,
                  seq_rows: Optional[int], write) -> torch.Tensor:
    """:func:`attention` over no cache or a dense cache (a whole sequence
    from row 0, a prefill from row 0, one-token decode: what the entry
    points give it) when the kv heads do not divide the model axis (the
    reference's fallback, ``_kv_model_axes``): wq / wk / wv keep their
    contiguous column shards, the dense cache holds every kv head's
    head_dim slice of the rank, wo stays row-parallel.

    q, k and v are all-gathered to whole heads (RoPE rotates pairs across
    the head_dim), and the rank keeps its head_dim slice of the fresh
    K / V rows for the cache. Decode (one token): the fresh row is
    written first, then the one-device decode's rows and arithmetic run
    on the rank's slice of the cache's view (:func:`_sdpa_decode`), the
    partial scores all-reduced over ``model`` before the softmax (over a
    sequence-sharded cache, :func:`_decode_dense`, which reads the cache
    before the write); the head_dim-sharded output is gathered and cut to
    the rank's columns for wo. A whole sequence (training, a prefill from
    row 0) attends with whole heads as :func:`attention` does (the
    block-local path, the chunked online softmax or one softmax): where
    the reference's Ulysses conditions hold (S divides over the ranks and
    exceeds them; for the block-local path each rank's rows a multiple
    of the window too) the queries are re-sharded by sequence with an
    all-to-all, each rank attends its rows, and an all-to-all takes the
    output back to the rank's columns; otherwise every rank attends every
    row and keeps its columns.
    """
    b, s, _ = x.shape
    tp = tp_current()
    m, r = tp.size, tp.rank
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = proj(p["wq"], xn, qc, recon)
    k = proj(p["wk"], xn, qc, recon)
    v = proj(p["wv"], xn, qc, recon)
    positions = (torch.arange(s, device=x.device) + q_offset)[None]
    kf = rope(_whole(k, kvh * hd, tp).reshape(b, s, kvh, hd), positions,
              cfg.rope_theta)
    vf = _whole(v, kvh * hd, tp).reshape(b, s, kvh, hd)
    if k_cache is not None:       # the rank's head_dim slice of the rows
        k_new = _hd_slice(kf, tp).to(k_cache.dtype)
        v_new = _hd_slice(vf, tp).to(v_cache.dtype)
    if s == 1 and k_cache is not None:          # dense decode
        qs = _hd_slice(rope(_whole(q, h * hd, tp).reshape(b, 1, h, hd),
                            positions, cfg.rope_theta), tp)
        if seq_rows is not None:
            o = _decode_dense(qs, k_cache.to(x.dtype), v_cache.to(x.dtype),
                              k_new.to(x.dtype), v_new.to(x.dtype), q_offset,
                              window, kv_start, seq_rows, hd ** -0.5, tp,
                              tp.over("data"))
            write(k_new, v_new)
        else:     # the one-device decode's rows and arithmetic, per slice
            write(k_new, v_new)
            n = q_offset + 1
            o = _sdpa_decode(qs, k_cache[:, :n], v_cache[:, :n], q_offset,
                             window, kv_start, cfg.attn_chunk, x.dtype, tp,
                             hd)
        out = tp.all_gather(o, -1).reshape(b, 1, h * hd)
        return _row_out(p["wo"], out, qc, recon, tp)
    t_ref = s
    if k_cache is not None:
        write(k_new, v_new)
        t_ref = _cache_rows(k_cache, seq_rows, tp)
    local = local_path(cfg, s, q_offset, window, prefix_len, kv_start)
    kf, vf = kf.to(x.dtype), vf.to(x.dtype)

    def attend(qh, row0):
        if local:
            return _sdpa_local(qh, kf, vf, window, row0)
        return _sdpa(qh, kf, vf, row0, window, kv_start, prefix_len,
                     attn_chunk(cfg, s, t_ref))
    rows = s // m
    if s % m == 0 and s > m and not (local and rows % window):   # Ulysses
        qs = (tp.all_to_all(q, 1, -1) if q.shape[-1] != h * hd
              else q.narrow(1, r * rows, rows))
        qs = rope(qs.reshape(b, rows, h, hd), positions[:, r * rows:
                                                        (r + 1) * rows],
                  cfg.rope_theta)
        o = attend(qs, r * rows).reshape(b, rows, h * hd)
        if _in_width(p["wo"]) != h * hd:         # back to the rank's columns
            return lut_linear_row(p["wo"], tp.all_to_all(o, -1, 1), qc,
                                  recon)
        out = tp.all_gather(o, 1)
    else:
        qf = rope(_whole(q, h * hd, tp).reshape(b, s, h, hd), positions,
                  cfg.rope_theta)
        out = attend(qf, 0).reshape(b, s, h * hd)
    return _row_out(p["wo"], out, qc, recon, tp)


def _cache_rows(k_cache: torch.Tensor, seq_rows: Optional[int], tp) -> int:
    """A dense cache's rows, the reference's T: all of them, across the
    data ranks where the cache is sharded by sequence."""
    rows = k_cache.shape[1]
    return rows if seq_rows is None else rows * tp.over("data").size


def _in_width(p: Params) -> int:
    """A projection's local input width (its rows: ``w``'s, or nc x v of
    its centroids)."""
    if "w" in p:
        return p["w"].shape[-2]
    return p["z"].shape[-3] * p["z"].shape[-1]


def _row_out(p: Params, out: torch.Tensor, qc: QuantConfig,
             recon: Optional[List[torch.Tensor]], tp) -> torch.Tensor:
    """A row-parallel projection of a whole (all-gathered) input: the
    rank's contiguous rows into ``lut_linear_row``, or, where the
    projection is replicated (its rows did not divide the model axis),
    the whole input through the one-device projection."""
    if _in_width(p) == out.shape[-1]:
        return lut_linear_apply(p, out, qc, recon)
    return lut_linear_row(p, tp.shard(out, -1).contiguous(), qc, recon)


def attention(p: Params, x: torch.Tensor, cfg, qc: QuantConfig, q_offset,
              k_pages: Optional[torch.Tensor],
              v_pages: Optional[torch.Tensor],
              phys: Optional[torch.Tensor], window: int = 0,
              codebook: Optional[Params] = None,
              kv_start: Optional[torch.Tensor] = None,
              recon: Optional[List[torch.Tensor]] = None,
              prefix_len: int = 0, seq_rows: Optional[int] = None,
              write=None) -> torch.Tensor:
    """Pre-norm GQA attention over one layer of the paged pool, or of a
    dense cache.

    With a pool or a cache, the fresh K/V rows (B, S, KVH, HD) go to
    ``write(k_new, v_new)``: in the pool's type for an fp pool, in x's
    type for a code pool (the writer encodes them). A dense cache at an
    int ``q_offset`` is written first and then read as a view of its rows
    [0, q_offset + S), as the reference's ``dynamic_update_slice``: no
    copy of the cached rows (a sequence-sharded cache's decode,
    :func:`_decode_dense`, reads first); the pool, and a dense cache at
    per-row positions, are read first and written after.

    Args:
      p: layer params {"wq","wk","wv","wo","norm"}.
      x: (B, S, D) residual stream.
      q_offset: prefill (S > 1, B == 1): int, absolute position of the
        chunk's first token; the slot's rows [0, q_offset) come from the
        pool, the chunk's own K/V are fresh. Decode (S == 1): (B,) int32
        per-slot positions (-1 = lane not decoding). Verify (S > 1, a
        (B,) int32 tensor): token t of row b sits at q_offset[b] + t and
        attends the committed rows < q_offset[b] plus fresh tokens 0..t
        (``_sdpa_verify``; -1 = lane not verifying).
      k_pages/v_pages: (P+1, page, KVH, HD) one layer of the pool; with
        ``phys`` None, one layer of a dense cache (B, T, KVH, HD) instead
        (the batch-to-completion engine, the hybrid's shared block): at
        an int ``q_offset`` every row sits there and attends the rows
        [0, q_offset + S) once the chunk is written (:func:`_dense_view`:
        decode in one softmax as the JAX package's dense decode; a chunk
        as a whole sequence); at a (B,) ``q_offset`` with S == 1 each
        row decodes at its own position over its rows < q_offset[b]
        (``_sdpa_decode_combine``). Both None (with ``phys`` None and
        ``q_offset`` 0): no cache, the whole sequence attends itself
        (training's forward).
      phys: (B, NP) trash-redirected physical page ids, or None.
      window: 0 = global attention, >0 = sliding window.
      codebook: this layer's slice of the KV codebook ({"zk": (nc, c, v),
        "zv", "sk": (KVH,), "sv"}) when the pool holds uint8 codes
        (P+1, page, KVH, nc); None for an fp pool.
      kv_start: optional (B,) first valid cache row of each row (dense
        cache only): rows before it hold left padding and are masked.
      recon: lut_train: the list each projection's recon term joins.
      prefix_len: positions < prefix_len attend each other both ways (a
        vlm's image prefix); taken by the paths that see the prefix, the
        one with no cache and a dense cache's chunk at q_offset 0.
      seq_rows: a dense cache sharded by sequence over ``data``
        (``parallel.sharding.cache_pspecs``' branch for a batch smaller
        than the data axes): the global index of this rank's first cache
        row. One-token decode then combines the data ranks' softmax
        triples (:func:`_decode_dense`).
      write: with a pool or a cache, ``write(k_new, v_new)`` stores the
        layer's fresh rows (called once, where the path needs it).

    Under tensor parallelism (a rank of ``parallel.collectives``) the
    rank computes its own heads: ``wq`` / ``wk`` / ``wv`` hold its
    columns, the pool its kv heads, and ``wo`` is row-parallel. B2 / B5
    split the pages as the one-device launch over every kv head does, so
    each head's sums run in the same order as on one device. Where the kv
    heads do not divide the model axis, the head_dim layout: over no
    cache or a dense cache, :func:`_attention_hd`; over the pool q, k and
    v are all-gathered to whole heads, and over an fp pool the rank keeps
    their head_dim slices, which its pool holds: the partial scores are
    all-reduced over ``model`` before the scale and the softmax, and the
    output's slices all-gathered for wo (decode: B2s, the all-reduce,
    B2a; prefill chunks and verify: plain torch, one softmax). A pool of
    codes is replicated under that layout (the reference's
    ``paged_cache_pspecs``): each rank encodes and attends every kv head
    with the whole q (B5 unchanged) and keeps its columns for wo.

    Returns: out (B, S, D).
    """
    b, s, _ = x.shape
    tp = tp_current()
    hd_form = hd_fallback(cfg, tp.size)
    if hd_form and phys is None:
        return _attention_hd(p, x, cfg, qc, q_offset, k_pages, v_pages,
                             window, kv_start, recon, prefix_len, seq_rows,
                             write)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = proj(p["wq"], xn, qc, recon)
    k = proj(p["wk"], xn, qc, recon)
    v = proj(p["wv"], xn, qc, recon)
    verify = s > 1 and torch.is_tensor(q_offset)
    if torch.is_tensor(q_offset):       # per-slot: decode (S = 1) or verify
        positions = q_offset[:, None] + torch.arange(s, device=x.device)
    else:
        positions = (torch.arange(s, device=x.device) + q_offset)[None]
    hd = cfg.head_dim
    att = None      # the head_dim layout's handle: partial scores reduced
    if hd_form:     # whole heads; an fp pool's head_dim slice of them
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        q = _whole(q, h * hd, tp).reshape(b, s, h, hd)
        k = _whole(k, kvh * hd, tp).reshape(b, s, kvh, hd)
        v = _whole(v, kvh * hd, tp).reshape(b, s, kvh, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if codebook is None:
            q, k, v = (_hd_slice(t, tp) for t in (q, k, v))
            att = tp
    else:
        h, kvh = cfg.num_heads // tp.size, cfg.num_kv_heads // tp.size
        q = rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
        k = rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, kvh, hd)
    d = q.shape[-1]                     # head_dim, or the rank's slice

    def out_proj(out):
        """wo: the rank's heads (row-parallel), or under the head_dim
        layout the whole heads' rank columns (:func:`_row_out`)."""
        if not hd_form:
            return lut_linear_row(p["wo"], out.reshape(b, s, h * hd), qc,
                                  recon)
        if att is not None:
            out = tp.all_gather(out.reshape(b, s, h, d), -1)
        return _row_out(p["wo"], out.reshape(b, s, h * hd), qc, recon, tp)

    if k_pages is None:     # no cache: the sequence attends itself
        if torch.is_tensor(q_offset) or q_offset != 0 or phys is not None:
            raise ValueError("attention without a cache runs the whole "
                             "sequence from position 0")
        if local_path(cfg, s, 0, window, prefix_len, None):
            out = _sdpa_local(q, k, v, window)
        else:
            out = _sdpa(q, k, v, 0, window, prefix_len=prefix_len,
                        chunk=attn_chunk(cfg, s, s))
        return out_proj(out)
    if codebook is None:
        k_new, v_new = k.to(k_pages.dtype), v.to(v_pages.dtype)
    else:                   # code pool: the fresh rows stay fp
        k_new, v_new = k, v
    if phys is None and not torch.is_tensor(q_offset) and not (
            s == 1 and seq_rows is not None):
        write(k_new, v_new)   # a dense cache: written, then read as a view
        out = _dense_view(q, k, v, k_new, v_new, k_pages, v_pages, cfg,
                          q_offset, window, kv_start, prefix_len, seq_rows,
                          tp)
        return out_proj(out)
    if phys is None and torch.is_tensor(q_offset):
        # dense cache, one token a row at per-row positions
        if s != 1:
            raise NotImplementedError("a dense cache takes per-row "
                                      "positions for one-token decode only")
        out = _sdpa_decode_combine(q, k_pages.to(x.dtype),
                                   v_pages.to(x.dtype), k.to(x.dtype),
                                   v.to(x.dtype), q_offset, window)
    elif phys is None and s == 1 and seq_rows is not None:
        # dense cache sharded by sequence over data: combine the triples
        out = _decode_dense(q, k_pages.to(x.dtype), v_pages.to(x.dtype),
                            k_new.to(x.dtype), v_new.to(x.dtype), q_offset,
                            window, kv_start, seq_rows, hd ** -0.5, None,
                            tp.over("data"))
    elif s == 1 and att is not None:
        # the head_dim layout's decode: a rank's partial scores (kernel
        # B2s), all-reduced over model, then the softmax and its V slice
        # (kernel B2a)
        sc = flash_decode_hd_scores(q, k_pages, k_new, phys, q_offset,
                                    window=window)
        out = flash_decode_hd_attend(tp.all_reduce(sc), v_pages, v_new,
                                     phys, q_offset, hd ** -0.5, q.dtype,
                                     window=window)
    elif s == 1:
        split = None if tp.size == 1 or hd_form else split_pages_for(
            b, cfg.num_kv_heads, phys.shape[1], codebook is not None)
        out = flash_decode_paged(q, k_pages, v_pages, k, v, phys, q_offset,
                                 window=window, codebook=codebook,
                                 split_pages=split)
    else:
        # prefill reads the slot's rows [0, q_offset); verify reads every
        # row of every slot's table and masks rows >= q_offset[b]
        n_rows = phys.shape[1] * k_pages.shape[1] if verify else q_offset
        k_old = _paged_view(k_pages, phys, n_rows)
        v_old = _paged_view(v_pages, phys, n_rows)
        if codebook is not None:
            # cached rows of a code pool, dequantized: a plain torch op on
            # the card too, as the JAX package computes it in XLA
            # (model._paged_view), not in a Pallas kernel. The fresh rows
            # stay fp.
            k_old = kv_decode(k_old, codebook["zk"], codebook["sk"], x.dtype)
            v_old = kv_decode(v_old, codebook["zv"], codebook["sv"], x.dtype)
        if verify:
            out = _sdpa_verify(q, k_old.to(x.dtype), v_old.to(x.dtype),
                               k.to(x.dtype), v.to(x.dtype), q_offset,
                               window, att, hd)
        else:
            k_all = torch.cat([k_old.to(x.dtype), k_new.to(x.dtype)], 1)
            v_all = torch.cat([v_old.to(x.dtype), v_new.to(x.dtype)], 1)
            out = _sdpa(q, k_all, v_all, q_offset, window, chunk=attn_chunk(
                cfg, s, phys.shape[1] * k_pages.shape[1]), tp=att, hd=hd)
    write(k_new, v_new)
    return out_proj(out)


def _dense_view(q, k, v, k_new, v_new, k_cache, v_cache, cfg, q_offset,
                window, kv_start, prefix_len, seq_rows, tp) -> torch.Tensor:
    """:func:`attention` over a dense cache at an int ``q_offset``, the
    chunk's rows already written: decode in one softmax over the rows
    [0, q_offset] (:func:`_sdpa_decode`); a chunk through the block-local
    path where the reference takes it (the fresh rows), else
    :func:`_sdpa` over the rows [0, q_offset + S) (a sequence-sharded
    cache holds a slice of the rows: its prefill, at q_offset 0, attends
    its own fresh rows). Returns (B, S, H, HD) in x's type."""
    s, dtype = q.shape[1], q.dtype
    if s == 1:
        return _sdpa_decode(q, k_cache[:, :q_offset + 1],
                            v_cache[:, :q_offset + 1], q_offset, window,
                            kv_start, cfg.attn_chunk, dtype)
    if local_path(cfg, s, q_offset, window, prefix_len, kv_start):
        return _sdpa_local(q, k, v, window)
    n = min(q_offset + s, k_cache.shape[1])
    k_all, v_all = ((k_cache[:, :n], v_cache[:, :n]) if seq_rows is None
                    else (k_new, v_new))
    return _sdpa(q, k_all.to(dtype), v_all.to(dtype), q_offset, window,
                 kv_start, prefix_len,
                 attn_chunk(cfg, s, _cache_rows(k_cache, seq_rows, tp)))


def mlp(p: Params, x: torch.Tensor, cfg, qc: QuantConfig,
        recon: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Pre-norm SwiGLU MLP (under tensor parallelism wg / wu
    column-parallel, wd row-parallel; replicated where d_ff does not
    divide the model axis, as the JAX rule drops the axis there)."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    g = proj(p["wg"], xn, qc, recon)
    u = proj(p["wu"], xn, qc, recon)
    hidden = torch.nn.functional.silu(g) * u
    if _in_width(p["wd"]) == cfg.d_ff:           # replicated (or one rank)
        return lut_linear_apply(p["wd"], hidden, qc, recon)
    return lut_linear_row(p["wd"], hidden, qc, recon)
