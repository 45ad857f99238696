"""Model building blocks: RMSNorm, RoPE, paged attention, SwiGLU MLP
(port of ``repro.models.layers``, dense family, ``head_layout="heads"``).

Every projection routes through :func:`proj`, a LutLinear, so the paper's
VQ-AMM technique is a switch for every projection (``QuantConfig.mode``).
Attention is ported for the three paths paged serving runs: a prefill
chunk over the slot's cached rows plus the chunk itself (plain matmul and
masked softmax, as the JAX package's naive ``_sdpa``); single-token decode
straight off the page pool (``kernels.flash_decode.flash_decode_paged``,
kernel B2, or B5 over a pool of centroid codes); and the speculative
verify, T proposed tokens per slot at per-slot positions over the
committed rows (``_sdpa_verify``, plain torch as the JAX package's XLA
form). The batch-to-completion engine's dense cache takes the prefill
path for its prefill and its decode steps, with a ``kv_start`` mask over
the left padding of each row (plain torch, as the JAX package's dense
``_sdpa``; its projections still run B1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.kv_codebook import kv_decode
from repro_torch.core.lut import QuantConfig, lut_linear_apply
from repro_torch.kernels.flash_decode import flash_decode_paged

Params = Dict


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
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


def proj(p: Params, x: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """One LutLinear projection."""
    return lut_linear_apply(p, x, qc)


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Grouped queries qg (B,S,KVH,G,D) against k/v (B,T,KVH,D): scores
    in float32 scaled by D^-0.5, masked to -1e30 where ``mask`` (broadcast
    to (B,KVH,G,S,T)) is false, softmax, then probabilities in v's type.
    Returns (B,S,KVH,G,D)."""
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * (qg.shape[-1] ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
          window: int, kv_start: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Grouped-query attention of a chunk: q (B,S,H,D) at absolute
    positions q_offset.., k/v (B,T,KVH,D) at positions 0..T-1
    (``_attend`` under a causal, optionally windowed mask). kv_start:
    optional (B,) first valid key position of each row; keys before it
    are masked (the left-padded prompts of the batch-to-completion
    engine)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qi = torch.arange(s, device=q.device) + q_offset
    kj = torch.arange(t, device=q.device)
    mask = kj[None, :] <= qi[:, None]                            # (s, t)
    if window > 0:
        mask = mask & (kj[None, :] > qi[:, None] - window)
    if kv_start is not None:                                     # (B, s, t)
        mask = mask[None] & (kj[None, None, :]
                             >= kv_start.to(q.device).long()[:, None, None])
        mask = mask[:, None, None]
    out = _attend(q.reshape(b, s, kvh, h // kvh, d), k, v, mask)
    return out.reshape(b, s, h, d)


def _sdpa_verify(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """Multi-token verify over a read-only cache plus the proposed tokens.

    Query t of row b sits at absolute position pos[b] + t and attends (a)
    the committed cache rows < pos[b], windowed against its own absolute
    position, and (b) the fresh tokens 0..t of its row, whose K/V are
    not in the cache yet. Cache rows >= pos[b] hold draft or stale KV and
    are masked. A pos = -1 lane masks every cache row and attends only
    its own fresh tokens (its output is discarded by the caller).

    q (B,S,H,D); k_cache/v_cache (B,T,KVH,D); k_new/v_new (B,S,KVH,D);
    pos (B,) int. Attends through ``_attend``. Returns (B, S, H*D) in q's
    type.
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
                  torch.cat([v_cache, v_new], 1), mask[:, None, None])
    return out.reshape(b, s, h * d).to(q.dtype)


def _paged_view(pages: torch.Tensor, phys: torch.Tensor,
                n_tokens: int) -> torch.Tensor:
    """Rows [0, n_tokens) of each slot, gathered from one layer's pool.
    pages (P+1, page, KVH, HD), phys (B, NP) -> (B, n_tokens, KVH, HD)."""
    ps = pages.shape[1]
    n_pages = -(-n_tokens // ps)
    view = pages[phys[:, :n_pages].long()]          # (B, n, page, KVH, HD)
    b = phys.shape[0]
    return view.reshape(b, n_pages * ps, *pages.shape[2:])[:, :n_tokens]


def attention(p: Params, x: torch.Tensor, cfg, qc: QuantConfig, q_offset,
              k_pages: torch.Tensor, v_pages: torch.Tensor,
              phys: Optional[torch.Tensor], window: int = 0,
              codebook: Optional[Params] = None,
              kv_start: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-norm GQA attention over one layer of the paged pool, or of a
    dense cache.

    The pool (or cache) is read only; the fresh K/V rows come back for
    the caller to write: in the pool's type for an fp pool, in x's type
    for a code pool (the caller encodes them).

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
        (the batch-to-completion engine): every row sits at the int
        ``q_offset``, rows [0, q_offset) come from the cache and the
        chunk's own K/V are fresh, as a prefill chunk's (decode too: S
        == 1 attends in plain torch, as the JAX package's dense decode).
      phys: (B, NP) trash-redirected physical page ids, or None.
      window: 0 = global attention, >0 = sliding window.
      codebook: this layer's slice of the KV codebook ({"zk": (nc, c, v),
        "zv", "sk": (KVH,), "sv"}) when the pool holds uint8 codes
        (P+1, page, KVH, nc); None for an fp pool.
      kv_start: optional (B,) first valid cache row of each row (dense
        cache only): rows before it hold left padding and are masked.

    Returns: (out (B, S, D), k_new, v_new (B, S, KVH, HD)).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = proj(p["wq"], xn, qc)
    k = proj(p["wk"], xn, qc)
    v = proj(p["wv"], xn, qc)
    verify = s > 1 and torch.is_tensor(q_offset)
    if torch.is_tensor(q_offset):       # per-slot: decode (S = 1) or verify
        positions = q_offset[:, None] + torch.arange(s, device=x.device)
    else:
        positions = (torch.arange(s, device=x.device) + q_offset)[None]
    q = rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, kvh, hd)
    if codebook is None:
        k_new, v_new = k.to(k_pages.dtype), v.to(v_pages.dtype)
    else:                   # code pool: the fresh rows stay fp
        k_new, v_new = k, v
    if phys is None:        # dense cache: rows [0, q_offset) + the chunk
        k_all = torch.cat([k_pages[:, :q_offset].to(x.dtype),
                           k_new.to(x.dtype)], 1)
        v_all = torch.cat([v_pages[:, :q_offset].to(x.dtype),
                           v_new.to(x.dtype)], 1)
        out = _sdpa(q, k_all, v_all, q_offset, window, kv_start).reshape(
            b, s, h * hd)
    elif s == 1:
        out = flash_decode_paged(q, k_pages, v_pages, k, v, phys, q_offset,
                                 window=window, codebook=codebook)
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
                               window)
        else:
            k_all = torch.cat([k_old.to(x.dtype), k_new.to(x.dtype)], 1)
            v_all = torch.cat([v_old.to(x.dtype), v_new.to(x.dtype)], 1)
            out = _sdpa(q, k_all, v_all, q_offset, window).reshape(
                b, s, h * hd)
    return proj(p["wo"], out, qc), k_new, v_new


def mlp(p: Params, x: torch.Tensor, cfg, qc: QuantConfig) -> torch.Tensor:
    """Pre-norm SwiGLU MLP."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    g = proj(p["wg"], xn, qc)
    u = proj(p["wu"], xn, qc)
    return proj(p["wd"], torch.nn.functional.silu(g) * u, qc)
