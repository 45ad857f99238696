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
None) attends the fresh K/V alone through the same plain softmax as a
prefill chunk; the JAX package's block-local fast path for windowed layers
(``_sdpa_local``) computes the same function and is not ported.
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
``_sdpa``; its projections still run B1). The hybrid family's shared
block reads a slot-dense cache: its prefill chunk takes the same dense
path, and its decode step, one token a slot at per-slot positions, the
two-part softmax ``_sdpa_decode_combine`` (plain torch, as the JAX
package's XLA form). Where the JAX package switches to a chunked
online softmax past ``attn_chunk`` key rows (``attn_impl="chunked"``),
the port computes the same function in one softmax. The vlm family's
prefix-LM term (:func:`mask_tile`: its image patches attend each other
both ways) reaches training's whole-sequence path and a dense cache's
prefill; decode passes 0, as the JAX package's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.kv_codebook import kv_decode
from repro_torch.core.lut import QuantConfig, lut_linear_apply, lut_linear_row
from repro_torch.kernels.flash_decode import (combine_splits,
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
            mask: torch.Tensor, tp=None, d: Optional[int] = None
            ) -> torch.Tensor:
    """Grouped queries qg (B,S,KVH,G,D) against k/v (B,T,KVH,D): scores
    in float32 scaled by D^-0.5, masked to -1e30 where ``mask`` (broadcast
    to (B,KVH,G,S,T)) is false, softmax, then probabilities in v's type.
    Returns (B,S,KVH,G,D). With ``tp`` the last dim is the rank's slice
    of a head_dim ``d``: the partial scores are all-reduced over it
    before the scale (the head_dim layout, ``_attention_hd``)."""
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    if tp is not None:
        scores = tp.all_reduce(scores)
    scores = scores * ((d or qg.shape[-1]) ** -0.5)
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


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
          window: int, kv_start: Optional[torch.Tensor] = None,
          prefix_len: int = 0, tp=None, hd: Optional[int] = None
          ) -> torch.Tensor:
    """Grouped-query attention of a chunk: q (B,S,H,D) at absolute
    positions q_offset.., k/v (B,T,KVH,D) at positions 0..T-1
    (``_attend`` under :func:`mask_tile`). kv_start: optional (B,) first
    valid key position of each row; keys before it are masked after the
    prefix term (the left-padded prompts of the batch-to-completion
    engine). ``tp`` / ``hd``: q and k hold the rank's slice of head_dim
    ``hd`` (``_attend``)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qi = torch.arange(s, device=q.device) + q_offset
    kj = torch.arange(t, device=q.device)
    mask = mask_tile(qi, kj, window, prefix_len)                 # (s, t)
    if kv_start is not None:                                     # (B, s, t)
        mask = mask[None] & (kj[None, None, :]
                             >= kv_start.to(q.device).long()[:, None, None])
        mask = mask[:, None, None]
    out = _attend(q.reshape(b, s, kvh, h // kvh, d), k, v, mask, tp, hd)
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
                  seq_rows: Optional[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`attention` when the kv heads do not divide the model axis
    (the reference's fallback, ``_kv_model_axes``): wq / wk / wv keep
    their contiguous column shards, the dense cache holds every kv head's
    head_dim slice of the rank, wo stays row-parallel.

    q, k and v are all-gathered to whole heads (RoPE rotates pairs across
    the head_dim), and the rank keeps its head_dim slice of the fresh
    K / V rows for the cache. Decode (one token): the one-device decode's
    rows and arithmetic on the rank's slice, the partial scores
    all-reduced over ``model`` before the softmax (``_attend``; over a
    sequence-sharded cache, :func:`_decode_dense`); the head_dim-sharded
    output is gathered and cut to the rank's columns for wo. A whole
    sequence (training, a prefill from row 0): where the
    reference's Ulysses conditions hold (S divides over the ranks and
    exceeds them) the queries are re-sharded by sequence with an
    all-to-all, each rank attends its rows with whole heads, and an
    all-to-all takes the output back to the rank's columns; otherwise
    every rank attends every row and keeps its columns.
    """
    b, s, _ = x.shape
    tp = tp_current()
    m, r = tp.size, tp.rank
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if torch.is_tensor(q_offset) or (s > 1 and q_offset != 0):
        raise NotImplementedError(
            "the head_dim layout (kv heads that do not divide the model "
            "axis) runs whole sequences from row 0 and one-token dense "
            "decode; per-slot positions and chunks past row 0 (the paged "
            "engine's) are not ported: ROADMAP.md queue A item 11")
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = proj(p["wq"], xn, qc, recon)
    k = proj(p["wk"], xn, qc, recon)
    v = proj(p["wv"], xn, qc, recon)
    positions = (torch.arange(s, device=x.device) + q_offset)[None]
    kf = rope(_whole(k, kvh * hd, tp).reshape(b, s, kvh, hd), positions,
              cfg.rope_theta)
    vf = _whole(v, kvh * hd, tp).reshape(b, s, kvh, hd)
    k_new, v_new = _hd_slice(kf, tp), _hd_slice(vf, tp)
    if k_cache is not None:
        k_new, v_new = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    if s == 1 and k_cache is not None:          # dense decode
        qs = _hd_slice(rope(_whole(q, h * hd, tp).reshape(b, 1, h, hd),
                            positions, cfg.rope_theta), tp)
        if seq_rows is not None:
            o = _decode_dense(qs, k_cache.to(x.dtype), v_cache.to(x.dtype),
                              k_new.to(x.dtype), v_new.to(x.dtype), q_offset,
                              window, kv_start, seq_rows, hd ** -0.5, tp,
                              tp.over("data"))
        else:     # the one-device decode's rows and arithmetic, per slice
            k_all = torch.cat([k_cache[:, :q_offset].to(x.dtype),
                               k_new.to(x.dtype)], 1)
            v_all = torch.cat([v_cache[:, :q_offset].to(x.dtype),
                               v_new.to(x.dtype)], 1)
            o = _sdpa(qs, k_all, v_all, q_offset, window, kv_start, 0, tp,
                      hd)
        out = tp.all_gather(o, -1).reshape(b, 1, h * hd)
    elif s % m == 0 and s > m:                  # Ulysses
        rows = s // m
        qs = (tp.all_to_all(q, 1, -1) if q.shape[-1] != h * hd
              else q.narrow(1, r * rows, rows))
        qs = rope(qs.reshape(b, rows, h, hd), positions[:, r * rows:
                                                        (r + 1) * rows],
                  cfg.rope_theta)
        o = _sdpa(qs, kf.to(x.dtype), vf.to(x.dtype), r * rows, window,
                  kv_start, prefix_len).reshape(b, rows, h * hd)
        if _in_width(p["wo"]) != h * hd:         # back to the rank's columns
            return (lut_linear_row(p["wo"], tp.all_to_all(o, -1, 1), qc,
                                   recon), k_new, v_new)
        out = tp.all_gather(o, 1)
    else:
        qf = rope(_whole(q, h * hd, tp).reshape(b, s, h, hd), positions,
                  cfg.rope_theta)
        out = _sdpa(qf, kf.to(x.dtype), vf.to(x.dtype), 0, window,
                    kv_start, prefix_len).reshape(b, s, h * hd)
    return _row_out(p["wo"], out, qc, recon, tp), k_new, v_new


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
              prefix_len: int = 0, seq_rows: Optional[int] = None
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
        (the batch-to-completion engine, the hybrid's shared block): at
        an int ``q_offset`` every row sits there, rows [0, q_offset) come
        from the cache and the chunk's own K/V are fresh, as a prefill
        chunk's (decode too: S == 1 attends in plain torch, as the JAX
        package's dense decode); at a (B,) ``q_offset`` with S == 1 each
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

    Under tensor parallelism (a rank of ``parallel.collectives``) the
    rank computes its own heads: ``wq`` / ``wk`` / ``wv`` hold its
    columns, the pool its kv heads, and ``wo`` is row-parallel. B2 / B5
    split the pages as the one-device launch over every kv head does, so
    each head's sums run in the same order as on one device. Where the kv
    heads do not divide the model axis, the head_dim layout
    (:func:`_attention_hd`; whole sequences and dense decode only).

    Returns: (out (B, S, D), k_new, v_new (B, S, KVH, HD)).
    """
    b, s, _ = x.shape
    tp = tp_current()
    if hd_fallback(cfg, tp.size):
        if phys is not None:
            raise NotImplementedError(
                "the paged pool under the head_dim layout (kv heads that "
                "do not divide the model axis: B2 / B5 would need a "
                "head_dim-split form) is not ported: ROADMAP.md queue A "
                "item 11")
        return _attention_hd(p, x, cfg, qc, q_offset, k_pages, v_pages,
                             window, kv_start, recon, prefix_len, seq_rows)
    h, kvh, hd = (cfg.num_heads // tp.size, cfg.num_kv_heads // tp.size,
                  cfg.head_dim)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = proj(p["wq"], xn, qc, recon)
    k = proj(p["wk"], xn, qc, recon)
    v = proj(p["wv"], xn, qc, recon)
    verify = s > 1 and torch.is_tensor(q_offset)
    if torch.is_tensor(q_offset):       # per-slot: decode (S = 1) or verify
        positions = q_offset[:, None] + torch.arange(s, device=x.device)
    else:
        positions = (torch.arange(s, device=x.device) + q_offset)[None]
    q = rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, kvh, hd)
    if k_pages is None:     # no cache: the sequence attends itself
        if torch.is_tensor(q_offset) or q_offset != 0 or phys is not None:
            raise ValueError("attention without a cache runs the whole "
                             "sequence from position 0")
        out = _sdpa(q, k, v, 0, window, prefix_len=prefix_len).reshape(
            b, s, h * hd)
        return lut_linear_row(p["wo"], out, qc, recon), k, v
    if codebook is None:
        k_new, v_new = k.to(k_pages.dtype), v.to(v_pages.dtype)
    else:                   # code pool: the fresh rows stay fp
        k_new, v_new = k, v
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
                            tp.over("data")).reshape(b, s, h * hd)
    elif phys is None:      # dense cache: rows [0, q_offset) + the chunk
        k_all = torch.cat([k_pages[:, :q_offset].to(x.dtype),
                           k_new.to(x.dtype)], 1)
        v_all = torch.cat([v_pages[:, :q_offset].to(x.dtype),
                           v_new.to(x.dtype)], 1)
        out = _sdpa(q, k_all, v_all, q_offset, window, kv_start,
                    prefix_len).reshape(b, s, h * hd)
    elif s == 1:
        split = None if tp.size == 1 else split_pages_for(
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
                               window)
        else:
            k_all = torch.cat([k_old.to(x.dtype), k_new.to(x.dtype)], 1)
            v_all = torch.cat([v_old.to(x.dtype), v_new.to(x.dtype)], 1)
            out = _sdpa(q, k_all, v_all, q_offset, window).reshape(
                b, s, h * hd)
    return lut_linear_row(p["wo"], out, qc, recon), k_new, v_new


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
