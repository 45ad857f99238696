"""Plain PyTorch versions of the VQ-AMM kernels and the flash-decode
oracles (port of ``repro.kernels.ref``).

Plain versions, which the CPU path runs and ``chip_smoke.py`` holds the
CUDA kernels against on the card:
  * ``assign_ref``      kernel B3 (``kernels/assign.py``)
  * ``lut_gemm_onehot`` kernel B4 (``kernels/lut_gemm.py``)
  * ``vq_amm_ref``      kernel B1 (``kernels/fused_amm.py``)
Each counts its calls (``.calls``), so a run on the card can show that its
main path never took a plain version. Distances are taken in float32
whatever the input type, as the kernels compute them. Each also takes a
leading expert axis on every operand (the grouped form an MoE layer
calls): a loop over the experts of the ungrouped form, stacked. With
``counts`` (E,) (the live rows of each expert's buffer, clamped to M)
rows past an expert's count come out 0.0 (index 0 for B3), as the
kernels write them; ``most_live`` only plans a kernel's launch and is
ignored here. Neither reads the host.

Oracles, for tests only: ``flash_decode_ref`` (whole-softmax paged decode)
and ``flash_decode_kvq_ref`` (dequantize the code pool, then the same).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.similarity import (Metric, one_hot,
                                         pairwise_distance_subspaces)
from . import _build


def _assign(x, z, metric):
    d = pairwise_distance_subspaces(x.float(), z.float(), metric)
    return torch.argmin(d, dim=-1).to(torch.int32)


def _lut_gemm(idx, lut, scale):
    c = lut.shape[1]
    onehot = one_hot(idx.long(), c, torch.float32)
    out = torch.einsum("mkc,kcn->mn", onehot, lut.to(torch.float32))
    if scale is not None:
        out = out * scale[None, :].to(torch.float32)
    return out


def _per_expert(fn, grouped: bool, *args):
    """fn over the experts of a grouped call (every non-None argument
    with a leading expert axis), stacked; fn itself otherwise."""
    if not grouped:
        return fn(*args)
    return torch.stack([fn(*(a if a is None else a[i] for a in args))
                        for i in range(args[0].shape[0])])


def live_only(out: torch.Tensor, counts: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """``out`` (E, M, ...) (or (M, ...) with counts of one expert) with
    the rows at or past each expert's count set to zero."""
    if counts is None:
        return out
    lead = out if out.dim() >= 3 else out[None]
    live = (torch.arange(lead.shape[1], device=out.device)[None]
            < counts.to(out.device)[:, None])
    shape = live.shape + (1,) * (lead.dim() - 2)
    return torch.where(live.reshape(shape), lead,
                       torch.zeros((), dtype=out.dtype,
                                   device=out.device)).reshape(out.shape)


def assign_ref(x: torch.Tensor, z: torch.Tensor, metric: Metric = "l2",
               counts: Optional[torch.Tensor] = None,
               most_live: Optional[int] = None) -> torch.Tensor:
    """Nearest-centroid assignment per subspace (plain version of B3).

    x (M, nc, v) inputs, z (nc, c, v) centroids -> (M, nc) int32; the
    lowest index wins a tie. Grouped: x (E, M, nc, v), z (E, nc, c, v)
    -> (E, M, nc); with ``counts``, index 0 past each expert's count.
    """
    _build.bump(assign_ref, "calls")
    return live_only(_per_expert(lambda xx, zz: _assign(xx, zz, metric),
                                 x.dim() == 4, x, z), counts)


def lut_gemm_onehot(idx: torch.Tensor, lut: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    counts: Optional[torch.Tensor] = None,
                    most_live: Optional[int] = None) -> torch.Tensor:
    """out[m, n] = sum_k lut[k, idx[m, k], n] (x scale[n]) as a one-hot
    contraction in float32 (plain version of B4). idx (M, nc) int32,
    lut (nc, c, N) float or int8 -> (M, N) float32. Grouped: idx
    (E, M, nc), lut (E, nc, c, N), scale (E, N) -> (E, M, N); with
    ``counts``, 0.0 past each expert's count."""
    _build.bump(lut_gemm_onehot, "calls")
    return live_only(_per_expert(_lut_gemm, idx.dim() == 3, idx, lut,
                                 scale), counts)


def vq_amm_ref(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               metric: Metric = "l2",
               counts: Optional[torch.Tensor] = None,
               most_live: Optional[int] = None) -> torch.Tensor:
    """Plain version of the fused assign + lookup: x (M, nc, v),
    z (nc, c, v), lut (nc, c, N) -> (M, N) float32. Grouped: x
    (E, M, nc, v), z (E, nc, c, v), lut (E, nc, c, N), scale (E, N)
    -> (E, M, N); with ``counts``, 0.0 past each expert's count.

    ``vq_amm_ref.calls`` counts calls, so a run on the card can show that
    its main path never took the plain version."""
    _build.bump(vq_amm_ref, "calls")
    return live_only(_per_expert(
        lambda xx, zz, ll, ss: _lut_gemm(_assign(xx, zz, metric), ll, ss),
        x.dim() == 4, x, z, lut, scale), counts)


assign_ref.calls = 0
lut_gemm_onehot.calls = 0
vq_amm_ref.calls = 0


def flash_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, phys: torch.Tensor, positions,
                     window: int = 0, kv_start=0) -> torch.Tensor:
    """Oracle for paged flash decode: gather the view, one full softmax,
    no split reduction.

    q (B,1,H,D); k_pages/v_pages (P+1, page, KVH, D) one layer of the
    pool; k_new/v_new (B,1,KVH,D) the fresh token (always live); phys
    (B, NP) trash-redirected page ids; positions (B,) per-slot lengths
    (-1 = inactive). Returns (B, 1, H*D) in q's dtype.
    """
    b, _, h, d = q.shape
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    g = h // kvh
    t = phys.shape[1] * ps
    dev = q.device
    qg = q.reshape(b, kvh, g, d).float()
    kg = k_pages[phys.long()].reshape(b, t, kvh, d).float()
    vg = v_pages[phys.long()].reshape(b, t, kvh, d).float()
    kj = torch.arange(t, dtype=torch.int32, device=dev)
    pos = torch.as_tensor(positions, dtype=torch.int32,
                          device=dev).expand(b)
    ks = torch.as_tensor(kv_start, dtype=torch.int32, device=dev).expand(b)
    mask = (kj[None] < pos[:, None]) & (kj[None] >= ks[:, None])
    if window > 0:
        mask = mask & (kj[None] > pos[:, None] - window)
    scale = d ** -0.5
    sc = torch.einsum("bkgd,btkd->bkgt", qg, kg) * scale
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].float()) * scale
    sc_all = torch.cat([sc, s_new[..., None]], dim=-1)
    mask_all = torch.cat([mask, torch.ones((b, 1), dtype=torch.bool,
                                           device=dev)], dim=-1)
    sc_all = torch.where(mask_all[:, None, None, :], sc_all,
                         torch.full_like(sc_all, -1e30))
    probs = torch.softmax(sc_all, dim=-1)
    v_all = torch.cat([vg, v_new[:, :1].float()], dim=1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_all)
    return out.reshape(b, 1, h * d).to(q.dtype)


def flash_decode_kvq_ref(q: torch.Tensor, kc_pages: torch.Tensor,
                         vc_pages: torch.Tensor, cb: dict,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         phys: torch.Tensor, positions, window: int = 0,
                         kv_start=0) -> torch.Tensor:
    """Oracle for the vector-quantized pool: dequantize the whole code
    pool with plain indexing, then :func:`flash_decode_ref`.

    kc_pages/vc_pages (P+1, page, KVH, nc) uint8; cb one layer's codebook
    slice {"zk": (nc, c, v), "zv": ..., "sk": (KVH,), "sv": ...}.
    """
    def deq(codes, z, s):
        nc = z.shape[0]
        sub = z.float()[torch.arange(nc, device=codes.device),
                        codes.long()]
        rows = sub.reshape(*codes.shape[:-1], -1)
        return rows * s.float()[:, None]
    return flash_decode_ref(q, deq(kc_pages, cb["zk"], cb["sk"]),
                            deq(vc_pages, cb["zv"], cb["sv"]), k_new, v_new,
                            phys, positions, window=window,
                            kv_start=kv_start)
