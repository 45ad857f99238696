"""The work of each kernel call: the bytes it must move and the CUDA-core
operations it must do, from its operands' shapes (and, where the work
depends on the data, an optional measured count).

One function a kernel, B1-B5 (and B2 / B5's triples form), and B2s /
B2a, the head_dim layout's decode. They count
what the call's function needs, whatever implements it: each input read
once, each output written once, the operations of the arithmetic the
function defines. ``chip_smoke.py``'s bound column divides them by the
card's peaks (``launch.roofline``), and the dry run's cost mode records
them for every kernel call (``launch.op_cost``), so a redesigned kernel
leaves both unchanged.

Each returns ``(bytes, ops)``. Operands may lie on any device, the meta
device included: only shapes and dtypes are read, except the measured
counts a caller passes.

Data-dependent terms:

* B1 / B4 read only the LUT rows some row selects. ``rows`` is the
  number of (expert, subspace, centroid) rows selected (``selected_rows``
  counts it from the indices); without it each subspace of each expert
  counts ``min(M, c)`` rows, an upper bound (every row picks a centroid
  no other row picks).
* B1, B3 and B4 of an MoE layer's routed experts (``counts``) work on
  the live rows of each expert's buffer only: they read those rows of x
  (B4: their indices), z and the scale of the experts with a live row,
  the LUT rows the live rows select, and write the whole output, the
  dead rows' zeros included. ``counts`` is a sequence of E ints or a
  tensor, read here (clamped to [0, M]); where it is unknown (a meta
  tensor, or only ``most_live`` given) the call counts the most that
  ``most_live`` live rows in all can need: min(E M, most_live) rows, on
  as many experts as they can fill.
* B2 / B5 (and B2s / B2a) read the K/V rows of the live tokens. ``live``
  is their number (the sum of the non-negative positions); without it
  every lane counts its whole page table, ``NP x page`` rows, an upper
  bound.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Work = Tuple[float, float]


def nbytes(*ts) -> int:
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _experts(x: torch.Tensor, plain_ndim: int) -> int:
    """The leading expert axis' length (1 without one)."""
    return x.shape[0] if x.dim() > plain_ndim else 1


def selected_rows(idx: torch.Tensor, c: int, counts=None) -> int:
    """How many (expert, subspace, centroid) LUT rows some row of ``idx``
    ((M, nc), or (E, M, nc) with an expert axis) selects: the rows a
    gather-accumulate must read; with ``counts`` (E,), only rows below
    each expert's count select. Reads ``idx`` (a device sync)."""
    idx = idx.reshape((-1,) + tuple(idx.shape[-2:]))
    e, m, nc = idx.shape
    hit = torch.ones(idx.shape, device=idx.device)
    if counts is not None:
        live = torch.as_tensor(counts, device=idx.device)
        hit = hit * (torch.arange(m, device=idx.device)[None]
                     < live[:, None])[..., None]
    rows = torch.zeros((e, nc, c), device=idx.device)
    rows.scatter_add_(2, idx.transpose(1, 2).long(), hit.transpose(1, 2))
    return int((rows > 0).sum())


class _Live:
    """The live rows of a call of E experts of M rows: ``rows`` in all,
    on ``experts`` experts, and ``lut_rows(nc, c)``, the most LUT rows
    they can select."""

    def __init__(self, e: int, m: int, counts=None,
                 most_live: Optional[int] = None):
        if isinstance(counts, torch.Tensor):
            counts = None if counts.is_meta else counts.tolist()
        if counts is not None:
            self.per = [min(max(int(n), 0), m) for n in counts]
            self.rows, self.experts = sum(self.per), sum(
                n > 0 for n in self.per)
        else:
            self.per = None
            self.rows = e * m if most_live is None else min(e * m, most_live)
            self.experts = min(e, self.rows)
        self.m = m

    def lut_rows(self, nc: int, c: int) -> int:
        if self.per is not None:
            return nc * sum(min(n, c) for n in self.per)
        return nc * min(self.rows, self.experts * min(self.m, c))


def vq_assign(x: torch.Tensor, z: torch.Tensor, counts=None,
              most_live: Optional[int] = None) -> Work:
    """B3: read x (M, nc, v) and z (nc, c, v), write the int32 indices
    (M, nc); a distance (4 v + 2 operations) for every (row, subspace,
    centroid). With live rows, those rows of x and the z of experts
    with one (the whole output is written)."""
    e = _experts(x, 3)
    m, nc, v = x.shape[-3:]
    c = z.shape[-2]
    lv = _Live(e, m, counts, most_live)
    return (lv.rows * nc * v * x.element_size()
            + lv.experts * nc * c * v * z.element_size() + e * m * nc * 4,
            lv.rows * nc * c * (4 * v + 2))


def lut_gemm(idx: torch.Tensor, lut: torch.Tensor,
             scale: Optional[torch.Tensor] = None,
             rows: Optional[int] = None, counts=None,
             most_live: Optional[int] = None) -> Work:
    """B4: read the indices (M, nc), the selected rows of the LUT (nc, c,
    N) and the scale, write the float32 output (M, N); an add per
    (row, subspace, column) and a multiply per output. With live rows,
    their indices and the scale of experts with one."""
    e = _experts(idx, 2)
    m, nc = idx.shape[-2:]
    c, n = lut.shape[-2:]
    lv = _Live(e, m, counts, most_live)
    rows = lv.lut_rows(nc, c) if rows is None else rows
    return (lv.rows * nc * 4 + (0 if scale is None else lv.experts * n * 4)
            + rows * n * lut.element_size() + e * m * n * 4,
            lv.rows * (nc * n + n))


def vq_amm(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
           scale: Optional[torch.Tensor] = None,
           rows: Optional[int] = None, counts=None,
           most_live: Optional[int] = None) -> Work:
    """B1: B3's reads and distances and B4's gather-accumulate, without
    the indices in between."""
    e = _experts(x, 3)
    m, nc, v = x.shape[-3:]
    c, n = lut.shape[-2:]
    lv = _Live(e, m, counts, most_live)
    rows = lv.lut_rows(nc, c) if rows is None else rows
    return (lv.rows * nc * v * x.element_size()
            + lv.experts * nc * c * v * z.element_size()
            + (0 if scale is None else lv.experts * n * 4)
            + rows * n * lut.element_size() + e * m * n * 4,
            lv.rows * (nc * c * (4 * v + 2) + nc * n + n))


def _live(phys: torch.Tensor, page: int, live: Optional[int]) -> int:
    return phys.shape[0] * phys.shape[1] * page if live is None else live


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 k_new: torch.Tensor, phys: torch.Tensor,
                 codebook: Optional[dict] = None,
                 live: Optional[int] = None) -> Work:
    """A whole ``flash_decode_paged`` call (B2, or B5 over a code pool
    with ``codebook``): read the live tokens' K and V rows (codes and the
    tables for B5), q, the new token's K/V rows, the page ids, the
    positions and kv starts (int32 a lane), write the output (q's size
    and dtype). Operations: scores and probabilities times V (4 a live
    token, head and dim), B5's dequantization (2 a live token, kv head
    and dim), and the split fold and self term (10 a lane, head and
    dim)."""
    b, _, h, d = q.shape
    kvh = k_pages.shape[2]
    live = _live(phys, k_pages.shape[1], live)
    small = nbytes(q, k_new, k_new) + phys.numel() * 4 + 2 * b * 4 \
        + nbytes(q)
    ops = 4 * live * h * d + 10 * b * h * d
    if codebook is None:
        rows = 2 * live * kvh * d * k_pages.element_size()
        return rows + small, ops
    return _codes(k_pages, kvh, codebook, live) + small, \
        ops + 2 * live * kvh * d


def _codes(k_pages, kvh: int, codebook: dict, live: int) -> int:
    """B5's reads of the live tokens' K and V codes and its tables."""
    return (2 * live * kvh * k_pages.shape[-1] * k_pages.element_size()
            + nbytes(*(codebook[k] for k in ("zk", "zv", "sk", "sv"))))


def flash_decode_splits(qg: torch.Tensor, k_pages: torch.Tensor,
                        phys: torch.Tensor, outs, codebook=None,
                        live: Optional[int] = None) -> Work:
    """B2 / B5's triples form (``flash_decode_splits[_kvq]_cuda``): read
    the live rows (codes and tables), the scaled query ``qg``, the padded
    page ids, positions and kv starts, write the triples ``outs`` (m, l,
    acc); scores and probabilities times V (and B5's dequantization;
    ``codebook`` as :func:`flash_decode` takes it)."""
    b, kvh, g, d = qg.shape
    live = _live(phys, k_pages.shape[1], live)
    small = nbytes(qg, *outs) + phys.numel() * 4 + (
        b * 4 if codebook is None else 2 * b * 4)
    ops = 4 * live * kvh * g * d
    if codebook is None:
        return 2 * live * kvh * d * k_pages.element_size() + small, ops
    return _codes(k_pages, kvh, codebook, live) + small, \
        ops + 2 * live * kvh * d


def flash_decode_hd_scores(q: torch.Tensor, k_pages: torch.Tensor,
                           phys: torch.Tensor,
                           live: Optional[int] = None) -> Work:
    """B2s: read the live tokens' K row slices (KVH x D a token), q's
    slice, the new token's K slice, the page ids, positions and kv
    starts, write the float32 scores (B, H, NP x page + 1); a multiply-add
    a live token (and the self term), head and dim."""
    b, _, h, d = q.shape
    kvh, ps = k_pages.shape[2], k_pages.shape[1]
    live = _live(phys, ps, live)
    t1 = phys.shape[1] * ps + 1
    return (live * kvh * d * k_pages.element_size() + nbytes(q)
            + b * kvh * d * k_pages.element_size() + phys.numel() * 4
            + 2 * b * 4 + b * h * t1 * 4,
            2 * (live + b) * h * d)


def flash_decode_hd_attend(sc: torch.Tensor, v_pages: torch.Tensor,
                           phys: torch.Tensor, out_dtype: torch.dtype,
                           live: Optional[int] = None) -> Work:
    """B2a: read the live tokens' scores (and each lane's self term), V
    row slices and the new token's V slice, the page ids, positions and
    kv starts, write the output (B, 1, H, D) in ``out_dtype``; the
    softmax (scale, max, exponential, sum, division: 5 a live score) and
    probabilities times V (2 a live token, head and dim)."""
    b, h, _ = sc.shape
    kvh, ps, d = v_pages.shape[2], v_pages.shape[1], v_pages.shape[3]
    live = _live(phys, ps, live)
    out_size = torch.empty((), dtype=out_dtype).element_size()
    return ((live + b) * h * 4 + live * kvh * d * v_pages.element_size()
            + b * kvh * d * v_pages.element_size() + phys.numel() * 4
            + 2 * b * 4 + b * h * d * out_size,
            5 * (live + b) * h + 2 * (live + b) * h * d)
