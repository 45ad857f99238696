"""Kernel B4 wrapper: LUT gather-accumulate GEMM on Hopper, the second of
the two passes that ``QuantConfig(fuse=False)`` runs.

Port of ``repro.kernels.lut_gemm.lut_gemm_pallas``. The kernel is CUDA C++
in ``csrc/lut_gemm.cu``, on kernel B1's device code (``csrc/vq_gather.cuh``;
their headers say what bounds it and how it is built); its int8 sums are
exact int32 sums times the scale, B1's expression, so for int8 LUTs
``lut_gemm_cuda(vq_assign_cuda(x, z), lut, s)`` equals
``vq_amm_cuda(x, z, lut, s)`` bit for bit, and for float LUTs wherever
``lut_gemm_geometry`` and ``fused_amm.vq_amm_geometry`` give the same
cluster size and row groups. This module checks the arguments, allocates
the output, and makes one C call that enqueues one kernel on the current
stream (no memset, no work buffer). The plain version is
``kernels.ref.lut_gemm_onehot``; ``kernels.ops.lut_matmul`` picks between
the two by device.

Every operand may carry a leading expert axis (idx ``(E, M, nc)``, lut
``(E, nc, c, N)``, scale ``(E, N)`` -> ``(E, M, N)``): all experts in one
launch, as the JAX package vmaps ``lut_gemm_pallas`` over the experts of
an MoE layer. The size limits hold per expert. With ``counts`` and
``most_live`` (as ``fused_amm.vq_amm_cuda`` takes them) rows past an
expert's count come out 0.0 and their indices are not read.

``lut_gemm_cuda.launches`` counts launches (a grouped call is one);
``lut_gemm_cuda.grouped`` counts those with a leading expert axis.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .fused_amm import _LUT_DTYPES, expert_count, geometry, live_args

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("lut_gemm").lut_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                       _P]
        fn.restype = _I
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lut_gemm_cuda: {msg}")


def lut_gemm_cuda(idx: torch.Tensor, lut: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  counts: Optional[torch.Tensor] = None,
                  most_live: Optional[int] = None) -> torch.Tensor:
    """LUT accumulate on the card.

    idx (M, nc) int32 with entries in [0, c), lut (nc, c, N)
    f32|bf16|int8, scale (N,) f32 or None (an int8 LUT without it
    gives the exact int32 sums as float32: a row-parallel shard's
    partials, ``core.lut.lut_linear_row``); all
    contiguous CUDA tensors on one device. Returns out (M, N) float32,
    ``sum_k lut[k, idx[m, k], :]`` (x scale); with a leading expert axis
    on every operand (idx (E, M, nc), lut (E, nc, c, N), scale (E, N)),
    (E, M, N) in one launch. ``counts`` (E,) int64 and ``most_live``:
    live rows only; rows past an expert's count are 0.0. Raises on
    anything else, and when the kernel cannot be built or launched.
    Entries of idx are not range-checked (that would cost a device read).
    """
    tensors = [idx, lut] + ([scale] if scale is not None else [])
    _check(all(t.device.type == "cuda" for t in tensors),
           "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1,
           "tensors lie on different devices")
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(idx.dtype == torch.int32, f"idx must be int32 (got {idx.dtype})")
    _check(lut.dtype in _LUT_DTYPES, f"lut dtype {lut.dtype}")
    e = expert_count("lut_gemm_cuda", idx, 2, [(lut, 3)] + (
        [(scale, 1)] if scale is not None else []))
    m, nc = idx.shape[-2:]
    c, n = lut.shape[-2:]
    _check(lut.shape[-3] == nc, f"shapes idx {tuple(idx.shape)}, lut "
           f"{tuple(lut.shape)} do not match")
    _check(1 <= c <= 256, f"c={c} out of range (uint8 indices)")
    if scale is not None:
        _check(scale.dtype == torch.float32 and scale.shape[-1] == n,
               "scale must be float32 of shape (N,), or (E, N)")
    # per expert: the kernel moves between experts with 64-bit offsets
    _check(m * n < 2 ** 31 and nc * c * n < 2 ** 31,
           "sizes of one expert beyond int32 indexing")
    cp, most = live_args("lut_gemm_cuda", counts, most_live, e,
                         idx.device)
    fn = _lib()
    out = torch.empty(idx.shape[:-1] + (n,), dtype=torch.float32,
                      device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), lut.data_ptr(),
                 scale.data_ptr() if scale is not None else None,
                 out.data_ptr(), e, cp, most, m, nc, c, n,
                 _LUT_DTYPES[lut.dtype], stream, None)
    if err != 0:
        raise RuntimeError(f"lut_gemm_cuda: launch failed with cudaError {err}")
    _build.bump(lut_gemm_cuda, "launches")
    _build.bump(lut_gemm_cuda, "grouped", idx.dim() == 3)
    return out


lut_gemm_cuda.launches = 0
lut_gemm_cuda.grouped = 0


def lut_gemm_geometry(idx: torch.Tensor, lut: torch.Tensor,
                      counts: Optional[torch.Tensor] = None,
                      most_live: Optional[int] = None) -> dict:
    """The launch that ``lut_gemm_cuda`` makes for these CUDA operands
    (with or without an expert axis, and live-row counts), without making
    it (the keys of ``fused_amm.vq_amm_geometry``; B4 always clusters
    along k)."""
    e = idx.shape[0] if idx.dim() == 3 else 1
    m, nc = idx.shape[-2:]
    c, n = lut.shape[-2:]
    cp, most = live_args("lut_gemm_geometry", counts, most_live, e,
                         idx.device)
    return geometry(_lib(), "lut_gemm_geometry", (
        idx.data_ptr(), lut.data_ptr(), None, None, e, cp, most, m, nc, c,
        n, _LUT_DTYPES[lut.dtype]), e, idx.device)
