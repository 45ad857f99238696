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

``lut_gemm_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .fused_amm import _LUT_DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("lut_gemm").lut_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
        fn.restype = _I
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lut_gemm_cuda: {msg}")


def lut_gemm_cuda(idx: torch.Tensor, lut: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LUT accumulate on the card.

    idx (M, nc) int32 with entries in [0, c), lut (nc, c, N)
    f32|bf16|int8, scale (N,) f32 or None (required for int8); all
    contiguous CUDA tensors on one device. Returns out (M, N) float32,
    ``sum_k lut[k, idx[m, k], :]`` (x scale). Raises on anything else, and
    when the kernel cannot be built or launched. Entries of idx are not
    range-checked (that would cost a device read).
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
    _check(idx.dim() == 2 and lut.dim() == 3, "idx 2-d and lut 3-d")
    m, nc = idx.shape
    _, c, n = lut.shape
    _check(lut.shape[0] == nc, f"shapes idx {tuple(idx.shape)}, lut "
           f"{tuple(lut.shape)} do not match")
    _check(1 <= c <= 256, f"c={c} out of range (uint8 indices)")
    if scale is not None:
        _check(scale.dtype == torch.float32 and tuple(scale.shape) == (n,),
               "scale must be float32 of shape (N,)")
    if lut.dtype == torch.int8:
        _check(scale is not None, "an int8 LUT needs its scale")
    _check(m * n < 2 ** 31 and nc * c * n < 2 ** 31,
           "sizes beyond int32 indexing")
    fn = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), lut.data_ptr(),
                 scale.data_ptr() if scale is not None else None,
                 out.data_ptr(), m, nc, c, n, _LUT_DTYPES[lut.dtype], stream,
                 None)
    if err != 0:
        raise RuntimeError(f"lut_gemm_cuda: launch failed with cudaError {err}")
    lut_gemm_cuda.launches += 1
    return out


lut_gemm_cuda.launches = 0


def lut_gemm_geometry(idx: torch.Tensor, lut: torch.Tensor) -> dict:
    """The launch that ``lut_gemm_cuda`` makes for these CUDA operands,
    without making it: cluster size (k splits), column tiles, row groups,
    subspaces a block and shared memory bytes a block (the keys of
    ``fused_amm.vq_amm_geometry``)."""
    m, nc = idx.shape
    _, c, n = lut.shape
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(idx.device):
        err = _lib()(idx.data_ptr(), lut.data_ptr(), None, None, m, nc, c,
                     n, _LUT_DTYPES[lut.dtype], None, info)
    if err != 0:
        raise RuntimeError(f"lut_gemm_geometry: cudaError {err}")
    return dict(zip(("cluster", "tiles", "row_groups", "subspaces", "smem"),
                    info))
