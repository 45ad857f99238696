"""Kernel B4 wrapper: LUT gather-accumulate GEMM on Hopper, the second of
the two passes that ``QuantConfig(fuse=False)`` runs.

Port of ``repro.kernels.lut_gemm.lut_gemm_pallas``. The kernel is CUDA C++
in ``csrc/lut_gemm.cu`` (its header says what bounds it); its int8 sums
are exact int32 sums times the scale, B1's expression, so for int8 LUTs
``lut_gemm_cuda(vq_assign_cuda(x, z), lut, s)`` equals
``vq_amm_cuda(x, z, lut, s)`` bit for bit. This module checks the
arguments, allocates the output and the split-K accumulator
(``work_buffer``) and launches the kernel on the current stream. The
plain version is
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
    lib = _build.load("lut_gemm")
    if lib.lut_gemm_launch.argtypes is None:
        lib.lut_gemm_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _P]
        lib.lut_gemm_launch.restype = _I
        lib.lut_gemm_splits.argtypes = [_I] * 3
        lib.lut_gemm_splits.restype = _I
    return lib


def work_buffer(splits, lut: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The split-K accumulator: (M, N) int32 for an int8 LUT (exact
    atomic sums), else (splits(), M, N) float32, one tile per split
    (``splits`` is called only then)."""
    if lut.dtype == torch.int8:
        return torch.empty((m, n), dtype=torch.int32, device=lut.device)
    return torch.empty((splits(), m, n), dtype=torch.float32,
                       device=lut.device)


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
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=idx.device)
    work = work_buffer(lambda: lib.lut_gemm_splits(m, nc, n), lut, m, n)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lut_gemm_launch(
            idx.data_ptr(), lut.data_ptr(),
            scale.data_ptr() if scale is not None else None, out.data_ptr(),
            work.data_ptr(), m, nc, c, n, _LUT_DTYPES[lut.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lut_gemm_cuda: launch failed with cudaError {err}")
    lut_gemm_cuda.launches += 1
    return out


lut_gemm_cuda.launches = 0
