"""Kernel B1 wrapper: fused VQ-assign + LUT gather-accumulate on Hopper.

Port of ``repro.kernels.fused_amm.vq_amm_pallas``. The kernel is CUDA C++
in ``csrc/fused_amm.cu`` (its header says what bounds it and how it is
built); this module checks the arguments, allocates the output and the
split-K accumulator (int32 (M, N) for int8 LUTs; one float32 (M, N) tile
per split for float LUTs, summed in split order by the kernel's finish
step, so float results are the same on every run), and launches it on
the current stream through the
library ``kernels._build`` makes. The plain version is
``kernels.ref.vq_amm_ref``; ``kernels.ops.vq_amm`` picks between the two
by device.

``vq_amm_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.similarity import Metric
from . import _build

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_METRICS = {"l2": 0, "l1": 1, "chebyshev": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("fused_amm")
    if lib.vq_amm_launch.argtypes is None:
        lib.vq_amm_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P]
        lib.vq_amm_launch.restype = _I
        lib.vq_amm_splits.argtypes = [_I] * 5
        lib.vq_amm_splits.restype = _I
    return lib


def work_buffer(splits, lut: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The split-K accumulator of B1 and B4: (M, N) int32 for an int8 LUT
    (exact atomic sums), else (splits(), M, N) float32, one tile per
    split (``splits`` is called only then)."""
    if lut.dtype == torch.int8:
        return torch.empty((m, n), dtype=torch.int32, device=lut.device)
    return torch.empty((splits(), m, n), dtype=torch.float32,
                       device=lut.device)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"vq_amm_cuda: {msg}")


def vq_amm_cuda(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                metric: Metric = "l2") -> torch.Tensor:
    """Fused assign + LUT accumulate on the card.

    x (M, nc, v) f32|bf16, z (nc, c, v) of x's type, lut (nc, c, N)
    f32|bf16|int8, scale (N,) f32 or None; all contiguous CUDA tensors on
    one device. Returns out (M, N) float32. Raises on anything else, and
    when the kernel cannot be built or launched.
    """
    tensors = [x, z, lut] + ([scale] if scale is not None else [])
    _check(all(t.device.type == "cuda" for t in tensors),
           "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1,
           "tensors lie on different devices")
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(x.dtype in _X_DTYPES and z.dtype == x.dtype,
           f"x and z must share one of {list(_X_DTYPES)} "
           f"(got {x.dtype}, {z.dtype})")
    _check(lut.dtype in _LUT_DTYPES, f"lut dtype {lut.dtype}")
    _check(metric in _METRICS, f"unknown metric {metric!r}")
    _check(x.dim() == 3 and z.dim() == 3 and lut.dim() == 3,
           "x, z and lut must be 3-d")
    m, nc, v = x.shape
    n = lut.shape[2]
    _check(tuple(z.shape) == (nc, z.shape[1], v)
           and tuple(lut.shape) == (nc, z.shape[1], n),
           f"shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
           f"lut {tuple(lut.shape)} do not match")
    c = z.shape[1]
    _check(1 <= c <= 256, f"c={c} out of range (uint8 indices)")
    if scale is not None:
        _check(scale.dtype == torch.float32 and tuple(scale.shape) == (n,),
               "scale must be float32 of shape (N,)")
    if lut.dtype == torch.int8:
        _check(scale is not None, "an int8 LUT needs its scale")
    _check(m * n < 2 ** 31 and nc * c * n < 2 ** 31 and m * nc * v < 2 ** 31,
           "sizes beyond int32 indexing")
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    work = work_buffer(lambda: lib.vq_amm_splits(m, nc, c, v, n), lut, m, n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vq_amm_launch(
            x.data_ptr(), z.data_ptr(), lut.data_ptr(),
            scale.data_ptr() if scale is not None else None, out.data_ptr(),
            work.data_ptr(), m, nc, c, v, n, _X_DTYPES[x.dtype],
            _LUT_DTYPES[lut.dtype], _METRICS[metric], stream)
    if err != 0:
        raise RuntimeError(f"vq_amm_cuda: launch failed with cudaError {err}")
    vq_amm_cuda.launches += 1
    return out


vq_amm_cuda.launches = 0
