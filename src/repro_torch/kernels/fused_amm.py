"""Kernel B1 wrapper: fused VQ-assign + LUT gather-accumulate on Hopper.

Port of ``repro.kernels.fused_amm.vq_amm_pallas``. The kernel is CUDA C++
in ``csrc/fused_amm.cu`` and ``csrc/vq_gather.cuh`` (their headers say
what bounds it and how it is built); this module checks the arguments,
allocates the output, and makes one C call that enqueues one kernel on
the current stream (no memset, no work buffer: the split-K sums meet in
a thread block cluster, in a fixed order, so float results are the same
on every run) through the library ``kernels._build`` makes. The plain
version is ``kernels.ref.vq_amm_ref``; ``kernels.ops.vq_amm`` picks
between the two by device.

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
        lib.vq_amm_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _P, _P]
        lib.vq_amm_launch.restype = _I
    return lib


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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vq_amm_launch(
            x.data_ptr(), z.data_ptr(), lut.data_ptr(),
            scale.data_ptr() if scale is not None else None, out.data_ptr(),
            m, nc, c, v, n, _X_DTYPES[x.dtype],
            _LUT_DTYPES[lut.dtype], _METRICS[metric], stream, None)
    if err != 0:
        raise RuntimeError(f"vq_amm_cuda: launch failed with cudaError {err}")
    vq_amm_cuda.launches += 1
    return out


vq_amm_cuda.launches = 0


def vq_amm_geometry(x: torch.Tensor, z: torch.Tensor,
                    lut: torch.Tensor) -> dict:
    """The launch that ``vq_amm_cuda`` makes for these CUDA operands,
    without making it: cluster size (k splits), column tiles, row groups,
    subspaces a block and shared memory bytes a block."""
    m, nc, v = x.shape
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(x.device):
        err = _lib().vq_amm_launch(
            x.data_ptr(), z.data_ptr(), lut.data_ptr(), None, None, m, nc,
            z.shape[1], v, lut.shape[2], _X_DTYPES[x.dtype],
            _LUT_DTYPES[lut.dtype], 0, None, info)
    if err != 0:
        raise RuntimeError(f"vq_amm_geometry: cudaError {err}")
    return dict(zip(("cluster", "tiles", "row_groups", "subspaces", "smem"),
                    info))
