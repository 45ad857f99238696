"""Kernel B3 wrapper: VQ centroid assignment on Hopper, the first of the
two passes that ``QuantConfig(fuse=False)`` runs.

Port of ``repro.kernels.assign.vq_assign_pallas``. The kernel is CUDA C++
in ``csrc/assign.cu`` (its header says what bounds it and how it is
built); it runs kernel B1's assignment code (``csrc/vq_gather.cuh``,
``assign_block``), so its indices are B1's bit for bit. This module checks
the arguments, allocates the index tensor, and makes one C call that
enqueues one kernel on the current stream. The plain version is
``kernels.ref.assign_ref``; ``kernels.ops.vq_assign`` picks between the
two by device.

``vq_assign_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.similarity import Metric
from . import _build
from .fused_amm import _METRICS, _X_DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("assign").vq_assign_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
        fn.restype = _I
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"vq_assign_cuda: {msg}")


def vq_assign_cuda(x: torch.Tensor, z: torch.Tensor, metric: Metric = "l2",
                   *, block_subspaces: Optional[int] = None) -> torch.Tensor:
    """Nearest-centroid assignment on the card.

    x (M, nc, v) f32|bf16 and z (nc, c, v) of x's type, contiguous CUDA
    tensors on one device. Returns idx (M, nc) int32; the lowest index
    wins a tie. ``block_subspaces`` sets the subspaces a block takes (for
    a measured sweep); None takes the kernel's rule (``csrc/assign.cu``).
    Raises on anything else, and when the kernel cannot be
    built or launched.
    """
    _check(x.device.type == "cuda" and z.device == x.device,
           "x and z must be CUDA tensors on one device")
    _check(x.is_contiguous() and z.is_contiguous(),
           "tensors must be contiguous")
    _check(x.dtype in _X_DTYPES and z.dtype == x.dtype,
           f"x and z must share one of {list(_X_DTYPES)} "
           f"(got {x.dtype}, {z.dtype})")
    _check(metric in _METRICS, f"unknown metric {metric!r}")
    _check(x.dim() == 3 and z.dim() == 3, "x and z must be 3-d")
    m, nc, v = x.shape
    c = z.shape[1]
    _check(tuple(z.shape) == (nc, c, v),
           f"shapes x {tuple(x.shape)}, z {tuple(z.shape)} do not match")
    _check(1 <= c <= 256, f"c={c} out of range (uint8 indices)")
    _check(m * nc * v < 2 ** 31, "sizes beyond int32 indexing")
    _check(block_subspaces is None or block_subspaces >= 1,
           f"block_subspaces={block_subspaces} must be at least 1")
    fn = _lib()
    idx = torch.empty((m, nc), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), z.data_ptr(), idx.data_ptr(), m, nc, c, v,
                 _X_DTYPES[x.dtype], _METRICS[metric], block_subspaces or 0,
                 stream, None)
    if err != 0:
        raise RuntimeError(
            f"vq_assign_cuda: launch failed with cudaError {err}")
    vq_assign_cuda.launches += 1
    return idx


vq_assign_cuda.launches = 0


def vq_assign_geometry(x: torch.Tensor, z: torch.Tensor,
                       block_subspaces: Optional[int] = None) -> dict:
    """The launch that ``vq_assign_cuda`` makes for these CUDA operands,
    without making it: blocks along nc and along M, subspaces and rows a
    block, shared memory bytes a block."""
    m, nc, v = x.shape
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), z.data_ptr(), None, m, nc, z.shape[1], v,
                     _X_DTYPES[x.dtype], 0, block_subspaces or 0, None, info)
    if err != 0:
        raise RuntimeError(f"vq_assign_geometry: cudaError {err}")
    return dict(zip(("k_blocks", "row_groups", "subspaces", "rows", "smem"),
                    info))
