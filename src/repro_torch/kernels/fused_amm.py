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

Every operand may carry a leading expert axis (x ``(E, M, nc, v)``, z
``(E, nc, c, v)``, lut ``(E, nc, c, N)``, scale ``(E, N)``): the E
per-expert projections of an MoE layer in one launch, as the JAX package
vmaps ``vq_amm_pallas`` over the experts. The size limits hold per
expert; the kernel moves between experts with 64-bit offsets.

``counts`` (an MoE layer's routed experts: an int64 device vector of E
live-row counts, the rows of each capacity buffer the router filled)
makes the launch work on live rows only: rows at or past an expert's
count (clamped to M by the kernel) come out 0.0 and are neither assigned
nor gathered. ``most_live``, the most live rows the call can have in all
(T x k for a routed layer), sizes the launch's clusters; no count is
read on the host.

``vq_amm_cuda.launches`` counts launches (a grouped call is one);
``vq_amm_cuda.grouped`` counts those with a leading expert axis.
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
        lib.vq_amm_launch.argtypes = [_P, _P, _P, _P, _P, _I, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                      _P]
        lib.vq_amm_launch.restype = _I
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"vq_amm_cuda: {msg}")


def expert_count(name: str, lead: torch.Tensor, dims: int,
                 others) -> int:
    """The expert count E of a kernel call: 1 when ``lead`` is
    ``dims``-d, its leading axis when it is ``dims + 1``-d, and then
    every tensor of ``others`` (pairs of a tensor and its ungrouped rank)
    must lead with the same E. Raises ``ValueError`` naming ``name``
    otherwise."""
    def check(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    check(lead.dim() in (dims, dims + 1),
          f"expected {dims} dims, or {dims + 1} with a leading expert axis; "
          f"got {tuple(lead.shape)}")
    grouped = lead.dim() == dims + 1
    e = lead.shape[0] if grouped else 1
    for t, rank in others:
        check(t.dim() == rank + grouped,
              "operands must all have a leading expert axis or none: "
              f"{tuple(lead.shape)} against {tuple(t.shape)}")
        check(not grouped or t.shape[0] == e,
              f"expert counts differ: {e} against {tuple(t.shape)}")
    check(e >= 1, "no experts")
    return e


def live_args(name: str, counts: Optional[torch.Tensor],
              most_live: Optional[int], e: int, device) -> tuple:
    """The C arguments of a launch's live rows: (pointer or None,
    most_live or 0). ``counts`` must be a contiguous int64 tensor of
    shape (E,) on the launch's device; ``most_live`` a non-negative int
    (None or 0: E x M), and given only with counts. Raises
    ``ValueError`` naming ``name`` otherwise."""
    if counts is None:
        if most_live:
            raise ValueError(f"{name}: most_live without counts")
        return None, 0
    if not (counts.device == device and counts.dtype == torch.int64
            and tuple(counts.shape) == (e,) and counts.is_contiguous()):
        raise ValueError(
            f"{name}: counts must be a contiguous int64 tensor of shape "
            f"({e},) on {device}; got {counts.dtype} "
            f"{tuple(counts.shape)} on {counts.device}")
    most = most_live or 0
    if not 0 <= most < 2 ** 31:
        raise ValueError(f"{name}: most_live={most_live} out of range")
    return counts.data_ptr(), most


def vq_amm_cuda(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                metric: Metric = "l2",
                counts: Optional[torch.Tensor] = None,
                most_live: Optional[int] = None, *,
                cluster: Optional[int] = None,
                tile_cluster: Optional[int] = None) -> torch.Tensor:
    """Fused assign + LUT accumulate on the card.

    x (M, nc, v) f32|bf16, z (nc, c, v) of x's type, lut (nc, c, N)
    f32|bf16|int8, scale (N,) f32 or None (an int8 LUT without it gives
    the exact int32 sums as float32: a row-parallel shard's partials,
    ``core.lut.lut_linear_row``); all contiguous CUDA tensors on
    one device. Returns out (M, N) float32. With a leading expert axis on
    every operand (x (E, M, nc, v), z (E, nc, c, v), lut (E, nc, c, N),
    scale (E, N)) it returns (E, M, N), one launch for all experts.
    ``counts`` (E,) int64 and ``most_live``: live rows only (the module's
    docstring); rows past an expert's count are 0.0. For a measured
    sweep, ``cluster`` sets the k splits (1-16, clusters along k) and
    ``tile_cluster`` the tiles of a tile cluster (1-8, with counts: k not
    split, the assignment shared); None takes the planner's layout.
    Raises on anything else, and when the kernel cannot be built or
    launched.
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
    e = expert_count("vq_amm_cuda", x, 3, [(z, 3), (lut, 3)] + (
        [(scale, 1)] if scale is not None else []))
    m, nc, v = x.shape[-3:]
    n = lut.shape[-1]
    c = z.shape[-2]
    _check(tuple(z.shape[-3:]) == (nc, c, v)
           and tuple(lut.shape[-3:]) == (nc, c, n),
           f"shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
           f"lut {tuple(lut.shape)} do not match")
    _check(1 <= c <= 256, f"c={c} out of range (uint8 indices)")
    if scale is not None:
        _check(scale.dtype == torch.float32 and scale.shape[-1] == n,
               "scale must be float32 of shape (N,), or (E, N)")
    # per expert: the kernel moves between experts with 64-bit offsets
    _check(m * n < 2 ** 31 and nc * c * n < 2 ** 31 and m * nc * v < 2 ** 31,
           "sizes of one expert beyond int32 indexing")
    cp, most = live_args("vq_amm_cuda", counts, most_live, e, x.device)
    layout = _layout(cluster, tile_cluster, counts)
    lib = _lib()
    out = torch.empty(x.shape[:-2] + (n,), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vq_amm_launch(
            x.data_ptr(), z.data_ptr(), lut.data_ptr(),
            scale.data_ptr() if scale is not None else None, out.data_ptr(),
            e, cp, most, m, nc, c, v, n, _X_DTYPES[x.dtype],
            _LUT_DTYPES[lut.dtype], _METRICS[metric], layout, stream, None)
    if err != 0:
        raise RuntimeError(f"vq_amm_cuda: launch failed with cudaError {err}")
    _build.bump(vq_amm_cuda, "launches")
    _build.bump(vq_amm_cuda, "grouped", x.dim() == 4)
    return out


vq_amm_cuda.launches = 0
vq_amm_cuda.grouped = 0


def _layout(cluster: Optional[int], tile_cluster: Optional[int],
            counts: Optional[torch.Tensor]) -> int:
    """The C argument of a sweep's layout: k splits, -tiles of a tile
    cluster, or 0 for the planner's."""
    _check(cluster is None or tile_cluster is None,
           "cluster and tile_cluster exclude each other")
    _check(cluster is None or 1 <= cluster <= 16,
           f"cluster={cluster} must be 1-16")
    _check(tile_cluster is None or (1 <= tile_cluster <= 8
                                    and counts is not None),
           f"tile_cluster={tile_cluster} must be 1-8, with counts")
    return cluster or -(tile_cluster or 0)


def geometry(fn, name: str, args, e: int, device) -> dict:
    """A launch's geometry from its C entry point in info mode (``args``
    its arguments before the stream): experts, k splits (``cluster``),
    column tiles, row groups of one expert, subspaces a block gathers,
    shared memory bytes a block, and the tiles of a tile cluster (0:
    clusters along k)."""
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = fn(*args, None, info)
    if err != 0:
        raise RuntimeError(f"{name}: cudaError {err}")
    return dict(experts=e, **dict(zip(
        ("cluster", "tiles", "row_groups", "subspaces", "smem",
         "tile_cluster"), info)))


def vq_amm_geometry(x: torch.Tensor, z: torch.Tensor,
                    lut: torch.Tensor, counts: Optional[torch.Tensor] = None,
                    most_live: Optional[int] = None,
                    cluster: Optional[int] = None,
                    tile_cluster: Optional[int] = None) -> dict:
    """The launch that ``vq_amm_cuda`` makes for these CUDA operands
    (with or without an expert axis, and live-row counts), without making
    it (``geometry``'s keys)."""
    e = x.shape[0] if x.dim() == 4 else 1
    m, nc, v = x.shape[-3:]
    cp, most = live_args("vq_amm_geometry", counts, most_live, e, x.device)
    return geometry(_lib().vq_amm_launch, "vq_amm_geometry", (
        x.data_ptr(), z.data_ptr(), lut.data_ptr(), None, None, e, cp, most,
        m, nc, z.shape[-2], v, lut.shape[-1], _X_DTYPES[x.dtype],
        _LUT_DTYPES[lut.dtype], 0, _layout(cluster, tile_cluster, counts)),
        e, x.device)
