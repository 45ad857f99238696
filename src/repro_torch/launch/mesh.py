"""Device meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is a grid of ``torch.device`` objects with axis names,
the counterpart of ``jax.sharding.Mesh``: ``mesh.shape`` maps each axis
name to its size, ``mesh.devices`` is the grid (a numpy object array).
Nothing here is ambient: there is no ``mesh_context``, since the port has
no jit to trace under a mesh; an engine takes its mesh as an argument.

A grid may name one device more than once. On a machine with fewer cards
than ranks several ranks then share one card (or the CPU), as the JAX
package's tests run four host devices on one CPU: the sharded program
runs unchanged, at the shard shapes, with its collectives reduced to
copies on one device (``parallel/collectives.py``).

``make_production_mesh`` is the JAX package's 16x16 ``(data, model)``
pod and 2x16x16 ``(pod, data, model)`` pair of pods, every entry one
given device (default the meta device: the dry run, ``launch.dryrun``,
runs one rank's program of them on meta tensors).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _device_grid(devices) -> np.ndarray:
    """``devices`` (nested sequences, or an object array) as an object
    array of ``torch.device``, keeping its shape."""
    grid = np.asarray(devices, dtype=object)
    out = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        out[idx] = torch.device(grid[idx])
    return out


class Mesh:
    """A named grid of devices.

    Args:
      devices: nested sequence (or numpy object array) of
        ``torch.device``; its shape is the mesh's.
      axis_names: one name per axis of ``devices``.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = _device_grid(devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        self.devices = grid
        self.shape = OrderedDict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {sorted({str(d) for d in self.devices.flat})})"


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_production_mesh(multi_pod: bool = False, device="meta") -> Mesh:
    """The single-pod mesh, 16 x 16 = 256 devices with axes (data,
    model), or with ``multi_pod`` 2 x 16 x 16 = 512 with a leading
    ``pod`` axis (an outer data-parallel axis: gradients reduce inside a
    pod first, then once across pods). Every entry is ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    return Mesh(np.full(shape, dev, dtype=object), axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device="cuda") -> Mesh:
    """A small mesh over the cards there are (or the CPU).

    ``device="cuda"`` deals the ranks out over the visible cards in rank
    order (rank i on card ``i % count``): on a machine with one H100 every
    rank shares it. ``device="cpu"`` (or a single device such as
    ``"cuda:1"``) puts every rank on that device."""
    dev = resolve_device(device)
    n = int(np.prod(shape))
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        flat = [torch.device("cuda", i % count) for i in range(n)]
    else:
        flat = [dev] * n
    return Mesh(_device_grid(flat).reshape(tuple(shape)), axes)


def replica_submeshes(mesh: Mesh):
    """Carve a ``(..., model)`` mesh into one TP submesh per data index.

    Every non-``model`` axis is flattened into replica groups: a
    ``(2, 16, 16)`` (pod, data, model) mesh yields 32 submeshes of shape
    ``(1, 16)`` with axes ``("data", "model")``. This is the data-parallel
    serving decomposition: each replica group runs its own
    tensor-parallel engine (``serve.router.ReplicaRouter.from_mesh``), so
    no collective ever crosses replica boundaries.
    """
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'model' axis")
    if mesh.axis_names[-1] != "model":
        raise ValueError("the 'model' axis must be trailing (fastest-"
                         f"varying), got {mesh.axis_names}")
    msize = mesh.shape["model"]
    groups = mesh.devices.reshape(-1, msize)
    return [Mesh(row.reshape(1, msize), ("data", "model")) for row in groups]
