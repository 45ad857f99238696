"""Atomic, self-describing checkpoints for fault-tolerant training (port
of ``repro.checkpoint.manager``).

* **Atomicity**: write ``<dir>/tmp.<step>``, then ``rename`` it to
  ``step_<k>``; a crash mid-write never corrupts the latest checkpoint.
* **Integrity**: a manifest records every leaf's path, shape and dtype
  and a CRC32 of its bytes; restore checks them before handing data to
  the trainer.
* **Retention**: keep the last N checkpoints; deletion is atomic too
  (rename to ``.trash`` then remove).

Storage is one ``.npz`` a checkpoint. Leaves are named by their tree path
(``['blocks'][3]['attn']['wq']['w']``: the per-layer list of ``blocks``
gives each layer a stable key). numpy has no bfloat16, so a bf16 leaf is
stored as its raw 16-bit pattern with ``bfloat16`` in the manifest, and
comes back bit for bit.

**Elastic restore**: a sharded state (one tree a rank of a mesh, the
sharded train step's) is saved as global arrays (``save(..., mesh=,
layout=)`` puts the shards back together with ``unshard_tree``), so a
checkpoint does not know the mesh it came from. ``restore(..., mesh=,
layout=)`` re-places it onto any mesh by that mesh's layout (the
counterpart of the reference's ``load_pytree(..., shardings=)``), and
without a mesh it restores unsharded.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import shard_tree, unshard_tree
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    return str(torch.as_tensor(leaf).dtype).replace("torch.", "")


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"))


def save_pytree(path: str, tree) -> None:
    flat = tree_flatten_with_path(tree)
    arrays = {key: _to_numpy(leaf) for key, leaf in flat}
    manifest = {key: {"shape": list(arrays[key].shape),
                      "dtype": _dtype_name(leaf), "crc": _crc(arrays[key])}
                for key, leaf in flat}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_pytree(path: str, tree_like, device=None):
    """The tree saved at ``path``, in the structure of ``tree_like``:
    each leaf with its saved dtype, on ``device`` or else on the device of
    ``tree_like``'s leaf (the CPU where that leaf is not a tensor or lies
    on the meta device: ``tree_like`` may be shapes only). Raises IOError
    on a CRC mismatch, KeyError on a missing leaf, ValueError on a shape
    mismatch."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    arrays = {}
    for key, meta in manifest.items():
        arr = data[key]
        if _crc(arr) != meta["crc"]:
            raise IOError(f"checkpoint corruption detected at leaf {key}")
        arrays[key] = (arr, meta["dtype"])

    def restore(key, ref):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, dtype = arrays[key]
        shape = tuple(torch.as_tensor(ref).shape)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {key}: {arr.shape} vs {shape}")
        if not arr.flags.writeable:
            arr = arr.copy()
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = device
        if dev is None:
            dev = ref.device if torch.is_tensor(ref) and not ref.is_meta \
                else "cpu"
        return t.to(dev)

    return tree_map_with_path(restore, tree_like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None,
             mesh=None, layout=None) -> str:
        """Write ``tree`` as checkpoint ``step``. With ``mesh``, ``tree`` is
        a list of per-rank trees (the order of ``mesh.devices.flat``) laid
        out by ``layout`` (a spec tree of one rank's structure), saved as
        the global arrays."""
        if mesh is not None:
            tree = unshard_tree(tree, layout, mesh, device="cpu")
        tmp = os.path.join(self.directory, f"tmp.{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(tmp, tree)
        if extra:
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                          # atomic commit
        self._gc()
        return final

    def restore(self, tree_like, step: Optional[int] = None, mesh=None,
                layout=None):
        """(tree, step, extra dict or None) of ``step`` (default: the
        latest). ``tree_like`` has the global shapes (its leaves may lie on
        the meta device). With ``mesh`` the tree is re-placed onto it by
        ``layout`` and comes back as one tree a rank (each shard its own
        copy on its rank's device), whatever mesh saved it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        if mesh is None:
            tree = load_pytree(path, tree_like)
        else:
            tree = shard_tree(load_pytree(path, tree_like, device="cpu"),
                              layout, mesh, copy=True)
        extra_path = os.path.join(path, "extra.json")
        extra = None
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return tree, step, extra

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            trash = os.path.join(self.directory, f".trash.{s}")
            os.rename(self._step_dir(s), trash)
            shutil.rmtree(trash, ignore_errors=True)
