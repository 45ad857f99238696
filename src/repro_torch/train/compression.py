"""Gradient compression and the hierarchical gradient reduction (port of
``repro.train.compression``).

* **bf16 with error feedback**: the residual each cast drops is kept in
  fp32 and added back before the next cast, so the compression error
  does not accumulate (Karimireddy et al.). The sharded train step
  applies it to the reduced gradient, as the reference's GSPMD step does.
* **Hierarchical reduction** (:func:`psum_hierarchical`): inside a rank
  of a ``parallel.collectives.RankRunner`` over a ``(pod, data, model)``
  mesh, the sum over the fast intra-pod ``data`` axis first, then over
  the slow ``pod`` axis, each in rank order (the reference's two
  ``psum``s inside ``shard_map``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.parallel.collectives import current
from repro_torch.tree import tree_map


def ef_compress(grads, ef_state) -> Tuple[Any, Any]:
    """Cast grads to bf16 with error feedback. Returns (bf16 grads,
    new_ef); ``ef_state`` is an fp32 tree of residuals, or None at the
    start."""
    if ef_state is None:
        ef_state = tree_map(lambda g: torch.zeros_like(g,
                                                        dtype=torch.float32),
                            grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef_state)
    comp = tree_map(lambda c: c.to(torch.bfloat16), corrected)
    new_ef = tree_map(lambda c, q: c - q.float(), corrected, comp)
    return comp, new_ef


def decompress(grads):
    return tree_map(lambda g: g.float(), grads)


def psum_hierarchical(grads, data_axis: str = "data",
                      pod_axis: str = "pod"):
    """Inside a rank of a runner over a mesh: every leaf of ``grads``
    summed over ``data_axis``, then over ``pod_axis`` (each an
    all-reduce in rank order, so every rank holds the same bits). An axis
    the mesh lacks is skipped, as the reference skips an unbound ``pod``
    axis; outside a runner the tree comes back as it is. Returns a tree of
    the same structure."""
    tp = current()
    g = tree_map(tp.over(data_axis).all_reduce, grads)
    return tree_map(tp.over(pod_axis).all_reduce, g)
