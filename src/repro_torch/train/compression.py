"""Gradient compression (port of ``repro.train.compression``): a bf16
cast with error feedback. The residual each cast drops is kept in fp32
and added back before the next cast, so the compression error does not
accumulate (Karimireddy et al.).

The hierarchical all-reduce (``psum_hierarchical``) belongs to scale-out
and raises (ROADMAP.md queue A item 11).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

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


def psum_hierarchical(grads, data_axis: str = "data", pod_axis: str = "pod"):
    """The two-level (intra-pod, then cross-pod) gradient reduction."""
    raise NotImplementedError(
        "psum_hierarchical (the cross-pod gradient reduction) is not "
        "ported: ROADMAP.md queue A item 11 (Scale-out, its training "
        "half)")


