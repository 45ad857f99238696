"""Similarity metrics between input sub-vectors and centroids (paper §V-2).

Port of ``repro.core.similarity`` (distances and hard assignment; the
straight-through estimators belong to training, which is not ported yet).

  * L2 (Euclidean)   — sum (v - z)^2
  * L1 (Manhattan)   — sum |v - z|
  * Chebyshev        — max |v - z|

Distances are smaller-is-closer; ``argmin`` takes the lowest index on
ties, as ``jnp.argmin`` does.
"""
from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["l2", "l1", "chebyshev"]


def pairwise_distance(x: torch.Tensor, z: torch.Tensor,
                      metric: Metric) -> torch.Tensor:
    """Distances between x (..., v) and centroids z (c, v) -> (..., c)."""
    if metric == "l2":
        # ||x||^2 - 2 x.z + ||z||^2, the form the JAX package and both
        # fused kernels use (no (..., c, v) intermediate).
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        z2 = torch.sum(z * z, dim=-1)
        xz = torch.einsum("...v,cv->...c", x, z)
        return x2 - 2.0 * xz + z2
    diff = torch.abs(x[..., None, :] - z)
    if metric == "l1":
        return torch.sum(diff, dim=-1)
    if metric == "chebyshev":
        return torch.amax(diff, dim=-1)
    raise ValueError(f"unknown metric: {metric}")


def pairwise_distance_subspaces(x: torch.Tensor, z: torch.Tensor,
                                metric: Metric) -> torch.Tensor:
    """x (..., nc, v), z (nc, c, v) -> distances (..., nc, c)."""
    if metric == "l2":
        x2 = torch.sum(x * x, dim=-1)[..., None]
        z2 = torch.sum(z * z, dim=-1)
        xz = torch.einsum("...kv,kcv->...kc", x, z)
        return x2 - 2.0 * xz + z2
    diff = torch.abs(x[..., None, :] - z)
    if metric == "l1":
        return torch.sum(diff, dim=-1)
    if metric == "chebyshev":
        return torch.amax(diff, dim=-1)
    raise ValueError(f"unknown metric: {metric}")


def assign_subspaces(x: torch.Tensor, z: torch.Tensor,
                     metric: Metric) -> torch.Tensor:
    """x (..., nc, v), z (nc, c, v) -> (..., nc) int32."""
    return torch.argmin(pairwise_distance_subspaces(x, z, metric),
                        dim=-1).to(torch.int32)
