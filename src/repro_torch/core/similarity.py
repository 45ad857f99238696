"""Similarity metrics between input sub-vectors and centroids (paper §V-2).

Port of ``repro.core.similarity``: distances, hard assignment, the
straight-through estimators LUTBoost trains through, and the soft
assignment.

  * L2 (Euclidean)   — sum (v - z)^2
  * L1 (Manhattan)   — sum |v - z|
  * Chebyshev        — max |v - z|

Distances are smaller-is-closer; ``argmin`` takes the lowest index on
ties, as ``jnp.argmin`` does.

The straight-through estimators (:func:`ste_quantize`,
:func:`ste_quantize_subspaces`) are ``torch.autograd.Function`` objects: the
forward is the nearest centroid, the backward passes the cotangent
straight through to the input and sums it per selected centroid for the
centroids. That sum is a one-hot contraction, as in the JAX package, not
an ``index_add_``: on CUDA the latter sums with atomics, in an order that
changes from run to run.
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

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


def assign(x: torch.Tensor, z: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Index of the nearest centroid. x (..., v), z (c, v) -> (...,) int32."""
    return torch.argmin(pairwise_distance(x, z, metric), dim=-1).to(
        torch.int32)


class _Ste(torch.autograd.Function):
    """x (..., v), z (c, v) -> z[argmin_j d(x, z_j)] (..., v)."""

    @staticmethod
    def forward(ctx, x, z, metric):
        idx = assign(x, z, metric)
        ctx.save_for_backward(idx)
        ctx.c = z.shape[0]
        return z[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx.long(), ctx.c).to(g.dtype)      # (..., c)
        return g, torch.einsum("...c,...v->cv", onehot, g), None


def ste_quantize(x: torch.Tensor, z: torch.Tensor,
                 metric: Metric) -> torch.Tensor:
    """Quantize sub-vectors to their nearest centroid with an STE backward.

    Forward:  x_hat = z[argmin_j d(x, z_j)]
    Backward: dL/dx = dL/dx_hat (straight through, paper §V-2); dL/dz =
              the cotangents of the sub-vectors assigned to each centroid,
              summed (a one-hot contraction).

    x : (..., v), z : (c, v) -> (..., v)
    """
    return _Ste.apply(x, z, metric)


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


class _SteSubspaces(torch.autograd.Function):
    """x (..., nc, v), z (nc, c, v) -> each subspace's nearest centroid
    (..., nc, v). Only the indices are kept for the backward, which
    rebuilds their one-hot (..., nc, c)."""

    @staticmethod
    def forward(ctx, x, z, metric):
        idx = assign_subspaces(x, z, metric)                   # (..., nc)
        ctx.save_for_backward(idx)
        ctx.c = z.shape[1]
        nc = z.shape[0]
        return z[torch.arange(nc, device=z.device), idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx.long(), ctx.c).to(g.dtype)      # (..., nc, c)
        return g, torch.einsum("...kc,...kv->kcv", onehot, g), None


def ste_quantize_subspaces(x: torch.Tensor, z: torch.Tensor,
                           metric: Metric) -> torch.Tensor:
    """Per-subspace STE quantisation: x (..., nc, v), z (nc, c, v) ->
    (..., nc, v).

    With a leading expert axis, z (E, nc, c, v) and x (E, ..., nc, v),
    each expert's rows take its own codebook (the JAX package vmaps over
    the experts): the expert axis joins the subspace axis, so one call
    serves every expert."""
    if z.dim() == 3:
        return _SteSubspaces.apply(x, z, metric)
    e, nc = z.shape[0], z.shape[1]
    lead = x.shape[1:-2]
    xm = torch.movedim(x, 0, -3).reshape(*lead, e * nc, x.shape[-1])
    out = _SteSubspaces.apply(xm, z.reshape(e * nc, *z.shape[2:]), metric)
    return torch.movedim(out.reshape(*lead, e, nc, x.shape[-1]), -3, 0)


def soft_assignment(x: torch.Tensor, z: torch.Tensor, metric: Metric,
                    temperature: float = 1.0) -> torch.Tensor:
    """Differentiable soft assignment, softmax over -distance / T: (..., c).

    z is one codebook (c, v), or per-subspace codebooks (nc, c, v) with x
    (..., nc, v)."""
    if z.dim() == 3:
        d = pairwise_distance_subspaces(x, z, metric)
    else:
        d = pairwise_distance(x, z, metric)
    return torch.softmax(-d / max(temperature, 1e-6), dim=-1)
