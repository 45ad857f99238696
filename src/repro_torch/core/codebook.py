"""Codebooks for VQ-AMM (paper §II-B step-1).

Port of ``repro.core.codebook``: the operating point of one LUT-ified GEMM,
the random centroid init, and k-means over calibration activations (what
the KV codebook fit and LUTBoost's stage ① run). Centroid tensors are ``(nc, c, v)``. A ``torch.Generator``
takes the place of the JAX key; the two give different streams, so the
tests hand both sides the same initial centroids.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import resolve_device
from .similarity import Metric


@dataclasses.dataclass(frozen=True)
class CodebookSpec:
    v: int = 8
    c: int = 16
    metric: Metric = "l2"

    def num_subspaces(self, k: int) -> int:
        if k % self.v != 0:
            raise ValueError(f"K={k} not divisible by v={self.v}")
        return k // self.v

    @property
    def equivalent_bits(self) -> float:
        """Paper Table V: equivalent bit-width = ceil(log2 c) / v."""
        return math.ceil(math.log2(self.c)) / self.v


def init_centroids(generator: torch.Generator, k: int, spec: CodebookSpec,
                   scale: float = 0.02, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """Random-normal centroid init, shape (nc, c, v), drawn from
    ``generator`` (which must live on ``device``)."""
    nc = spec.num_subspaces(k)
    z = torch.randn((nc, spec.c, spec.v), generator=generator,
                    device=resolve_device(device), dtype=torch.float32)
    return (scale * z).to(dtype)


def _distances(x: torch.Tensor, cents: torch.Tensor,
               metric: Metric) -> torch.Tensor:
    """x (..., n, v), cents (..., c, v) -> (..., n, c): the forms of
    ``similarity.pairwise_distance`` with a batch of centroid sets."""
    if metric == "l2":
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        z2 = torch.sum(cents * cents, dim=-1)[..., None, :]
        xz = torch.einsum("...nv,...cv->...nc", x, cents)
        return x2 - 2.0 * xz + z2
    diff = torch.abs(x[..., :, None, :] - cents[..., None, :, :])
    if metric == "l1":
        return torch.sum(diff, dim=-1)
    if metric == "chebyshev":
        return torch.amax(diff, dim=-1)
    raise ValueError(f"unknown metric: {metric}")


def kmeans(x: torch.Tensor, c: int, metric: Metric = "l2", iters: int = 10,
           generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-means over x (..., n, v) -> centroids (..., c, v), every leading
    index its own problem.

    Seeding: ``init`` (..., c, v) when given, else c distinct random
    samples of each problem, drawn for all problems at once from
    ``generator``. Lloyd updates as the JAX package's: the mean for every
    metric, and an empty cluster is re-seeded with the point farthest from
    its centroid.
    """
    n = x.shape[-2]
    if init is None:
        if n < c:
            raise ValueError(f"{n} rows cannot seed {c} centroids")
        order = torch.argsort(torch.rand(x.shape[:-1], generator=generator,
                                         device=x.device), dim=-1)
        init = torch.gather(x, -2, order[..., :c, None].expand(
            *x.shape[:-2], c, x.shape[-1]))
    cents = init.to(x.dtype)
    for _ in range(iters):
        d = _distances(x, cents, metric)                      # (..., n, c)
        idx = torch.argmin(d, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, c).to(x.dtype)
        counts = onehot.sum(dim=-2)                           # (..., c)
        sums = torch.einsum("...nc,...nv->...cv", onehot, x)
        new = sums / torch.clamp_min(counts, 1.0)[..., None]
        far = torch.argmax(torch.amin(d, dim=-1), dim=-1)     # (...,)
        worst = torch.gather(
            x, -2, far[..., None, None].expand(*far.shape, 1, x.shape[-1]))
        cents = torch.where((counts > 0)[..., None], new, worst)
    return cents


def kmeans_codebook(acts: torch.Tensor, k: int, spec: CodebookSpec,
                    iters: int = 10,
                    generator: Optional[torch.Generator] = None,
                    max_samples: int = 4096,
                    init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-means per subspace over calibration activations.

    acts (..., K) -> centroids (nc, c, v) float32. At most ``max_samples``
    rows (a random subset from ``generator``) enter the fit; the nc
    subspaces are fit as one batch, from ``init`` (nc, c, v) when given.
    """
    nc = spec.num_subspaces(k)
    flat = acts.reshape(-1, nc, spec.v)                       # (n, nc, v)
    n = flat.shape[0]
    if n > max_samples:
        sel = torch.randperm(n, generator=generator,
                             device=acts.device)[:max_samples]
        flat = flat[sel]
    return kmeans(flat.transpose(0, 1).float(), spec.c, spec.metric, iters,
                  generator, init)                            # (nc, c, v)
