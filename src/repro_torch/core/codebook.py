"""Codebooks for VQ-AMM (paper §II-B step-1).

Port of ``repro.core.codebook``: the operating point of one LUT-ified GEMM
and the random centroid init. Centroid tensors are ``(nc, c, v)``. K-means
initialisation from calibration activations belongs to LUTBoost training,
which is not ported yet.
"""
from __future__ import annotations

import dataclasses

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


def init_centroids(generator: torch.Generator, k: int, spec: CodebookSpec,
                   scale: float = 0.02, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """Random-normal centroid init, shape (nc, c, v), drawn from
    ``generator`` (which must live on ``device``)."""
    nc = spec.num_subspaces(k)
    z = torch.randn((nc, spec.c, spec.v), generator=generator,
                    device=resolve_device(device), dtype=torch.float32)
    return (scale * z).to(dtype)
