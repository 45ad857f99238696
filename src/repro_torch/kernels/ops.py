"""Public VQ-AMM entry point (port of ``repro.kernels.ops.vq_amm``).

Dispatch is by the tensors' device alone: CPU tensors take the plain
PyTorch version (``kernels.ref.vq_amm_ref``), CUDA tensors take kernel B1
(``kernels.fused_amm.vq_amm_cuda``), which raises on anything it cannot
run. No option selects between them and nothing falls back.

The JAX package's single-stage entry points ``vq_assign`` / ``lut_matmul``
drive the two-pass kernels B3 and B4, which are not ported yet
(ROADMAP.md queue A item 8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.similarity import Metric
from . import ref as _ref
from .fused_amm import vq_amm_cuda


def vq_amm(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
           scale: Optional[torch.Tensor] = None,
           metric: Metric = "l2") -> torch.Tensor:
    """Fused approximate matmul: assignment + LUT accumulation in one.

    Args:
      x: (M, nc, v) inputs; z: (nc, c, v) centroids;
      lut: (nc, c, N) precomputed table; scale: optional (N,) dequant
        scale (int8 LUTs).
      metric: "l2" | "l1" | "chebyshev".

    Returns: (M, N) float32, ``sum_k lut[k, argmin_j d(x[m,k], z[k,j]), :]``
    (x scale).
    """
    if x.device.type == "cpu":
        return _ref.vq_amm_ref(x, z, lut, scale, metric)
    return vq_amm_cuda(x, z, lut, scale, metric)
