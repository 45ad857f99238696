"""Public VQ-AMM entry points (port of ``repro.kernels.ops``).

  * :func:`vq_amm`      fused assignment + LUT accumulate (kernel B1);
  * :func:`vq_assign`   assignment alone (kernel B3, the CCM stage);
  * :func:`lut_matmul`  LUT accumulate of given indices (kernel B4, the
                        IMM stage). ``vq_assign`` then ``lut_matmul`` is
                        the two-pass path (``QuantConfig(fuse=False)``),
                        the fused kernel's baseline.

Dispatch is by the tensors' device alone: CPU tensors take the plain
PyTorch version (``kernels.ref``), CUDA tensors take the kernel, which
raises on anything it cannot run. No option selects between them and
nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.similarity import Metric
from . import ref as _ref
from .assign import vq_assign_cuda
from .fused_amm import vq_amm_cuda
from .lut_gemm import lut_gemm_cuda


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


def vq_assign(x: torch.Tensor, z: torch.Tensor,
              metric: Metric = "l2") -> torch.Tensor:
    """CCM stage: nearest-centroid assignment per subspace.

    x (M, nc, v) inputs, z (nc, c, v) centroids -> (M, nc) int32 indices
    (the lowest index wins a tie).
    """
    if x.device.type == "cpu":
        return _ref.assign_ref(x, z, metric)
    return vq_assign_cuda(x, z, metric)


def lut_matmul(idx: torch.Tensor, lut: torch.Tensor,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IMM stage: accumulate precomputed partial products out of the LUT.

    idx (M, nc) int32 from :func:`vq_assign`, lut (nc, c, N), scale
    optional (N,) dequant scale (int8 LUTs) -> (M, N) float32,
    ``sum_k lut[k, idx[m, k], :]`` (x scale).
    """
    if idx.device.type == "cpu":
        return _ref.lut_gemm_onehot(idx, lut, scale)
    return lut_gemm_cuda(idx, lut, scale)
