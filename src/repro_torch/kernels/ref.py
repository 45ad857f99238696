"""Plain PyTorch versions of the VQ-AMM kernel (port of
``repro.kernels.ref``: ``assign_ref``, ``lut_gemm_onehot``, ``vq_amm_ref``).

``vq_amm_ref`` is the plain version of kernel B1 (``kernels/fused_amm.py``):
the CPU path runs it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card. Distances are taken in float32 whatever the input type,
as the fused kernels (the Pallas one and the CUDA one) compute them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.similarity import Metric, pairwise_distance_subspaces


def assign_ref(x: torch.Tensor, z: torch.Tensor,
               metric: Metric = "l2") -> torch.Tensor:
    """Nearest-centroid assignment per subspace.

    x (M, nc, v) inputs, z (nc, c, v) centroids -> (M, nc) int32; the
    lowest index wins a tie.
    """
    d = pairwise_distance_subspaces(x.float(), z.float(), metric)
    return torch.argmin(d, dim=-1).to(torch.int32)


def lut_gemm_onehot(idx: torch.Tensor, lut: torch.Tensor,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[m, n] = sum_k lut[k, idx[m, k], n] (x scale[n]) as a one-hot
    contraction in float32. idx (M, nc) int32, lut (nc, c, N) float or
    int8 -> (M, N) float32."""
    c = lut.shape[1]
    onehot = torch.nn.functional.one_hot(idx.long(), c).to(torch.float32)
    out = torch.einsum("mkc,kcn->mn", onehot, lut.to(torch.float32))
    if scale is not None:
        out = out * scale[None, :].to(torch.float32)
    return out


def vq_amm_ref(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               metric: Metric = "l2") -> torch.Tensor:
    """Plain version of the fused assign + lookup: x (M, nc, v),
    z (nc, c, v), lut (nc, c, N) -> (M, N) float32.

    ``vq_amm_ref.calls`` counts calls, so a run on the card can show that
    its main path never took the plain version."""
    vq_amm_ref.calls += 1
    return lut_gemm_onehot(assign_ref(x, z, metric), lut, scale)


vq_amm_ref.calls = 0
