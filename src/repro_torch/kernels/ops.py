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
nothing falls back. Meta tensors (the dry run, ``launch``) run nothing:
under an open ``launch.op_cost.OpCost`` the call records its kernel's
work (``kernels.work``) and returns an empty meta result; outside one it
raises. Under an OpCost a CPU or CUDA call records the same work and runs
as it would without.

Each also takes a leading expert axis on every operand, the per-expert
projections of an MoE layer (``models/moe.py``), where the JAX package
vmaps these entry points over the experts: on the card that is one
launch of the kernel for all experts. A routed layer also passes
``counts``, an int64 vector (E,) on the operands' device holding each
expert buffer's live rows (the pairs the router kept there; the kernels
clamp it to M), and ``most_live``, the most live rows of the call in all
(T x k): rows past an expert's count come out 0.0 (index 0 from
``vq_assign``) and the kernels do no work on them. Without counts every
call is as before, and nothing here reads a count on the host: under an
OpCost the recorded work is the bound ``most_live`` gives
(``kernels.work``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.similarity import Metric
from repro_torch.launch.op_cost import kernel_call, meta_result
from . import ref as _ref
from . import work as _work
from .assign import vq_assign_cuda
from .fused_amm import vq_amm_cuda
from .lut_gemm import lut_gemm_cuda


def _live(counts: Optional[torch.Tensor], most_live: Optional[int]
          ) -> dict:
    """The live-row arguments a kernel or plain version takes: none
    without counts, so a call without them is the call it always was.
    An OpCost records their bound, ``most_live`` (no count is read)."""
    return {} if counts is None else {"counts": counts,
                                      "most_live": most_live}


def vq_amm(x: torch.Tensor, z: torch.Tensor, lut: torch.Tensor,
           scale: Optional[torch.Tensor] = None,
           metric: Metric = "l2", counts: Optional[torch.Tensor] = None,
           most_live: Optional[int] = None) -> torch.Tensor:
    """Fused approximate matmul: assignment + LUT accumulation in one.

    Args:
      x: (M, nc, v) inputs; z: (nc, c, v) centroids;
      lut: (nc, c, N) precomputed table; scale: optional (N,) dequant
        scale (int8 LUTs); or each with a leading expert axis E.
      metric: "l2" | "l1" | "chebyshev".
      counts, most_live: live rows of each expert and their bound (the
        module's docstring).

    Returns: (M, N) float32 (grouped: (E, M, N)),
    ``sum_k lut[k, argmin_j d(x[m,k], z[k,j]), :]`` (x scale); 0.0 past
    each expert's count.
    """
    live = _live(counts, most_live)
    with kernel_call("b1", x.device, lambda: _work.vq_amm(
            x, z, lut, scale, most_live=live.get("most_live"))):
        if x.is_meta:
            return meta_result(x.shape[:-2] + lut.shape[-1:], torch.float32)
        if x.device.type == "cpu":
            return _ref.vq_amm_ref(x, z, lut, scale, metric, **live)
        return vq_amm_cuda(x, z, lut, scale, metric, **live)


def vq_assign(x: torch.Tensor, z: torch.Tensor, metric: Metric = "l2",
              counts: Optional[torch.Tensor] = None,
              most_live: Optional[int] = None) -> torch.Tensor:
    """CCM stage: nearest-centroid assignment per subspace.

    x (M, nc, v) inputs, z (nc, c, v) centroids -> (M, nc) int32 indices
    (the lowest index wins a tie); grouped: (E, M, nc, v), (E, nc, c, v)
    -> (E, M, nc); index 0 past each expert's count.
    """
    live = _live(counts, most_live)
    with kernel_call("b3", x.device, lambda: _work.vq_assign(
            x, z, most_live=live.get("most_live"))):
        if x.is_meta:
            return meta_result(x.shape[:-1], torch.int32)
        if x.device.type == "cpu":
            return _ref.assign_ref(x, z, metric, **live)
        return vq_assign_cuda(x, z, metric, **live)


def lut_matmul(idx: torch.Tensor, lut: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               counts: Optional[torch.Tensor] = None,
               most_live: Optional[int] = None) -> torch.Tensor:
    """IMM stage: accumulate precomputed partial products out of the LUT.

    idx (M, nc) int32 from :func:`vq_assign`, lut (nc, c, N), scale
    optional (N,) dequant scale (int8 LUTs) -> (M, N) float32,
    ``sum_k lut[k, idx[m, k], :]`` (x scale); grouped: (E, M, nc),
    (E, nc, c, N), (E, N) -> (E, M, N); 0.0 past each expert's count.
    """
    live = _live(counts, most_live)
    with kernel_call("b4", idx.device, lambda: _work.lut_gemm(
            idx, lut, scale, most_live=live.get("most_live"))):
        if idx.is_meta:
            return meta_result(idx.shape[:-1] + lut.shape[-1:],
                               torch.float32)
        if idx.device.type == "cpu":
            return _ref.lut_gemm_onehot(idx, lut, scale, **live)
        return lut_gemm_cuda(idx, lut, scale, **live)
