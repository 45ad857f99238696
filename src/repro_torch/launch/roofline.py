"""Roofline analysis of a costed program (port of ``repro.launch.roofline``,
with the peaks of one NVIDIA H100).

Three terms per (arch x shape x mesh), in seconds, all PER DEVICE (the
cost is that of one rank's program, ``launch.op_cost``):

  t_compute    = flops / 989e12 FLOP/s (bf16, tensor cores)
               + core_ops / 67e12 op/s (CUDA cores)
  t_memory     = bytes / 3.35e12 B/s (HBM3)
  t_collective = collective_bytes / (18 links x 25e9 B/s, NVLink 4)

``flops`` are the matmul-class FLOPs of the program's aten ops, as the
JAX report counts dots. ``core_ops`` are the LUT kernels' work on CUDA
cores (distances, compares, gathers and adds: ``kernels.work``), which
has no tensor-core counterpart. The port's eager kernels run one after
another on one stream, so the two compute terms add. Where the JAX
package takes its figures from the compiled HLO, the port counts the
ops of one eager run of the rank's program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# ---- one NVIDIA H100 SXM5 (80 GB HBM3), at its 700 W power limit -------
#: Dense BF16 tensor-core FLOP/s (NVIDIA H100 data sheet, SXM column,
#: 1,979 TFLOP/s with sparsity).
PEAK_FLOPS = 989e12
#: FP32 CUDA-core operations a second (data sheet: 67 TFLOP/s FP32); also
#: the rate taken for int32 adds and compares.
CORE_OPS = 67e12
#: HBM3 bytes a second (data sheet: 3.35 TB/s).
HBM_BW = 3.35e12
#: NVLink 4 bytes a second, one direction of one link (data sheet: 900
#: GB/s bidirectional over 18 links).
NVLINK_BW = 25e9
#: NVLink 4 links of one card.
NVLINK_LINKS = 18


@dataclasses.dataclass
class RooflineReport:
    """All cost figures are PER DEVICE (one rank's program);
    ``model_flops`` / ``model_bytes`` are the GLOBAL useful work (bytes =
    the irreducible HBM traffic: params + caches + optimizer state,
    read/written once)."""
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, int]
    chips: int
    model_flops: float = 0.0
    model_bytes: float = 0.0
    core_ops: float = 0.0

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(v for k, v in self.coll_bytes.items()
                         if k != "count"))

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS + self.core_ops / CORE_OPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.total_coll_bytes / (NVLINK_BW * NVLINK_LINKS)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted flops (remat/redundancy waste)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def t_ideal(self) -> float:
        """Roofline-ideal step time: the workload's own compute/bandwidth
        floor (whichever is larger) on perfect hardware utilisation."""
        return max(self.model_flops / (self.chips * PEAK_FLOPS),
                   self.model_bytes / (self.chips * HBM_BW))

    @property
    def roofline_fraction(self) -> float:
        """ideal step time / achievable step time (bound by max term)."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_ideal / t_bound if t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "core_ops_per_device": self.core_ops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.total_coll_bytes,
            "collectives": {k: v for k, v in self.coll_bytes.items()},
            "chips": self.chips, "model_flops": self.model_flops,
            "model_bytes": self.model_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "t_ideal_s": self.t_ideal,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(cost, chips: int, model_flops: float = 0.0,
            model_bytes: float = 0.0) -> RooflineReport:
    """Roofline terms from an :class:`~repro_torch.launch.op_cost.OpCost`
    (one rank's program), over ``chips`` devices."""
    coll = {k: int(v) for k, v in cost.coll.items()}
    coll["count"] = int(cost.coll_count)
    return RooflineReport(flops=cost.flops, bytes_accessed=cost.bytes,
                          coll_bytes=coll, chips=chips,
                          model_flops=model_flops, model_bytes=model_bytes,
                          core_ops=cost.core_ops)


def model_flops_for(cfg, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (forward) per token, using
    active params (MoE counts routed top-k + shared only)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * batch


def model_bytes_for(cfg, kind: str, batch: int, seq: int,
                    param_bytes: float, cache_bytes: float = 0.0) -> float:
    """Irreducible global HBM traffic per step.

    decode : stream all (LUT/dense) params once + read the KV/state cache
    prefill: params + write the cache once
    train  : params fwd+bwd reads + grad write + fp32 Adam m/v read+write
    """
    if kind == "decode":
        return param_bytes + cache_bytes
    if kind == "prefill":
        return param_bytes + cache_bytes
    n_params = param_bytes / 2.0          # bf16 params
    return 3.0 * param_bytes + 16.0 * n_params
