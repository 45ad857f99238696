"""Analytical models of LUT-DLA (paper §VI-B, Eqs. 1–5 and Table I).

Port of ``repro.dse.models``: the same plain-Python arithmetic in the
same order, so every value equals the JAX package's exactly. The models
describe the paper's ASIC; no H100 term enters them.

All quantities use the paper's symbols:
  M, K, N      GEMM dims (input M×K, weight K×N)
  v            sub-vector length
  c            centroids per codebook
  beta         memory bandwidth (bits/cycle)
  n_ccu, n_imm module parallelism
"""
from __future__ import annotations

import dataclasses
import math
from enum import Enum
from typing import Dict

from repro_torch.core.similarity import ALPHA_SIM


@dataclasses.dataclass(frozen=True)
class LutDlaPoint:
    """One co-design point."""
    v: int
    c: int
    metric: str = "l2"
    n_ccu: int = 1
    n_imm: int = 1
    bits_lut: int = 8          # LUT entry width (paper +INT8 mode)
    bits_idx: int = 0          # derived: ceil(log2 c)
    bits_out: int = 32         # accumulator/output width
    tile_n: int = 128          # T_n

    def __post_init__(self):
        object.__setattr__(self, "bits_idx",
                           max(1, math.ceil(math.log2(self.c))))

    @property
    def equivalent_bits(self) -> float:
        return self.bits_idx / self.v


# ---------------------------------------------------------------------------
# Eq. (1): computation cost-utility tau(v, c)
# ---------------------------------------------------------------------------

def compute_model(m: int, k: int, n: int, pt: LutDlaPoint) -> Dict[str, float]:
    """OPs for the LUT path vs dense GEMM (paper Eq. 1)."""
    nc = k / pt.v
    alpha = ALPHA_SIM[pt.metric]
    op_sim = alpha * pt.c * m * k            # compare M·K elements to c cents
    op_add = m * n * nc                      # accumulate nc partials per out
    dense = 2.0 * m * n * k
    return {"op_sim": op_sim, "op_add": op_add, "total": op_sim + op_add,
            "dense_ops": dense, "speedup_ops": dense / (op_sim + op_add)}


# ---------------------------------------------------------------------------
# Eq. (2): memory phi(v, c)
# ---------------------------------------------------------------------------

def memory_model(m: int, k: int, n: int, pt: LutDlaPoint) -> Dict[str, float]:
    """Memory footprint in BITS (paper Eq. 2): LUT + output + indices."""
    nc = k / pt.v
    mem_lut = n * pt.c * nc * pt.bits_lut
    mem_out = m * n * pt.bits_out
    mem_idx = nc * m * pt.bits_idx
    return {"mem_lut": mem_lut, "mem_out": mem_out, "mem_idx": mem_idx,
            "total": mem_lut + mem_out + mem_idx}


# ---------------------------------------------------------------------------
# Table I: dataflow → on-chip memory requirements
# ---------------------------------------------------------------------------

class DataflowOrder(str, Enum):
    MNK = "MNK"
    NMK = "NMK"
    MKN = "MKN"
    KMN = "KMN"
    KNM = "KNM"
    LS = "LUT-Stationary"


def dataflow_memory(m: int, k: int, n: int, pt: LutDlaPoint,
                    order: DataflowOrder) -> Dict[str, float]:
    """On-chip KB per buffer for each loop order (reproduces Table I).

    Sizes are the minimum such that no LUT entry is loaded twice
    (paper's criterion). "K" here is the subspace loop (N_c iterations).
    """
    nc = k / pt.v
    lut_entry = pt.bits_lut / 8.0                        # bytes
    out_entry = pt.bits_out / 8.0
    idx_entry = pt.bits_idx / 8.0
    full_lut = nc * pt.c * n * lut_entry
    kb = 1024.0

    if order == DataflowOrder.MNK:
        # innermost K: one output element accumulates in place; all LUTs
        # must stay resident (revisited for every (m, n)).
        scratch = 1 * out_entry * 8
        idx = nc * idx_entry
        lut = full_lut
    elif order == DataflowOrder.NMK:
        scratch = 1 * out_entry * 8
        idx = m * nc * idx_entry                          # reused across n
        lut = full_lut
    elif order == DataflowOrder.MKN:
        scratch = n * out_entry                           # one output row
        idx = 1 * idx_entry
        lut = full_lut
    elif order == DataflowOrder.KMN:
        scratch = m * n * out_entry                       # all partials
        idx = 1 * idx_entry
        lut = pt.c * n * lut_entry                        # one subspace
    elif order == DataflowOrder.KNM:
        scratch = m * n * out_entry
        idx = m * idx_entry
        lut = pt.c * pt.tile_n * lut_entry                # one (k, n) tile
    else:  # LUT-Stationary: N outer, K middle, M inner with N tiled by T_n
        scratch = m * pt.tile_n * out_entry               # M × T_n psums
        idx = m * idx_entry
        lut = pt.c * pt.tile_n * lut_entry
    return {"scratchpad_kb": scratch / kb, "indices_kb": idx / kb,
            "psum_lut_kb": lut / kb,
            "total_kb": (scratch + idx + lut) / kb}


# ---------------------------------------------------------------------------
# Eq. (5): pipeline-balance cycles omega
# ---------------------------------------------------------------------------

def parallelism_model(m: int, k: int, n: int, pt: LutDlaPoint,
                      beta_bits_per_cycle: float) -> Dict[str, float]:
    """Clock cycles of the three pipeline phases; omega = max (Eq. 5)."""
    nc = k / pt.v
    load = (pt.c * nc * n * pt.bits_lut / beta_bits_per_cycle) / pt.n_imm
    sim = (m * k / pt.v) / pt.n_ccu          # one subspace compare per cycle
    lut = (m * n * nc / pt.tile_n) / pt.n_imm
    return {"load": load, "sim": sim, "lut": lut,
            "omega": max(load, sim, lut),
            "bound": max((("load", load), ("sim", sim), ("lut", lut)),
                         key=lambda t: t[1])[0]}


# ---------------------------------------------------------------------------
# Table VII: per-IMM SRAM + bandwidth
# ---------------------------------------------------------------------------

def imm_resources(v: int, c: int, tile_n: int, m: int,
                  bits_lut: int = 8, freq_hz: float = 300e6
                  ) -> Dict[str, float]:
    """SRAM KB and min streaming bandwidth for one IMM (paper Table VII).

    SRAM = ping-pong LUT tile pair (2·c·T_n int8) + requantised int8 psum
    scratch (M·T_n) + index buffer — exact on all three published designs
    (36.1 / 72.1 / 408.2 KB).

    Min bandwidth ≈ LUT tile stream (c·T_n entries per M-row sweep) plus the
    int8 activation/index streams; the paper's quoted numbers sit ~20-40%
    above the pure LUT stream, consistent with these side channels.
    """
    import math as _m
    lut_bytes = c * tile_n * bits_lut / 8
    psum_bytes = m * tile_n                               # int8 requantised
    idx_bytes = m * _m.ceil(_m.log2(c)) / 8
    sram_kb = (2 * lut_bytes + psum_bytes + idx_bytes) / 1024
    bw_lut = tile_n * c / m * freq_hz * (bits_lut / 8)
    bw_side = (v + 1) * freq_hz * 0.5                     # acts + idx stream
    return {"sram_kb": sram_kb, "bandwidth_gbs": (bw_lut + bw_side) / 1e9}
