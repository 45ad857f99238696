"""Cycle-approximate simulator of LUT-DLA executing GEMMs (paper §VII-C).

Port of ``repro.simulator.cycle_sim`` (same calibration, same layer
lists). It models the paper's accelerator, not the H100.

Throughput model (calibrated against the paper's Table IX: 4743k cycles for
a 512×768×768 GEMM at c=32, v=4, 16 LUT banks):

  * IMM: ``banks × n_imm`` element-lookup-accumulates per cycle — total
    element accumulates are M·N·N_c.
  * CCM: one centroid distance per CCU per cycle (M·N_c·c comparisons),
    overlapped with lookups (decoupled clock domains, §IV-A).
  * LS dataflow: per (k, n-tile) the ping-pong buffer preloads the next
    LUT tile during the M-row sweep; a stall occurs only when
    load_cycles > compute_cycles (paper Table VII bandwidth condition).
  * PQA (Table IX comparison): whole-layer LUT must be resident before
    compute (no ping-pong / on-demand tiles) → full un-overlapped load
    stalls, whole-layer on-chip SRAM, same lookup throughput.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from repro_torch.dse.models import LutDlaPoint


@dataclasses.dataclass
class LutDlaSim:
    pt: LutDlaPoint
    banks: int = 16                       # element lookups / cycle / IMM
    freq_hz: float = 300e6
    bw_gbs: float = 25.6                  # DDR4 (paper end-to-end setting)
    m_tile: int = 16                      # psum scratch rows (Table IX cfg)

    @property
    def bw_bytes_per_cycle(self) -> float:
        return self.bw_gbs * 1e9 / self.freq_hz

    def gemm_cycles(self, m: int, k: int, n: int) -> Dict[str, float]:
        pt = self.pt
        nc = math.ceil(k / pt.v)
        n_tiles = math.ceil(n / pt.tile_n)
        lut_tile_bytes = pt.c * pt.tile_n * pt.bits_lut / 8
        load_cycles = lut_tile_bytes / self.bw_bytes_per_cycle
        # per-(k, n-tile) lookup sweep over M rows
        tile_compute = m * pt.tile_n / (self.banks * pt.n_imm)
        stall_per_tile = max(0.0, load_cycles - tile_compute)
        tiles = nc * n_tiles
        lookup_total = tiles * (tile_compute + stall_per_tile)
        # CCM similarity: one distance per CCU-cycle, only on the first
        # n-tile pass (indices are buffered — Algorithm 1, line 5)
        sim_total = m * nc * pt.c / pt.n_ccu
        fill = tiles * 4
        cycles = max(lookup_total, sim_total) + fill
        return {
            "cycles": cycles, "stall_cycles": stall_per_tile * tiles,
            "sim_cycles": sim_total, "lookup_cycles": lookup_total,
            "fill": fill,
            "effective_acc_per_cycle": m * n * nc / cycles,
            "onchip_kb": (2 * lut_tile_bytes
                          + self.m_tile * pt.tile_n * 1     # int8 psum
                          + self.m_tile * pt.bits_idx / 8) / 1024,
        }

    def network_cycles(self, layers: List[Tuple[int, int, int]]
                       ) -> Dict[str, float]:
        tot = {"cycles": 0.0, "stall_cycles": 0.0, "macs": 0.0}
        for (m, k, n) in layers:
            r = self.gemm_cycles(m, k, n)
            tot["cycles"] += r["cycles"]
            tot["stall_cycles"] += r["stall_cycles"]
            tot["macs"] += m * k * n
        tot["time_s"] = tot["cycles"] / self.freq_hz
        tot["gops"] = 2 * tot["macs"] / tot["time_s"] / 1e9
        return tot


@dataclasses.dataclass
class PqaSim:
    """PQA-style execution (paper §VII-B / Table IX): the whole layer's LUT
    is loaded on-chip before compute starts (compute pause, no ping-pong
    overlap) and — per the paper's "does not allow for data reuse" — each
    of the `banks` lookup banks holds its own copy of the table (fp32
    entries, PQA's full-precision prototype). Calibrated against Table IX
    (7864k cycles)."""
    pt: LutDlaPoint
    banks: int = 16
    freq_hz: float = 300e6
    bw_gbs: float = 25.6
    entry_bits: int = 32

    @property
    def bw_bytes_per_cycle(self) -> float:
        return self.bw_gbs * 1e9 / self.freq_hz

    def gemm_cycles(self, m: int, k: int, n: int) -> Dict[str, float]:
        pt = self.pt
        nc = math.ceil(k / pt.v)
        lut_bytes = nc * pt.c * n * self.entry_bits / 8
        load = self.banks * lut_bytes / self.bw_bytes_per_cycle
        lookups = m * n * nc / (self.banks * pt.n_imm)
        sim = m * nc * pt.c / pt.n_ccu
        return {"cycles": load + max(lookups, sim),
                "stall_cycles": load,
                "onchip_kb": (lut_bytes + m * n * 1) / 1024}


# ---------------------------------------------------------------------------
# workload definitions (paper Fig 13: ResNet18 + BERT-base compute layers)
# ---------------------------------------------------------------------------

def _conv_as_gemm(hw: int, cin: int, cout: int, ksz: int,
                  stride: int = 1) -> Tuple[int, int, int]:
    out_hw = hw // stride
    return (out_hw * out_hw, cin * ksz * ksz, cout)


#: ResNet18 @224 conv layers (im2col GEMM shapes), batch 1
RESNET18_LAYERS: List[Tuple[int, int, int]] = (
    [_conv_as_gemm(56, 64, 64, 3)] * 4
    + [_conv_as_gemm(56, 64, 128, 3, 2)]
    + [_conv_as_gemm(28, 128, 128, 3)] * 3
    + [_conv_as_gemm(28, 128, 256, 3, 2)]
    + [_conv_as_gemm(14, 256, 256, 3)] * 3
    + [_conv_as_gemm(14, 256, 512, 3, 2)]
    + [_conv_as_gemm(7, 512, 512, 3)] * 3
    + [(1, 512, 1000)]
)

#: BERT-base layer GEMMs (seq 512): QKV+proj+FFN, ×12 layers
BERT_BASE_LAYERS: List[Tuple[int, int, int]] = (
    ([(512, 768, 768)] * 4 + [(512, 768, 3072), (512, 3072, 768)]) * 12
)


def simulate_gemm(m: int, k: int, n: int, pt: LutDlaPoint,
                  arch: str = "lutdla", **kw) -> Dict[str, float]:
    sim = LutDlaSim(pt, **kw) if arch == "lutdla" else PqaSim(pt, **kw)
    return sim.gemm_cycles(m, k, n)


def simulate_network(layers: List[Tuple[int, int, int]], pt: LutDlaPoint,
                     **kw) -> Dict[str, float]:
    return LutDlaSim(pt, **kw).network_cycles(layers)
