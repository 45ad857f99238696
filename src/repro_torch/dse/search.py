"""Co-Design Space Search Engine (paper §VI-C, Algorithm 2).

Port of ``repro.dse.search``: the same pruning order and greedy
expansion, so the best point and the statistics equal the JAX package's.

    min  omega(v, c, beta, n_IMM, n_CCU)
    s.t. tau, phi        <= GEMM requirements
         area, power     <= HW constraints
         LUTBoost(v, c)  >= accuracy constraint

Steps (Fig. 11): ① prune by compute/memory models; ② prune by hardware
models; ③ coarse-grained accuracy (a fast-trainable proxy or a supplied
accuracy table); ④ LUT-first greedy parallelism expansion — when lookup
throughput is the binding phase, add IMMs so idle CCUs serve more IMMs;
when similarity comparison binds, add CCUs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .models import LutDlaPoint, compute_model, memory_model, parallelism_model
from .ppa import design_ppa


@dataclasses.dataclass
class SearchConstraints:
    m: int = 512
    k: int = 768
    n: int = 768
    beta_bits_per_cycle: float = 683.0     # 25.6 GB/s @ 300 MHz
    max_ops_ratio: float = 1.0             # tau must beat dense GEMM
    max_mem_ratio: float = 4.0             # phi vs dense weight bytes
    max_area_mm2: float = 4.0
    max_power_mw: float = 500.0
    min_accuracy: float = 0.0              # on the proxy accuracy scale
    max_units: int = 256


@dataclasses.dataclass
class SearchResult:
    point: LutDlaPoint
    omega: float
    bound: str
    area_mm2: float
    power_mw: float
    accuracy: float
    history: List[Dict] = dataclasses.field(default_factory=list)


def co_design_search(
    constraints: SearchConstraints,
    v_space: Iterable[int] = (2, 3, 4, 6, 8, 9, 12, 16),
    c_space: Iterable[int] = (8, 16, 32, 64),
    metrics: Iterable[str] = ("l2", "l1", "chebyshev"),
    accuracy_fn: Optional[Callable[[LutDlaPoint], float]] = None,
    verbose: bool = False,
) -> Tuple[Optional[SearchResult], Dict[str, int]]:
    """Algorithm 2. Returns (best design, pruning statistics)."""
    cn = constraints
    m, k, n = cn.m, cn.k, cn.n
    stats = {"total": 0, "pruned_compute": 0, "pruned_memory": 0,
             "pruned_hw": 0, "pruned_accuracy": 0, "expanded": 0}
    dense_bits = k * n * 8                        # int8 dense weight bytes
    best: Optional[SearchResult] = None

    for metric in metrics:
        for v in v_space:
            if k % v:
                continue
            for c in c_space:
                stats["total"] += 1
                pt = LutDlaPoint(v=v, c=c, metric=metric)

                # -- Step 1a: compute pruning (Eq. 1) --------------------
                ops = compute_model(m, k, n, pt)
                if ops["total"] > cn.max_ops_ratio * ops["dense_ops"]:
                    stats["pruned_compute"] += 1
                    continue
                # -- Step 1b: memory pruning (Eq. 2) ---------------------
                mem = memory_model(m, k, n, pt)
                if mem["total"] > cn.max_mem_ratio * dense_bits:
                    stats["pruned_memory"] += 1
                    continue
                # -- Step 2: base hardware constraint --------------------
                ppa1 = design_ppa(pt)
                if (ppa1.area_mm2 > cn.max_area_mm2
                        or ppa1.power_mw > cn.max_power_mw):
                    stats["pruned_hw"] += 1
                    continue
                # -- Step 3: coarse accuracy -----------------------------
                acc = accuracy_fn(pt) if accuracy_fn else 1.0
                if acc < cn.min_accuracy:
                    stats["pruned_accuracy"] += 1
                    continue
                # -- Step 4: LUT-first greedy parallelism expansion ------
                n_ccu, n_imm = 1, 1
                while n_ccu + n_imm < cn.max_units:
                    cand = LutDlaPoint(v=v, c=c, metric=metric,
                                       n_ccu=n_ccu, n_imm=n_imm,
                                       tile_n=pt.tile_n)
                    ppa = design_ppa(cand)
                    if (ppa.area_mm2 > cn.max_area_mm2
                            or ppa.power_mw > cn.max_power_mw):
                        break
                    par = parallelism_model(m, k, n, cand,
                                            cn.beta_bits_per_cycle)
                    res = SearchResult(cand, par["omega"], par["bound"],
                                       ppa.area_mm2, ppa.power_mw, acc)
                    if best is None or res.omega < best.omega:
                        best = res
                        stats["expanded"] += 1
                    # greedy: grow whichever phase binds (paper: IMM-bound
                    # when the lookup dominates and n_imm < n_ccu*N)
                    if par["bound"] == "lut" and n_imm < n_ccu * n:
                        n_imm += 1
                    elif par["bound"] == "sim":
                        n_ccu += 1
                    else:          # load-bound: more IMMs only split BW
                        break
                if verbose and best is not None:
                    print(f"  ({metric},v={v},c={c}) acc={acc:.3f} "
                          f"omega={best.omega:.0f}")
    return best, stats
