"""Co-design space exploration with the PyTorch port's models (paper §VI,
Algorithm 2 + Fig 11; twin of ``examples/dse_search.py``).

Searches (v, c, metric, n_CCU, n_IMM) under area/power/accuracy constraints
and dumps the pruning heatmaps as CSV. The models describe the paper's
accelerator and run on the host: ``--device`` is accepted so every twin
takes the same command line, and names no tensor here.

Where it differs from the JAX example: the heatmap is written whatever
the search finds, and "no feasible design" is a result (exit 0), not an
error. The JAX example exits 1 before its heatmap whenever no point is
feasible, which its own defaults always give: its accuracy proxy clears
0.9 only at v=2, c=8, whose LUTs alone take the whole 4x memory budget.
The rows of the CSV are the JAX example's, byte for byte.

Run: PYTHONPATH=src python examples/torch_dse_search.py [--area MM2]
     [--power MW] [--csv PATH]
"""
import argparse
import csv
import os
import sys

from repro_torch.dse.models import LutDlaPoint, compute_model, memory_model
from repro_torch.dse.ppa import design_ppa
from repro_torch.dse.search import SearchConstraints, co_design_search

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def accuracy_proxy(pt: LutDlaPoint) -> float:
    """Fast stand-in for LUTBoost coarse accuracy (paper step ③): the
    empirical trends of Table V — accuracy rises with c, falls with v,
    and L1/Chebyshev cost a small penalty."""
    base = 1.0 - 0.055 * pt.v + 0.012 * min(pt.c, 48) ** 0.5 * pt.v ** 0.25
    penalty = {"l2": 0.0, "l1": 0.01, "chebyshev": 0.02}[pt.metric]
    return base - penalty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--area", type=float, default=4.0)
    ap.add_argument("--power", type=float, default=500.0)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--k", type=int, default=768)
    ap.add_argument("--n", type=int, default=768)
    ap.add_argument("--csv",
                    default=os.path.join(ROOT, "build", "dse_heatmap.csv"))
    ap.add_argument("--device", default="cuda",
                    help="accepted for a uniform command line; the search "
                         "is host arithmetic")
    args = ap.parse_args(argv)

    cn = SearchConstraints(m=args.m, k=args.k, n=args.n,
                           max_area_mm2=args.area, max_power_mw=args.power,
                           min_accuracy=0.9)
    best, stats = co_design_search(cn, accuracy_fn=accuracy_proxy,
                                   verbose=True)
    print("\npruning stats:", stats)
    if best is None:
        print("no feasible design under these constraints")
    else:
        p = best.point
        print(f"\nbest design: v={p.v} c={p.c} metric={p.metric} "
              f"n_ccu={p.n_ccu} n_imm={p.n_imm}")
        print(f"  omega={best.omega:.0f} cycles/GEMM (bound: {best.bound})")
        print(f"  area={best.area_mm2:.2f} mm2, power={best.power_mw:.0f} "
              f"mW, equiv bits={p.equivalent_bits:.2f}")

    # Fig 11-style heatmap dump over (v, c)
    os.makedirs(os.path.dirname(os.path.abspath(args.csv)), exist_ok=True)
    with open(args.csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["v", "c", "metric", "ops_ratio", "mem_ratio",
                    "area_mm2", "power_mw", "accuracy"])
        for metric in ("l2", "l1", "chebyshev"):
            for v in (2, 3, 4, 6, 8, 12, 16):
                for c in (8, 16, 32, 64):
                    pt = LutDlaPoint(v=v, c=c, metric=metric)
                    ops = compute_model(args.m, args.k, args.n, pt)
                    mem = memory_model(args.m, args.k, args.n, pt)
                    ppa = design_ppa(pt)
                    w.writerow([v, c, metric,
                                f"{ops['total'] / ops['dense_ops']:.4f}",
                                f"{mem['total'] / (args.k * args.n * 8):.3f}",
                                f"{ppa.area_mm2:.3f}",
                                f"{ppa.power_mw:.1f}",
                                f"{accuracy_proxy(pt):.3f}"])
    print(f"heatmap written to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
