"""Perf hill-climb runner (port of ``repro.launch.hillclimb``): re-run the
three chosen cells' dry run (``launch.dryrun.run_cell``, meta device,
H100 roofline) after each code change and log (tag, roofline) to
``results/perf_torch/``.

Cells (the JAX package's choice):
  * zamba2-1.2b  x long_500k   -- worst baseline roofline fraction
  * gemma3-4b    x prefill_32k -- most collective-bound
  * gemma3-27b   x decode_32k  -- most representative of the paper's
                                  technique (large-model LUT-int8 decode)

    python -m repro_torch.launch.hillclimb --tag I1_bf16_kv \\
        [--cell arch:shape] [--override key=value ...]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh

CELLS = [
    ("zamba2-1.2b", "long_500k"),
    ("gemma3-4b", "prefill_32k"),
    ("gemma3-27b", "decode_32k"),
]


def parse_override(kv: str):
    """``key=value`` -> (key, int / float / bool / str value)."""
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            continue
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True,
                    help="iteration tag, e.g. I1_bf16_kv")
    ap.add_argument("--cell", default="all", help="'all' or arch:shape")
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    args = ap.parse_args(argv)

    overrides = dict(parse_override(kv) for kv in args.override)
    cells = CELLS if args.cell == "all" else [tuple(args.cell.split(":"))]
    mesh = make_production_mesh()
    os.makedirs(args.out, exist_ok=True)
    for arch, shape in cells:
        res = run_cell(arch, shape, mesh, "lut", cfg_overrides=overrides)
        path = os.path.join(args.out, f"{args.tag}__{arch}__{shape}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        rl = res.get("roofline", {})
        print(f"[hillclimb:{args.tag}] {arch}x{shape}: "
              f"frac={rl.get('roofline_fraction', 0):.4f} "
              f"t_mem={rl.get('t_memory_s', 0):.3e} "
              f"t_comp={rl.get('t_compute_s', 0):.3e} "
              f"t_coll={rl.get('t_collective_s', 0):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
