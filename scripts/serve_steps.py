#!/usr/bin/env python3
"""The serve phase of ``chip_smoke.py`` alone, for one tree of this
repository on an NVIDIA GPU: full-width qwen1.5-4b (lut_infer, int8
LUTs, random weights from the seed) serving chip_smoke's 10 requests
under the named configurations, each printing its generated tokens/s,
mean decode-step and mean prefill-chunk wall time (``chip_smoke.serve``),
plus the median decode step.

Everything comes from the named tree's own ``chip_smoke.py`` and
``src/``, so serve times of two commits can be compared in turns, one
process per tree and turn, without the kernel phase before them:

    python3 scripts/serve_steps.py [--tree DIR] [--configs two-pass,fused]
                                   [--save TOKENS.json]

``--save`` writes each configuration's generated tokens, for comparing
two trees' greedy tokens.

Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the tree whose serve path runs")
    ap.add_argument("--configs", default="two-pass,fused",
                    help="comma list of fused, two-pass, vq-kv")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", help="JSON file for the generated tokens")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_steps: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs       # the tree's own; it puts its src/ first
    cs._build.build()
    cfg = cs.qwen1p5_4b.config()
    qc = cs.QuantConfig(mode="lut_infer", v=cs.V, c=cs.C, metric="l2",
                        lut_dtype="int8")
    model = cs.Model(cfg)
    params = model.init(torch.Generator(device=cs.DEV).manual_seed(
        args.seed), qc)
    runs = {"fused": (qc, {"b1"}, {"b3", "b4"}),
            "two-pass": (qc.replace(fuse=False), {"b3", "b4"}, {"b1"}),
            "vq-kv": (qc.replace(kv_quant="vq", kv_v=cs.KV_V,
                                 kv_c=cs.KV_C), {"b1", "b5"}, {"b3", "b4"})}
    tokens = {}
    for label in args.configs.split(","):
        qc_r, launched, idle = runs[label]
        steps = []
        real = cs.Engine._decode_step

        def timed(self, *a, real=real):
            t0 = time.perf_counter()
            out = real(self, *a)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            return out
        cs.Engine._decode_step = timed
        try:
            _, tokens[label], _ = cs.serve(model, params, qc_r, args.seed,
                                           label, launched, idle)
        finally:
            cs.Engine._decode_step = real
        print(f"serve [{label}] tree {args.tree}: median decode step "
              f"{1e3 * float(np.median(steps)):.1f} ms over {len(steps)}")
    if args.save:
        with open(args.save, "w") as f:
            json.dump(tokens, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
