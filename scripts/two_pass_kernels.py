#!/usr/bin/env python3
"""Kernels B3 (assign) and B4 (LUT gather-accumulate) of one tree of this
repository on an NVIDIA GPU, timed at the main path's six projection
shapes (M = 8 and 32; 2560->2560, 2560->6912, 6912->2560; int8 LUTs):
flushed (``chip_smoke.time_ms``), warm in a CUDA graph of 30 calls
(``chip_smoke.graph_ms``), host µs a call (``chip_smoke.host_us``) and
what one call enqueues (``repro_torch.device.enqueued``); then B4 with
float32 and bfloat16 LUTs, flushed; then B3 and B4 at M=8, N=6912 with
nc cut to 80 / 160 / 320, flushed and warm.

Every helper and wrapper comes from the named tree's own
``chip_smoke.py`` and ``src/``, so one call can time two commits in turn,
each from its own root and build:

    python3 scripts/two_pass_kernels.py [--tree DIR]   # default: this tree

Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the tree whose kernels are timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("two_pass_kernels: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs       # the tree's own; it puts its src/ first
    from repro_torch.device import enqueued
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"tree {tree}")
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device=cs.DEV)
    b3, b4 = cs.vq_assign_cuda, cs.lut_gemm_cuda
    # a process's first timed series reads high (B3 at 17-23 us against
    # 8-14 measured after it, in both trees): one is run and dropped
    x, z, lut, scale, _ = cs.vq_inputs(gen, 8, 2560, 2560)
    idx = b3(x, z)
    for fn in (lambda: b3(x, z), lambda: b4(idx, lut, scale)):
        cs.time_ms(fn, 30, flush)
    lay = {}
    for m in (8, 32):
        for k, n, cnt in cs.PROJ_SHAPES:
            x, z, lut, scale, _ = cs.vq_inputs(gen, m, k, n)
            idx = b3(x, z)
            row = {}
            for name, fn in (("B3", lambda: b3(x, z)),
                             ("B4", lambda: b4(idx, lut, scale))):
                r = (cs.time_ms(fn, 30, flush), cs.graph_ms(fn),
                     cs.host_us(fn), enqueued(fn))
                row[name] = r
                acc = lay.setdefault((name, m), [0.0, 0.0])
                acc[0] += cnt * r[0]
                acc[1] += cnt * r[1]
            floats = []
            for dt in (torch.float32, torch.bfloat16):
                lf = (lut.float() * scale).to(dt).contiguous()
                floats.append(cs.time_ms(lambda: b4(idx, lf), 30, flush))
            print(f"M={m} K={k} N={n}: " + "; ".join(
                f"{name} {r[0] * 1e3:.1f} us flushed, {r[1] * 1e3:.1f} us "
                f"warm, host {r[2]:.1f} us, enqueues {r[3]}"
                for name, r in row.items())
                + f"; B4 float32 / bfloat16 LUT {floats[0] * 1e3:.1f} / "
                f"{floats[1] * 1e3:.1f} us flushed")
    for (name, m), (ms, warm) in lay.items():
        print(f"{name} per layer (7 projections) at M={m}: "
              f"{ms * 1e3:.1f} us flushed, {warm * 1e3:.1f} us warm")
    for nc in (80, 160, 320):
        x, z, lut, scale, _ = cs.vq_inputs(gen, 8, nc * cs.V, 6912)
        idx = b3(x, z)
        t = [f(fn) for fn in (lambda: b3(x, z), lambda: b4(idx, lut, scale))
             for f in (lambda g: cs.time_ms(g, 30, flush), cs.graph_ms)]
        print(f"nc sweep M=8 N=6912 nc={nc}: B3 {t[0] * 1e3:.1f} / "
              f"{t[1] * 1e3:.1f} us, B4 {t[2] * 1e3:.1f} / {t[3] * 1e3:.1f} "
              "us (flushed / warm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
