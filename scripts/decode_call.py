#!/usr/bin/env python3
"""One ``flash_decode_paged`` call of one tree of this repository on an
NVIDIA GPU, at the main path's attention shape (8 slots x 20 heads,
head_dim 128, pages of 16, 32 pages a slot, chip_smoke's seeded mixed
lengths) and at one slot of 4096 tokens: an fp pool (bfloat16, and
float32) and a uint8 code pool (nc=32, c=16). For each case it prints the
whole call's device time flushed (``chip_smoke.time_ms``; mean and
median of 30) and warm in a CUDA graph of 30 calls
(``chip_smoke.graph_ms``), host µs a call and what one call enqueues
(``repro_torch.device.enqueued``), and saves the outputs, so two trees
can be compared bit for bit:

    python3 scripts/decode_call.py [--tree DIR] --save OUT.pt
    python3 scripts/decode_call.py --compare A.pt B.pt

The inputs come from a seeded generator on the card, made by this script
whatever the tree; the call, the kernels and the timing helpers are the
named tree's own (its ``chip_smoke.py`` and ``src/``). Exits 2 without a
CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, HEADS, HEAD_DIM, PAGE, PAGES = 8, 20, 128, 16, 32
NC, CODES = 32, 16


def inputs(seed, b, np_, positions, pool, dtype):
    """q, k_new, v_new in dtype; the pool (fp in dtype, or uint8 codes with
    random tables); phys with unallocated pages on the trash page."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = b * np_

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = randn(b, 1, HEADS, HEAD_DIM).to(dtype)
    kn = randn(b, 1, HEADS, HEAD_DIM).to(dtype)
    vn = randn(b, 1, HEADS, HEAD_DIM).to(dtype)
    codebook = None
    if pool == "codes":
        kp, vp = (torch.randint(0, CODES, (n_pages + 1, PAGE, HEADS, NC),
                                generator=gen, device="cuda").to(torch.uint8)
                  for _ in range(2))
        codebook = {"zk": randn(NC, CODES, HEAD_DIM // NC),
                    "zv": randn(NC, CODES, HEAD_DIM // NC),
                    "sk": 0.5 + randn(HEADS).abs(),
                    "sv": 0.5 + randn(HEADS).abs()}
    else:
        kp = randn(n_pages + 1, PAGE, HEADS, HEAD_DIM).to(dtype)
        vp = randn(n_pages + 1, PAGE, HEADS, HEAD_DIM).to(dtype)
    phys = torch.randperm(n_pages, generator=gen, device="cuda").reshape(
        b, np_).to(torch.int32)
    for i, p in enumerate(positions):
        phys[i, max(0, -(-p // PAGE)):] = n_pages
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, kp, vp, kn, vn, phys, pos, codebook


def run(tree, save):
    sys.path.insert(0, tree)
    import chip_smoke as cs       # the tree's own; it puts its src/ first
    from repro_torch.device import enqueued
    from repro_torch.kernels import flash_decode as fd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"tree {tree}")
    cs._build.build()
    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device="cuda")
    rng = np.random.default_rng(0)        # chip_smoke's main-path lengths
    main_pos = sorted(rng.integers(32, 512, SLOTS).tolist())
    cases = [("main fp bf16", SLOTS, PAGES, main_pos, "fp", torch.bfloat16),
             ("main fp f32", SLOTS, PAGES, main_pos, "fp", torch.float32),
             ("main codes", SLOTS, PAGES, main_pos, "codes", torch.bfloat16),
             ("one slot 4096 fp bf16", 1, 256, [4095], "fp",
              torch.bfloat16),
             ("one slot 4096 codes", 1, 256, [4095], "codes",
              torch.bfloat16)]
    outs = {}
    for i, (name, b, np_, positions, pool, dtype) in enumerate(cases):
        q, kp, vp, kn, vn, phys, pos, cb = inputs(i, b, np_, positions, pool,
                                                  dtype)

        def call():
            return fd.flash_decode_paged(q, kp, vp, kn, vn, phys, pos,
                                         codebook=cb)
        outs[name] = call().cpu()
        times = cs.device_times(call, 30, flush)
        warm = cs.graph_ms(call)
        host = cs.host_us(call)
        calls = enqueued(call)
        print(f"decode_call [{name}]: {1e3 * float(np.mean(times)):.2f} us "
              f"flushed (median {1e3 * float(np.median(times)):.2f}), "
              f"{1e3 * warm:.2f} us warm in a graph, host {host:.1f} us a "
              f"call, enqueues {calls}; 40 layers: "
              f"{40 * float(np.mean(times)):.3f} ms flushed, "
              f"{40 * warm:.3f} ms warm a decode step")
    if save:
        torch.save(outs, save)


def compare(a, b):
    x, y = torch.load(a), torch.load(b)
    for name in x:
        same = torch.equal(x[name], y[name])
        diff = float((x[name].float() - y[name].float()).abs().max())
        print(f"decode_call compare [{name}]: "
              f"{'bitwise equal' if same else 'differ'}, max abs diff "
              f"{diff:.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the tree whose call runs")
    ap.add_argument("--save", help="file for the outputs (torch.save)")
    ap.add_argument("--compare", nargs=2, metavar="FILE",
                    help="compare two saved runs and exit")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if not torch.cuda.is_available():
        print("decode_call: no CUDA device visible to torch", file=sys.stderr)
        return 2
    run(os.path.abspath(args.tree), args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
