#!/usr/bin/env python3
"""Grouped B1 (``vq_amm_cuda``) and B3 (``vq_assign_cuda``) of one tree of
this repository on an NVIDIA GPU, at the MoE expert shapes: deepseek-moe-16b's
routed wg/wu (64 experts, 2048 -> 1408) and wd (1408 -> 2048), and a
dbrx-132b expert layer's w1 (16 experts, 6144 -> 10752) and w2 (10752 ->
6144), 8 capacity rows an expert, int8 LUTs, bfloat16 x.

Each shape runs at two buffers:
  * decode: the rows a decode step of 8 tokens fills (a seeded router,
    top-6 of 64 or top-4 of 16, each expert's pairs up to its capacity),
    the other rows zero, as the dispatch leaves them. A tree whose
    wrappers take live-row counts gets them (``counts``, ``most_live`` =
    T x k); an older tree computes every row, as its decode step does.
  * full: every row random, no counts (the buffers earlier PRs timed).

For each it prints the device time flushed (``chip_smoke.device_times``,
mean and median of 30) and warm in a CUDA graph of 30 calls
(``chip_smoke.graph_ms``), host µs a call, what one call enqueues, the
launch's geometry, and the bound at the H100's peaks of what the call
must move (``kernels.work``'s count with counts: live rows of x, z and
scale of experts with a live row, the LUT rows live rows select, the
whole output). It saves B1's outputs and B3's indices, so two trees'
live rows can be compared bit for bit:

    python3 scripts/grouped_call.py [--tree DIR] --save OUT.pt
    python3 scripts/grouped_call.py --compare A.pt B.pt

The inputs come from a seeded generator on the card, made by this script
whatever the tree; the kernels and the timing helpers are the named
tree's own (its ``chip_smoke.py`` and ``src/``). To compare two trees on
one card, run them in turns (parent, change, change, parent), each with
``--tree``. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, C, CAP, TOKENS = 8, 16, 8, 8
DEV = "cuda"
HBM_BW, CORE_OPS = 3.35e12, 67e12     # H100 SXM peaks (launch.roofline)

# (label, experts, K, N, top-k of the router)
CASES = (("deepseek-moe-16b routed wg/wu", 64, 2048, 1408, 6),
         ("deepseek-moe-16b routed wd", 64, 1408, 2048, 6),
         ("dbrx-132b w1", 16, 6144, 10752, 4),
         ("dbrx-132b w2", 16, 10752, 6144, 4))


def decode_counts(gen, e, k):
    """Each expert's live rows after routing TOKENS tokens (top-k of e,
    random router logits; the lowest expert wins a tie) into buffers of
    CAP rows: the pairs it received, up to CAP."""
    probs = torch.softmax(torch.randn((TOKENS, e), generator=gen,
                                      device=DEV), -1)
    eid = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    return torch.bincount(eid.reshape(-1), minlength=e).clamp(max=CAP)


def inputs(gen, e, kdim, n):
    """x rows that are a centroid of their expert plus small noise (a
    clear argmin), z, an int8 LUT and its scale."""
    nc = kdim // V
    z = (0.02 * torch.randn((e, nc, C, V), generator=gen,
                            device=DEV)).to(torch.bfloat16)
    pick = torch.randint(0, C, (e, CAP, nc), generator=gen, device=DEV)
    x = z.float()[torch.arange(e, device=DEV)[:, None, None],
                  torch.arange(nc, device=DEV)[None, None], pick]
    x = (x + 0.002 * torch.randn(x.shape, generator=gen, device=DEV)).to(
        torch.bfloat16)
    lut = torch.randint(-127, 128, (e, nc, C, n), generator=gen,
                        device=DEV, dtype=torch.int32).to(torch.int8)
    scale = 1e-3 + 1e-2 * torch.rand((e, n), generator=gen, device=DEV)
    return x, z, lut, scale


def bound_us(x, z, lut, live, idx):
    """B1's and B3's least time at the H100's peaks for the live rows
    ``live`` (E, M) bool: bytes (live rows of x, z and scale of experts
    with one, the LUT rows they select, the whole output) and CUDA-core
    operations, whichever takes longer."""
    e, m, nc, v = x.shape
    c, n = lut.shape[-2:]
    rows = int(live.sum())
    experts = int(live.any(1).sum())
    sel = torch.zeros((e, nc, c), device=DEV)
    sel.scatter_add_(2, idx.transpose(1, 2).long(),
                     live[:, None, :].expand(e, nc, m).float())
    lut_rows = int((sel > 0).sum())
    x_b = rows * nc * v * 2 + experts * nc * c * v * 2
    b1 = max((x_b + experts * n * 4 + lut_rows * n + e * m * n * 4) / HBM_BW,
             rows * (nc * c * (4 * v + 2) + nc * n + n) / CORE_OPS)
    b3 = max((x_b + e * m * nc * 4) / HBM_BW,
             rows * nc * c * (4 * v + 2) / CORE_OPS)
    return 1e6 * b1, 1e6 * b3


def timed(cs, label, call, flush):
    from repro_torch.device import enqueued
    times = cs.device_times(call, 30, flush)
    print(f"grouped_call [{label}]: {1e3 * float(np.mean(times)):.2f} us "
          f"flushed (median {1e3 * float(np.median(times)):.2f}), "
          f"{1e3 * cs.graph_ms(call):.2f} us warm in a graph, host "
          f"{cs.host_us(call):.1f} us a call, enqueues {enqueued(call)}")


def run(tree, save):
    sys.path.insert(0, tree)
    import chip_smoke as cs       # the tree's own; it puts its src/ first
    from repro_torch.kernels.assign import vq_assign_cuda, vq_assign_geometry
    from repro_torch.kernels.fused_amm import vq_amm_cuda, vq_amm_geometry
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    live_kw = "counts" in inspect.signature(vq_amm_cuda).parameters
    print(f"tree {tree}: live-row counts "
          f"{'taken' if live_kw else 'not taken (every row computed)'}")
    cs._build.build(["fused_amm", "assign"])
    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    outs = {}
    for label, e, kdim, n, k in CASES:
        x, z, lut, scale = inputs(gen, e, kdim, n)
        counts = decode_counts(gen, e, k)
        live = torch.arange(CAP, device=DEV)[None] < counts[:, None]
        for buf in ("decode", "full"):
            xb = (x * live[..., None, None]).contiguous() if buf == "decode" \
                else x
            kw = dict(counts=counts, most_live=TOKENS * k) if (
                buf == "decode" and live_kw) else {}
            mask = live if buf == "decode" else torch.ones_like(live)
            name = f"{label}, {buf} buffer"

            def b1():
                return vq_amm_cuda(xb, z, lut, scale, **kw)

            def b3():
                return vq_assign_cuda(xb, z, **kw)
            idx = b3()
            outs[f"{name} B1"] = (b1() * mask[..., None]).cpu()
            outs[f"{name} B3"] = (idx * mask[..., None]).cpu()
            bound1, bound3 = bound_us(xb, z, lut, mask, idx)
            print(f"grouped_call [{name}]: E={e} M={CAP} K={kdim} N={n}, "
                  f"{int(mask.sum())} live rows on "
                  f"{int(mask.any(1).sum())} experts; bound B1 "
                  f"{bound1:.2f} us, B3 {bound3:.3f} us; B1 geometry "
                  f"{vq_amm_geometry(xb, z, lut, **kw)}, B3 geometry "
                  f"{vq_assign_geometry(xb, z, **kw)}")
            timed(cs, f"{name} B1", b1, flush)
            timed(cs, f"{name} B3", b3, flush)
    if save:
        torch.save(outs, save)


def compare(a, b):
    x, y = torch.load(a), torch.load(b)
    for name in x:
        same = torch.equal(x[name], y[name])
        diff = float((x[name].float() - y[name].float()).abs().max())
        print(f"grouped_call compare [{name}, live rows]: "
              f"{'bitwise equal' if same else 'differ'}, max abs diff "
              f"{diff:.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the tree whose kernels run")
    ap.add_argument("--save", help="file for the outputs (torch.save)")
    ap.add_argument("--compare", nargs=2, metavar="FILE",
                    help="compare two saved runs and exit")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if not torch.cuda.is_available():
        print("grouped_call: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    run(os.path.abspath(args.tree), args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
