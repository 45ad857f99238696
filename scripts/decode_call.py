#!/usr/bin/env python3
"""One ``flash_decode_paged`` call of one tree of this repository on an
NVIDIA GPU, at the main path's attention shape (8 slots x 20 heads,
head_dim 128, pages of 16, 32 pages a slot, chip_smoke's seeded mixed
lengths) and at one slot of 4096 tokens: an fp pool (bfloat16, and
float32) and a uint8 code pool (nc=32, c=16). Then the head_dim layout's
two kernels, B2s (``flash_decode_hd_scores_cuda``) and B2a
(``flash_decode_hd_attend_cuda``), at rank 0's slice of a bfloat16 pool
over a (1, 8) mesh: qwen1.5-4b (8 slots, 20 kv heads, head_dim 128 / 8,
32 pages, the main path's lengths) and gemma3-4b (8 slots, 4 kv heads,
G = 2, head_dim 256 / 8, 128 pages, its 1024 window, kv starts, a pos =
-1 lane; chip_smoke's scale-phase lengths); B2a reads the whole
head_dim's scores, made here. For each case it prints the device time
flushed (``chip_smoke.time_ms``; mean and median of 30) and warm in a
CUDA graph of 30 calls (``chip_smoke.graph_ms``), host µs a call and
what one call enqueues (``repro_torch.device.enqueued``), and saves the
outputs, so two trees can be compared bit for bit:

    python3 scripts/decode_call.py [--tree DIR] [--only paged|hd] --save OUT.pt
    python3 scripts/decode_call.py --compare A.pt B.pt

The inputs come from a seeded generator on the card, made by this script
whatever the tree; the call, the kernels and the timing helpers are the
named tree's own (its ``chip_smoke.py`` and ``src/``). To compare two
trees on one card, run them in turns (parent, change, change, parent),
each with ``--tree``. Exits 2 without a CUDA device.
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


#: the head_dim slices over (1, 8): name, kv heads, G, head_dim, pages a
#: slot, window, kv starts (None: 0)
HD_MESH = 8
HD_CASES = (("qwen1.5-4b (1, 8)", 20, 1, 128, 32, 0, None),
            ("gemma3-4b (1, 8)", 4, 2, 256, 128, 1024,
             [0, 0, 7, 0, 300, 0, 0, 12]))


def hd_inputs(seed, kvh, g, d, np_, positions, window, kv_start):
    """Rank 0's head_dim slices of q, the bf16 pool and the new rows, the
    page table, positions and kv starts, and the whole head_dim's scores
    (B, H, NP x page + 1) float32, what the all-reduce hands B2a: the dot
    products over the live keys (0 elsewhere), then the self term."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, n_pages = SLOTS, kvh * g, SLOTS * np_

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, kn, vn = randn(b, 1, h, d), randn(b, 1, kvh, d), randn(b, 1, kvh, d)
    kp = randn(n_pages + 1, PAGE, kvh, d)
    vp = randn(n_pages + 1, PAGE, kvh, d)
    phys = torch.randperm(n_pages, generator=gen, device="cuda").reshape(
        b, np_).to(torch.int32)
    for i, p in enumerate(positions):
        phys[i, max(0, -(-p // PAGE)):] = n_pages
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    ks = torch.tensor(kv_start or [0] * b, dtype=torch.int32, device="cuda")
    t = np_ * PAGE
    kj = torch.arange(t, device="cuda")[None]
    live = (kj < pos[:, None]) & (kj >= ks[:, None])
    if window > 0:
        live &= kj > pos[:, None] - window
    qf = q[:, 0].float().reshape(b, kvh, g, d)
    kg = kp[phys.long()].reshape(b, t, kvh, d).float()
    sc = torch.einsum("bkgd,btkd->bkgt", qf, kg) * live[:, None, None]
    s_new = torch.einsum("bkgd,bkd->bkg", qf, kn[:, 0].float())
    sc = torch.cat([sc, s_new[..., None]], -1).reshape(b, h, t + 1)
    ds = d // HD_MESH
    cut = [x[..., :ds].contiguous() for x in (q, kp, vp, kn, vn)]
    return cut, phys, pos, ks, sc.contiguous(), d ** -0.5


def timed(cs, label, call, flush):
    from repro_torch.device import enqueued
    times = cs.device_times(call, 30, flush)
    print(f"decode_call [{label}]: {1e3 * float(np.mean(times)):.2f} us "
          f"flushed (median {1e3 * float(np.median(times)):.2f}), "
          f"{1e3 * cs.graph_ms(call):.2f} us warm in a graph, host "
          f"{cs.host_us(call):.1f} us a call, enqueues {enqueued(call)}")


def run_hd(cs, fd, flush, outs):
    rng = np.random.default_rng(0)        # chip_smoke's scale-phase lengths
    lengths = [sorted(rng.integers(32, 512, SLOTS).tolist())]
    gemma = sorted(rng.integers(1100, 1800, SLOTS).tolist())
    gemma[1] = -1
    lengths.append(gemma)
    for i, ((name, kvh, g, d, np_, window, kv_start), positions) in \
            enumerate(zip(HD_CASES, lengths)):
        (q, kp, vp, kn, vn), phys, pos, ks, sc, scale = hd_inputs(
            100 + i, kvh, g, d, np_, positions, window, kv_start)

        def scores():
            return fd.flash_decode_hd_scores_cuda(q, kp, kn, phys, pos,
                                                  window, ks)

        def attend():
            return fd.flash_decode_hd_attend_cuda(sc, vp, vn, phys, pos,
                                                  window, ks, scale, q.dtype)
        outs[f"{name} B2s"] = scores().cpu()
        outs[f"{name} B2a"] = attend().cpu()
        timed(cs, f"{name} B2s", scores, flush)
        timed(cs, f"{name} B2a", attend, flush)


def run(tree, save, only):
    sys.path.insert(0, tree)
    import chip_smoke as cs       # the tree's own; it puts its src/ first
    from repro_torch.device import enqueued
    from repro_torch.kernels import flash_decode as fd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"tree {tree}")
    cs._build.build(["flash_decode_hd"] if only == "hd" else
                    ["flash_decode", "flash_decode_kvq"] if only == "paged"
                    else cs._build.SOURCES)
    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device="cuda")
    outs = {}
    if only != "paged":
        run_hd(cs, fd, flush, outs)
    if only == "hd":
        if save:
            torch.save(outs, save)
        return
    rng = np.random.default_rng(0)        # chip_smoke's main-path lengths
    main_pos = sorted(rng.integers(32, 512, SLOTS).tolist())
    cases = [("main fp bf16", SLOTS, PAGES, main_pos, "fp", torch.bfloat16),
             ("main fp f32", SLOTS, PAGES, main_pos, "fp", torch.float32),
             ("main codes", SLOTS, PAGES, main_pos, "codes", torch.bfloat16),
             ("one slot 4096 fp bf16", 1, 256, [4095], "fp",
              torch.bfloat16),
             ("one slot 4096 codes", 1, 256, [4095], "codes",
              torch.bfloat16)]
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
    ap.add_argument("--only", choices=("paged", "hd"),
                    help="only flash_decode_paged's cases, or only the "
                    "head_dim kernels'")
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
    run(os.path.abspath(args.tree), args.save, args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
