#!/usr/bin/env python3
"""Where kernel B1 (``src/repro_torch/csrc/fused_amm.cu``) spends its time,
phase by phase, at the main path's six projection shapes (int8 LUTs,
M = 8 and 32), on an NVIDIA GPU; with ``--grouped``, at the grouped
decode buffers of deepseek-moe-16b's routed experts and a dbrx-132b
expert layer (live-row counts from a seeded ``route`` of 8 tokens).

Builds the kernel once more with ``-DVQG_PROFILE`` (thread 0 of every
block then writes ``clock64()`` at each phase boundary), launches it on
the same operands as ``chip_smoke.py``'s B1 phase, once after an L2 flush
(the LUT comes from device memory, as on the main path) and once warm
(right after a launch on the same inputs), and prints per phase the
median and the largest cycle count over the blocks: x and z staged,
assigned, gathered, pushed to the owning ranks, past the cluster barrier,
finished. Beside them: the regular build's time per call flushed
(``chip_smoke.time_ms``), without a flush, and warm in a CUDA graph
(``chip_smoke.graph_ms``). Grouped: the phases of the live blocks (a
block of an empty row group returns before its first stamp), when the
live blocks start (quantiles from the first start: waves), and the
regular build's time with every count 0 (the grid alone: dead clusters
write their zeros and return) beside the live launch.

    python3 scripts/b1_phases.py [--grouped]

Exits 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

PHASES = ["stage x, z", "assign", "gather", "push", "cluster barrier",
          "finish"]
# a tile cluster's block (live rows): its share of the assignment, the
# indices over the cluster, the gather of its tile, the partitions' tiles
# stored, its rows written
TILE_PHASES = ["stage x, z", "assign", "share indices", "gather", "merge",
               "finish"]


def build_profiled() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "fused_amm-phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DVQG_PROFILE",
                        "-o", str(out), str(_build.CSRC / "fused_amm.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vq_amm_launch.argtypes = ([p] * 5 + [i, p] + [i] * 10 + [p, p])
    lib.vq_amm_set_prof.argtypes = [p]
    return lib


# (label, experts, rows, K, N, tokens, top-k) of the grouped cases
GROUPED = [("deepseek-moe-16b routed wg/wu", 64, 8, 2048, 1408, 8, 6),
           ("deepseek-moe-16b routed wd", 64, 8, 1408, 2048, 8, 6),
           ("dbrx-132b w1", 16, 8, 6144, 10752, 8, 4)]


def decode_counts(gen, e, t, k, cap):
    """Each expert's live rows after a seeded route of t tokens (top-k of
    e, random router logits), clamped to the capacity cap."""
    logits = torch.randn((t, e), generator=gen, device=cs.DEV)
    load = cs.moe_mod.route(torch.softmax(logits, -1), k, cap)[4]
    return load.clamp(max=cap)


def profile(lib, launch, stamps, flush, blocks, label, names=PHASES):
    """Phase cycles of the blocks that stamped (flushed, then warm)."""
    lib.vq_amm_set_prof(stamps.data_ptr())
    for mode in ("flushed", "warm"):
        launch()
        torch.cuda.synchronize()
        stamps.zero_()
        torch.cuda._sleep(cs.SPIN_CYCLES)
        if mode == "flushed":
            flush.sum()
        launch()
        torch.cuda.synchronize()
        t = stamps[:16 * blocks].reshape(blocks, 16).cpu().numpy()
        t = t[t[:, 14] != 0]
        cyc = np.diff(t[:, :7].astype(np.float64), axis=1)
        block_us = np.median(t[:, 15] - t[:, 14]) / 1e3
        span_us = (t[:, 15].max() - t[:, 14].min()) / 1e3
        starts = (t[:, 14] - t[:, 14].min()) / 1e3
        print(f"  {label}{mode}: {len(t)} blocks stamped; cycles median / "
              f"max: " + ", ".join(
                  f"{name} {a:.0f} / {b:.0f}" for name, a, b in
                  zip(names, np.median(cyc, 0), cyc.max(0)))
              + f"; block {block_us:.2f} us (median), first start to last "
              f"end {span_us:.2f} us; starts at quantiles 0.25 / 0.5 / 0.75 "
              f"/ 1 of the first: " + " / ".join(
                  f"{q:.2f}" for q in np.quantile(starts, [.25, .5, .75, 1]))
              + " us")
    lib.vq_amm_set_prof(None)


def grouped(lib, gen, flush, stamps) -> None:
    for label, e, m, k, n, t, top in GROUPED:
        x, z, lut, scale, _ = cs.vq_inputs(gen, m, k, n, e)
        counts = decode_counts(gen, e, t, top, m)
        most = t * top
        live = torch.arange(m, device=cs.DEV)[None] < counts[:, None]
        x = (x * live[..., None, None]).contiguous()
        out = torch.empty((e, m, n), device=cs.DEV)
        geo = cs.vq_amm_geometry(x, z, lut, counts=counts, most_live=most)
        tcs = geo["tile_cluster"]
        tiles = -(-geo["tiles"] // tcs) * tcs if tcs else geo["tiles"]
        blocks = e * geo["cluster"] * tiles * geo["row_groups"]
        dead = torch.zeros_like(counts)

        def launch():
            err = lib.vq_amm_launch(
                x.data_ptr(), z.data_ptr(), lut.data_ptr(), scale.data_ptr(),
                out.data_ptr(), e, counts.data_ptr(), most, m, k // cs.V,
                cs.C, cs.V, n, 1, 2, 0, 0,
                torch.cuda.current_stream().cuda_stream, None)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        def regular(c=counts):
            cs.vq_amm_cuda(x, z, lut, scale, counts=c, most_live=most)

        def parent():
            cs.vq_amm_cuda(x, z, lut, scale)
        cs.time_ms(regular, 5, flush)
        print(f"B1 {label} E={e} M={m} K={k} N={n}, {int(live.sum())} live "
              f"rows on {int((counts > 0).sum())} experts: "
              f"{cs.cluster_text(geo)}, {e} experts; "
              f"{cs.time_ms(regular, 30, flush) * 1e3:.1f} us flushed, "
              f"{cs.graph_ms(regular) * 1e3:.1f} us warm in a graph; every "
              f"count 0: {cs.time_ms(lambda: regular(dead), 30, flush) * 1e3:.1f}"
              f" us flushed, {cs.graph_ms(lambda: regular(dead)) * 1e3:.1f} "
              f"warm; without counts {cs.time_ms(parent, 30, flush) * 1e3:.1f}"
              " us flushed")
        profile(lib, launch, stamps, flush, blocks, "",
                TILE_PHASES if tcs else PHASES)


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_phases: no CUDA device visible to torch", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build_profiled()
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device=cs.DEV)
    stamps = torch.zeros(16 * 65536, dtype=torch.int64, device=cs.DEV)
    if "--grouped" in sys.argv[1:]:
        grouped(lib, gen, flush, stamps)
        return 0
    for m in (8, 32):
        for k, n, _ in cs.PROJ_SHAPES:
            x, z, lut, scale, _ = cs.vq_inputs(gen, m, k, n)
            out = torch.empty((m, n), device=cs.DEV)
            geo = cs.vq_amm_geometry(x, z, lut)
            blocks = geo["cluster"] * geo["tiles"] * geo["row_groups"]

            def launch():
                err = lib.vq_amm_launch(
                    x.data_ptr(), z.data_ptr(), lut.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), 1, None, 0, m,
                    k // cs.V, cs.C, cs.V, n, 1, 2, 0, 0,
                    torch.cuda.current_stream().cuda_stream, None)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            def regular():
                cs.vq_amm_cuda(x, z, lut, scale)
            cs.time_ms(regular, 5, flush)    # the process's first timing
            print(f"B1 M={m} K={k} N={n}: cluster {geo['cluster']} x "
                  f"{geo['tiles']} tiles, {geo['subspaces']} subspaces a "
                  f"block; {cs.time_ms(regular, 30, flush) * 1e3:.1f} us "
                  f"flushed, {cs.time_ms(regular, 30, lut[:1]) * 1e3:.1f} "
                  f"us unflushed, {cs.graph_ms(regular) * 1e3:.1f} us warm "
                  "in a graph")
            profile(lib, launch, stamps, flush, blocks, "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
