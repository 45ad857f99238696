#!/usr/bin/env python3
"""Where kernels B2s and B2a (``src/repro_torch/csrc/flash_decode_hd.cu``,
the head_dim layout's decode) spend their time, phase by phase, at rank
0's slice of qwen1.5-4b and gemma3-4b over a (1, 8) mesh (the inputs of
``scripts/decode_call.py``), on an NVIDIA GPU.

Builds the source once more with ``-DHD_PROFILE`` (thread 0 of every
block then writes ``clock64()`` at each phase boundary and the global
timer at its start and end), launches each kernel once after an L2 flush
(as the main path finds the pool), once warm (right after a launch on
the same inputs) and once right behind another launch (no other kernel
between the two), and prints per phase the median and the largest cycle
count over the blocks that reach it, a block's median span and the span
from the first block's start to the last block's end. Beside them: the
regular build's time a call flushed (``chip_smoke.time_ms``) and warm in
a CUDA graph (``chip_smoke.graph_ms``), and the same two for a one-block
kernel that adds 1 to 8 floats (what the timing itself costs).

    python3 scripts/hd_phases.py

Exits 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import decode_call as dc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

PHASES = {
    "B2s": {1: "positions, ids, q, k_new", 2: "barrier",
            3: "pages issued, self column, zeros", 4: "first page landed",
            13: "scores stored"},
    "B2a": {1: "positions, page table, self scores", 2: "scores landed",
            3: "chunk max", 4: "max exchanged", 5: "chunk sum",
            6: "sum exchanged", 7: "probabilities", 9: "value sum",
            10: "partials pushed", 11: "partials landed", 13: "stored"},
}


def build_profiled() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "flash_decode_hd-phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DHD_PROFILE",
                        "-o", str(out), str(_build.CSRC / "flash_decode_hd.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_hd_scores_launch.argtypes = (
        [p] * 6 + [i, p] + [i] * 10 + [p, p])
    lib.flash_decode_hd_attend_launch.argtypes = (
        [p] * 6 + [i, f, p] + [i] * 10 + [p, p])
    lib.flash_decode_hd_set_prof.argtypes = [p]
    return lib


def report(label, stamps, blocks, names):
    t = stamps[:16 * blocks].reshape(blocks, 16).cpu().numpy().astype(
        np.float64)
    parts = []
    prev = 0
    for i in sorted(names):
        ok = (t[:, i] != 0) & (t[:, prev] != 0)
        if ok.any():
            d = t[ok, i] - t[ok, prev]
            parts.append(f"{names[i]} {np.median(d):.0f} / {d.max():.0f}")
        prev = i
    live = t[:, 15] != 0
    block_us = np.median(t[live, 15] - t[live, 14]) / 1e3
    span_us = (t[live, 15].max() - t[live, 14].min()) / 1e3
    print(f"  {label}: cycles median / max: " + ", ".join(parts)
          + f"; block {block_us:.2f} us (median), first start to last end "
          f"{span_us:.2f} us")


def main() -> int:
    if not torch.cuda.is_available():
        print("hd_phases: no CUDA device visible to torch", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build(["flash_decode_hd"])
    lib = build_profiled()
    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device="cuda")
    stamps = torch.zeros(16 * 65536, dtype=torch.int64, device="cuda")
    x = torch.zeros(8, device="cuda")
    print(f"floor: an 8-float add_ {1e3 * cs.time_ms(lambda: x.add_(1), 30, flush):.2f} "
          f"us flushed, {1e3 * cs.graph_ms(lambda: x.add_(1)):.2f} us warm "
          "in a graph")
    rng = np.random.default_rng(0)        # chip_smoke's scale-phase lengths
    lengths = [sorted(rng.integers(32, 512, dc.SLOTS).tolist())]
    gemma = sorted(rng.integers(1100, 1800, dc.SLOTS).tolist())
    gemma[1] = -1
    lengths.append(gemma)
    for i, ((name, kvh, g, d, np_, window, kv_start), positions) in \
            enumerate(zip(dc.HD_CASES, lengths)):
        (q, kp, vp, kn, vn), phys, pos, ks, sc, scale = dc.hd_inputs(
            100 + i, kvh, g, d, np_, positions, window, kv_start)
        b, _, h, ds = q.shape
        plan = fd.hd_plan(b, kvh, ds, dc.PAGE, np_, kp.element_size())
        scores = torch.empty((b, h, np_ * dc.PAGE + 1), device="cuda")
        out = torch.empty_like(q)
        st = torch.cuda.current_stream().cuda_stream
        shape = [b, kvh, g, ds, dc.PAGE, np_, plan.kv_heads]

        def b2s():
            return lib.flash_decode_hd_scores_launch(
                q.data_ptr(), kp.data_ptr(), kn.data_ptr(), phys.data_ptr(),
                pos.data_ptr(), ks.data_ptr(), window, scores.data_ptr(),
                *shape, plan.pages, 1, 1, st, None)

        def b2a():
            return lib.flash_decode_hd_attend_launch(
                sc.data_ptr(), vp.data_ptr(), vn.data_ptr(), phys.data_ptr(),
                pos.data_ptr(), ks.data_ptr(), window, scale, out.data_ptr(),
                *shape, plan.cluster, 1, 1, st, None)

        def reg_s():
            fd.flash_decode_hd_scores_cuda(q, kp, kn, phys, pos, window, ks)

        def reg_a():
            fd.flash_decode_hd_attend_cuda(sc, vp, vn, phys, pos, window, ks,
                                           scale, q.dtype)
        groups = plan.groups
        for key, launch, regular, blocks in (
                ("B2s", b2s, reg_s, plan.blocks * b * groups),
                ("B2a", b2a, reg_a, plan.cluster * b * groups)):
            print(f"{name} {key} ({plan}): "
                  f"{1e3 * cs.time_ms(regular, 30, flush):.2f} us flushed, "
                  f"{1e3 * cs.graph_ms(regular):.2f} us warm in a graph")
            lib.flash_decode_hd_set_prof(stamps.data_ptr())
            for mode in ("flushed", "warm", "back to back"):
                if launch():
                    raise RuntimeError(f"{key}: launch failed")
                torch.cuda.synchronize()
                stamps.zero_()
                torch.cuda._sleep(cs.SPIN_CYCLES)
                if mode == "flushed":
                    flush.sum()
                if mode == "back to back" and launch():
                    raise RuntimeError(f"{key}: launch failed")
                if launch():
                    raise RuntimeError(f"{key}: launch failed")
                torch.cuda.synchronize()
                report(mode, stamps, blocks, PHASES[key])
            lib.flash_decode_hd_set_prof(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
