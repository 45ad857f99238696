#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds the hand-written kernels (B1-B5), holds each against its
plain PyTorch version at the main path's shapes (B1, B3, B4 also: one
kernel a call and nothing else, their times flushed and warm in a CUDA
graph, their host time and launch geometry, and a sweep of nc at M=8,
N=6912, with B3's subspaces a block swept beside it; B2 and B5 in both
forms -- triples out, and fused with the split reduction and self-term
fold, one kernel for a whole flash_decode_paged call -- also at one slot
of 4096 tokens), serves full-width qwen1.5-4b (lut_infer, int8 LUTs)
through the continuous-batching engine three times -- fused projections
on an fp KV pool (B1, B2), two-pass projections (B3, B4, B2), fused
projections on a VQ code pool (B1, B5) -- and checks one
decode step's logits of each through the kernels against the plain
versions. A last phase checks that float-LUT results are the same on
every run: B1 and B4 with float32 and bfloat16 LUTs launched twice on one
input (and B4(B3(x)) == B1(x) bit for bit wherever the two launches take
one geometry), then two engine runs and two decode steps of full-width
qwen1.5-4b with float32 LUTs, cut to 4 layers. Every projection shape
the serve runs reach is held at every row count they give it (decode:
the slots; prefill: the chunk; a speculative verify: slots x (k+1)):
B1, B3 and B4 at qwen1.5-4b's, yi-9b's, gemma3-4b's and gemma3-27b's
shapes, and B2 / B5 at each config's decode attention (GQA, window) and
at one slot of 4096 tokens at G=8 D=128 and G=2 D=256. A speculative
phase serves full-width qwen1.5-4b plainly, with an n-gram drafter and
with a 10-layer model drafter (every emitted token must be its verify
row's argmax; in float32, cut to 4 layers, every speculative stream must
equal the plain one). Then yi-9b (fp pool), gemma3-4b (fp and VQ code
pools, prompts past its 1024-token window) and a short gemma3-27b serve
run at full width and depth, each freed before the next, each with a
logit check. In float32, one verify_paged call must give the logits of
a chain of decode_paged steps over the same tokens (qwen1.5-4b, yi-9b,
gemma3-4b, at full depth).

    python3 chip_smoke.py [--seed N]

Imports nothing of JAX and nothing of the JAX package. Exits non-zero,
without a result line, when there is no CUDA device or any check fails.
Its last line is ``{"ok": true, "device": {...}}``; the two before it
are the per-kernel JSON record (times in ms, measured in this run, with
the bound computed from this run's inputs; launches of the main path,
qwen1.5-4b's three serve runs) and the card's name and power limit.
Every serve run's launches are printed before them, by run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    gemma3_4b, gemma3_27b, qwen1p5_4b, yi_9b)
from repro_torch.core.lut import QuantConfig  # noqa: E402
from repro_torch.device import enqueued  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.core.kv_codebook import KVCodebook, kv_encode  # noqa
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    vq_assign_cuda, vq_assign_geometry)
from repro_torch.kernels.fused_amm import (  # noqa: E402
    vq_amm_cuda, vq_amm_geometry)
from repro_torch.kernels.lut_gemm import (  # noqa: E402
    lut_gemm_cuda, lut_gemm_geometry)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.serve.speculative import Drafter, SpecConfig  # noqa

# Published H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_CUDA_CORE_OPS_PER_S = 67e12      # also used for int32 adds
L2_FLUSH_BYTES = 256 << 20            # > the 50 MB L2: launches start cold
SPIN_CYCLES = 2_000_000               # ~1 ms: longer than any host enqueue

DEV = "cuda"
SLOTS, PAGE, MAX_SEQ, CHUNK = 8, 16, 512, 32
V, C = 8, 16
KV_V, KV_C = 4, 16                    # the VQ-KV run's codebook
# (K, N, launches per layer) of the 7 projections: wq wk wv wo, wg wu, wd
PROJ_SHAPES = [(2560, 2560, 4), (2560, 6912, 2), (6912, 2560, 1)]
# the same for yi-9b (wq wo, wk wv, wg wu, wd) and gemma3-4b (wq, wk wv,
# wo, wg wu, wd)
YI_PROJ_SHAPES = [(4096, 4096, 2), (4096, 512, 2), (4096, 11008, 2),
                  (11008, 4096, 1)]
GEMMA_PROJ_SHAPES = [(2560, 2048, 1), (2560, 1024, 2), (2048, 2560, 1),
                     (2560, 10240, 2), (10240, 2560, 1)]
# and gemma3-27b (wq, wk wv, wo, wg wu, wd)
GEMMA27_PROJ_SHAPES = [(5376, 4096, 1), (5376, 2048, 2), (4096, 5376, 1),
                       (5376, 21504, 2), (21504, 5376, 1)]
# rows of a projection call: decode (the slots), the prefill chunk, and a
# speculative verify of SLOTS slots x (k+1) tokens at k = SPEC_K
SPEC_K = 4
VERIFY_M = SLOTS * (SPEC_K + 1)
QWEN_MS = (SLOTS, CHUNK, VERIFY_M)
DENSE_MS = (8, 32, VERIFY_M)

# What one call of B1, B3 or B4 must enqueue (device.enqueued)
ONE_KERNEL = {"kernels": 1, "copies": 0, "memsets": 0, "other": 0}

# Logit check tolerance. Both sides compute every projection as an exact
# int8 sum times the same scale, and attention with fp32 sums in another
# order. A projection's output is piecewise constant in its input (a hard
# centroid assignment), so a small difference upstream vanishes at the
# next projection, unless it flips an argmin that nearly ties. A flip
# moves that row of that projection by a few percent and cascades through
# the later layers, but only within its own slot: decode rows never mix.
# In bf16 the attention sums' fp32 rounding reaches the next projection
# as whole bf16 ulps, so flips are likelier than in float32. A wrong
# kernel (mask, index, scale) corrupts every row instead. So a row
# "agrees" when ||lg_kernel - lg_plain|| <= 1e-3 ||lg_plain||, and all but
# LOGIT_ROWS_OFF[dtype] of the rows must agree. On an H100 this measured
# 7 of 8 rows agreeing exactly in bf16 (the eighth at 0.157), and 8 of 8
# exactly in float32.
LOGIT_ROW_REL_TOL = 1e-3
LOGIT_ROWS_OFF = {"bfloat16": 2, "float32": 1}


# each serve run's kernel launches, by the run's label (filled by serve)
PATH_LAUNCHES: dict = {}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's wall time (host clock, the card synchronised)."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"phase [{name}]: {time.perf_counter() - t0:.1f} s")


def device_times(fn, iters: int, flush: torch.Tensor) -> list:
    """Device time of each of ``iters`` launches of ``fn`` in ms: CUDA
    events around each launch, the L2 flushed before each (the main path
    reaches every LUT and page cold: a decode step streams GBs between two
    visits). A spin kernel ahead of each keeps the card busy while the
    host enqueues, so the events time the device work, not the wrapper's
    host time."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.sum()                   # a read: the L2 is left clean
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` in ms over :func:`device_times`."""
    return float(np.mean(device_times(fn, iters, flush)))


def graph_ms(fn, calls: int = 30) -> float:
    """Warm device time per call of ``fn`` in ms: ``calls`` back-to-back
    calls captured in one CUDA graph and replayed, so neither the host
    nor a launch gap between calls is timed and the L2 stays warm."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    ms = s.elapsed_time(e) / calls
    graph.reset()
    return ms


def host_us(fn, iters: int = 50) -> float:
    """Host time per call of ``fn`` in us (enqueue only; the card runs
    behind): what each call costs the Python step loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_: float, ops_: float):
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / FP32_CUDA_CORE_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# (module, attribute of the kernel's wrapper, its plain version): the CUDA
# dispatch of every kernel, as the entry points look it up
DISPATCH = {
    "b1": (ops, "vq_amm_cuda", ref.vq_amm_ref),
    "b3": (ops, "vq_assign_cuda", ref.assign_ref),
    "b4": (ops, "lut_gemm_cuda", ref.lut_gemm_onehot),
    "b2": (fd, "flash_decode_paged_cuda", fd.flash_decode_paged_plain),
    "b5": (fd, "flash_decode_paged_kvq_cuda",
           fd.flash_decode_paged_kvq_plain),
}
WRAPPERS = {"b1": vq_amm_cuda, "b3": vq_assign_cuda, "b4": lut_gemm_cuda,
            "b2": fd.flash_decode_paged_cuda,
            "b5": fd.flash_decode_paged_kvq_cuda}


@contextlib.contextmanager
def plain_kernels():
    """Route the CUDA dispatch of every kernel to its plain version (for
    the kernel-vs-plain logit check only)."""
    saved = {k: getattr(mod, attr) for k, (mod, attr, _) in DISPATCH.items()}
    for mod, attr, plain in DISPATCH.values():
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for k, (mod, attr, _) in DISPATCH.items():
            setattr(mod, attr, saved[k])


def reset_counts() -> None:
    for k, (_, _, plain) in DISPATCH.items():
        WRAPPERS[k].launches = 0
        plain.calls = 0


def read_counts() -> dict:
    out = {k: w.launches for k, w in WRAPPERS.items()}
    out.update({k + "_plain": plain.calls
                for k, (_, _, plain) in DISPATCH.items()})
    return out


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def vq_inputs(gen, m, k, n):
    """One projection's operands at a main-path shape: x = a centroid +
    small noise (every argmin has a clear margin), an int8 LUT and its
    scale, and random unit-scale rows xr (as after RMSNorm; near-ties may
    flip between two orders of summation)."""
    dev = DEV
    nc = k // V
    z = (0.02 * torch.randn((nc, C, V), generator=gen, device=dev)).to(
        torch.bfloat16)
    pick = torch.randint(0, C, (m, nc), generator=gen, device=dev)
    noise = 0.002 * torch.randn((m, nc, V), generator=gen, device=dev)
    x = (z.float()[torch.arange(nc, device=dev)[None], pick] + noise).to(
        torch.bfloat16)
    lut = torch.randint(-127, 128, (nc, C, n), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.int8)
    scale = 1e-3 + 1e-2 * torch.rand((n,), generator=gen, device=dev)
    xr = torch.randn((m, nc, V), generator=gen, device=dev).to(
        torch.bfloat16)
    return x, z, lut, scale, xr


def selected_lut_bytes(idx, n):
    """Bytes of the int8 LUT rows that some row of idx (M, nc) selects:
    what a gather-accumulate must read."""
    rows = torch.zeros((idx.shape[1], C), device=DEV)
    rows.scatter_(1, idx.T.long(), 1.0)
    return float(rows.sum()) * n


def b1_case(gen, m, k, n, flush):
    """B1 at one main-path shape. Returns a result dict."""
    dev = DEV
    nc = k // V
    x, z, lut, scale, xr = vq_inputs(gen, m, k, n)

    idx_plain = ref.assign_ref(x, z)
    # index probe: lut[k, j, col] = j * [col == k] reads each selected
    # index back through the kernel's own argmin and gather
    probe = (torch.arange(C, device=dev)[None, :, None]
             * torch.eye(nc, device=dev)[:, None, :]).to(torch.int8)
    idx_kernel = vq_amm_cuda(x, z, probe, torch.ones(nc, device=dev))
    idx_kernel = torch.round(idx_kernel).to(torch.int32)
    check(torch.equal(idx_kernel, idx_plain),
          f"B1 {m}x{k}x{n}: kernel indices differ from the plain argmin at "
          f"{int((idx_kernel != idx_plain).sum())} of {idx_plain.numel()}")
    out_k = vq_amm_cuda(x, z, lut, scale)
    out_p = ref.vq_amm_ref(x, z, lut, scale)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    # both sides are exact int32/fp32 integer sums times the same scale
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    check(err <= tol, f"B1 {m}x{k}x{n}: max abs err {err} > {tol}")

    flips = float((torch.round(vq_amm_cuda(xr, z, probe, torch.ones(
        nc, device=dev))).to(torch.int32) != ref.assign_ref(xr, z)).float()
        .mean())
    off = float(((vq_amm_cuda(xr, z, lut, scale)
                  - ref.vq_amm_ref(xr, z, lut, scale)).abs() > 1e-3)
                .float().mean())
    check(flips < 1e-3, f"B1 {m}x{k}x{n}: {flips:.2%} of random-x "
          "assignments differ (a near-tie flip rate is ~1e-4)")

    ms = time_ms(lambda: vq_amm_cuda(x, z, lut, scale), 30, flush)
    warm_ms = graph_ms(lambda: vq_amm_cuda(x, z, lut, scale))
    plain_ms = time_ms(lambda: ref.vq_amm_ref(x, z, lut, scale), 5, flush)
    host = host_us(lambda: vq_amm_cuda(x, z, lut, scale))
    calls = enqueued(lambda: vq_amm_cuda(x, z, lut, scale))
    check(calls == ONE_KERNEL, f"B1 {m}x{k}x{n}: a call enqueues {calls}")
    geo = vq_amm_geometry(x, z, lut)
    # bytes this data needs: x, z, the LUT rows some row selects, scale, out
    lut_bytes = selected_lut_bytes(idx_plain, n)
    b = nbytes(x, z, scale) + lut_bytes + m * n * 4
    o = m * nc * C * (4 * V + 2) + m * nc * n + m * n
    bms, by = bound(b, o)
    print(f"B1 vq_amm M={m} K={k} N={n}: kernel {ms * 1e3:.1f} us "
          f"(warm, 30 calls in one graph: {warm_ms * 1e3:.1f} us a call), "
          f"plain {plain_ms * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by}; "
          f"{lut_bytes / 1e6:.2f} MB of LUT rows selected of "
          f"{nbytes(lut) / 1e6:.2f}), host {host:.1f} us/call, enqueues "
          f"{calls}, cluster {geo['cluster']} x {geo['tiles']} column tiles "
          f"x {geo['row_groups']} row groups ({geo['subspaces']} subspaces "
          f"and {geo['smem']} B of shared memory a block), max abs err "
          f"{err:.3g}; random x: "
          f"{flips:.2e} index flips, {off:.2%} of outputs off by >1e-3")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "err": err, "warm_ms": warm_ms, "host": host}


def cluster_text(geo):
    return (f"cluster {geo['cluster']} x {geo['tiles']} column tiles x "
            f"{geo['row_groups']} row groups, {geo['subspaces']} subspaces "
            f"and {geo['smem']} B of shared memory a block")


def assign_text(geo):
    return (f"{geo['k_blocks']} x {geo['row_groups']} blocks of "
            f"{geo['subspaces']} subspaces x {geo['rows']} rows, "
            f"{geo['smem']} B of shared memory a block")


B3_BLOCK_SUBSPACES = (4, 8, 16, 32, 64)


def nc_sweep(gen, flush, m=8, n=6912, full_nc=320):
    """B1, B3 and B4 at M=8, N=6912 with nc cut to 1/4, 1/2 and all of the
    2560 -> 6912 projection's 320 subspaces: flushed (time_ms) and warm
    (graph_ms). If time barely follows nc, a fixed cost per block or per
    launch holds the kernel back; if it follows nc, bytes in flight do.
    B3 also at each of B3_BLOCK_SUBSPACES subspaces a block (flushed /
    warm), beside its rule's choice, and so at M=32, nc=320."""
    rows = []
    for nc in (full_nc // 4, full_nc // 2, full_nc):
        x, z, lut, scale, _ = vq_inputs(gen, m, nc * V, n)
        idx = vq_assign_cuda(x, z)
        r = {"b1_ms": time_ms(lambda: vq_amm_cuda(x, z, lut, scale), 30,
                              flush),
             "b1_graph_ms": graph_ms(lambda: vq_amm_cuda(x, z, lut, scale)),
             "b1_geo": vq_amm_geometry(x, z, lut),
             "b4_ms": time_ms(lambda: lut_gemm_cuda(idx, lut, scale), 30,
                              flush),
             "b4_graph_ms": graph_ms(lambda: lut_gemm_cuda(idx, lut, scale)),
             "b4_geo": lut_gemm_geometry(idx, lut),
             "b3_ms": time_ms(lambda: vq_assign_cuda(x, z), 30, flush),
             "b3_graph_ms": graph_ms(lambda: vq_assign_cuda(x, z)),
             "b3_geo": vq_assign_geometry(x, z), "b3_sweep": []}
        for kb in B3_BLOCK_SUBSPACES:
            def call(kb=kb):
                return vq_assign_cuda(x, z, block_subspaces=kb)
            check(torch.equal(call(), idx),
                  f"B3 nc={nc} at {kb} subspaces a block: indices differ")
            r["b3_sweep"].append((kb, time_ms(call, 30, flush),
                                  graph_ms(call)))
        rows.append((nc, r))
    # the block size at the prefill chunk's rows too (M=32, nc=320)
    x, z, _, _, _ = vq_inputs(gen, 32, full_nc * V, n)
    big = []
    for kb in B3_BLOCK_SUBSPACES:
        def call(kb=kb):
            return vq_assign_cuda(x, z, block_subspaces=kb)
        big.append((kb, time_ms(call, 30, flush), graph_ms(call)))
    for nc, r in rows:
        print(f"nc sweep M={m} N={n} nc={nc}: B1 {r['b1_ms'] * 1e3:.1f} us "
              f"flushed, {r['b1_graph_ms'] * 1e3:.1f} us warm in a graph "
              f"({cluster_text(r['b1_geo'])}); B4 {r['b4_ms'] * 1e3:.1f} us "
              f"flushed, {r['b4_graph_ms'] * 1e3:.1f} us warm "
              f"({cluster_text(r['b4_geo'])}); B3 {r['b3_ms'] * 1e3:.1f} us "
              f"flushed, {r['b3_graph_ms'] * 1e3:.1f} us warm "
              f"({assign_text(r['b3_geo'])}); B3 at "
              + ", ".join(f"{kb}: {a * 1e3:.1f} / {b * 1e3:.1f}"
                          for kb, a, b in r["b3_sweep"])
              + " subspaces a block: us flushed / warm")
    print(f"B3 at M=32 nc={full_nc} ({assign_text(vq_assign_geometry(x, z))}"
          " by its rule): "
          + ", ".join(f"{kb}: {a * 1e3:.1f} / {b * 1e3:.1f}"
                      for kb, a, b in big)
          + " subspaces a block: us flushed / warm")
    return rows


def b34_case(gen, m, k, n, flush):
    """B3 then B4 (the two-pass path) at one main-path shape: B3's indices
    equal the plain argmin on margin inputs and B1's own on random ones
    (they share one distance and argmin code), B4's int8 sums are exact,
    and B4(B3(x)) equals B1(x) bit for bit. Returns two result dicts."""
    dev = DEV
    nc = k // V
    x, z, lut, scale, xr = vq_inputs(gen, m, k, n)
    idx_k = vq_assign_cuda(x, z)
    idx_p = ref.assign_ref(x, z)
    check(torch.equal(idx_k, idx_p),
          f"B3 {m}x{k}: kernel indices differ from the plain argmin at "
          f"{int((idx_k != idx_p).sum())} of {idx_p.numel()}")
    out_k = lut_gemm_cuda(idx_k, lut, scale)
    out_p = ref.lut_gemm_onehot(idx_p, lut, scale)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    check(err <= tol, f"B4 {m}x{k}x{n}: max abs err {err} > {tol}")
    probe = (torch.arange(C, device=dev)[None, :, None]
             * torch.eye(nc, device=dev)[:, None, :]).to(torch.int8)
    ones = torch.ones(nc, device=dev)
    for name, xx in (("margin", x), ("random", xr)):
        two = lut_gemm_cuda(vq_assign_cuda(xx, z), lut, scale)
        check(torch.equal(two, vq_amm_cuda(xx, z, lut, scale)),
              f"B4(B3(x)) != B1(x) at {m}x{k}x{n} on {name} x")
    idx_r = vq_assign_cuda(xr, z)
    b1_r = torch.round(vq_amm_cuda(xr, z, probe, ones)).to(torch.int32)
    check(torch.equal(idx_r, b1_r),
          f"B3 {m}x{k}: indices differ from B1's on random x")
    flips = float((idx_r != ref.assign_ref(xr, z)).float().mean())
    check(flips < 1e-3, f"B3 {m}x{k}: {flips:.2%} of random-x "
          "assignments differ from the plain argmin")

    lut_f = lut.float().reshape(nc * C, n)       # embedding_bag's table
    offs = (idx_k.long() + C * torch.arange(nc, device=dev)[None])
    lib = torch.nn.functional.embedding_bag(offs, lut_f, mode="sum")
    check(torch.allclose(lib * scale, out_k, rtol=1e-6, atol=0.0),
          f"B4 {m}x{k}x{n}: embedding_bag yardstick disagrees")
    calls3 = enqueued(lambda: vq_assign_cuda(x, z))
    check(calls3 == ONE_KERNEL, f"B3 {m}x{k}: a call enqueues {calls3}")
    calls4 = enqueued(lambda: lut_gemm_cuda(idx_k, lut, scale))
    check(calls4 == ONE_KERNEL,
          f"B4 {m}x{k}x{n}: a call enqueues {calls4}")
    r3 = {"ms": time_ms(lambda: vq_assign_cuda(x, z), 30, flush),
          "warm_ms": graph_ms(lambda: vq_assign_cuda(x, z)),
          "plain_ms": time_ms(lambda: ref.assign_ref(x, z), 5, flush),
          "host": host_us(lambda: vq_assign_cuda(x, z)), "err": 0.0,
          "library_ms": None}
    r4 = {"ms": time_ms(lambda: lut_gemm_cuda(idx_k, lut, scale), 30, flush),
          "warm_ms": graph_ms(lambda: lut_gemm_cuda(idx_k, lut, scale)),
          "plain_ms": time_ms(lambda: ref.lut_gemm_onehot(idx_k, lut, scale),
                              5, flush),
          "host": host_us(lambda: lut_gemm_cuda(idx_k, lut, scale)),
          "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
              offs, lut_f, mode="sum"), 30, flush),
          "err": err}
    # B3 must read x and z and write the indices; B4 read the indices,
    # the LUT rows they select and the scale, and write out
    r3["bound_ms"], r3["bound_by"] = bound(
        nbytes(x, z, idx_k), m * nc * C * (4 * V + 2))
    lut_bytes = selected_lut_bytes(idx_k, n)
    r4["bound_ms"], r4["bound_by"] = bound(
        nbytes(idx_k, scale) + lut_bytes + m * n * 4, m * nc * n + m * n)
    print(f"B3 vq_assign M={m} K={k}: kernel {r3['ms'] * 1e3:.1f} us (warm, "
          f"30 calls in one graph: {r3['warm_ms'] * 1e3:.1f} us a call), "
          f"plain {r3['plain_ms'] * 1e3:.1f} us, bound "
          f"{r3['bound_ms'] * 1e3:.3f} us ({r3['bound_by']}), host "
          f"{r3['host']:.1f} us/call, enqueues {calls3}, "
          f"{assign_text(vq_assign_geometry(x, z))}; random x: "
          f"{flips:.2e} flips vs plain, indices equal to B1's")
    print(f"B4 lut_gemm M={m} K={k} N={n}: kernel {r4['ms'] * 1e3:.1f} us "
          f"(warm, 30 calls in one graph: {r4['warm_ms'] * 1e3:.1f} us a "
          f"call), plain {r4['plain_ms'] * 1e3:.1f} us, embedding_bag "
          f"(float32 copy of the int8 table, no scale) "
          f"{r4['library_ms'] * 1e3:.1f} us, bound "
          f"{r4['bound_ms'] * 1e3:.2f} us ({r4['bound_by']}), host "
          f"{r4['host']:.1f} us/call, enqueues {calls4}, "
          f"{cluster_text(lut_gemm_geometry(idx_k, lut))} (B1: "
          f"{cluster_text(vq_amm_geometry(x, z, lut))}), max abs err "
          f"{err:.3g}; B4(B3(x)) == B1(x) bitwise")
    return r3, r4


def float_lut_case(gen, m, k, n, flush):
    """B1 and B4 with float32 and bfloat16 LUTs (the int8 table times its
    scale) at one main-path shape, on random unit-scale rows: two
    launches on one input give the same bits, a B1 call enqueues one
    kernel, the result agrees with the plain version, and both are timed
    beside the int8 kernels. B4(B3(x)) must equal B1(x) bit for bit where
    the two launches take one cluster size and row groups (then they sum
    in one order); elsewhere whether it does is recorded."""
    _, z, lut8, scale, xr = vq_inputs(gen, m, k, n)
    idx = vq_assign_cuda(xr, z)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        lut = (lut8.float() * scale).to(dt).contiguous()
        b1 = [vq_amm_cuda(xr, z, lut) for _ in range(2)]
        b4 = [lut_gemm_cuda(idx, lut) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(b1[0], b1[1]),
              f"B1 {m}x{k}x{n} {dt}: two launches on one input differ")
        check(torch.equal(b4[0], b4[1]),
              f"B4 {m}x{k}x{n} {dt}: two launches on one input differ")
        for name, fn in (("B1", lambda: vq_amm_cuda(xr, z, lut)),
                         ("B4", lambda: lut_gemm_cuda(idx, lut))):
            calls = enqueued(fn)
            check(calls == ONE_KERNEL,
                  f"{name} {m}x{k}x{n} {dt}: a call enqueues {calls}")
        g1, g4 = vq_amm_geometry(xr, z, lut), lut_gemm_geometry(idx, lut)
        same = (g1["cluster"], g1["row_groups"]) == (g4["cluster"],
                                                     g4["row_groups"])
        bitwise = torch.equal(b1[0], b4[0])
        check(bitwise or not same,
              f"B4(B3(x)) != B1(x) at {m}x{k}x{n} {dt} though both launch "
              f"cluster {g1['cluster']}")
        want = ref.lut_gemm_onehot(idx, lut)
        for name, got in (("B1", b1[0]), ("B4", b4[0])):
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                  f"{name} {m}x{k}x{n} {dt}: disagrees with the plain sum")
        key = str(dt).split(".")[-1]
        res[key] = {
            "b1_ms": time_ms(lambda: vq_amm_cuda(xr, z, lut), 30, flush),
            "b4_ms": time_ms(lambda: lut_gemm_cuda(idx, lut), 30, flush),
            "two_pass_bitwise": bitwise, "clusters": (g1["cluster"],
                                                      g4["cluster"])}
    return res


def fused_case(label, fused, plain_triples, q, kn, vn, pos, kvh):
    """The fused kernel (B2 or B5 with the fold epilogue: one launch, the
    whole flash_decode_paged call) against the plain pair on the same
    inputs (the plain triples, then fold_splits), with q, k_new and v_new
    in float32 and in bfloat16: float32 output within 2e-5 (1 + max|ref|)
    (the fold tests' tolerance), bfloat16 output within half a bfloat16
    ulp more; pos = -1 lanes exactly their v_new row; two launches bitwise
    equal. ``fused(q, kn, vn)`` launches it; ``plain_triples(qg)`` gives
    the plain triples. Returns the float32 output's max abs error."""
    b, _, h, d = q.shape
    g = h // kvh
    dead = (pos < 0).nonzero().flatten().tolist()
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        qc, knc, vnc = (t.to(dt).contiguous() for t in (q, kn, vn))
        got = fused(qc, knc, vnc)
        again = fused(qc, knc, vnc)
        qg = (qc.reshape(b, kvh, g, d).float() * d ** -0.5).contiguous()
        want = fd.fold_splits(*plain_triples(qg), qg, knc, vnc,
                              torch.float32)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == want.shape,
              f"{label} ({dt}): output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{label} ({dt}): non-finite")
        check(torch.equal(got, again), f"{label} ({dt}): two launches differ")
        e = float((got.float() - want).abs().max())
        half_ulp = 0.0 if dt == torch.float32 else 2.0 ** -8
        tol = 2e-5 * (1.0 + float(want.abs().max()))
        check(bool(((got.float() - want).abs()
                    <= tol + half_ulp * want.abs()).all()),
              f"{label} ({dt}): max abs err {e} > {tol} (+ {half_ulp} "
              "relative) against the plain triples + fold_splits")
        if dt == torch.float32:
            err = e
        for lane in dead:
            row = vnc[lane, 0, :, None, :].expand(kvh, g, d).reshape(1, -1)
            check(torch.equal(got[lane], row),
                  f"{label} ({dt}): pos=-1 lane {lane} is not exactly its "
                  "v_new row")
    return err


def geometry_text(geo):
    return (f"{geo['clusters']} clusters of {geo['cluster']} blocks, "
            f"{geo['resident']} resident at once ({geo['smem']} B of shared "
            f"memory, {geo['registers']} registers a thread)")


def call_timings(label, call, plain, flush):
    """A whole flash_decode_paged call: flushed (mean and median of 30),
    warm in a graph of 30 calls, host us a call, what it enqueues (one
    kernel), and the plain pair's time."""
    times = device_times(call, 30, flush)
    calls = enqueued(call)
    check(calls == ONE_KERNEL,
          f"{label}: flash_decode_paged enqueues {calls}")
    return {"ms": float(np.mean(times)), "med_ms": float(np.median(times)),
            "warm_ms": graph_ms(call), "host": host_us(call),
            "plain_ms": time_ms(plain, 5, flush), "enqueues": calls}


def b2_inputs(gen, b, h, kvh, d, np_, positions, kv_start, ps, dev=DEV):
    n_pages = b * np_
    kp = torch.randn((n_pages + 1, ps, kvh, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pages + 1, ps, kvh, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    kp[-1] = 1e4                      # trash page: must never be attended
    vp[-1] = 1e4
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    phys = perm.reshape(b, np_).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    for i, p in enumerate(positions):  # unallocated tail -> trash
        phys[i, max(0, -(-p // ps)):] = n_pages
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kn = torch.randn((b, 1, kvh, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vn = torch.randn((b, 1, kvh, d), generator=gen, device=dev).to(
        torch.bfloat16)
    ks = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    return q, kp, vp, kn, vn, phys, pos, ks


def split_sweep(np_, sp):
    """Pages per split timed beside the rule's ``sp``: powers of two up to
    the whole sequence."""
    return sorted({s for s in (1, 2, 4, 8, 16, 32) if s <= np_} | {sp})


def b2_case(gen, name, b, h, kvh, d, np_, positions, window, kv_start,
            flush, timed, ps=PAGE):
    q, kp, vp, kn, vn, phys, pos, ks = b2_inputs(gen, b, h, kvh, d, np_,
                                                 positions, kv_start, ps)
    g = h // kvh
    sp = fd.split_pages_for(b, kvh, np_)
    qg = (q.reshape(b, kvh, g, d).float() * d ** -0.5).contiguous()
    pad = (-np_) % sp
    phys_p = torch.nn.functional.pad(phys, (0, pad),
                                     value=kp.shape[0] - 1).contiguous()
    tk = fd.flash_decode_splits_cuda(qg, kp, vp, phys_p, pos, window, ks, sp)
    tp = fd.flash_decode_splits(qg, kp, vp, phys_p, pos, window, ks, sp)
    torch.cuda.synchronize()
    for nm, a, c in zip("mla", tk, tp):
        e = float((a - c).abs().max())
        check(e <= 2e-5 * (1.0 + float(c.abs().max())),
              f"B2 {name}: split {nm} max abs err {e}")
    neg = torch.tensor(fd.NEG_INF, dtype=torch.float32)
    dead = pos < 0
    if bool(dead.any()):              # masked lanes: exactly the identity
        check(bool((tk[0][:, dead] == neg.to(tk[0].device)).all()
                   and (tk[1][:, dead] == 0).all()
                   and (tk[2][:, dead] == 0).all()),
              f"B2 {name}: masked lane is not (-1e30, 0, 0)")
    fused_err = fused_case(
        f"B2 fused {name}",
        lambda qc, knc, vnc: fd.flash_decode_paged_cuda(
            qc, kp, vp, knc, vnc, phys, pos, window, ks, sp),
        lambda qg_: fd.flash_decode_splits(qg_, kp, vp, phys_p, pos, window,
                                           ks, sp), q, kn, vn, pos, kvh)
    out_k = fd.flash_decode_paged(q, kp, vp, kn, vn, phys, pos,
                                  window=window, kv_start=ks)
    with plain_kernels():
        out_p = fd.flash_decode_paged(q, kp, vp, kn, vn, phys, pos,
                                      window=window, kv_start=ks)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), f"B2 {name}: non-finite out")
    err = float((out_k.float() - out_p.float()).abs().max())
    # the two differ only in fp32 summation order before the bf16 cast
    check(err <= 2e-2, f"B2 {name}: output max abs err {err}")
    if not timed:
        print(f"B2 flash_decode {name}: max abs err {err:.3g} (bf16 out), "
              f"fused vs plain pair {fused_err:.3g} (float32 out; checked)")
        return {"err": fused_err}

    def call():
        return fd.flash_decode_paged(q, kp, vp, kn, vn, phys, pos,
                                     window=window, kv_start=ks)

    def plain():
        return fd.flash_decode_paged_plain(q, kp, vp, kn, vn, phys, pos,
                                           window, ks, sp)
    ct = call_timings(f"B2 {name}", call, plain, flush)
    geo = fd.fused_geometry(q, kp, phys, sp)
    times = device_times(lambda: fd.flash_decode_splits_cuda(
        qg, kp, vp, phys_p, pos, window, ks, sp), 30, flush)
    ms, med = float(np.mean(times)), float(np.median(times))
    sweep, fsweep = [], []
    for s in split_sweep(np_, sp):    # pages per split
        ph = torch.nn.functional.pad(phys, (0, (-np_) % s),
                                     value=kp.shape[0] - 1).contiguous()
        t_s = time_ms(lambda: fd.flash_decode_splits_cuda(
            qg, kp, vp, ph, pos, window, ks, s), 30, flush)
        sweep.append(f"{s}: {t_s * 1e3:.1f}")
        if -(-np_ // s) <= fd.MAX_SPLITS:
            t_f = time_ms(lambda: fd.flash_decode_paged_cuda(
                q, kp, vp, kn, vn, phys, pos, window, ks, s), 30, flush)
            g_s = fd.fused_geometry(q, kp, phys, s)
            fsweep.append(f"{s}: {t_f * 1e3:.1f} ({g_s['resident']} of "
                          f"{g_s['clusters']} clusters resident)")
    print(f"B2 flash_decode {name}: us by pages per split (the split rule "
          f"takes {sp}), triples form {', '.join(sweep)}; fused "
          f"{', '.join(fsweep)}")
    # yardstick: SDPA over the already gathered, contiguous K/V
    t = np_ * ps
    kg = kp[phys.long()].reshape(b, t, kvh, d).transpose(1, 2).contiguous()
    vg = vp[phys.long()].reshape(b, t, kvh, d).transpose(1, 2).contiguous()
    mask = (torch.arange(t, device=DEV)[None] < pos[:, None])[:, None,
                                                                None]
    qs = q.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             qs, kg, vg, attn_mask=mask,
                             enable_gqa=h != kvh),
                         30, flush)
    live = int(pos.clamp_min(0).sum())
    rows = 2 * live * kvh * d * kp.element_size()
    tms, tby = bound(rows + nbytes(qg, phys_p, pos) + nbytes(*tk),
                     4 * live * h * d)
    # the whole call: K/V rows, q, the new token's rows, page ids, out
    bms, by = bound(rows + nbytes(q, kn, vn, phys, pos, ks) + nbytes(q),
                    4 * live * h * d + 10 * b * h * d)
    print(f"B2 flash_decode {name}: whole flash_decode_paged call (fused "
          f"kernel) {ct['ms'] * 1e3:.1f} us flushed (median "
          f"{ct['med_ms'] * 1e3:.1f}), {ct['warm_ms'] * 1e3:.1f} us warm in "
          f"a graph, host {ct['host']:.1f} us/call, enqueues "
          f"{ct['enqueues']}, bound {bms * 1e3:.2f} us ({by}; {live} live "
          f"tokens, {sp} pages a split), {geometry_text(geo)}; triples "
          f"form {ms * 1e3:.1f} us (median {med * 1e3:.1f}; bound "
          f"{tms * 1e3:.2f} us, {tby}); plain pair {ct['plain_ms'] * 1e3:.1f}"
          f" us; SDPA on gathered K/V {library_ms * 1e3:.1f} us; max abs err "
          f"{fused_err:.3g} (float32 out), {err:.3g} (bf16 out)")
    return {"ms": ct["ms"], "plain_ms": ct["plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "err": fused_err,
            "warm_ms": ct["warm_ms"], "triples_ms": ms}


def b5_inputs(gen, b, h, kvh, d, np_, positions, kv_start, ps,
              exact_c=None):
    """A code pool of one layer: random fp K/V pages, encoded with a table
    fit on them (nc = d / KV_V, c = KV_C), or with an exact-cover table of
    exact_c rows (nc = 1, v = d) and random codes; the trash page holds
    codes too (never attended). Returns the operands and the fp pages the
    codes stand for (dequantized), for the SDPA yardstick."""
    dev = DEV
    n_pages = b * np_
    kp = torch.randn((n_pages + 1, ps, kvh, d), generator=gen, device=dev)
    vp = torch.randn((n_pages + 1, ps, kvh, d), generator=gen, device=dev)
    if exact_c is None:
        cb = KVCodebook.fit(kp[None, :n_pages].reshape(1, -1, kvh, d),
                            vp[None, :n_pages].reshape(1, -1, kvh, d),
                            v=KV_V, c=KV_C, generator=gen)
        kc = kv_encode(kp, cb.zk[0], cb.sk[0])
        vc = kv_encode(vp, cb.zv[0], cb.sv[0])
    else:
        rows = torch.randn((2, 1, exact_c // kvh, kvh, d), generator=gen,
                           device=dev)
        cb = KVCodebook.from_rows(rows[0], rows[1])
        kc = torch.randint(0, exact_c, (n_pages + 1, ps, kvh, 1),
                           generator=gen, device=dev).to(torch.uint8)
        vc = torch.randint(0, exact_c, (n_pages + 1, ps, kvh, 1),
                           generator=gen, device=dev).to(torch.uint8)
    cb_l = {key: leaf[0].contiguous() for key, leaf in cb.tree().items()}
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    phys = perm.reshape(b, np_).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    for i, p in enumerate(positions):  # unallocated tail -> trash
        phys[i, max(0, -(-p // ps)):] = n_pages
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    kn = torch.randn((b, 1, kvh, d), generator=gen, device=dev)
    vn = torch.randn((b, 1, kvh, d), generator=gen, device=dev)
    ks = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    return q, kc, vc, cb_l, kn, vn, phys, pos, ks


def b5_case(gen, name, b, h, kvh, d, np_, positions, window, kv_start,
            flush, timed, exact_c=None, ps=PAGE):
    """B5 at one shape, against its plain version (triples and output)
    and the dequantize-then-reference oracle, all in float32."""
    q, kc, vc, cb_l, kn, vn, phys, pos, ks = b5_inputs(
        gen, b, h, kvh, d, np_, positions, kv_start, ps, exact_c)
    g = h // kvh
    sp = fd.split_pages_for(b, kvh, np_, kvq=True)
    qg = (q.reshape(b, kvh, g, d).float() * d ** -0.5).contiguous()
    tab = (cb_l["zk"], cb_l["zv"], cb_l["sk"], cb_l["sv"])

    def pad(s_):
        return torch.nn.functional.pad(phys, (0, (-np_) % s_),
                                       value=kc.shape[0] - 1).contiguous()
    phys_p = pad(sp)
    nc, c_, v_ = cb_l["zk"].shape
    form = fd.kvq_form(g, d, ps, sp, nc, c_, v_)
    fform = fd.kvq_form(g, d, ps, sp, nc, c_, v_, fused=True)
    tk = fd.flash_decode_splits_kvq_cuda(qg, kc, vc, *tab, phys_p, pos,
                                         window, ks, sp)
    tp = fd.flash_decode_splits_kvq(qg, kc, vc, *tab, phys_p, pos, window,
                                    ks, sp)
    torch.cuda.synchronize()
    for nm, a, c in zip("mla", tk, tp):
        e = float((a - c).abs().max())
        check(e <= 2e-5 * (1.0 + float(c.abs().max())),
              f"B5 {name}: split {nm} max abs err {e}")
    neg = torch.tensor(fd.NEG_INF, dtype=torch.float32, device=DEV)
    dead = pos < 0
    if bool(dead.any()):              # masked lanes: exactly the identity
        check(bool((tk[0][:, dead] == neg).all()
                   and (tk[1][:, dead] == 0).all()
                   and (tk[2][:, dead] == 0).all()),
              f"B5 {name}: masked lane is not (-1e30, 0, 0) in float32")
    fused_err = fused_case(
        f"B5 fused {name}",
        lambda qc, knc, vnc: fd.flash_decode_paged_kvq_cuda(
            qc, kc, vc, *tab, knc, vnc, phys, pos, window, ks, sp),
        lambda qg_: fd.flash_decode_splits_kvq(qg_, kc, vc, *tab, phys_p,
                                               pos, window, ks, sp),
        q, kn, vn, pos, kvh)
    out_k = fd.flash_decode_paged(q, kc, vc, kn, vn, phys, pos,
                                  window=window, kv_start=ks, codebook=cb_l)
    with plain_kernels():
        out_p = fd.flash_decode_paged(q, kc, vc, kn, vn, phys, pos,
                                      window=window, kv_start=ks,
                                      codebook=cb_l)
    oracle = ref.flash_decode_kvq_ref(q, kc, vc, cb_l, kn, vn, phys, pos,
                                      window=window, kv_start=ks)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), f"B5 {name}: non-finite out")
    live = ~dead
    err = max(float((out_k - w)[live].abs().max()) for w in (out_p, oracle))
    check(err <= 1e-4, f"B5 {name}: output max abs err {err} (float32)")
    tables = nbytes(*tab)
    if not timed:
        print(f"B5 flash_decode_kvq {name}: tables {tables / 1024:.0f} KB, "
              f"{form} form ({fform} fused), max abs err {err:.3g} vs plain and oracle, "
              f"fused vs plain pair {fused_err:.3g} (checked)")
        return {"err": max(err, fused_err)}

    def call():
        return fd.flash_decode_paged(q, kc, vc, kn, vn, phys, pos,
                                     window=window, kv_start=ks,
                                     codebook=cb_l)

    def plain():
        return fd.flash_decode_paged_kvq_plain(q, kc, vc, *tab, kn, vn, phys,
                                               pos, window, ks, sp)
    ct = call_timings(f"B5 {name}", call, plain, flush)
    geo = fd.fused_geometry(q, kc, phys, sp, cb_l)
    times = device_times(lambda: fd.flash_decode_splits_kvq_cuda(
        qg, kc, vc, *tab, phys_p, pos, window, ks, sp), 30, flush)
    ms, med = float(np.mean(times)), float(np.median(times))
    sweep, fsweep = [], []
    for s_ in split_sweep(np_, sp):   # pages per split
        ph = pad(s_)
        t_s = time_ms(lambda: fd.flash_decode_splits_kvq_cuda(
            qg, kc, vc, *tab, ph, pos, window, ks, s_), 30, flush)
        sweep.append(f"{s_}: {t_s * 1e3:.1f}")
        if -(-np_ // s_) <= fd.MAX_SPLITS:
            t_f = time_ms(lambda: fd.flash_decode_paged_kvq_cuda(
                q, kc, vc, *tab, kn, vn, phys, pos, window, ks, s_), 30,
                flush)
            g_s = fd.fused_geometry(q, kc, phys, s_, cb_l)
            fsweep.append(f"{s_}: {t_f * 1e3:.1f} ({g_s['resident']} of "
                          f"{g_s['clusters']} clusters resident)")
    print(f"B5 flash_decode_kvq {name}: us by pages per split (the split "
          f"rule takes {sp}), triples form {', '.join(sweep)}; fused "
          f"{', '.join(fsweep)}")
    # yardstick: SDPA over K/V already dequantized, gathered, contiguous
    t = np_ * ps
    kd = (cb_l["zk"][torch.arange(kc.shape[-1], device=DEV),
                     kc[phys.long()].long()].reshape(b, t, kvh, d)
          * cb_l["sk"][:, None]).to(torch.bfloat16)
    vd = (cb_l["zv"][torch.arange(vc.shape[-1], device=DEV),
                     vc[phys.long()].long()].reshape(b, t, kvh, d)
          * cb_l["sv"][:, None]).to(torch.bfloat16)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    mask = (torch.arange(t, device=DEV)[None] < pos[:, None])[:, None, None]
    qs = q.to(torch.bfloat16).transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             qs, kd, vd, attn_mask=mask,
                             enable_gqa=h != kvh),
                         30, flush)
    live_t = int(pos.clamp_min(0).sum())
    codes = 2 * live_t * kvh * kc.shape[-1] * kc.element_size() + tables
    ops = 4 * live_t * h * d + 2 * live_t * kvh * d
    tms, tby = bound(codes + nbytes(qg, phys_p, pos, ks) + nbytes(*tk), ops)
    bms, by = bound(codes + nbytes(q, kn, vn, phys, pos, ks) + nbytes(q),
                    ops + 10 * b * h * d)
    print(f"B5 flash_decode_kvq {name}: whole flash_decode_paged call "
          f"(fused kernel, {fform} form) {ct['ms'] * 1e3:.1f} us flushed "
          f"(median {ct['med_ms'] * 1e3:.1f}), {ct['warm_ms'] * 1e3:.1f} us "
          f"warm in a graph, host {ct['host']:.1f} us/call, enqueues "
          f"{ct['enqueues']}, bound {bms * 1e3:.2f} us ({by}; {live_t} live "
          f"tokens, {kc.shape[-1]} code bytes per token and head, {sp} pages"
          f" a split), {geometry_text(geo)}; triples form ({form}) "
          f"{ms * 1e3:.1f} us (median {med * 1e3:.1f}; bound "
          f"{tms * 1e3:.2f} us, {tby}); "
          f"plain pair {ct['plain_ms'] * 1e3:.1f} us; SDPA on dequantized "
          f"bf16 K/V {library_ms * 1e3:.1f} us; max abs err {err:.3g} vs "
          f"plain and oracle, fused vs plain pair {fused_err:.3g}")
    return {"ms": ct["ms"], "plain_ms": ct["plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms,
            "err": max(err, fused_err), "warm_ms": ct["warm_ms"],
            "triples_ms": ms}


# ---------------------------------------------------------------------------
# serve phase + logit check
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Load:
    """One serve run's workload: ``n`` requests of ``prompt`` (lo, hi)
    random prompt tokens and ``new`` new tokens each, all submitted at
    once to an engine of ``slots`` slots, ``max_seq`` tokens a slot, page
    PAGE and prefill chunk ``chunk``; request ``hot`` samples at
    temperature 0.8 (-1: all greedy). The logit check prefills its slots
    to ``check`` (lo, hi) tokens."""
    slots: int = SLOTS
    max_seq: int = MAX_SEQ
    chunk: int = CHUNK
    n: int = 10
    prompt: tuple = (32, 257)
    new: int = 32
    hot: int = 3
    check: tuple = (40, 300)


MAIN_LOAD = Load()
# gemma3: prompts past the 1024-token window of its local layers, so the
# window masks in prefill and in decode (at max_seq 512 it never would)
GEMMA_LOAD = Load(max_seq=2048, chunk=256, prompt=(1100, 1801),
                  check=(1100, 1800))
GEMMA27_LOAD = Load(slots=4, max_seq=2048, chunk=256, n=4,
                    prompt=(1100, 1301), new=16, hot=-1, check=(1100, 1300))
# (projection shapes, rows of a call) of each dense config's kernel
# checks: every M its serve runs give B1 (decode: the slots; prefill: the
# chunk), and yi-9b and gemma3-4b also at DENSE_MS
DENSE_PATHS = {
    "yi-9b": (YI_PROJ_SHAPES, sorted({*DENSE_MS, MAIN_LOAD.slots,
                                      MAIN_LOAD.chunk})),
    "gemma3-4b": (GEMMA_PROJ_SHAPES, sorted({*DENSE_MS, GEMMA_LOAD.slots,
                                             GEMMA_LOAD.chunk})),
    "gemma3-27b": (GEMMA27_PROJ_SHAPES, sorted({GEMMA27_LOAD.slots,
                                                GEMMA27_LOAD.chunk})),
}


def serve(model, params, qc, seed, label, launched, idle, load=MAIN_LOAD,
          spec=None, hook=None):
    """Serve ``load`` through the engine under ``qc`` (speculatively with
    ``spec``); every kernel in ``launched`` must launch, none in ``idle``,
    and no plain version may run. ``hook(eng)``, when given, may wrap the
    engine's methods before the run (after the step timers). Returns
    (counts, tokens, engine)."""
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    reqs = [Request(tokens=rng.integers(0, vocab, int(n)).tolist(),
                    max_new_tokens=load.new,
                    temperature=0.8 if i == load.hot else 0.0)
            for i, n in enumerate(rng.integers(*load.prompt, load.n))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(model, params, qc, batch_size=load.slots,
                 max_seq=load.max_seq, page_size=PAGE,
                 prefill_chunk=load.chunk, seed=seed, spec_decode=spec)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    step = "_decode_step" if spec is None else "_spec_decode_step"
    times = {"_prefill_chunk_step": [], step: []}

    def timed(name):
        fn = getattr(eng, name)

        def wrapper(*a):
            t0 = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        return wrapper
    for name in times:
        setattr(eng, name, timed(name))
    if hook is not None:
        hook(eng)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    PATH_LAUNCHES[label] = {k: counts[k] for k in WRAPPERS}
    for r in reqs:
        check(r.done and len(r.out_tokens) == load.new,
              f"{label}: request not served in full: {len(r.out_tokens)} "
              "tokens")
        check(all(0 <= t < vocab for t in r.out_tokens),
              f"{label}: token out of range")
    check(all(counts[k] > 0 for k in launched),
          f"{label}: the path did not launch {launched}: {counts}")
    check(all(counts[k] == 0 for k in idle),
          f"{label}: the path launched one of {idle}: {counts}")
    check(all(counts[k + "_plain"] == 0 for k in DISPATCH),
          f"{label}: the path took a plain version: {counts}")
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    prompt_tokens = sum(len(r.tokens) for r in reqs)
    dec, pre = times[step], times["_prefill_chunk_step"]
    fit = (f"codebook fit + pool in {setup:.2f} s, "
           if qc.kv_quant == "vq" else "")
    what = "decode steps" if spec is None else "speculative rounds"
    print(f"serve [{label}]: {len(reqs)} requests ({prompt_tokens} prompt "
          f"tokens, {gen_tokens} generated) in {wall:.2f} s: "
          f"{gen_tokens / wall:.1f} generated tokens/s; "
          f"{len(dec)} {what}, mean {1e3 * np.mean(dec):.1f} ms; "
          f"{len(pre)} prefill chunks of {load.chunk}, mean "
          f"{1e3 * np.mean(pre):.1f} ms; "
          f"{eng.device_reads} host reads; {fit}KV pool "
          f"{eng.kv.bytes_per_token} B per token "
          f"({eng.kv.data['k'].dtype}); launches {counts}")
    eng.stats = {"wall": wall, "tokens_per_s": gen_tokens / wall,
                 "step_ms": 1e3 * float(np.mean(dec))}
    eng.requests = reqs
    return counts, [r.out_tokens for r in reqs], eng


def prefilled_pool(model, params, qc, seed, codebook=None, load=MAIN_LOAD):
    """A paged pool with ``load.slots`` slots prefilled to random lengths
    in ``load.check``, and one decode step's inputs: (kv, table, tokens,
    positions, lengths)."""
    rng = np.random.default_rng(seed + 1)
    slots, c = load.slots, load.chunk
    npg = load.max_seq // PAGE
    kv = model.init_paged_cache(load.max_seq, PAGE, slots * npg,
                                codebook=codebook)
    table = torch.arange(slots * npg, dtype=torch.int32,
                         device=DEV).reshape(slots, npg)
    lengths = rng.integers(*load.check, slots)
    for slot, n in enumerate(lengths):
        prompt = rng.integers(0, model.cfg.vocab_size, int(n))
        for pos in range(0, int(n), c):
            chunk = prompt[pos:pos + c]
            toks = np.zeros((1, c), np.int32)
            toks[0, :len(chunk)] = chunk
            model.prefill_paged(params, torch.from_numpy(toks).to(DEV), kv,
                                table, slot, pos, len(chunk), qc)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (slots, 1)).astype(np.int32)).to(DEV)
    positions = torch.from_numpy(lengths.astype(np.int32)).to(DEV)
    return kv, table, toks, positions, lengths


def logit_check(model, params, qc, seed, label, codebook=None,
                load=MAIN_LOAD):
    """One full-width decode_paged step through the kernels and through
    the plain versions, on the same pool (in the model's dtype, or codes
    under ``codebook``)."""
    kv, table, toks, positions, lengths = prefilled_pool(
        model, params, qc, seed, codebook, load)
    slots = load.slots
    lg_k = model.decode_paged(params, toks, kv, table, positions, qc).float()
    with plain_kernels():
        lg_p = model.decode_paged(params, toks, kv, table, positions,
                                  qc).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg_k).all()), "non-finite logits")
    delta = lg_k - lg_p
    rel = (delta.norm(dim=-1) / lg_p.norm(dim=-1)).tolist()
    mean_frac = float(delta.abs().mean() / lg_p.std())
    agree = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    agreeing = sum(r <= LOGIT_ROW_REL_TOL for r in rel)
    print(f"logit check [{label}], {model.cfg.dtype} (one decode step, "
          f"{slots} slots at lengths {lengths.tolist()}): {agreeing}/{slots} "
          f"rows agree (relative L2 <= {LOGIT_ROW_REL_TOL}); row relative "
          f"L2 {[round(r, 4) for r in rel]}, mean |diff| {mean_frac:.4f} of "
          f"std {float(lg_p.std()):.4g}, max |diff| "
          f"{float(delta.abs().max()):.4g}, argmax agrees on {agree}/{slots}")
    allowed = LOGIT_ROWS_OFF[model.cfg.dtype]
    check(agreeing >= slots - allowed,
          f"kernel vs plain logits [{label}] ({model.cfg.dtype}): "
          f"{agreeing} of "
          f"{slots} rows within relative L2 {LOGIT_ROW_REL_TOL}, at least "
          f"{slots - allowed} required")


VERIFY_ROW_REL_TOL = 1e-4


def verify_check(model, params, qc, seed, label, load=MAIN_LOAD):
    """One verify_paged call of SPEC_K + 1 tokens a slot against a chain of
    SPEC_K + 1 decode_paged steps over the same tokens, each on its own
    copy of one prefilled fp pool, in float32: the verify's row (b, t)
    must give step t's logits of slot b. Slot 1 has 2 live columns and
    slot 2 sits out (-1); only live rows are compared. The verify attends
    in plain torch, the chain through B2, and both sum the int8 LUTs
    exactly, so a live row differs only by float32 summation order, or by
    a near-tie argmin flip that follows it (which moves that row and its
    slot's later rows); a wrong mask, window or per-row position moves
    every slot. A slot agrees when each of its live rows is within
    relative L2 VERIFY_ROW_REL_TOL; all but LOGIT_ROWS_OFF["float32"] of
    the live slots must."""
    check(model.cfg.dtype == "float32" and qc.kv_quant != "vq",
          "verify_check takes a float32 model over an fp pool")
    kv, table, _, positions, lengths = prefilled_pool(model, params, qc,
                                                      seed, None, load)
    t_v, slots = SPEC_K + 1, load.slots
    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (slots, t_v)).astype(np.int32)).to(DEV)
    n_live = torch.full((slots,), t_v, dtype=torch.int32, device=DEV)
    n_live[1], n_live[2] = 2, 0
    positions[2] = -1
    kv_v = {k: v.clone() for k, v in kv.items()}
    lg_v = model.verify_paged(params, toks, kv_v, table, positions, n_live,
                              qc).float()
    del kv_v
    chain = [model.decode_paged(
        params, toks[:, t:t + 1], kv, table,
        torch.where(positions >= 0, positions + t, positions), qc).float()
        for t in range(t_v)]
    lg_d = torch.stack(chain, 1)                          # (B, T, V)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg_v).all()), f"{label}: non-finite verify "
          "logits")
    rel = ((lg_v - lg_d).norm(dim=-1) / lg_d.norm(dim=-1)).cpu()
    live = [(b, int(n_live[b])) for b in range(slots) if n_live[b] > 0]
    worst = {b: float(rel[b, :n].max()) for b, n in live}
    agreeing = sum(w <= VERIFY_ROW_REL_TOL for w in worst.values())
    argmax = sum(int((lg_v[b, :n].argmax(-1) == lg_d[b, :n].argmax(-1))
                     .sum()) for b, n in live)
    rows = sum(n for _, n in live)
    print(f"verify check [{label}], {model.cfg.dtype} (one verify_paged "
          f"call of {t_v} tokens against {t_v} decode_paged steps; slots at "
          f"lengths {lengths.tolist()}, slot 1 with 2 live columns, slot 2 "
          f"out): {agreeing}/{len(live)} slots agree (every live row within "
          f"relative L2 {VERIFY_ROW_REL_TOL}); worst row per slot "
          f"{[f'{w:.2e}' for w in worst.values()]}; argmax agrees on "
          f"{argmax}/{rows} live rows")
    allowed = LOGIT_ROWS_OFF["float32"]
    check(agreeing >= len(live) - allowed,
          f"verify_paged vs decode_paged logits [{label}]: {agreeing} of "
          f"{len(live)} slots within relative L2 {VERIFY_ROW_REL_TOL}, at "
          f"least {len(live) - allowed} required")


def float_lut_serve(seed, layers=4):
    """Full-width qwen1.5-4b with float32 LUTs, cut to ``layers`` layers
    (~0.63 GB of float32 LUT a layer): two engine runs of the same
    requests must give the same tokens, and two decode_paged steps on one
    pool the same logits, bit for bit."""
    cfg = qwen1p5_4b.config().replace(num_layers=layers)
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    tokens = []
    for i in (1, 2):
        _, toks, eng = serve(model, params, qc, seed,
                             f"float32 LUTs, {layers} layers, run {i}",
                             {"b1", "b2"}, {"b3", "b4", "b5"})
        tokens.append(toks)
        del eng
    check(tokens[0] == tokens[1],
          "float32-LUT engine runs gave different tokens")
    kv, table, toks, positions, _ = prefilled_pool(model, params, qc, seed)
    lg = [model.decode_paged(params, toks, kv, table, positions, qc)
          for _ in range(2)]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg[0]).all()), "float32-LUT logits non-finite")
    check(torch.equal(lg[0], lg[1]),
          "float32-LUT decode steps gave different logits")
    print(f"float32 LUTs ({layers} layers, full width): two engine runs "
          f"gave identical tokens (10 requests, {sum(map(len, tokens[0]))} "
          f"tokens) and two decode_paged steps bitwise equal logits")


class VerifyTap:
    """Stands in for the engine's model: records, for each decode step,
    each row's top-2 logit gap (``gaps``, on the device), and for each
    verify call its rows' argmax (``verify_ids``, read to the host here,
    apart from the engine's own reads)."""

    def __init__(self, model):
        self._model = model
        self.gaps = []
        self.verify_ids = None

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_paged(self, *a):
        lg = self._model.decode_paged(*a)
        top = torch.topk(lg.float(), 2, dim=-1).values
        self.gaps.append(top[:, 0] - top[:, 1])
        return lg

    def verify_paged(self, *a):
        lg = self._model.verify_paged(*a)
        self.verify_ids = torch.argmax(lg, dim=-1).cpu()
        return lg


def tap_steps(eng, attr, after):
    """Wrap ``eng.<attr>`` (a decode step or a speculative round): before
    it, note each decoding slot's (idx, request, tokens so far); after
    it, call ``after(notes)``."""
    fn = getattr(eng, attr)

    def wrapper():
        notes = [(s.idx, s.req, len(s.req.out_tokens))
                 for s in eng.scheduler.decode_slots()]
        fn()
        after(notes)
    setattr(eng, attr, wrapper)


class ShiftDrafter(Drafter):
    """Proposes the slot's pending token + 1, k times: on the repeating
    greedy streams of a random-weight model the target rejects every
    proposal, so each round rolls back (``PagedKVCache.trim``)."""

    def propose(self, engine, dslots, k_slot, k):
        vocab = engine.model.cfg.vocab_size
        g = np.zeros((engine.num_slots, k), np.int32)
        n_prop = np.zeros((engine.num_slots,), np.int32)
        for s in dslots:
            g[s.idx] = (s.next_token + 1) % vocab
            n_prop[s.idx] = k_slot[s.idx]
        return g, n_prop, None


def spec_runs(model, params, qc, seed, label, specs, load):
    """The non-speculative engine, then one speculative engine per entry
    of ``specs`` ((name, SpecConfig, kernels it launches, a drafter that
    replaces the config's or None)), on the same requests (``load``, all
    greedy). Check (a): every token a round emits
    is the argmax of its verify row (the bonus token included). Returns
    the streams, each run's engine stats, and where each speculative
    stream parts from the non-speculative one: (name, request, token
    index, the non-speculative top-2 logit gap at that step)."""
    idle = {"b3", "b4", "b5"}
    base_tap = VerifyTap(model)
    gap_at = {}
    steps = []

    def note_gaps(notes):            # a step that decoded: its gaps
        if len(base_tap.gaps) > len(steps):
            steps.append((notes, base_tap.gaps[-1]))

    def base_hook(eng):
        eng.model = base_tap
        tap_steps(eng, "_decode_step", note_gaps)
    _, base, eng = serve(model, params, qc, seed, f"{label} non-spec",
                         {"b1", "b2"}, idle, load, hook=base_hook)
    stats = {"non-spec": eng.stats}
    index = {id(r): i for i, r in enumerate(eng.requests)}
    del eng
    for notes, gap in steps:
        gap = gap.cpu()
        for idx, req, n0 in notes:         # the step emitted token n0
            gap_at[(index[id(req)], n0)] = float(gap[idx])
    streams, parted = {"non-spec": base}, []
    for name, spec, launched, drafter in specs:
        tap = VerifyTap(model)
        rounds = []

        def check_round(notes, name=name):
            ids = tap.verify_ids
            for idx, req, n0 in notes:
                got = req.out_tokens[n0:]
                want = ids[idx, :len(got)].tolist()
                check(got == want, f"{label} {name}: a round emitted {got}, "
                      f"its verify rows' argmax is {want}")
            rounds.append(len(notes))

        def hook(eng, drafter=drafter):
            eng.model = tap
            if drafter is not None:
                eng.drafter = drafter
                drafter.bind(eng)
            tap_steps(eng, "_spec_decode_step", check_round)
        _, toks, eng = serve(model, params, qc, seed, f"{label} {name}",
                             launched, idle, load, spec=spec, hook=hook)
        check(eng.spec_rounds == len(rounds) and eng.spec_rounds > 0,
              f"{label} {name}: {eng.spec_rounds} rounds, {len(rounds)} "
              "checked")
        check(eng.kv.table.live_pages == 0,
              f"{label} {name}: {eng.kv.table.live_pages} pages left live")
        stats[name] = dict(eng.stats, acceptance=eng.acceptance_rate,
                           per_verify=eng.tokens_per_verify,
                           reads=eng.device_reads)
        del eng
        streams[name] = toks
        same = sum(a == b for sa, sb in zip(toks, base)
                   for a, b in zip(sa, sb))
        whole = sum(sa == sb for sa, sb in zip(toks, base))
        stats[name]["same"], stats[name]["whole"] = same, whole
        for i, (sa, sb) in enumerate(zip(toks, base)):
            j = next((j for j, (a, b) in enumerate(zip(sa, sb)) if a != b),
                     None)
            if j is not None:
                parted.append((name, i, j, gap_at.get((i, j))))
    n_tok = sum(map(len, base))
    print(f"spec [{label}]: distinct tokens in each non-spec stream "
          f"{[len(set(t)) for t in base]} (of {len(base[0])})")
    for name, st in stats.items():
        extra = "" if name == "non-spec" else (
            f", acceptance rate {st['acceptance']:.3f}, "
            f"{st['per_verify']:.2f} tokens per verify, "
            f"{st['reads']} host reads, {st['same']} of {n_tok} emitted "
            f"tokens equal the non-spec stream's ({st['whole']} of "
            f"{len(base)} requests whole)")
        print(f"spec [{label}] {name}: {st['tokens_per_s']:.1f} generated "
              f"tokens/s, decode round {st['step_ms']:.1f} ms{extra}")
    for name, i, j, gap in parted:
        print(f"spec [{label}] {name}: request {i} parts from the "
              f"non-spec stream at token {j}; non-spec top-2 logit gap "
              f"there {gap}")
    return streams, stats, parted


def free() -> None:
    """Return the freed models' memory to the card before the next."""
    gc.collect()
    torch.cuda.empty_cache()


def spec_float32(seed, layers=4):
    """Check (b): full-width qwen1.5-4b in float32 (dtype and LUTs), cut
    to ``layers`` layers: the speculative streams (ngram, and the model
    drafter over the first half of the layers) must equal the
    non-speculative stream token for token; and one verify_paged call
    must give a chain of decode_paged steps' logits (``verify_check``)."""
    cfg = qwen1p5_4b.config().replace(num_layers=layers, dtype="float32")
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    streams, _, parted = spec_runs(
        model, params, qc, seed, f"float32, {layers} layers", [
            (f"ngram k={SPEC_K}", SpecConfig(k=SPEC_K, drafter="ngram"),
             {"b1"}, None),
            (f"model k={SPEC_K} draft_layers={layers // 2}",
             SpecConfig(k=SPEC_K, draft_layers=layers // 2), {"b1", "b2"},
             None),
            (f"rejected drafter k={SPEC_K}", SpecConfig(k=SPEC_K), {"b1"},
             ShiftDrafter())],
        Load(hot=-1))
    check(not parted, f"float32 speculative streams part from the "
          f"non-speculative stream: {parted}")
    print(f"float32 ({layers} layers, full width): every speculative "
          f"stream equals the non-speculative one "
          f"({sum(map(len, streams['non-spec']))} tokens each)")
    verify_check(model, params, qc, seed, f"float32 LUTs, {layers} layers")
    del model, params
    free()


def dense_config(cfg, qc, seed, load, runs,
                 logits=("bfloat16", "float32")):
    """A full-width, full-depth config from a seed: serve ``load`` once
    per entry of ``runs`` (label -> (qc, launched, idle)); its peak device
    memory; then a logit check of each run's path in each dtype of
    ``logits``, and in float32 a verify check of each fp-pool run
    (``verify_check``); the model freed."""
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    torch.cuda.synchronize()
    pbytes = sum(nbytes(t) for t in _leaves(params))
    window = (f"window {cfg.sliding_window} on all but one layer in "
              f"{cfg.global_every}, " if cfg.sliding_window else "")
    print(f"init: full-width {cfg.name} ({cfg.num_layers} layers, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, head_dim "
          f"{cfg.head_dim}, {window}lut_infer int8 v={V} c={C}) built on "
          f"the card in {time.perf_counter() - t0:.1f} s, "
          f"{pbytes / 1e9:.2f} GB of params")
    if cfg.sliding_window:
        check(load.prompt[0] > cfg.sliding_window,
              f"{cfg.name}: prompts must run past the window")
    codebook = None
    for label, (qc_r, launched, idle) in runs.items():
        _, _, eng = serve(model, params, qc_r, seed, f"{cfg.name} {label}",
                          launched, idle, load)
        if qc_r.kv_quant == "vq":
            codebook = eng.kv_codebook
        del eng
    print(f"peak device memory, {cfg.name} (init and serving): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    models = {"bfloat16": (model, params)}
    if "float32" in logits:
        models["float32"] = (Model(cfg.replace(dtype="float32")),
                             _map_float(params, torch.float32))
    for label, (qc_r, _, _) in runs.items():
        cb = codebook if qc_r.kv_quant == "vq" else None
        for dt in logits:
            logit_check(*models[dt], qc_r, seed, f"{cfg.name} {label}", cb,
                        load)
        if "float32" in logits and cb is None:
            verify_check(*models["float32"], qc_r, seed,
                         f"{cfg.name} {label}", load)
    del model, params, codebook, models
    free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 versions
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas [{name}]:", line.strip())

    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    t_kernels = time.perf_counter()
    try:
        b1, b3, b4 = {}, {}, {}
        for m in QWEN_MS:
            for k, n, _ in PROJ_SHAPES:
                b1[(m, k, n)] = b1_case(gen, m, k, n, flush)
                b3[(m, k, n)], b4[(m, k, n)] = b34_case(gen, m, k, n, flush)
        nc_sweep(gen, flush)
        rng = np.random.default_rng(args.seed)
        main_pos = sorted(rng.integers(32, MAX_SEQ, SLOTS).tolist())
        full_pos = [MAX_SEQ - 1] * SLOTS
        main_name = "main path B=8 KVH=20 G=1 D=128 NP=32"
        b2 = b2_case(gen, main_name, SLOTS, 20, 20, 128, MAX_SEQ // PAGE,
                     main_pos, 0, [0] * SLOTS, flush, True)
        b2_full = b2_case(gen, "all 8 slots at 511 tokens", SLOTS, 20, 20,
                          128, MAX_SEQ // PAGE, full_pos, 0, [0] * SLOTS,
                          flush, True)
        b2_one = b2_case(gen, "one slot at 4096 tokens", 1, 20, 20, 128,
                         4096 // PAGE, [4095], 0, [0], flush, True)
        b2_checks = [
            b2_case(gen, "G=4 window=100 kv_start>0, pos=-1 lanes", 4, 16,
                    4, 128, 16, [200, -1, 77, 255], 100, [5, 0, 3, 17],
                    flush, False),
            b2_case(gen, "page 64, window=150 kv_start>0, pos=-1 lanes", 4,
                    20, 20, 128, 8, [511, -1, 64, 300], 150, [0, 0, 9, 40],
                    flush, False, ps=64)]
        b5 = b5_case(gen, main_name + " nc=32 c=16", SLOTS, 20, 20, 128,
                     MAX_SEQ // PAGE, main_pos, 0, [0] * SLOTS, flush, True)
        b5_full = b5_case(gen, "all 8 slots at 511 tokens", SLOTS, 20, 20,
                          128, MAX_SEQ // PAGE, full_pos, 0, [0] * SLOTS,
                          flush, True)
        b5_one = b5_case(gen, "one slot at 4096 tokens", 1, 20, 20, 128,
                         4096 // PAGE, [4095], 0, [0], flush, True)
        b5_checks = [
            b5_case(gen, "G=4 window=100 kv_start>0, pos=-1 lanes", 4, 16,
                    4, 128, 16, [200, -1, 77, 255], 100, [5, 0, 3, 17],
                    flush, False),
            b5_case(gen, "exact cover c=128 (64 KB a table)", 4, 8,
                    2, 128, 8, [100, -1, 37, 128], 0, [0, 0, 4, 0], flush,
                    False, exact_c=128),
            b5_case(gen, "exact cover c=256 (128 KB a table)", 4, 8, 2, 128,
                    8, [100, 64, -1, 128], 30, [0, 2, 0, 0], flush, False,
                    exact_c=256),
            b5_case(gen, "page 64, window=150 kv_start>0, pos=-1 lanes", 4,
                    20, 20, 128, 8, [511, -1, 64, 300], 150, [0, 0, 9, 40],
                    flush, False, ps=64)]
        dense = {"b1": {}, "b3": {}, "b4": {}}
        for shapes, ms in DENSE_PATHS.values():
            for k, n, _ in shapes:
                for m in ms:
                    if (m, k, n) in dense["b1"]:
                        continue
                    dense["b1"][(m, k, n)] = b1_case(gen, m, k, n, flush)
                    dense["b3"][(m, k, n)], dense["b4"][(m, k, n)] = (
                        b34_case(gen, m, k, n, flush))
        # each dense config's decode attention as its serve run calls it
        # (gemma3: a local layer, window 1024, contexts past it)
        g_pos = sorted(rng.integers(*GEMMA_LOAD.check, SLOTS).tolist())
        g27_pos = sorted(rng.integers(*GEMMA27_LOAD.check,
                                      GEMMA27_LOAD.slots).tolist())
        g_np = GEMMA_LOAD.max_seq // PAGE
        b2_checks += [
            b2_case(gen, "yi-9b decode B=8 KVH=4 G=8 D=128 NP=32", SLOTS,
                    32, 4, 128, MAX_SEQ // PAGE, main_pos, 0, [0] * SLOTS,
                    flush, False),
            b2_case(gen, "gemma3-4b decode B=8 KVH=4 G=2 D=256 NP=128 "
                    "window=1024", SLOTS, 8, 4, 256, g_np, g_pos, 1024,
                    [0] * SLOTS, flush, False),
            b2_case(gen, "gemma3-27b decode B=4 KVH=16 G=2 D=128 NP=128 "
                    "window=1024", GEMMA27_LOAD.slots, 32, 16, 128, g_np,
                    g27_pos, 1024, [0] * GEMMA27_LOAD.slots, flush, False)]
        b5_checks.append(
            b5_case(gen, "gemma3-4b decode B=8 KVH=4 G=2 D=256 NP=128 "
                    "window=1024 nc=64 c=16", SLOTS, 8, 4, 256, g_np, g_pos,
                    1024, [0] * SLOTS, flush, False))
        # one slot at 4096 tokens (16 splits, one cluster of 16 blocks a
        # kv head) at yi-9b's G=8 D=128 and gemma3-4b's G=2 D=256
        wide = [
            b2_case(gen, "one slot at 4096 tokens, yi-9b G=8 D=128 (32 "
                    "heads / 4 kv)", 1, 32, 4, 128, 4096 // PAGE, [4095], 0,
                    [0], flush, True),
            b2_case(gen, "one slot at 4096 tokens, gemma3-4b G=2 D=256 (8 "
                    "heads / 4 kv)", 1, 8, 4, 256, 4096 // PAGE, [4095], 0,
                    [0], flush, True),
            b5_case(gen, "one slot at 4096 tokens, yi-9b G=8 D=128 nc=32 "
                    "c=16", 1, 32, 4, 128, 4096 // PAGE, [4095], 0, [0],
                    flush, True),
            b5_case(gen, "one slot at 4096 tokens, gemma3-4b G=2 D=256 "
                    "nc=64 c=16", 1, 8, 4, 256, 4096 // PAGE, [4095], 0,
                    [0], flush, True)]
        b2_checks += wide[:2]
        b5_checks += wide[2:]
        for m in QWEN_MS:
            for k, n, _ in PROJ_SHAPES:
                fl = float_lut_case(gen, m, k, n, flush)
                print(f"float LUTs M={m} K={k} N={n}: two launches on one "
                      "input bitwise equal; B1 us float32 / bfloat16 / int8 "
                      f"{fl['float32']['b1_ms'] * 1e3:.1f} / "
                      f"{fl['bfloat16']['b1_ms'] * 1e3:.1f} / "
                      f"{b1[(m, k, n)]['ms'] * 1e3:.1f}, B4 us "
                      f"{fl['float32']['b4_ms'] * 1e3:.1f} / "
                      f"{fl['bfloat16']['b4_ms'] * 1e3:.1f} / "
                      f"{b4[(m, k, n)]['ms'] * 1e3:.1f}; B4(B3(x)) == B1(x) "
                      "bitwise (clusters B1, B4): float32 "
                      f"{fl['float32']['two_pass_bitwise']} "
                      f"{fl['float32']['clusters']}, bfloat16 "
                      f"{fl['bfloat16']['two_pass_bitwise']} "
                      f"{fl['bfloat16']['clusters']}")
    finally:
        clocks.terminate()
        out = clocks.communicate()[0]
    del flush
    print(f"phase [kernels]: {time.perf_counter() - t_kernels:.1f} s")
    samples = [[float(f) for f in line.split(",")]
               for line in out.splitlines() if line.count(",") == 1]
    if samples:
        sm = sorted(x[0] for x in samples)
        print(f"kernel phase: SM clock min/median/max {sm[0]:.0f}/"
              f"{sm[len(sm) // 2]:.0f}/{sm[-1]:.0f} MHz, power max "
              f"{max(x[1] for x in samples):.0f} W ({len(samples)} samples)")

    cfg = qwen1p5_4b.config()
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="int8")
    t_qwen = time.perf_counter()
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(
        args.seed), qc)
    torch.cuda.synchronize()
    pbytes = sum(nbytes(t) for t in _leaves(params))
    print(f"init: full-width {cfg.name} ({cfg.num_layers} layers, lut_infer "
          f"int8 v={V} c={C}) built on the card in "
          f"{time.perf_counter() - t0:.1f} s, {pbytes / 1e9:.2f} GB of params")

    def per_step(res):
        return cfg.num_layers * sum(res[(8, k, n)]["ms"] * cnt
                                    for k, n, cnt in PROJ_SHAPES)
    for name, res in (("B1", b1), ("B3", b3), ("B4", b4)):
        for m in QWEN_MS:
            lay = {key: sum(res[(m, k, n)][key] * cnt
                            for k, n, cnt in PROJ_SHAPES)
                   for key in ("ms", "warm_ms", "bound_ms")}
            print(f"{name} int8 per layer (7 projections) at M={m}: "
                  f"{lay['ms'] * 1e3:.1f} us flushed, "
                  f"{lay['warm_ms'] * 1e3:.1f} us warm in a graph, bound "
                  f"{lay['bound_ms'] * 1e3:.2f} us; host us a call "
                  + ", ".join(f"{res[(m, k, n)]['host']:.1f}"
                              for k, n, _ in PROJ_SHAPES))
    for arch, (shapes, ms) in DENSE_PATHS.items():
        for name in ("b1", "b3", "b4"):
            res = dense[name]
            print(f"{name.upper()} int8 per {arch} layer (7 projections): "
                  + "; ".join(
                      f"M={m} {1e3 * sum(res[(m, k, n)]['ms'] * c for k, n, c in shapes):.1f} us flushed, bound "  # noqa: E501
                      f"{1e3 * sum(res[(m, k, n)]['bound_ms'] * c for k, n, c in shapes):.2f} us"  # noqa: E501
                      for m in ms))
    print(f"kernel device time per decode step (from the kernel phase): "
          f"fused B1 {per_step(b1):.2f} ms, two-pass B3 {per_step(b3):.2f} + "
          f"B4 {per_step(b4):.2f} ms; attention, one flash_decode_paged call"
          f" (one kernel) a layer: fp pool {cfg.num_layers * b2['ms']:.2f} "
          f"ms flushed ({cfg.num_layers * b2['warm_ms']:.2f} warm), codes "
          f"{cfg.num_layers * b5['ms']:.2f} ms "
          f"({cfg.num_layers * b5['warm_ms']:.2f} warm)")
    torch.cuda.reset_peak_memory_stats()
    runs = {
        "fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"}),
        "two-pass": (qc.replace(fuse=False), {"b3", "b4", "b2"},
                     {"b1", "b5"}),
        "vq-kv": (qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
                  {"b1", "b5"}, {"b2", "b3", "b4"}),
    }
    counts, tokens, codebook, bpt = {}, {}, None, {}
    for label, (qc_r, launched, idle) in runs.items():
        counts[label], tokens[label], eng = serve(
            model, params, qc_r, args.seed, label, launched, idle)
        bpt[label] = eng.kv.bytes_per_token
        if qc_r.kv_quant == "vq":
            codebook = eng.kv_codebook
        del eng
    check(tokens["two-pass"] == tokens["fused"],
          "two-pass tokens differ from the fused run's")
    want_vq = 2 * cfg.num_layers * cfg.num_kv_heads * (cfg.head_dim // KV_V)
    want_fp = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    check(bpt["vq-kv"] == want_vq and bpt["fused"] == want_fp,
          f"bytes per token {bpt}, expected {want_vq} (codes) and "
          f"{want_fp} (bf16)")
    print(f"two-pass tokens identical to the fused run's (10 requests, "
          f"temperature request included); KV bytes per token: codes "
          f"{bpt['vq-kv']} vs bf16 {bpt['fused']} "
          f"({bpt['fused'] / bpt['vq-kv']:.1f}x)")
    print(f"peak device memory while serving: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    params32 = _map_float(params, torch.float32)
    model32 = Model(cfg.replace(dtype="float32"))
    for label, (qc_r, _, _) in runs.items():
        cb = codebook if qc_r.kv_quant == "vq" else None
        logit_check(model, params, qc_r, args.seed, label, cb)
        # the same step in float32 (LUTs stay int8): what is left of the
        # difference without bf16 rounding
        logit_check(model32, params32, qc_r, args.seed, label, cb)
        if cb is None:
            verify_check(model32, params32, qc_r, args.seed, label)
    del model32, params32, codebook, cb
    print(f"phase [qwen1.5-4b serve]: {time.perf_counter() - t_qwen:.1f} s")
    with phase("speculative, qwen1.5-4b int8"):
        spec_runs(
            model, params, qc, args.seed, "qwen1.5-4b int8", [
                (f"ngram k={SPEC_K}", SpecConfig(k=SPEC_K, drafter="ngram"),
                 {"b1"}, None),
                (f"model k={SPEC_K} draft_layers=10",
                 SpecConfig(k=SPEC_K, drafter="model", draft_layers=10),
                 {"b1", "b2"}, None),
                (f"rejected drafter k={SPEC_K}", SpecConfig(k=SPEC_K),
                 {"b1"}, ShiftDrafter())], Load(hot=-1))
    del model, params
    free()
    with phase("float32 LUTs, qwen1.5-4b cut to 4 layers"):
        float_lut_serve(args.seed)
        spec_float32(args.seed)
    with phase("yi-9b"):
        dense_config(
            yi_9b.config(), qc, args.seed, MAIN_LOAD,
            {"fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"})})
    with phase("gemma3-4b"):
        dense_config(
            gemma3_4b.config(), qc, args.seed, GEMMA_LOAD,
            {"fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"}),
             "vq-kv": (qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
                       {"b1", "b5"}, {"b2", "b3", "b4"})})
    with phase("gemma3-27b"):
        # bf16 logit check only: a float32 copy of 54 GB does not fit
        dense_config(
            gemma3_27b.config(), qc, args.seed, GEMMA27_LOAD,
            {"fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"})},
            logits=("bfloat16",))

    def layer_sum(res, key):
        return sum(res[(8, k, n)][key] * cnt for k, n, cnt in PROJ_SHAPES)

    def proj_row(name, res, source, replaces, launches):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["err"] for r in res.values()),
                "ms": layer_sum(res, "ms"),
                "plain_ms": layer_sum(res, "plain_ms"),
                "bound_ms": layer_sum(res, "bound_ms"),
                "bound_by": "bytes" if all(
                    res[(8, k, n)]["bound_by"] == "bytes"
                    for k, n, _ in PROJ_SHAPES) else "operations",
                "library_ms": (None if res[(8, 2560, 2560)]["library_ms"]
                               is None else layer_sum(res, "library_ms"))}

    def attn_row(name, res, errs, source, replaces, launches):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs), "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res["library_ms"]}

    def launches(key):               # the main path: qwen's three runs
        return sum(c[key] for c in counts.values())
    for r in b1.values():
        r["library_ms"] = None
    kernels = [
        proj_row("vq_amm (B1, 7 projections of one layer at decode M=8)",
                 b1, "src/repro_torch/csrc/fused_amm.cu",
                 "src/repro/kernels/fused_amm.py:87", launches("b1")),
        attn_row("flash_decode_paged_cuda (B2 fused with the split "
                 "reduction and self-term fold: one layer's whole decode "
                 "attention, 8 slots)", b2,
                 [r["err"] for r in [b2, b2_full, b2_one] + b2_checks],
                 "src/repro_torch/csrc/flash_decode.cu",
                 "src/repro/kernels/flash_decode.py:183", launches("b2")),
        proj_row("vq_assign (B3, 7 projections of one layer at decode M=8)",
                 b3, "src/repro_torch/csrc/assign.cu",
                 "src/repro/kernels/assign.py:54", launches("b3")),
        proj_row("lut_gemm (B4, 7 projections of one layer at decode M=8)",
                 b4, "src/repro_torch/csrc/lut_gemm.cu",
                 "src/repro/kernels/lut_gemm.py:61", launches("b4")),
        attn_row("flash_decode_paged_kvq_cuda (B5 fused with the split "
                 "reduction and self-term fold, one layer, 8 slots, nc=32 "
                 "c=16)", b5,
                 [r["err"] for r in [b5, b5_full, b5_one] + b5_checks],
                 "src/repro_torch/csrc/flash_decode_kvq.cu",
                 "src/repro/kernels/flash_decode.py:294", launches("b5")),
    ]
    print(f"launches by serve run: {json.dumps(PATH_LAUNCHES)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _map_float(tree, dtype):
    if isinstance(tree, dict):
        return {k: _map_float(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_float(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
