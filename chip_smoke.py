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
shapes and at deepseek-moe-16b's attention (float LUTs too), and B2 /
B5 at each config's decode attention (GQA, window) and at one slot of
4096 tokens at G=8 D=128 and G=2 D=256. A speculative phase serves
full-width qwen1.5-4b plainly, with an n-gram drafter and with a
10-layer model drafter (every emitted token must be its verify
row's argmax; in float32, cut to 4 layers, every speculative stream must
equal the plain one). Then yi-9b (fp pool), gemma3-4b (fp and VQ code
pools, prompts past its 1024-token window) and a short gemma3-27b serve
run at full width and depth, each freed before the next, each with a
logit check. In float32, one verify_paged call must give the logits of
a chain of decode_paged steps over the same tokens (qwen1.5-4b, yi-9b,
gemma3-4b, at full depth). Five serving phases run full-width qwen1.5-4b
cut to its first SERVING_LAYERS layers (its weights shared; the phases
check policy, not depth, and are host-bound, so their time is the
depth's) through the rest of the serving stack, each also in float32 cut
to 4 layers where streams must be identical: prefix (a shared system prompt,
copy-on-write forks, a resumed chunk past max_seq; cold and warm on the
fp and the code pool; one decode step over slots sharing physical pages
against the plain versions), policy (a bounded priority queue,
deadlines, the degradation ladder on a speculative engine), chaos (two
replicas on one card under the canned fault schedule), baseline (the
batch-to-completion engine beside the continuous one; B1 at its prefill
rows) and obs (timers and tracer on). Then a phase, moe, holds B1, B3 and
B4 in their grouped form (a leading expert axis, one launch for all
experts) at deepseek-moe-16b's routed and shared expert shapes and at
dbrx-132b's expert layer (and 18 of its experts, whose int8 table passes
2^31 bytes) against their plain versions, then serves full-width,
full-depth deepseek-moe-16b three times (fused fp pool, two-pass, fused
code pool: one decode step's launches by kernel, a bf16 logit check of
each against the plain versions, how many routed pairs overflow their
expert's capacity: real tokens and pad rows apart, by layer, with the
experts a call chose, its largest load and the share of its router
logits that its tokens have in common) and a float32-LUT copy cut to 4
layers twice (tokens and logits bitwise equal). A phase, ssm, holds
B1, B3 and B4 at the projection shapes mamba2-2.7b and zamba2-1.2b add
(their in_proj's dt columns, which the last column tile holds, on their
own too), serves full-width, full-depth mamba2-2.7b twice (fused,
two-pass) and zamba2-1.2b once (fused), each with one decode step's
launches and a bf16 logit check, and a float32-LUT copy of each cut in
depth twice (bitwise) and with 8 concurrent requests on 4 slots (each
stream equal to the request served alone). A last phase, train, runs
LUTBoost on full-width, full-depth qwen1.5-4b in bf16: stage 1 (k-means
of each projection's inputs in the dense forward: 280 of 280 codebooks
changed and closer to their rows), three centroid-only steps (every
other leaf bit for bit), three joint steps (every weight moved), one
block's loss and gradients in float32 on the card against the CPU, a
checkpoint of a 2-layer copy (bf16 bit for bit, and a resume against
the uninterrupted run), then int8 LUTs of the result served through the
engine with B1 and B2 (one decode step's launches, a bf16 logit check).

    python3 chip_smoke.py [--seed N]

Imports nothing of JAX and nothing of the JAX package. Exits non-zero,
without a result line, when there is no CUDA device or any check fails.
Its last line is ``{"ok": true, "device": {...}}``; the two before it
are the per-kernel JSON record (times in ms, measured in this run, with
the bound computed from this run's inputs; launches of the main path,
qwen1.5-4b's three serve runs (B1, B2: and the train phase's serve run
of the converted model), for the grouped rows the grouped
launches of deepseek-moe-16b's three, for the SSM rows the launches of
the three recurrent runs) and the card's name and power limit.
Every serve run's launches are printed before them, by run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    deepseek_moe_16b, gemma3_4b, gemma3_27b, mamba2_2p7b, qwen1p5_4b, yi_9b,
    zamba2_1p2b)
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, load_pytree, save_pytree)
from repro_torch.core.lut import (  # noqa: E402
    DENSE, QuantConfig, strip_for_inference)
from repro_torch.core.lutboost import (  # noqa: E402
    capture_activations, convert, precompute_model)
from repro_torch.core import similarity  # noqa: E402
from repro_torch.core.similarity import (  # noqa: E402
    pairwise_distance_subspaces)
from repro_torch.data import SyntheticDataset  # noqa: E402
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
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import RECURRENT, Model  # noqa: E402
from repro_torch.obs import Obs, Tracer, validate_trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchToCompletionEngine, Engine, FaultInjector, FaultSchedule,
    FinishReason, ReplicaHealth, ReplicaRouter, Request)
from repro_torch.serve.speculative import Drafter, SpecConfig  # noqa
from repro_torch.train import (  # noqa: E402
    TrainConfig, Trainer, init_opt_state, make_train_step)
from repro_torch.tree import (  # noqa: E402
    tree_flatten_with_path, tree_leaves, tree_map)

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
# the card's name and power limit (nvidia-smi), set by main(): printed
# beside every number of the serving policy phases
SMI = ""


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


# the kernels that also take a leading expert axis: their grouped launches
# are counted on their own too (``<kernel>_grouped``)
GROUPED = ("b1", "b3", "b4")


def reset_counts() -> None:
    for k, (_, _, plain) in DISPATCH.items():
        WRAPPERS[k].launches = 0
        plain.calls = 0
    for k in GROUPED:
        WRAPPERS[k].grouped = 0


def read_counts() -> dict:
    out = {k: w.launches for k, w in WRAPPERS.items()}
    out.update({k + "_grouped": WRAPPERS[k].grouped for k in GROUPED})
    out.update({k + "_plain": plain.calls
                for k, (_, _, plain) in DISPATCH.items()})
    return out


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def vq_inputs(gen, m, k, n, e=None):
    """One projection's operands at a main-path shape: x = a centroid +
    small noise (every argmin has a clear margin), an int8 LUT and its
    scale, and random unit-scale rows xr (as after RMSNorm; near-ties may
    flip between two orders of summation). With ``e``, every operand
    leads with an expert axis of e (x (e, m, nc, v), scale (e, n))."""
    dev = DEV
    nc = k // V
    lead = () if e is None else (e,)
    z = (0.02 * torch.randn(lead + (nc, C, V), generator=gen,
                            device=dev)).to(torch.bfloat16)
    pick = torch.randint(0, C, lead + (m, nc), generator=gen, device=dev)
    noise = 0.002 * torch.randn(lead + (m, nc, V), generator=gen, device=dev)
    # x[..., i, j] = z[..., j, pick[..., i, j]]
    x = z.float().unsqueeze(-4).expand(lead + (m, nc, C, V)).gather(
        -2, pick[..., None, None].expand(lead + (m, nc, 1, V))).squeeze(-2)
    x = (x + noise).to(torch.bfloat16)
    lut = torch.randint(-127, 128, lead + (nc, C, n), generator=gen,
                        device=dev, dtype=torch.int32).to(torch.int8)
    scale = 1e-3 + 1e-2 * torch.rand(lead + (n,), generator=gen, device=dev)
    xr = torch.randn(lead + (m, nc, V), generator=gen, device=dev).to(
        torch.bfloat16)
    return x, z, lut, scale, xr


def selected_lut_bytes(idx, n):
    """Bytes of the int8 LUT rows that some row of idx (M, nc) selects,
    summed over the experts of a leading expert axis (E, M, nc): what a
    gather-accumulate must read."""
    idx = idx.reshape((-1,) + tuple(idx.shape[-2:]))
    rows = torch.zeros((idx.shape[0], idx.shape[2], C), device=idx.device)
    rows.scatter_(2, idx.transpose(1, 2).long(), 1.0)
    return float(rows.sum()) * n


def case_text(m, k, n=None, e=None):
    """A kernel case's shape, with its expert count when grouped."""
    return (("" if e is None else f"E={e} ") + f"M={m} K={k}"
            + ("" if n is None else f" N={n}"))


def case_tags(label, tag="moe"):
    """A labelled case's lines open with ``{tag} [label]`` (a grouped
    case's with ``moe``, an SSM projection's with ``ssm``) and end with
    the card's name and power limit; the other 3-d cases' carry
    neither."""
    return ("", "") if label is None else (f"{tag} [{label}] ", f" [{SMI}]")


def index_probe(nc, lead):
    """A LUT (and its unit scale) whose output column j is the index
    selected in subspace j: lut[j, i, col] = i * [col == j]. B1 on it
    reads each selected index back through its own argmin and gather."""
    probe = (torch.arange(C, device=DEV)[None, :, None]
             * torch.eye(nc, device=DEV)[:, None, :]).to(torch.int8)
    return (probe.expand(lead + (nc, C, nc)).contiguous(),
            torch.ones(lead + (nc,), device=DEV))


def b1_case(gen, m, k, n, flush, e=None, label=None, tag="moe"):
    """B1 at one main-path shape (with ``e``: its grouped form, one launch
    for e experts, ``label`` naming the expert projection; lines tagged
    ``tag``). Returns a result dict."""
    nc = k // V
    lead = () if e is None else (e,)
    what = case_text(m, k, n, e)
    head, tail = case_tags(label, tag)
    x, z, lut, scale, xr = vq_inputs(gen, m, k, n, e)

    idx_plain = ref.assign_ref(x, z)
    probe, ones = index_probe(nc, lead)
    idx_kernel = torch.round(vq_amm_cuda(x, z, probe, ones)).to(torch.int32)
    check(torch.equal(idx_kernel, idx_plain),
          f"B1 {what}: kernel indices differ from the plain argmin at "
          f"{int((idx_kernel != idx_plain).sum())} of {idx_plain.numel()}")
    out_k = vq_amm_cuda(x, z, lut, scale)
    out_p = ref.vq_amm_ref(x, z, lut, scale)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    # both sides are exact int32/fp32 integer sums times the same scale
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    check(err <= tol, f"B1 {what}: max abs err {err} > {tol}")

    flips = float((torch.round(vq_amm_cuda(xr, z, probe, ones)).to(
        torch.int32) != ref.assign_ref(xr, z)).float().mean())
    off = float(((vq_amm_cuda(xr, z, lut, scale)
                  - ref.vq_amm_ref(xr, z, lut, scale)).abs() > 1e-3)
                .float().mean())
    check(flips < 1e-3, f"B1 {what}: {flips:.2%} of random-x "
          "assignments differ (a near-tie flip rate is ~1e-4)")
    del probe, ones

    ms = time_ms(lambda: vq_amm_cuda(x, z, lut, scale), 30, flush)
    warm_ms = graph_ms(lambda: vq_amm_cuda(x, z, lut, scale))
    plain_ms = time_ms(lambda: ref.vq_amm_ref(x, z, lut, scale), 5, flush)
    host = host_us(lambda: vq_amm_cuda(x, z, lut, scale))
    calls = enqueued(lambda: vq_amm_cuda(x, z, lut, scale))
    check(calls == ONE_KERNEL, f"B1 {what}: a call enqueues {calls}")
    geo = vq_amm_geometry(x, z, lut)
    # bytes this data needs: x, z, the LUT rows some row selects (of each
    # expert), scale, out
    ne = 1 if e is None else e
    lut_bytes = selected_lut_bytes(idx_plain, n)
    b = nbytes(x, z, scale) + lut_bytes + ne * m * n * 4
    o = ne * (m * nc * C * (4 * V + 2) + m * nc * n + m * n)
    bms, by = bound(b, o)
    print(f"{head}B1 vq_amm {what}: kernel {ms * 1e3:.1f} us "
          f"(warm, 30 calls in one graph: {warm_ms * 1e3:.1f} us a call), "
          f"plain {plain_ms * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by}; "
          f"{lut_bytes / 1e6:.2f} MB of LUT rows selected of "
          f"{nbytes(lut) / 1e6:.2f}), host {host:.1f} us/call, enqueues "
          f"{calls}, cluster {geo['cluster']} x {geo['tiles']} column tiles "
          f"x {geo['row_groups']} row groups ({geo['subspaces']} subspaces "
          f"and {geo['smem']} B of shared memory a block), max abs err "
          f"{err:.3g}; random x: "
          f"{flips:.2e} index flips, {off:.2%} of outputs off by >1e-3{tail}")
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


def b34_case(gen, m, k, n, flush, e=None, label=None, tag="moe"):
    """B3 then B4 (the two-pass path) at one main-path shape (with ``e``:
    their grouped forms, as in :func:`b1_case`): B3's indices equal the
    plain argmin on margin inputs and B1's own on random ones (they share
    one distance and argmin code), B4's int8 sums are exact, and
    B4(B3(x)) equals B1(x) bit for bit. Returns two result dicts."""
    dev = DEV
    nc = k // V
    lead = () if e is None else (e,)
    ne = 1 if e is None else e
    what, whatk = case_text(m, k, n, e), case_text(m, k, None, e)
    head, tail = case_tags(label, tag)
    x, z, lut, scale, xr = vq_inputs(gen, m, k, n, e)
    idx_k = vq_assign_cuda(x, z)
    idx_p = ref.assign_ref(x, z)
    check(torch.equal(idx_k, idx_p),
          f"B3 {whatk}: kernel indices differ from the plain argmin at "
          f"{int((idx_k != idx_p).sum())} of {idx_p.numel()}")
    out_k = lut_gemm_cuda(idx_k, lut, scale)
    out_p = ref.lut_gemm_onehot(idx_p, lut, scale)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    check(err <= tol, f"B4 {what}: max abs err {err} > {tol}")
    for name, xx in (("margin", x), ("random", xr)):
        two = lut_gemm_cuda(vq_assign_cuda(xx, z), lut, scale)
        check(torch.equal(two, vq_amm_cuda(xx, z, lut, scale)),
              f"B4(B3(x)) != B1(x) at {what} on {name} x")
    idx_r = vq_assign_cuda(xr, z)
    probe, ones = index_probe(nc, lead)
    b1_r = torch.round(vq_amm_cuda(xr, z, probe, ones)).to(torch.int32)
    del probe, ones
    check(torch.equal(idx_r, b1_r),
          f"B3 {whatk}: indices differ from B1's on random x")
    flips = float((idx_r != ref.assign_ref(xr, z)).float().mean())
    check(flips < 1e-3, f"B3 {whatk}: {flips:.2%} of random-x "
          "assignments differ from the plain argmin")

    # embedding_bag's table: every (expert, subspace, centroid) row
    lut_f = lut.float().reshape(-1, n)
    offs = idx_k.long() + C * torch.arange(nc, device=dev)
    if e is not None:
        offs = offs + (nc * C * torch.arange(e, device=dev))[:, None, None]
    offs = offs.reshape(-1, nc)
    lib = torch.nn.functional.embedding_bag(offs, lut_f, mode="sum")
    check(torch.allclose(lib.reshape(out_k.shape) * scale[..., None, :],
                         out_k, rtol=1e-6, atol=0.0),
          f"B4 {what}: embedding_bag yardstick disagrees")
    calls3 = enqueued(lambda: vq_assign_cuda(x, z))
    check(calls3 == ONE_KERNEL, f"B3 {whatk}: a call enqueues {calls3}")
    calls4 = enqueued(lambda: lut_gemm_cuda(idx_k, lut, scale))
    check(calls4 == ONE_KERNEL, f"B4 {what}: a call enqueues {calls4}")
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
    del lut_f, lib
    # B3 must read x and z and write the indices; B4 read the indices,
    # the LUT rows they select (of each expert) and the scale, and write
    # out
    r3["bound_ms"], r3["bound_by"] = bound(
        nbytes(x, z, idx_k), ne * m * nc * C * (4 * V + 2))
    lut_bytes = selected_lut_bytes(idx_k, n)
    r4["bound_ms"], r4["bound_by"] = bound(
        nbytes(idx_k, scale) + lut_bytes + ne * m * n * 4,
        ne * (m * nc * n + m * n))
    print(f"{head}B3 vq_assign {whatk}: kernel {r3['ms'] * 1e3:.1f} us (warm,"
          f" 30 calls in one graph: {r3['warm_ms'] * 1e3:.1f} us a call), "
          f"plain {r3['plain_ms'] * 1e3:.1f} us, bound "
          f"{r3['bound_ms'] * 1e3:.3f} us ({r3['bound_by']}), host "
          f"{r3['host']:.1f} us/call, enqueues {calls3}, "
          f"{assign_text(vq_assign_geometry(x, z))}; random x: "
          f"{flips:.2e} flips vs plain, indices equal to B1's{tail}")
    print(f"{head}B4 lut_gemm {what}: kernel {r4['ms'] * 1e3:.1f} us "
          f"(warm, 30 calls in one graph: {r4['warm_ms'] * 1e3:.1f} us a "
          f"call), plain {r4['plain_ms'] * 1e3:.1f} us, embedding_bag "
          f"(float32 copy of the int8 table, no scale) "
          f"{r4['library_ms'] * 1e3:.1f} us, bound "
          f"{r4['bound_ms'] * 1e3:.2f} us ({r4['bound_by']}), host "
          f"{r4['host']:.1f} us/call, enqueues {calls4}, "
          f"{cluster_text(lut_gemm_geometry(idx_k, lut))} (B1: "
          f"{cluster_text(vq_amm_geometry(x, z, lut))}), max abs err "
          f"{err:.3g}; B4(B3(x)) == B1(x) bitwise{tail}")
    return r3, r4


def float_lut_case(gen, m, k, n, flush, e=None):
    """B1 and B4 with float32 and bfloat16 LUTs (the int8 table times its
    scale) at one main-path shape (with ``e``: their grouped forms), on
    random unit-scale rows: two launches on one input give the same bits,
    a B1 call enqueues one kernel, the result agrees with the plain
    version, and both are timed beside the int8 kernels. B4(B3(x)) must
    equal B1(x) bit for bit where the two launches take one cluster size
    and row groups (then they sum in one order); elsewhere whether it
    does is recorded."""
    what = case_text(m, k, n, e)
    _, z, lut8, scale, xr = vq_inputs(gen, m, k, n, e)
    idx = vq_assign_cuda(xr, z)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        lut = (lut8.float() * scale[..., None, None, :]).to(dt).contiguous()
        b1 = [vq_amm_cuda(xr, z, lut) for _ in range(2)]
        b4 = [lut_gemm_cuda(idx, lut) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(b1[0], b1[1]),
              f"B1 {what} {dt}: two launches on one input differ")
        check(torch.equal(b4[0], b4[1]),
              f"B4 {what} {dt}: two launches on one input differ")
        for name, fn in (("B1", lambda: vq_amm_cuda(xr, z, lut)),
                         ("B4", lambda: lut_gemm_cuda(idx, lut))):
            calls = enqueued(fn)
            check(calls == ONE_KERNEL,
                  f"{name} {what} {dt}: a call enqueues {calls}")
        g1, g4 = vq_amm_geometry(xr, z, lut), lut_gemm_geometry(idx, lut)
        same = (g1["cluster"], g1["row_groups"]) == (g4["cluster"],
                                                     g4["row_groups"])
        bitwise = torch.equal(b1[0], b4[0])
        check(bitwise or not same,
              f"B4(B3(x)) != B1(x) at {what} {dt} though both launch "
              f"cluster {g1['cluster']}")
        want = ref.lut_gemm_onehot(idx, lut)
        for name, got in (("B1", b1[0]), ("B4", b4[0])):
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                  f"{name} {what} {dt}: disagrees with the plain sum")
        key = str(dt).split(".")[-1]
        res[key] = {
            "b1_ms": time_ms(lambda: vq_amm_cuda(xr, z, lut), 30, flush),
            "b4_ms": time_ms(lambda: lut_gemm_cuda(idx, lut), 30, flush),
            "two_pass_bitwise": bitwise, "clusters": (g1["cluster"],
                                                      g4["cluster"])}
        del lut, b1, b4, want
    return res


def float_lut_text(fl, b1_int8_ms, b4_int8_ms) -> str:
    """float_lut_case's result beside the int8 kernels' times."""
    return ("two launches on one input bitwise equal; B1 us float32 / "
            f"bfloat16 / int8 {fl['float32']['b1_ms'] * 1e3:.1f} / "
            f"{fl['bfloat16']['b1_ms'] * 1e3:.1f} / {b1_int8_ms * 1e3:.1f}, "
            f"B4 us {fl['float32']['b4_ms'] * 1e3:.1f} / "
            f"{fl['bfloat16']['b4_ms'] * 1e3:.1f} / {b4_int8_ms * 1e3:.1f}; "
            "B4(B3(x)) == B1(x) bitwise (clusters B1, B4): float32 "
            f"{fl['float32']['two_pass_bitwise']} "
            f"{fl['float32']['clusters']}, bfloat16 "
            f"{fl['bfloat16']['two_pass_bitwise']} "
            f"{fl['bfloat16']['clusters']}")


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
# (projection shapes, rows of a call) of each config's 3-d kernel
# checks: every M its serve runs give B1 (decode: the slots; prefill: the
# chunk), and yi-9b and gemma3-4b also at DENSE_MS
DENSE_PATHS = {
    "yi-9b": (YI_PROJ_SHAPES, sorted({*DENSE_MS, MAIN_LOAD.slots,
                                      MAIN_LOAD.chunk})),
    "gemma3-4b": (GEMMA_PROJ_SHAPES, sorted({*DENSE_MS, GEMMA_LOAD.slots,
                                             GEMMA_LOAD.chunk})),
    "gemma3-27b": (GEMMA27_PROJ_SHAPES, sorted({GEMMA27_LOAD.slots,
                                                GEMMA27_LOAD.chunk})),
    # deepseek-moe-16b's attention (wq wk wv wo, 3-d calls); its expert
    # projections are the moe phase's grouped cases (MOE_CASES)
    "deepseek-moe-16b": ([(2048, 2048, 4)], sorted({MAIN_LOAD.slots,
                                                    MAIN_LOAD.chunk})),
}


def load_requests(load, seed, vocab):
    """``load``'s requests, their prompts drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, vocab, int(n)).tolist(),
                    max_new_tokens=load.new,
                    temperature=0.8 if i == load.hot else 0.0)
            for i, n in enumerate(rng.integers(*load.prompt, load.n))]


def timed_steps(eng, names) -> dict:
    """Wrap each ``eng.<name>`` (a prefill chunk, a decode step) to time
    every call, the card synchronised after it; returns {name: [s, ...]}
    filled as the engine runs."""
    times = {name: [] for name in names}

    def timed(name):
        fn = getattr(eng, name)

        def wrapper(*a):
            t0 = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        return wrapper
    for name in names:
        setattr(eng, name, timed(name))
    return times


def serve(model, params, qc, seed, label, launched, idle, load=MAIN_LOAD,
          spec=None, hook=None, tag="serve"):
    """Serve ``load`` through the engine under ``qc`` (speculatively with
    ``spec``); every kernel in ``launched`` must launch, none in ``idle``,
    and no plain version may run. ``hook(eng)``, when given, may wrap the
    engine's methods before the run (after the step timers). The result
    line starts ``{tag} [{label}]``. Returns (counts, tokens, engine)."""
    vocab = model.cfg.vocab_size
    reqs = load_requests(load, seed, vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(model, params, qc, batch_size=load.slots,
                 max_seq=load.max_seq, page_size=PAGE,
                 prefill_chunk=load.chunk, seed=seed, spec_decode=spec)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    step = "_decode_step" if spec is None else "_spec_decode_step"
    times = timed_steps(eng, ("_prefill_chunk_step", step))
    if hook is not None:
        hook(eng)
    _, wall, counts = path_run(label, in_stages(eng, [reqs]), launched,
                               idle)
    for r in reqs:
        check(r.done and len(r.out_tokens) == load.new,
              f"{label}: request not served in full: {len(r.out_tokens)} "
              "tokens")
        check(all(0 <= t < vocab for t in r.out_tokens),
              f"{label}: token out of range")
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    prompt_tokens = sum(len(r.tokens) for r in reqs)
    dec, pre = times[step], times["_prefill_chunk_step"]
    fit = (f"codebook fit + pool in {setup:.2f} s, "
           if qc.kv_quant == "vq" else "")
    what = "decode steps" if spec is None else "speculative rounds"
    print(f"{tag} [{label}]: {len(reqs)} requests ({prompt_tokens} prompt "
          f"tokens, {gen_tokens} generated) in {wall:.2f} s: "
          f"{gen_tokens / wall:.1f} generated tokens/s; "
          f"{len(dec)} {what}, mean {1e3 * np.mean(dec):.1f} ms; "
          f"{len(pre)} prefill chunks of {load.chunk}, mean "
          f"{1e3 * np.mean(pre):.1f} ms; "
          f"{eng.device_reads} host reads; {fit}{pool_text(eng.kv)}; "
          f"launches {counts} [{SMI}]")
    eng.stats = {"wall": wall, "tokens_per_s": gen_tokens / wall,
                 "step_ms": 1e3 * float(np.mean(dec))}
    eng.requests = reqs
    return counts, [r.out_tokens for r in reqs], eng


def pool_text(kv) -> str:
    """A serve line's account of the engine's cache: bytes a token of a
    page pool, or the size of the slot state of a recurrent family."""
    if kv.paged:
        return (f"KV pool {kv.bytes_per_token} B per token "
                f"({kv.data['k'].dtype})")
    return (f"slot state {sum(nbytes(t) for t in _leaves(kv.data)) / 1e6:.1f}"
            f" MB for {kv.num_slots} slots (no pages)")


def prefilled_pool(model, params, qc, seed, codebook=None, load=MAIN_LOAD):
    """A paged pool with ``load.slots`` slots prefilled to random lengths
    in ``load.check``, and one decode step's inputs: (kv, table, tokens,
    positions, lengths)."""
    rng = np.random.default_rng(seed + 1)
    slots, c = load.slots, load.chunk
    npg = load.max_seq // PAGE
    kv = model.init_paged_cache(load.max_seq, PAGE, slots * npg,
                                codebook=codebook, num_slots=slots)
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
    decode_logit_check(model, params, qc, kv, table, toks, positions, label,
                       f"{load.slots} slots at lengths {lengths.tolist()}")


def decode_logit_check(model, params, qc, kv, table, toks, positions, label,
                       what, tag="logit check"):
    """One decode_paged step on ``kv`` through the kernels and through
    the plain versions; all but LOGIT_ROWS_OFF[dtype] rows must agree
    within LOGIT_ROW_REL_TOL (relative L2). The line starts ``{tag}
    [{label}]``."""
    slots = toks.shape[0]
    # a recurrent family's decode step moves its state in place: the plain
    # step starts from the state the kernel step started from
    saved = _clone(kv) if model.cfg.family in RECURRENT else None
    lg_k = model.decode_paged(params, toks, kv, table, positions, qc).float()
    if saved is not None:
        _restore(kv, saved)
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
    print(f"{tag} [{label}], {model.cfg.dtype} (one decode step, "
          f"{what}): {agreeing}/{slots} "
          f"rows agree (relative L2 <= {LOGIT_ROW_REL_TOL}); row relative "
          f"L2 {[round(r, 4) for r in rel]}, mean |diff| {mean_frac:.4f} of "
          f"std {float(lg_p.std()):.4g}, max |diff| "
          f"{float(delta.abs().max()):.4g}, argmax agrees on {agree}/{slots}"
          f" [{SMI}]")
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


def float_lut_serve(seed, layers=4, cfg=None, tag=None,
                    kernels=({"b1", "b2"}, {"b3", "b4", "b5"}), after=None):
    """A full-width config (qwen1.5-4b unless ``cfg``) with float32 LUTs,
    cut to ``layers`` layers (~0.63 GB of float32 LUT a qwen layer, ~4.5
    GB a deepseek-moe-16b one): two engine runs of the same requests must
    give the same tokens, and two decode_paged steps on one pool (a
    recurrent family: from one state) the same logits, bit for bit. The
    runs launch the kernels of ``kernels`` (launched, idle). Its lines
    start with ``tag`` when given. ``after(model, params, qc)``, when
    given, runs on the model before it is freed."""
    cfg = (cfg or qwen1p5_4b.config()).replace(num_layers=layers)
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    tokens = []
    for i in (1, 2):
        _, toks, eng = serve(model, params, qc, seed,
                             f"{cfg.name} float32 LUTs, {layers} layers, "
                             f"run {i}", *kernels, tag=tag or "serve")
        tokens.append(toks)
        del eng
    check(tokens[0] == tokens[1],
          "float32-LUT engine runs gave different tokens")
    kv, table, toks, positions, _ = prefilled_pool(model, params, qc, seed)
    saved = _clone(kv)
    lg = []
    for _ in range(2):
        _restore(kv, saved)
        lg.append(model.decode_paged(params, toks, kv, table, positions, qc))
    del saved
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg[0]).all()), "float32-LUT logits non-finite")
    check(torch.equal(lg[0], lg[1]),
          "float32-LUT decode steps gave different logits")
    print(f"{tag or 'float32 LUTs'} [{cfg.name} float32 LUTs, {layers} "
          f"layers, full width]: "
          f"two engine runs gave identical tokens (10 requests, "
          f"{sum(map(len, tokens[0]))} tokens) and two decode_paged steps "
          f"bitwise equal logits [{SMI}]")
    if after is not None:
        after(model, params, qc)
    del model, params, kv
    free()


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


# ---------------------------------------------------------------------------
# serving policy phases: prefix cache, policy and the ladder, chaos,
# the batch-to-completion baseline, observability
# ---------------------------------------------------------------------------

def path_run(label, drive, launched, idle):
    """Run ``drive()`` (one path's serving) with every kernel count set to
    0 just before and read just after. The path must launch each kernel
    of ``launched``, none of ``idle``, and no plain version; its launches
    are kept in PATH_LAUNCHES[label]. Returns (drive's result, the wall
    time in s, the counts)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    PATH_LAUNCHES[label] = {k: n for k, n in counts.items()
                            if k in WRAPPERS
                            or (k.endswith("_grouped") and n)}
    check(all(counts[k] > 0 for k in launched),
          f"{label}: the path did not launch {launched}: {counts}")
    check(all(counts[k] == 0 for k in idle),
          f"{label}: the path launched one of {idle}: {counts}")
    check(all(counts[k + "_plain"] == 0 for k in DISPATCH),
          f"{label}: the path took a plain version: {counts}")
    return out, wall, counts


def in_stages(target, stages):
    """A ``drive`` for :func:`path_run`: each list of requests submitted to
    ``target`` (an engine or a router), then run until idle. Returns the
    requests in order."""
    def drive():
        for stage in stages:
            for r in stage:
                target.submit(r)
            target.run_until_idle()
        return [r for stage in stages for r in stage]
    return drive


def f32_model(seed, layers=4):
    """Full-width qwen1.5-4b in float32 (dtype and LUTs) cut to ``layers``
    layers: where float32 streams must be identical."""
    cfg = qwen1p5_4b.config().replace(num_layers=layers, dtype="float32")
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="float32")
    model = Model(cfg)
    return model, model.init(torch.Generator(device=DEV).manual_seed(seed),
                             qc), qc


def engine_kw(**kw):
    return dict(dict(batch_size=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                     prefill_chunk=CHUNK), **kw)


def streams_agree(label, got, want, gap_at=None):
    """Print how many streams of ``got`` equal ``want`` and, where one
    parts, its token index (and the reference's top-2 logit gap there
    when ``gap_at`` has it). Returns the number of equal streams."""
    same = sum(a == b for a, b in zip(got, want))
    print(f"{label}: {same} of {len(want)} streams equal [{SMI}]")
    for i, (a, b) in enumerate(zip(got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            gap = None if gap_at is None else gap_at.get((i, j))
            print(f"{label}: request {i} parts at token {j}; top-2 logit "
                  f"gap of the reference there {gap}")
    return same


def gap_tap(eng, reqs):
    """Record, for each decode step of ``eng``, each decoding request's
    top-2 logit gap at the token the step emits, keyed (index in
    ``reqs``, token index): where a stream parts from this one."""
    tap = VerifyTap(eng.model)
    eng.model = tap
    index = {id(r): i for i, r in enumerate(reqs)}
    gap_at = {}

    def after(notes):
        if tap.gaps:
            gap = tap.gaps.pop().cpu()
            for idx, req, n0 in notes:
                gap_at[(index[id(req)], n0)] = float(gap[idx])
    tap_steps(eng, "_decode_step", after)
    return gap_at


PREFIX_SYS = 224                       # 7 prefill chunks of 32
PREFIX_SUFFIX = (16, 17, 20, 23, 27, 30, 32, 35, 39, 42, 45, 48)
PREFIX_REPEAT = (6, 11)                # suffix 32 and 48: page-aligned
PREFIX_LONG = 497                      # 31 pages + 1: resumes at 496


def prefix_stages(vocab, seed):
    """The prefix phase's traffic, as stages served one after another: one
    request of a shared 224-token system prompt + its suffix (served
    alone: it fills the index), the 11 others (distinct 16-48-token
    suffixes, 32 new tokens each), two whole-prompt repeats of
    page-aligned prompts (copy-on-write forks), then a 497-token prompt
    and its repeat (the repeat resumes prefill at 496: its chunk [496,
    528) runs past max_seq 512). Returns (stages, the cached_tokens each
    request must get, forks)."""
    rng = np.random.default_rng(seed + 10)
    system = rng.integers(0, vocab, PREFIX_SYS).tolist()
    prompts = [system + rng.integers(0, vocab, s).tolist()
               for s in PREFIX_SUFFIX]
    long = rng.integers(0, vocab, PREFIX_LONG).tolist()

    def req(p, n):
        return Request(tokens=list(p), max_new_tokens=n)
    stages = [[req(prompts[0], 32)], [req(p, 32) for p in prompts[1:]],
              [req(prompts[i], 32) for i in PREFIX_REPEAT],
              [req(long, 8)], [req(long, 8)]]
    want = ([0] + [PREFIX_SYS] * (len(prompts) - 1)
            + [len(prompts[i]) - 1 for i in PREFIX_REPEAT]
            + [0, PREFIX_LONG // PAGE * PAGE])
    return stages, want, len(PREFIX_REPEAT)


def prefix_run(model, params, qc, seed, label, warm, codebook, launched,
               idle, gaps=False):
    """Serve the prefix traffic cold or warm; returns (engine, requests,
    wall s, step times, gap_at)."""
    stages, want, forks = prefix_stages(model.cfg.vocab_size, seed)
    eng = Engine(model, params, qc, prefix_cache=warm, kv_codebook=codebook,
                 seed=seed, **engine_kw())
    times = timed_steps(eng, ("_prefill_chunk_step", "_decode_step"))
    reqs = [r for st in stages for r in st]
    gap_at = gap_tap(eng, reqs) if gaps else None
    _, wall, _ = path_run(label, in_stages(eng, stages), launched, idle)
    check(all(r.done and r.finish_reason is FinishReason.COMPLETED
              for r in reqs), f"{label}: a request did not complete")
    check(eng.kv.live_pages == 0,
          f"{label}: {eng.kv.live_pages} pages left live")
    got = [r.cached_tokens for r in reqs]
    if warm:
        check(got == want and eng.kv.cow_forks == forks,
              f"{label}: cached tokens {got} (expected {want}), "
              f"{eng.kv.cow_forks} forks (expected {forks})")
    else:
        check(not any(got) and eng.kv.cow_forks == 0,
              f"{label}: a cold engine served cached tokens {got}")
    return eng, reqs, wall, times, gap_at


def shared_pool_check(model, params, qc, seed, label, codebook):
    """One decode step of a warm pool whose slots share physical pages
    (the system prompt's): 8 requests of the prefix traffic admitted
    after the first, stepped until all 8 decode, then the step through
    the kernels against the plain versions (``decode_logit_check``)."""
    stages, _, _ = prefix_stages(model.cfg.vocab_size, seed)
    eng = Engine(model, params, qc, kv_codebook=codebook, seed=seed,
                 **engine_kw())
    stages[0][0].max_new_tokens = 1     # its prefill fills the index
    eng.run(stages[0])
    for r in stages[1][:SLOTS]:
        eng.submit(r)
    while eng.scheduler.waiting or eng.scheduler.prefill_slots():
        eng.step()
    slots = eng.scheduler.decode_slots()
    check(len(slots) == SLOTS, f"{label}: {len(slots)} slots decoding")
    rows = eng.kv.table.table
    live = rows[rows >= 0]
    shared = int((np.bincount(live) > 1).sum())
    check(shared >= PREFIX_SYS // PAGE,
          f"{label}: only {shared} physical pages are shared")
    toks = torch.tensor([[s.next_token] for s in slots], dtype=torch.int32,
                        device=DEV)
    positions = torch.tensor([s.pos for s in slots], dtype=torch.int32,
                             device=DEV)
    decode_logit_check(model, params, qc, eng.kv.data, eng.kv.table_device(),
                       toks, positions, label,
                       f"{SLOTS} slots at lengths {positions.tolist()} "
                       f"sharing {shared} physical pages")


def prefix_phase(model, params, qc, f32, seed):
    """Cold and warm on the fp pool (B1, B2) and the code pool (B1, B5) at
    full depth; the shared-page decode check on each; in float32 cut to
    4 layers, warm streams must equal cold ones."""
    pools = {"fp": (qc, {"b1", "b2"}, {"b3", "b4", "b5"}),
             "codes": (qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
                       {"b1", "b5"}, {"b2", "b3", "b4"})}
    for pool, (qc_p, launched, idle) in pools.items():
        codebook = None
        if qc_p.kv_quant == "vq":
            codebook = Engine(model, params, qc_p, **engine_kw(
                batch_size=1)).kv_codebook
        res = {}
        for warm in (False, True):
            tag = "warm" if warm else "cold"
            eng, reqs, wall, times, gap_at = prefix_run(
                model, params, qc_p, seed, f"prefix {pool} {tag}", warm,
                codebook, launched, idle, gaps=not warm)
            gen = sum(len(r.out_tokens) for r in reqs)
            dec, pre = times["_decode_step"], times["_prefill_chunk_step"]
            res[tag] = [r.out_tokens for r in reqs]
            if not warm:
                cold_gaps = gap_at
            print(f"prefix [{pool} {tag}]: {len(reqs)} requests "
                  f"({eng.prompt_tokens} prompt tokens, {eng.cached_tokens}"
                  f" served from shared pages, {eng.prefilled_tokens} "
                  f"prefilled; hit rate {eng.prefix_hit_rate:.3f}; "
                  f"{eng.kv.cow_forks} copy-on-write forks) in {wall:.2f} "
                  f"s: {gen / wall:.1f} generated tokens/s; {len(dec)} "
                  f"decode steps, mean {1e3 * np.mean(dec):.1f} ms; "
                  f"{len(pre)} prefill chunks, mean {1e3 * np.mean(pre):.1f}"
                  f" ms [{SMI}]")
            del eng
        streams_agree(f"prefix [{pool}] bf16 warm vs cold", res["warm"],
                      res["cold"], cold_gaps)
        shared_pool_check(model, params, qc_p, seed,
                          f"prefix {pool}, shared pages", codebook)
        del codebook
    fm, fp, fqc = f32
    for pool, qc_p in (("fp", fqc), ("codes", fqc.replace(
            kv_quant="vq", kv_v=KV_V, kv_c=KV_C))):
        launched = {"b1", "b5"} if pool == "codes" else {"b1", "b2"}
        codebook = (Engine(fm, fp, qc_p, **engine_kw(batch_size=1))
                    .kv_codebook if pool == "codes" else None)
        runs = [prefix_run(fm, fp, qc_p, seed, f"prefix {pool} float32 "
                           f"{tag}", tag == "warm", codebook, launched,
                           {"b3", "b4"})[1] for tag in ("cold", "warm")]
        same = streams_agree(f"prefix [{pool}] float32 (4 layers) warm vs "
                             "cold", [r.out_tokens for r in runs[1]],
                             [r.out_tokens for r in runs[0]])
        check(same == len(runs[0]), f"prefix {pool} float32: warm streams "
              "differ from cold ones")


# the policy traffic's pool: 48 pages (768 tokens) against a demand of
# ~8 x 10 pages, so decode growth fills it again and again (the ladder's
# top rung needs >= 47 live pages at a step's start)
POLICY_POOL = 48
POLICY_PROMPT = (24, 65)               # prompt tokens of the 18 requests
POLICY_NEW = 112


def policy_plan(vocab, seed):
    """The policy phase's traffic: two priority-2 requests with a
    10-step deadline (40-token prompts, 64 new tokens: they expire
    mid-decode), then 18 requests of priorities 0-2 (24-64-token
    prompts, 112 new tokens), three a step over six steps, into a queue
    bounded at 4 and a POLICY_POOL-page pool. Returns {step: requests}."""
    rng = np.random.default_rng(seed + 20)
    plan = {0: [Request(tokens=rng.integers(0, vocab, 40).tolist(),
                        max_new_tokens=64, priority=2, deadline_steps=10)
                for _ in range(2)]}
    for step in range(6):
        plan.setdefault(step, []).extend(
            Request(tokens=rng.integers(0, vocab, int(n)).tolist(),
                    max_new_tokens=POLICY_NEW, priority=int(p))
            for n, p in zip(rng.integers(*POLICY_PROMPT, 3),
                            rng.integers(0, 3, 3)))
    return plan


def policy_run(model, params, qc, seed, label, launched):
    """Serve the policy traffic on a speculative engine (ngram, k=4) with
    the default ladder. Hard checks: every shed request is the lowest
    priority, newest of the queue it overflowed, and finishes LoadShedded
    with no output; the deadline requests finish DEADLINE with partial
    output; no verify call runs in mode 1 or above. Returns (requests,
    modes by step, engine)."""
    plan = policy_plan(model.cfg.vocab_size, seed)
    eng = Engine(model, params, qc, num_pages=POLICY_POOL, max_queue=4,
                 spec_decode=SpecConfig(k=SPEC_K, drafter="ngram"),
                 seed=seed, **engine_kw())
    verify_modes, modes, shed = [], [], []
    verify = eng._verify_call

    def spy(*a):
        verify_modes.append(eng.mode)
        return verify(*a)
    eng._verify_call = spy
    reqs = [r for step in sorted(plan) for r in plan[step]]

    def drive():
        step = 0
        while step in plan or eng.scheduler.has_work:
            for r in plan.get(step, []):
                before = list(eng.scheduler.waiting)
                victim = eng.submit(r)
                if victim is not None:
                    check(victim is min(before + [r], key=lambda q: (
                        q.priority, -q._seq)), f"{label}: shed a request "
                        "that is not the lowest priority, newest of the "
                        "queue")
                    shed.append(victim)
            eng.step()
            modes.append(eng.mode)
            step += 1
        return step
    step, wall, _ = path_run(label, drive, launched, {"b3", "b4", "b5"})
    check(shed and all(r.finish_reason is FinishReason.LOAD_SHED
                       and not r.out_tokens for r in shed),
          f"{label}: {len(shed)} shed requests, not all clean LoadShedded")
    expired = [r for r in reqs if r.finish_reason is FinishReason.DEADLINE]
    check(len(expired) >= 2 and all(
        0 < len(r.out_tokens) < r.max_new_tokens for r in reqs[:2]),
        f"{label}: the deadline requests did not expire mid-decode: "
        f"{[(r.finish_reason, len(r.out_tokens)) for r in reqs[:2]]}")
    check(verify_modes and set(verify_modes) == {0},
          f"{label}: verify ran in modes {sorted(set(verify_modes))}")
    check(all(r.done for r in reqs), f"{label}: a request was lost")
    check(eng.kv.live_pages == 0, f"{label}: pages left live")
    done = sum(r.finish_reason is FinishReason.COMPLETED for r in reqs)
    print(f"policy [{label}]: {len(reqs)} requests in {wall:.2f} s, "
          f"{step} steps: {done} completed, {len(shed)} shed (lowest "
          f"priority, newest first), {len(expired)} expired with "
          f"{[len(r.out_tokens) for r in expired]} tokens; steps by mode "
          f"{eng.mode_steps}, {eng.scheduler.preemptions} preemptions, "
          f"{eng.spec_rounds} verify calls (all in mode 0), acceptance "
          f"{eng.acceptance_rate:.3f} [{SMI}]")
    return reqs, modes, eng


def policy_phase(model, params, qc, f32, seed):
    """The policy traffic at full depth (bf16): the ladder must reach
    modes 1-3 and come back to 0; then in float32 cut to 4 layers, every
    completed request's stream must equal a roomy-pool engine's (an
    expired one's partial output its prefix)."""
    _, modes, eng = policy_run(model, params, qc, seed, "policy bf16",
                               {"b1", "b2"})
    check({1, 2, 3} <= set(modes) and modes[-1] == 0,
          f"policy: the ladder went through modes {sorted(set(modes))} "
          f"and ended in {modes[-1]}")
    del eng
    fm, fp, fqc = f32
    reqs, _, _ = policy_run(fm, fp, fqc, seed, "policy float32 4 layers",
                            {"b1"})
    roomy = [Request(tokens=list(r.tokens), max_new_tokens=r.max_new_tokens)
             for r in reqs]
    Engine(fm, fp, fqc, seed=seed, **engine_kw()).run(roomy)
    for r, w in zip(reqs, roomy):
        if r.finish_reason is FinishReason.COMPLETED:
            check(r.out_tokens == w.out_tokens, "policy float32: a "
                  "completed stream differs from the roomy engine's")
        elif r.finish_reason is FinishReason.DEADLINE:
            check(r.out_tokens == w.out_tokens[:len(r.out_tokens)],
                  "policy float32: an expired request's partial output "
                  "is not the roomy engine's prefix")
    print("policy float32 (4 layers): every completed stream equals the "
          "roomy-pool engine's, every expired one is its prefix")


def chaos_run(model, params, qc, seed, label):
    """ReplicaRouter.build(replicas=2) on one card (shared params), the
    canned fault schedule attached, 12 requests; and the same requests on
    one fault-free engine. Returns (router streams, fault-free streams)."""
    load = Load(n=12, hot=-1)
    rng = np.random.default_rng(seed + 30)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*load.prompt, load.n)]
    router = ReplicaRouter.build(model, params, qc, replicas=2, seed=seed,
                                 **engine_kw())
    check(all(e.params is params for e in router.engines),
          f"{label}: the replicas do not share one params dict")
    inj = FaultInjector(FaultSchedule.canned(2)).attach(router)
    reqs, wall, _ = path_run(label, in_stages(router, [[
        Request(tokens=p, max_new_tokens=load.new) for p in prompts]]),
        {"b1", "b2"}, {"b3", "b4", "b5"})
    check(all(r.done and not r.shed and r.finish_reason is
              FinishReason.COMPLETED and len(r.out_tokens) == load.new
              for r in reqs), f"{label}: a request was lost or shed")
    check(router.status[1].health is ReplicaHealth.DEAD,
          f"{label}: replica 1 is {router.status[1].health}")
    check(router.retried_requests > 0, f"{label}: nothing was retried")
    fired = inj.report()["by_kind"]
    print(f"chaos [{label}]: {len(reqs)} requests in {wall:.2f} s over 2 "
          f"replicas, {router.step_count} router steps; faults fired "
          f"{fired}; replica health "
          f"{[st.health.value for st in router.status]}, "
          f"{router.retried_requests} requests retried, "
          f"{router.status[1].recovered_requests} recovered from the dead "
          f"replica [{SMI}]")
    free_reqs = [Request(tokens=p, max_new_tokens=load.new) for p in prompts]
    eng = Engine(model, params, qc, seed=seed, **engine_kw())
    gap_at = gap_tap(eng, free_reqs)
    eng.run(free_reqs)
    return ([r.out_tokens for r in reqs], [r.out_tokens for r in free_reqs],
            gap_at)


def chaos_phase(model, params, qc, f32, seed):
    got, want, gap_at = chaos_run(model, params, qc, seed, "chaos bf16")
    streams_agree("chaos bf16 router vs fault-free engine", got, want,
                  gap_at)
    got, want, _ = chaos_run(*f32[:2], f32[2], seed,
                             "chaos float32 4 layers")
    check(streams_agree("chaos float32 (4 layers) router vs fault-free "
                        "engine", got, want) == len(want),
          "chaos float32: the router's streams differ from a fault-free "
          "engine's")


def batch_rows(load, seed, vocab):
    """The prefill rows of the batch engine at ``load``: each batch of
    SLOTS requests (left-padded to its longest prompt) is one call of
    SLOTS x longest rows."""
    reqs = load_requests(load, seed, vocab)
    return sorted({SLOTS * max(len(r.tokens) for r in reqs[i:i + SLOTS])
                   for i in range(0, len(reqs), SLOTS)})


def baseline_run(model, params, qc, seed, label):
    """The batch engine and the continuous engine (obs off) on the main
    load (all greedy); returns both streams."""
    load = Load(hot=-1)
    vocab = model.cfg.vocab_size
    out = {}
    for name in ("batch", "continuous"):
        reqs = load_requests(load, seed, vocab)
        eng = (BatchToCompletionEngine(model, params, qc, batch_size=SLOTS,
                                       max_seq=MAX_SEQ, seed=seed)
               if name == "batch" else
               Engine(model, params, qc, seed=seed, obs=Obs.disabled(),
                      **engine_kw()))
        launched = {"b1"} if name == "batch" else {"b1", "b2"}
        idle = {"b2", "b3", "b4", "b5"} - launched
        reqs, wall, _ = path_run(f"{label} {name}", lambda: eng.run(reqs),
                                 launched, idle)
        gen = sum(len(r.out_tokens) for r in reqs)
        check(all(r.done and len(r.out_tokens) == load.new for r in reqs),
              f"{label} {name}: a request was not served in full")
        step_ms = 1e3 * wall / eng.step_count
        print(f"baseline [{label} {name}]: {len(reqs)} requests, {gen} "
              f"generated tokens in {wall:.2f} s: {gen / wall:.1f} "
              f"tokens/s, {eng.step_count} steps, {step_ms:.1f} ms a step "
              f"[{SMI}]")
        out[name] = [r.out_tokens for r in reqs]
    return out


def baseline_phase(model, params, qc, f32, seed, gen, flush):
    """B1 at the batch engine's prefill rows against its plain version
    (int8 timed and bounded; float32 LUTs checked), then both engines at
    full depth (bf16 agreement printed) and in float32 cut to 4 layers
    (greedy streams must be equal). Returns the full-depth continuous
    engine's streams (obs off: the obs phase's reference)."""
    for m in batch_rows(Load(hot=-1), seed, model.cfg.vocab_size):
        lay = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
        for k, n, cnt in PROJ_SHAPES:
            r = b1_case(gen, m, k, n, flush)
            for key in lay:
                lay[key] += r[key] * cnt
            x, z, lut8, scale, xr = vq_inputs(gen, m, k, n)
            lut = (lut8.float() * scale).contiguous()
            got, want = vq_amm_cuda(xr, z, lut), ref.vq_amm_ref(xr, z, lut)
            torch.cuda.synchronize()
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                  f"B1 float32 LUT M={m} K={k} N={n}: disagrees with the "
                  "plain version")
        print(f"B1 int8 per layer (7 projections) at the batch engine's "
              f"prefill rows M={m}: {lay['ms'] * 1e3:.1f} us flushed, bound "
              f"{lay['bound_ms'] * 1e3:.2f} us, plain "
              f"{lay['plain_ms'] * 1e3:.1f} us; float32 LUTs agree with the "
              f"plain version [{SMI}]")
    out = baseline_run(model, params, qc, seed, "baseline bf16")
    streams_agree("baseline bf16 batch vs continuous", out["batch"],
                  out["continuous"])
    f32_out = baseline_run(*f32[:2], f32[2], seed,
                           "baseline float32 4 layers")
    check(streams_agree("baseline float32 (4 layers) batch vs continuous",
                        f32_out["batch"], f32_out["continuous"])
          == len(f32_out["continuous"]),
          "baseline float32: the batch engine's streams differ from the "
          "continuous engine's")
    return out["continuous"]


# the serving phases' depth: the first 8 of qwen1.5-4b's 40 layers
SERVING_LAYERS = 8


def cut_depth(model, params, layers):
    """``model`` and ``params`` cut to their first ``layers`` layers, at
    full width: a new Model over the same weight tensors (nothing is
    copied)."""
    return (Model(model.cfg.replace(num_layers=layers)),
            {**params, "blocks": params["blocks"][:layers]})


def serving_phases(model, params, qc, seed, gen):
    """The prefix, policy, chaos, baseline and obs phases on full-width
    qwen1.5-4b (``model``, int8 LUTs) cut to SERVING_LAYERS layers, each
    with its float32 runs on one 4-layer float32 model."""
    model, params = cut_depth(model, params, SERVING_LAYERS)
    f32 = f32_model(seed)
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    with phase("prefix"):
        prefix_phase(model, params, qc, f32, seed)
    with phase("policy"):
        policy_phase(model, params, qc, f32, seed)
    with phase("chaos"):
        chaos_phase(model, params, qc, f32, seed)
    with phase("baseline"):
        off_streams = baseline_phase(model, params, qc, f32, seed, gen,
                                     flush)
    with phase("obs"):
        obs_phase(model, params, qc, seed, off_streams)
    del f32, flush
    free()


OBS_PHASES = ("admit", "prefill_chunk", "decode", "sample", "device_read")


def obs_phase(model, params, qc, seed, off_streams):
    """The main load (all greedy) with obs fully on (timers and tracer):
    tokens equal ``off_streams`` (the baseline phase's run of the same
    load with obs off), one device read a decode step (plus one a
    finished prefill), a valid exported trace; prints each phase's p50
    host time."""
    obs = Obs(tracer=Tracer(enabled=True))
    reqs = load_requests(Load(hot=-1), seed, model.cfg.vocab_size)
    eng = Engine(model, params, qc, seed=seed, obs=obs, **engine_kw())
    reqs, wall, _ = path_run("obs on", in_stages(eng, [reqs]), {"b1", "b2"},
                             {"b3", "b4", "b5"})
    check(eng.scheduler.preemptions == 0, "obs: a request was preempted")
    check([r.out_tokens for r in reqs] == off_streams,
          "obs: tokens differ with obs on")
    met = obs.metrics
    steps = met.get_histogram("engine.phase.decode_s").count
    check(eng.device_reads == steps + len(reqs),
          f"obs: {eng.device_reads} device reads for {steps} decode steps "
          f"and {len(reqs)} prefills")
    path = os.path.join(ROOT, "build", "obs_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = obs.tracer.export(path)
    problems = validate_trace(doc)
    check(problems == [], f"obs: exported trace invalid: {problems[:3]}")
    p50 = {ph: met.get_histogram(f"engine.phase.{ph}_s").percentile(0.5)
           * 1e3 for ph in OBS_PHASES}
    lat = {fam: met.get_histogram(f"req.{fam}").percentile(0.5)
           for fam in ("ttft_s", "tpot_s", "latency_s")}
    print(f"obs [on]: {len(reqs)} requests in {wall:.2f} s, tokens equal "
          f"obs off, {eng.device_reads} device reads ({steps} decode steps "
          f"+ {len(reqs)} prefills), trace of {len(doc['traceEvents'])} "
          f"events valid; phase p50 ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in p50.items())
          + "; request p50 s "
          + ", ".join(f"{k} {v:.3f}" for k, v in lat.items())
          + f" [{SMI}]")


# ---------------------------------------------------------------------------
# MoE phase: grouped B1 / B3 / B4 at the expert shapes, then full-width
# deepseek-moe-16b through the engine
# ---------------------------------------------------------------------------

# (label, experts, rows, K, N, launches per deepseek-moe-16b layer) of the
# grouped cases: the routed experts (64, capacity 8 at decode and at the
# 32-token chunk), the shared experts (2, the step's rows: 8 at decode, 32
# a chunk), one dbrx-132b expert layer (16 experts; its int8 w1 table is
# 2.11e9 bytes, just below 2^31), and 18 experts of dbrx's w1 shape, whose
# table (2.38e9 bytes) passes 2^31: the 64-bit expert offsets
MOE_CASES = [
    ("routed wg/wu", 64, 8, 2048, 1408, 2),
    ("routed wd", 64, 8, 1408, 2048, 1),
    ("shared wg/wu", 2, 8, 2048, 1408, 2), ("shared wd", 2, 8, 1408, 2048, 1),
    ("shared wg/wu chunk", 2, 32, 2048, 1408, 0),
    ("shared wd chunk", 2, 32, 1408, 2048, 0),
    ("dbrx-132b w1", 16, 8, 6144, 10752, 0),
    ("dbrx-132b w2", 16, 8, 10752, 6144, 0),
    ("dbrx-132b w1 x 18 experts, past 2^31", 18, 8, 6144, 10752, 0)]


@contextlib.contextmanager
def drop_tally(model, calls):
    """Record each MoE layer call's routing while ``model`` serves through
    prefill_paged and decode_paged: (layer, T, capacity, counts) appended
    to ``calls``, counts a device vector (real pairs dropped, pad pairs
    dropped, real pairs, pad pairs, experts some real token chose, the
    largest real load of an expert, and the share of the real tokens'
    router logits, centred over the experts, that they have in common:
    |mean_t l_t|^2 / mean_t |l_t|^2, about 1/T for independent tokens
    and 1 when all route alike). Real rows are a chunk's first
    valid_len and a decode step's live slots (position >= 0); pad rows
    come after the real ones in (token, choice) order, so they take the
    last slots and never push a real pair out. Nothing here reads the
    device."""
    orig_route = moe_mod.route
    orig_pre, orig_dec = model.prefill_paged, model.decode_paged
    pre_sig = inspect.signature(orig_pre)
    dec_sig = inspect.signature(orig_dec)
    state = {"layer": 0, "real": None}

    def prefill_paged(*a, **kw):
        arg = pre_sig.bind(*a, **kw).arguments
        width = arg["tokens"].shape[1]
        state.update(layer=0, real=torch.arange(
            width, device=arg["tokens"].device) < arg["valid_len"])
        return orig_pre(*a, **kw)

    def decode_paged(*a, **kw):
        state.update(layer=0,
                     real=dec_sig.bind(*a, **kw).arguments["positions"] >= 0)
        return orig_dec(*a, **kw)

    def route(probs, k, cap):
        out = orig_route(probs, k, cap)
        eid, keep = out[0], out[2]
        t, e = probs.shape
        real = state["real"].repeat_interleave(k)
        load = torch.zeros(e, device=probs.device).scatter_add_(
            0, eid, real.float())
        # log-softmax is the logits less a per-token constant: centred
        # over the experts, both give the same vector
        lg = torch.log(probs.clamp_min(1e-30))
        lg = lg - lg.mean(-1, keepdim=True)
        w = state["real"].float()
        n = w.sum().clamp_min(1.0)
        common = ((lg * w[:, None]).sum(0) / n).square().sum() / (
            (lg.square().sum(-1) * w).sum() / n).clamp_min(1e-30)
        calls.append((state["layer"], t, cap, torch.stack([
            (~keep & real).sum().float(), (~keep & ~real).sum().float(),
            real.sum().float(), (~real).sum().float(),
            (load > 0).sum().float(), load.max(), common])))
        state["layer"] += 1
        return out
    moe_mod.route = route
    model.prefill_paged, model.decode_paged = prefill_paged, decode_paged
    try:
        yield
    finally:
        moe_mod.route = orig_route
        del model.prefill_paged, model.decode_paged


def uniform_overflow(t, k, e, cap) -> float:
    """Pairs a call of t real tokens would drop, on average, if each token
    chose its k experts uniformly at random: E[sum_e (L_e - cap)+], L_e ~
    Binomial(t, k / e)."""
    p = k / e
    return e * sum(math.comb(t, j) * p ** j * (1 - p) ** (t - j) * (j - cap)
                   for j in range(cap + 1, t + 1))


def drop_text(calls, k, e) -> str:
    """What drop_tally recorded, by token count T of a call: real and pad
    pairs dropped, the experts chosen and the largest load of a call,
    beside uniform routing's expected drops; layer 0 on its own, and the
    real drop rate of every layer."""
    groups = {}
    for layer, t, cap, row in calls:
        groups.setdefault((t, cap), []).append((layer, row.tolist()))
    out = []
    for (t, cap), rows in sorted(groups.items()):
        def stats(sel):
            r = np.array([row for _, row in sel])
            common = r[:, 6].mean()
            r = r[:, :6].round().astype(np.int64)
            uni = sum(uniform_overflow(int(n) // k, k, e, cap)
                      for n in r[:, 2])
            real, dropped = r[:, 2].sum(), r[:, 0].sum()
            return (f"{len(r)} calls, real pairs dropped {dropped} of {real} "
                    f"({dropped / max(1, real):.2%}; uniform routing would "
                    f"drop {uni:.1f}), {int((r[:, 0] > 0).sum())} calls with "
                    f"a real drop, pad pairs dropped {r[:, 1].sum()} of "
                    f"{r[:, 3].sum()}, experts chosen a call "
                    f"{r[:, 4].mean():.1f} (min {r[:, 4].min()}), "
                    f"largest load a call mean {r[:, 5].mean():.1f} max "
                    f"{r[:, 5].max()}, common share of the router logits "
                    f"{common:.3f} (independent tokens: about "
                    f"{1 / max(1.0, r[:, 2].mean() / k):.3f})")
        layers = sorted({layer for layer, _ in rows})
        per_layer = []
        for li in layers:
            r = np.array([row for lay, row in rows if lay == li])
            per_layer.append(f"{r[:, 0].sum() / max(1, r[:, 2].sum()):.0%}"
                             f" ({r[:, 6].mean():.2f})")
        out.append(f"T={t} (capacity {cap}): all layers: "
                   f"{stats(rows)}; layer 0: "
                   f"{stats([x for x in rows if x[0] == 0])}; real drop "
                   f"rate (common share) by layer {' '.join(per_layer)}")
    return "; ".join(out)


def step_launches(model, params, qc, kv, table, toks, positions):
    """Each kernel's launches in one decode_paged step (grouped ones also
    on their own, under ``<kernel>_grouped``)."""
    reset_counts()
    model.decode_paged(params, toks, kv, table, positions, qc)
    torch.cuda.synchronize()
    return {key: n for key, n in read_counts().items()
            if n and not key.endswith("_plain")}


def moe_serve(seed):
    """Full-width, full-depth deepseek-moe-16b (int8 LUTs) through the
    engine on MAIN_LOAD: fused on an fp pool (B1 grouped, B2), two-pass
    (B3 + B4 grouped; tokens must equal the fused run's) and fused on a
    VQ code pool (B5); each run's launches in one decode step (fused: 280
    B1, 168 of them grouped, and 28 B2) and a bf16 logit check of one
    decode_paged step through the kernels against the plain versions;
    then a fourth, fused run with its routing tallied (drop_tally)."""
    cfg = deepseek_moe_16b.config()
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    torch.cuda.synchronize()
    pbytes = sum(nbytes(t) for t in _leaves(params))
    print(f"moe [init]: full-width {cfg.name} ({cfg.num_layers} layers, "
          f"{cfg.num_experts} routed experts top-{cfg.top_k} + "
          f"{cfg.num_shared_experts} shared, d_ff {cfg.d_ff}, lut_infer "
          f"int8 v={V} c={C}) built on the card in "
          f"{time.perf_counter() - t0:.1f} s, {pbytes / 1e9:.2f} GB of "
          f"params [{SMI}]")
    runs = {
        "fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"}),
        "two-pass": (qc.replace(fuse=False), {"b3", "b4", "b2"},
                     {"b1", "b5"}),
        "vq-kv": (qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
                  {"b1", "b5"}, {"b2", "b3", "b4"}),
    }
    experts = 3 + 3 * bool(cfg.num_shared_experts)   # grouped a layer
    proj, attn = cfg.num_layers * (4 + experts), cfg.num_layers
    grouped = cfg.num_layers * experts
    want_step = {"fused": {"b1": proj, "b1_grouped": grouped, "b2": attn},
                 "two-pass": {"b3": proj, "b4": proj, "b3_grouped": grouped,
                              "b4_grouped": grouped, "b2": attn},
                 "vq-kv": {"b1": proj, "b1_grouped": grouped, "b5": attn}}
    tokens, codebook, drops = {}, None, []
    for label, (qc_r, launched, idle) in runs.items():
        counts, tokens[label], eng = serve(
            model, params, qc_r, seed, f"{cfg.name} {label}", launched,
            idle, tag="moe")
        if qc_r.kv_quant == "vq":
            codebook = eng.kv_codebook
        del eng
        kv, table, toks, positions, lengths = prefilled_pool(
            model, params, qc_r, seed, codebook if qc_r.kv_quant == "vq"
            else None)
        got = step_launches(model, params, qc_r, kv, table, toks,
                            positions)
        print(f"moe [{cfg.name} {label}]: one decode step launches {got} "
              f"(expected {want_step[label]}) [{SMI}]")
        check(got == want_step[label],
              f"moe {label}: one decode step launches {got}, expected "
              f"{want_step[label]}")
        decode_logit_check(model, params, qc_r, kv, table, toks, positions,
                           f"logit check, {cfg.name} {label}",
                           f"{SLOTS} slots at lengths {lengths.tolist()}",
                           tag="moe")
        del kv
    check(tokens["two-pass"] == tokens["fused"],
          "moe: two-pass tokens differ from the fused run's")
    # the routing, tallied in a fourth fused run (so the tally's ops stay
    # out of the three runs' times): its tokens must equal the fused run's
    with drop_tally(model, drops):
        _, tallied, eng = serve(model, params, qc, seed,
                                f"{cfg.name} fused, routing tallied",
                                *runs["fused"][1:], tag="moe")
    del eng
    check(tallied == tokens["fused"],
          "moe: the tallied run's tokens differ from the fused run's")
    print(f"moe [{cfg.name} routing, a fused run]: "
          f"{drop_text(drops, cfg.top_k, cfg.num_experts)} [{SMI}]")
    print(f"moe [{cfg.name}]: two-pass tokens identical to the fused run's "
          f"(10 requests, {sum(map(len, tokens['fused']))} tokens); peak "
          f"device memory (init and serving) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{pbytes / 1e9:.2f} GB of params [{SMI}]")
    del model, params, codebook
    free()


def moe_phase(gen, seed):
    """The MoE phase: the grouped kernel cases, the deepseek-moe-16b serve
    runs, and the float32-LUT copy cut to 4 layers served twice. Returns
    the kernel cases' results by label."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    cases = {}
    for label, e, m, k, n, _ in MOE_CASES:
        r1 = b1_case(gen, m, k, n, flush, e, label)
        r3, r4 = b34_case(gen, m, k, n, flush, e, label)
        free()
        fl = float_lut_case(gen, m, k, n, flush, e)
        print(f"moe [{label}] float LUTs {case_text(m, k, n, e)}: "
              + float_lut_text(fl, r1["ms"], r4["ms"]) + f" [{SMI}]")
        cases[label] = {"b1": r1, "b3": r3, "b4": r4}
        free()
    del flush
    for key in ("b1", "b3", "b4"):
        lay = {f: sum(cases[label][key][f] * cnt
                      for label, *_, cnt in MOE_CASES)
               for f in ("ms", "warm_ms", "bound_ms")}
        print(f"moe [{key.upper()} grouped per deepseek-moe-16b layer at "
              f"decode, 3 routed + 3 shared expert projections]: "
              f"{lay['ms'] * 1e3:.1f} us flushed, {lay['warm_ms'] * 1e3:.1f}"
              f" us warm, bound {lay['bound_ms'] * 1e3:.2f} us [{SMI}]")
    moe_serve(seed)
    float_lut_serve(seed, cfg=deepseek_moe_16b.config(), tag="moe")
    return cases


# ---------------------------------------------------------------------------
# ssm phase: mamba2-2.7b (SSM) and zamba2-1.2b (hybrid)
# ---------------------------------------------------------------------------

# (label, K, N, launches in one decode step of its model, the first dt
# column of an in_proj or None) of the projections the two recurrent
# models add: each Mamba2 block's in_proj (z, xBC, dt: 2 d_inner + 2 N +
# heads columns) and out_proj, and zamba2's shared MLP (its shared
# attention, 2048 -> 2048 x 4, is deepseek-moe-16b's DENSE_PATHS shape)
SSM_CASES = [
    ("mamba2-2.7b in_proj", 2560, 10576, 64, 10496),
    ("mamba2-2.7b out_proj", 5120, 2560, 64, None),
    ("zamba2-1.2b in_proj", 2048, 8384, 38, 8320),
    ("zamba2-1.2b out_proj", 4096, 2048, 38, None),
    ("zamba2-1.2b shared wg/wu", 2048, 8192, 12, None),
    ("zamba2-1.2b shared wd", 8192, 2048, 6, None),
]
# rows of a projection call on MAIN_LOAD: a decode step, a prefill chunk
SSM_MS = (MAIN_LOAD.slots, MAIN_LOAD.chunk)
# the recurrent float32 copies: zamba2 keeps 6 layers, so that its
# shared block (after every 6th) runs once
SSM_F32_LAYERS = {"mamba2-2.7b": 4, "zamba2-1.2b": 6}


def tail_case(gen, m, k, n, lo, label):
    """The columns [lo, n) of one projection alone (an in_proj's dt
    slice, which the last column tile of B1 and B4 holds, or shares with
    B and C) through B1, B4(B3), and B1 / B4 with float32 and bfloat16
    LUTs, against the plain versions on the same margin inputs (int8:
    within 1e-5 of the largest output, float LUTs within 1e-4)."""
    x, z, lut, scale, _ = vq_inputs(gen, m, k, n)
    idx = vq_assign_cuda(x, z)
    want = ref.vq_amm_ref(x, z, lut, scale)[..., lo:]
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    errs = {}
    for name, got in (("B1 int8", vq_amm_cuda(x, z, lut, scale)),
                      ("B4(B3) int8", lut_gemm_cuda(idx, lut, scale))):
        errs[name] = float((got[..., lo:] - want).abs().max())
        check(errs[name] <= tol, f"{name} {label} M={m}: dt columns "
              f"[{lo}, {n}) max abs err {errs[name]} > {tol}")
    for dt in (torch.float32, torch.bfloat16):
        lutf = (lut.float() * scale[..., None, None, :]).to(dt).contiguous()
        wantf = ref.lut_gemm_onehot(idx, lutf)[..., lo:]
        key = str(dt).split(".")[-1]
        for name, got in ((f"B1 {key}", vq_amm_cuda(x, z, lutf)),
                          (f"B4 {key}", lut_gemm_cuda(idx, lutf))):
            errs[name] = float((got[..., lo:] - wantf).abs().max())
            check(torch.allclose(got[..., lo:], wantf, rtol=1e-4, atol=1e-4),
                  f"{name} {label} M={m}: dt columns [{lo}, {n}) disagree "
                  f"with the plain sum (max abs err {errs[name]})")
        del lutf
    torch.cuda.synchronize()
    tiles = ", ".join(f"{name} [{(n - 1) // cols * cols}, {n})"
                      for name, cols in (("int8", 256), ("bfloat16", 128),
                                         ("float32", 64)))
    print(f"ssm [{label} dt columns [{lo}, {n})] M={m} K={k} N={n}: max abs "
          f"err " + ", ".join(f"{k_} {v:.3g}" for k_, v in errs.items())
          + f" (int8 tolerance {tol:.3g}); last column tile {tiles} [{SMI}]")


def ssm_serve(cfg, runs, seed):
    """A full-width, full-depth recurrent config (int8 LUTs) through the
    engine on MAIN_LOAD, once per entry of ``runs`` (label -> (qc,
    launched, idle, one decode step's launches)): each run's one decode
    step launches, counted on a state prefilled to MAIN_LOAD.check
    lengths, and a bf16 logit check of one decode_paged step through the
    kernels against the plain versions; two-pass tokens must equal the
    fused run's."""
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed),
                        next(iter(runs.values()))[0])
    torch.cuda.synchronize()
    pbytes = sum(nbytes(t) for t in _leaves(params))
    shared = (f", one shared attention + MLP block ({cfg.num_heads} heads, "
              f"d_ff {cfg.d_ff}) after every {cfg.shared_attn_every} layers"
              if cfg.family == "hybrid" else "")
    print(f"ssm [init]: full-width {cfg.name} ({cfg.num_layers} Mamba2 "
          f"layers, d_inner {cfg.d_inner}, {cfg.ssm_nheads} heads of "
          f"{cfg.ssm_headdim}, state {cfg.ssm_state}{shared}; lut_infer "
          f"int8 v={V} c={C}) built on the card in "
          f"{time.perf_counter() - t0:.1f} s, {pbytes / 1e9:.2f} GB of "
          f"params [{SMI}]")
    tokens, stats = {}, {}
    for label, (qc_r, launched, idle, want) in runs.items():
        _, tokens[label], eng = serve(model, params, qc_r, seed,
                                      f"{cfg.name} {label}", launched, idle,
                                      tag="ssm")
        stats[label] = eng.stats
        del eng
        kv, table, toks, positions, lengths = prefilled_pool(
            model, params, qc_r, seed)
        got = step_launches(model, params, qc_r, kv, table, toks, positions)
        print(f"ssm [{cfg.name} {label}]: one decode step launches {got} "
              f"(expected {want}) [{SMI}]")
        check(got == want, f"ssm {cfg.name} {label}: one decode step "
              f"launches {got}, expected {want}")
        decode_logit_check(model, params, qc_r, kv, table, toks, positions,
                           f"logit check, {cfg.name} {label}",
                           f"{SLOTS} slots at lengths {lengths.tolist()}",
                           tag="ssm")
        del kv
    if "two-pass" in tokens:
        check(tokens["two-pass"] == tokens["fused"],
              f"ssm {cfg.name}: two-pass tokens differ from the fused run's")
    print(f"ssm [{cfg.name}]: "
          + ("two-pass tokens identical to the fused run's; "
             if "two-pass" in tokens else "")
          + f"peak device memory (init and serving) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{pbytes / 1e9:.2f} GB of params [{SMI}]")
    del model, params
    free()
    return stats


def recurrent_streams(model, params, qc, seed, label, slots=4):
    """Eight greedy requests on an engine of ``slots`` slots (so slots
    recycle): seven short prompts, and after 12 steps, while they decode,
    a 200-token prompt (7 prefill chunks). Each request's stream must
    equal the one it gets served alone on an engine of the same shape
    (the decode step computes every lane at the same shapes, so a lane's
    result does not depend on the others)."""
    rng = np.random.default_rng(seed + 3)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(20, 70, 7)]
    long_prompt = rng.integers(0, vocab, 200).tolist()
    kw = dict(batch_size=slots, max_seq=MAX_SEQ, page_size=PAGE,
              prefill_chunk=CHUNK, seed=seed)

    def make(p):
        return Request(tokens=p, max_new_tokens=24)
    eng = Engine(model, params, qc, **kw)
    reqs = [make(p) for p in prompts]
    decoding = []

    def drive():
        for r in reqs:
            eng.submit(r)
        for _ in range(12):
            eng.step()
        decoding.append(len(eng.scheduler.decode_slots()))
        reqs.append(make(long_prompt))
        eng.submit(reqs[-1])
        eng.run_until_idle()
        return reqs
    path_run(f"{label}, concurrent", drive, {"b1"}, {"b2", "b3", "b4", "b5"})
    check(decoding[0] > 0, f"{label}: no slot decodes when the long prompt "
          "is submitted")
    alone = []
    for r in reqs:
        e1 = Engine(model, params, qc, **kw)
        r1 = make(r.tokens)
        e1.submit(r1)
        e1.run_until_idle()
        alone.append(r1.out_tokens)
        del e1
    same = streams_agree(f"ssm [{label}] {len(reqs)} concurrent requests on "
                         f"{slots} slots ({decoding[0]} decoding when the "
                         f"200-token prompt arrives) vs each served alone",
                         [r.out_tokens for r in reqs], alone)
    check(same == len(reqs), f"{label}: concurrent streams differ from "
          "the streams served alone")


def ssm_phase(gen, seed):
    """The SSM phase: B1, B3 and B4 at the recurrent models' new projection
    shapes (SSM_CASES, at SSM_MS rows; the dt columns on their own), the
    full-width serve runs of mamba2-2.7b (fused, two-pass) and zamba2-1.2b
    (fused), and a float32-LUT copy of each cut in depth, served twice
    (bitwise) and concurrently against each request alone. Returns the
    kernel cases' results by (label, M) and the serve runs' stats."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    cases = {}
    for label, k, n, _, dt0 in SSM_CASES:
        for m in SSM_MS:
            r1 = b1_case(gen, m, k, n, flush, label=label, tag="ssm")
            r3, r4 = b34_case(gen, m, k, n, flush, label=label, tag="ssm")
            free()
            fl = float_lut_case(gen, m, k, n, flush)
            print(f"ssm [{label}] float LUTs {case_text(m, k, n)}: "
                  + float_lut_text(fl, r1["ms"], r4["ms"]) + f" [{SMI}]")
            if dt0 is not None:
                tail_case(gen, m, k, n, dt0, label)
            cases[(label, m)] = {"b1": r1, "b3": r3, "b4": r4}
            free()
    del flush
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        for key in ("b1", "b3", "b4"):
            lay = {f: sum(cases[(label, SLOTS)][key][f] * cnt
                          for label, _, _, cnt, _ in SSM_CASES
                          if label.startswith(arch))
                   for f in ("ms", "warm_ms", "bound_ms")}
            print(f"ssm [{key.upper()} int8, every new projection of one "
                  f"{arch} decode step at M={SLOTS}]: "
                  f"{lay['ms']:.3f} ms flushed, {lay['warm_ms']:.3f} ms "
                  f"warm, bound {lay['bound_ms']:.3f} ms [{SMI}]")
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="int8")
    m2 = mamba2_2p7b.config()
    z2 = zamba2_1p2b.config()
    m2_proj = 2 * m2.num_layers
    z2_proj = 2 * z2.num_layers + 7 * sum(
        1 for i in range(z2.num_layers)
        if i % z2.shared_attn_every == z2.shared_attn_every - 1)
    stats = {}
    stats["mamba2-2.7b"] = ssm_serve(m2, {
        "fused": (qc, {"b1"}, {"b2", "b3", "b4", "b5"}, {"b1": m2_proj}),
        "two-pass": (qc.replace(fuse=False), {"b3", "b4"},
                     {"b1", "b2", "b5"}, {"b3": m2_proj, "b4": m2_proj})},
        seed)
    stats["zamba2-1.2b"] = ssm_serve(z2, {
        "fused": (qc, {"b1"}, {"b2", "b3", "b4", "b5"}, {"b1": z2_proj})},
        seed)
    for cfg in (m2, z2):
        layers = SSM_F32_LAYERS[cfg.name]
        float_lut_serve(
            seed, layers, cfg, tag="ssm",
            kernels=({"b1"}, {"b2", "b3", "b4", "b5"}),
            after=lambda model, params, qc_f, cfg=cfg, layers=layers:
            recurrent_streams(model, params, qc_f, seed,
                              f"{cfg.name} float32 LUTs, {layers} layers"))
    return cases, stats


# ---------------------------------------------------------------------------
# train phase: LUTBoost on full-width qwen1.5-4b, then served
# ---------------------------------------------------------------------------

# the calibration and training batch: 2 sequences of 256 tokens
TRAIN_BATCH, TRAIN_SEQ = 2, 256
# steps of stage 2 (centroids only) and stage 3 (joint)
TRAIN_STEPS = {2: 3, 3: 3}
TRAIN_LR = 1e-4
# the card-vs-CPU check: one block at float32 on this many tokens; every
# tensor within relative L2 BLOCK_REL_TOL on equal centroid assignments
# (a near-tie may flip an argmin between two orders of summation: then the
# card's side is run again on the CPU's assignments, see block_check)
BLOCK_TOKENS = 64
BLOCK_REL_TOL = 1e-4
# the checkpoint copy: full width, cut to this many layers
CKPT_LAYERS = 2
TRAIN_LABEL = "qwen1.5-4b converted, fused"


def _lut_layers(tree):
    """The LutLinear dict of every projection in ``tree``, in order."""
    if isinstance(tree, dict):
        if "z" in tree and "w" in tree:
            yield tree
            return
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _lut_layers(v)


def _strip(tree):
    """Every LutLinear of ``tree`` without its dense weight."""
    if isinstance(tree, dict):
        if "lut" in tree:
            return strip_for_inference(tree)
        return {k: _strip(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_strip(v) for v in tree]
    return tree


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@contextlib.contextmanager
def _ste_assignments(replay=None):
    """Record every subspace STE call in call order as (x, z, indices) on
    the CPU; with ``replay`` (such a record), each call takes the indices
    of the recorded call in the same place in place of its own argmin."""
    calls = []
    own = similarity.assign_subspaces

    def assign(x, z, metric):
        idx = (own(x, z, metric) if replay is None
               else replay[len(calls)][2].to(x.device))
        calls.append((x.detach().cpu(), z.detach().cpu(), idx.cpu()))
        return idx

    similarity.assign_subspaces = assign
    try:
        yield calls
    finally:
        similarity.assign_subspaces = own


def block_check(model, layer, qc, seed):
    """One full-width block (layer 0 of the trained params) in float32:
    its output, its loss (a fixed projection of the output plus
    recon_weight x its recon) and the gradients of the loss for every
    leaf and for the input, on the card and on the CPU (TF32 off), each
    within relative L2 BLOCK_REL_TOL. Every sub-vector's centroid is
    compared too. A flip (a near-tie decided the other way by another
    order of summation) must be a near-tie on the CPU's distances, and
    the card's side is then run again on the CPU's assignments, so that
    the forward and the backward are always held at BLOCK_REL_TOL."""
    cfg = model.cfg.replace(dtype="float32")
    gen = torch.Generator().manual_seed(seed + 7)
    x = torch.randn((1, BLOCK_TOKENS, cfg.d_model), generator=gen)
    cot = torch.randn((1, BLOCK_TOKENS, cfg.d_model), generator=gen)

    def run(dev, replay=None):
        m = Model(cfg, device=dev)
        p = tree_map(lambda t: t.to(dev, torch.float32, copy=True), layer)
        leaves = list(_leaves(p))
        for t in leaves:
            t.requires_grad_(True)
        xd = x.to(dev).requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ste_assignments(replay) as calls:
            y, r, _ = m._train_layer(p, 0, None, qc, xd)
        loss = (y * cot.to(dev)).sum() / y.numel() + qc.recon_weight * r
        grads = torch.autograd.grad(loss, [xd] + leaves)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = [y.detach().cpu(), loss.detach().cpu()] + [g.cpu()
                                                         for g in grads]
        return got, calls, secs

    def rel(got, want):
        return [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(got, want)]

    got, calls_card, t_card = run(DEV)
    want, calls_cpu, t_cpu = run("cpu")
    check(len(calls_card) == len(calls_cpu) == 7,
          f"train device check: {len(calls_card)} / {len(calls_cpu)} STE "
          "calls, want 7")
    flips, n_assign, worst_gap = 0, 0, 0.0
    for (_, _, ic), (xc, zc, iw) in zip(calls_card, calls_cpu):
        n_assign += iw.numel()
        off = ic != iw
        flips += int(off.sum())
        if off.any():
            d = pairwise_distance_subspaces(xc, zc, qc.metric)
            gap = (d.gather(-1, ic.long()[..., None])
                   - d.gather(-1, iw.long()[..., None]))[..., 0][off]
            zw = zc[torch.arange(zc.shape[0]), iw.long()]
            size = ((xc * xc).sum(-1) + (zw * zw).sum(-1))[off] + 1.0
            worst_gap = max(worst_gap, float((gap / size).max()))
    rels = rel(got, want)
    print(f"train [device check]: layer 0 of the trained model, float32, "
          f"{BLOCK_TOKENS} tokens, card vs CPU (TF32 off): output rel L2 "
          f"{rels[0]:.2e}, loss {rels[1]:.2e}, input grad {rels[2]:.2e}, "
          f"max over the {len(rels) - 3} leaf grads {max(rels[3:]):.2e}; "
          f"centroid assignments differing {flips} of {n_assign}; card "
          f"{1e3 * t_card:.1f} ms, CPU {1e3 * t_cpu:.1f} ms [{SMI}]")
    if flips:
        # a flip is a near-tie: the card's centroid is no farther on the
        # CPU's own distances than float32 rounding of |x|^2 + |z|^2 explains
        check(worst_gap <= 1e-5,
              f"train device check: a flipped assignment is {worst_gap:.2e}"
              " (relative to |x|^2 + |z|^2 + 1) farther on the CPU: not a "
              "near-tie")
        got, _, _ = run(DEV, calls_cpu)
        rels = rel(got, want)
        print(f"train [device check]: card rerun on the CPU's assignments: "
              f"output rel L2 {rels[0]:.2e}, loss {rels[1]:.2e}, input "
              f"grad {rels[2]:.2e}, max leaf grad {max(rels[3:]):.2e}")
    check(max(rels) <= BLOCK_REL_TOL,
          f"train device check: card vs CPU relative L2 {max(rels):.2e} > "
          f"{BLOCK_REL_TOL} on equal assignments")


def checkpoint_check(cfg, params, qc, seed):
    """A copy of the trained params cut to CKPT_LAYERS layers (full width):
    save_pytree / load_pytree bit for bit (every leaf bf16), then resume:
    two Trainer steps in one run against one step, a checkpoint (params
    and optimizer state) and a restart from it for the second. On the
    card the embedding's backward sums with atomics, so the two runs are
    held within a tolerance: the same step count, the params' updates
    and the moments within relative L2 1e-2 of the uninterrupted run's
    (a restart that dropped the moments or the count misses by far
    more)."""
    cut_cfg = cfg.replace(num_layers=CKPT_LAYERS)
    cut = _clone({"embed": params["embed"],
                 "final_norm": params["final_norm"],
                 "blocks": params["blocks"][:CKPT_LAYERS]})
    model = Model(cut_cfg)
    ds = SyntheticDataset(cut_cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed + 1,
                          device=DEV)
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=base)
    try:
        t0 = time.perf_counter()
        save_pytree(os.path.join(tmp, "cut"), cut)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_pytree(os.path.join(tmp, "cut"), cut)
        t_load = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
                   for a, b in zip(_leaves(cut), _leaves(back)))
        nb = sum(nbytes(t) for t in _leaves(cut))
        check(same, "train checkpoint: a restored leaf differs")
        del back
        tc = TrainConfig(total_steps=2, lr=TRAIN_LR, warmup=0,
                         checkpoint_every=100, log_every=100,
                         keep_checkpoints=1)
        quiet = dict(log_fn=lambda _: None)
        p_a, o_a, _ = Trainer(model, ds, qc, tc, **quiet).run(_clone(cut))
        free()
        ck = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        _, o_b, _ = Trainer(model, ds, qc, tc, checkpoint_dir=ck,
                            **quiet).run(_clone(cut), num_steps=1)
        t_ckpt = time.perf_counter() - t0
        del o_b
        free()
        t0 = time.perf_counter()
        (p_b, o_b), step, _ = CheckpointManager(ck).restore(
            (_clone(cut), init_opt_state(cut, tc)))
        t_restore = time.perf_counter() - t0
        p_b, o_b, _ = Trainer(model, ds, qc, tc, **quiet).run(
            p_b, o_b, start_step=step, num_steps=1)
        check(step == 1 and int(o_b["adam"]["count"]) == 2
              == int(o_a["adam"]["count"]),
              f"train checkpoint: resumed at step {step}, counts "
              f"{int(o_b['adam']['count'])} / {int(o_a['adam']['count'])}")
        bitwise = all(torch.equal(_bits(a), _bits(b)) for a, b in
                      zip(_leaves([p_a, o_a]), _leaves([p_b, o_b])))
        upd = max(float((a.float() - b.float()).norm()
                        / (a.float() - c.float()).norm().clamp_min(1e-30))
                  for a, b, c in zip(_leaves(p_a), _leaves(p_b),
                                     _leaves(cut))
                  if not torch.equal(a, c))
        mom = max(float((a - b).norm() / a.norm().clamp_min(1e-30))
                  for a, b in zip(_leaves([o_a["adam"]["m"],
                                           o_a["adam"]["v"]]),
                                  _leaves([o_b["adam"]["m"],
                                           o_b["adam"]["v"]])))
        ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ck) for f in fs)
        print(f"train [checkpoint]: {cut_cfg.name} cut to {CKPT_LAYERS} "
              f"layers, {nb / 1e9:.2f} GB of bf16 params: saved in "
              f"{t_save:.1f} s, loaded in {t_load:.1f} s, every leaf bit for "
              f"bit; resume: one step + a checkpoint of params and "
              f"optimizer state ({ck_bytes / 1e9:.2f} GB) in {t_ckpt:.1f} s,"
              f" restored in {t_restore:.1f} s, then a second step: "
              f"{'bit for bit' if bitwise else 'not bit for bit'} the "
              f"uninterrupted run (updates within relative L2 {upd:.2e}, "
              f"moments {mom:.2e}) [{SMI}]")
        check(upd <= 1e-2 and mom <= 1e-2,
              f"train checkpoint: resumed run off the uninterrupted one "
              f"(updates {upd:.2e}, moments {mom:.2e})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, cut, p_a, o_a, p_b, o_b
    free()


def train_phase(seed):
    """LUTBoost on full-width qwen1.5-4b (lut_train, v=8 c=16 l2): stage 1
    (convert: k-means of each projection's inputs captured in the dense
    forward of one calibration batch), stage 2 (centroids only), stage 3
    (joint); the
    card-vs-CPU block check; a checkpoint round trip and resume on a copy
    cut to CKPT_LAYERS layers; then int8 LUTs (precompute_model) served
    through the engine on MAIN_LOAD with B1 and B2, one decode step's
    launches and a bf16 logit check."""
    cfg = qwen1p5_4b.config()
    qc = QuantConfig(mode="lut_train", v=V, c=C, metric="l2")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"train [init]: full-width {cfg.name} ({cfg.num_layers} layers, "
          f"lut_train v={V} c={C} l2, {cfg.dtype}), {n_params / 1e9:.3f} B "
          f"params, built on the card in {time.perf_counter() - t0:.1f} s "
          f"[{SMI}]")
    ds = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                          device=DEV)

    # stage 1: the calibration activations are the dense model's, as the
    # paper's converter and the JAX package's example take them (captured
    # under the lut_train forward, each layer would see the output of
    # upstream layers quantized to their random centroids: the residual
    # stream stays at the embedding's scale, and the gradient then grows
    # exponentially with depth, NaN at 40 layers: PERF.md, section 6)
    calib = ds.batch(0)

    def dense_forward(p, b):
        return model.forward(p, b, DENSE)
    t0 = time.perf_counter()
    conv = convert(dense_forward, params, calib, qc, seed=seed)
    torch.cuda.synchronize()
    t_convert = time.perf_counter() - t0
    with torch.no_grad(), capture_activations() as cap:
        dense_forward(params, calib)
    old = list(_lut_layers(params))
    new = list(_lut_layers(conv))
    changed = sum(not torch.equal(a["z"], b["z"]) for a, b in zip(old, new))
    closer = 0
    for a, b in zip(old, new):
        rows = cap[id(a["z"])].float().reshape(-1, a["z"].shape[0], V)

        def dist(z):
            return float(pairwise_distance_subspaces(
                rows, z.float(), "l2").amin(-1).mean())
        closer += dist(b["z"]) < dist(a["z"])
    n_proj = 7 * cfg.num_layers
    print(f"train [stage 1]: convert ({TRAIN_BATCH} x {TRAIN_SEQ} "
          f"calibration tokens through the dense forward: capture + "
          f"k-means of {len(new)} "
          f"projections, 10 Lloyd iterations) in {t_convert:.2f} s; z "
          f"changed in {changed} of {n_proj} projections; mean "
          f"nearest-centroid distance over the captured rows below the "
          f"random init's in {closer} of {n_proj} [{SMI}]")
    check(len(new) == n_proj and changed == n_proj and closer == n_proj,
          f"train stage 1: {changed} / {closer} of {n_proj} projections "
          "converted / closer")
    del cap, old, new
    params = conv
    del conv
    free()

    # stages 2 and 3
    tc = TrainConfig(total_steps=sum(TRAIN_STEPS.values()), lr=TRAIN_LR,
                     warmup=0, weight_decay=0.01, grad_clip=1.0)
    opt = init_opt_state(params, tc)
    frozen = {path: t.clone() for path, t in tree_flatten_with_path(params)
              if not path.endswith("['z']")}
    z_before = {path: t.clone() for path, t in
                tree_flatten_with_path(params) if path.endswith("['z']")}
    times, step = {2: [], 3: []}, 0
    for stage, n in TRAIN_STEPS.items():
        fn = make_train_step(model, qc, tc, stage)
        for _ in range(n):
            batch = ds.batch(1 + step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = fn(params, opt, batch, step)
            torch.cuda.synchronize()
            times[stage].append(time.perf_counter() - t0)
            loss, gn = float(met["loss"]), float(met["grad_norm"])
            print(f"train [stage {stage}] step {step}: loss {loss:.4f} (ce "
                  f"{float(met['ce']):.4f}, recon {float(met['recon']):.4f})"
                  f", grad_norm {gn:.4g}, lr {met['lr']:.2e}, "
                  f"{1e3 * times[stage][-1]:.1f} ms [{SMI}]")
            check(math.isfinite(loss) and math.isfinite(gn),
                  f"train stage {stage}: non-finite loss or grad_norm")
            step += 1
        flat = dict(tree_flatten_with_path(params))
        if stage == 2:
            kept = sum(torch.equal(_bits(flat[p]), _bits(t))
                       for p, t in frozen.items())
            moved = sum(not torch.equal(flat[p], t)
                        for p, t in z_before.items())
            print(f"train [stage 2]: {kept} of {len(frozen)} non-centroid "
                  f"leaves bit for bit unchanged, {moved} of "
                  f"{len(z_before)} z moved [{SMI}]")
            check(kept == len(frozen) and moved == len(z_before),
                  f"train stage 2: {kept} of {len(frozen)} frozen leaves "
                  f"kept, {moved} of {len(z_before)} z moved")
        else:
            w_paths = [p for p in frozen if p.endswith("['w']")]
            moved = sum(not torch.equal(flat[p], frozen[p])
                        for p in w_paths)
            print(f"train [stage 3]: {moved} of {len(w_paths)} weights "
                  f"changed [{SMI}]")
            check(moved == len(w_paths),
                  f"train stage 3: {moved} of {len(w_paths)} w changed")
        del flat
    del frozen, z_before
    free()
    all_t = times[2] + times[3]
    print(f"train [steps]: stage 2 mean {1e3 * np.mean(times[2]):.1f} ms, "
          f"stage 3 mean {1e3 * np.mean(times[3]):.1f} ms a step "
          f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW with fp32 moments); "
          f"{TRAIN_BATCH * TRAIN_SEQ * len(all_t) / sum(all_t):.0f} training"
          f" tokens/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{SMI}]")
    del opt
    free()

    block_check(model, params["blocks"][0], qc, seed)
    free()
    checkpoint_check(cfg, params, qc, seed)

    # deployment: int8 LUTs, served
    qi = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = _strip(precompute_model(params, qi))
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    del params
    free()
    pbytes = sum(nbytes(t) for t in _leaves(served))
    print(f"train [precompute]: int8 LUTs of {n_proj} projections in "
          f"{t_pre:.2f} s, {pbytes / 1e9:.2f} GB of params served [{SMI}]")
    _, _, eng = serve(model, served, qi, seed, TRAIN_LABEL, {"b1", "b2"},
                      {"b3", "b4", "b5"}, tag="train")
    del eng
    kv, table, toks, positions, lengths = prefilled_pool(model, served, qi,
                                                         seed)
    want = {"b1": n_proj, "b2": cfg.num_layers}
    got = step_launches(model, served, qi, kv, table, toks, positions)
    print(f"train [{TRAIN_LABEL}]: one decode step launches {got} "
          f"(expected {want}) [{SMI}]")
    check(got == want, f"train: one decode step launches {got}, expected "
          f"{want}")
    decode_logit_check(model, served, qi, kv, table, toks, positions,
                       f"logit check, {TRAIN_LABEL}",
                       f"{SLOTS} slots at lengths {lengths.tolist()}",
                       tag="train")
    del kv, model, served
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
    global SMI
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    SMI = smi
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
        # float LUTs at qwen's shapes, and at deepseek-moe-16b's attention
        # (its float32-LUT run cut to 4 layers; its grouped expert shapes
        # are held in the moe phase)
        int8 = {**dense["b1"], **b1}, {**dense["b4"], **b4}
        moe_attn, moe_ms = DENSE_PATHS["deepseek-moe-16b"]
        for m, k, n in ([(m, k, n) for m in QWEN_MS
                         for k, n, _ in PROJ_SHAPES]
                        + [(m, k, n) for k, n, _ in moe_attn
                           for m in moe_ms]):
            fl = float_lut_case(gen, m, k, n, flush)
            print(f"float LUTs M={m} K={k} N={n}: " + float_lut_text(
                fl, int8[0][(m, k, n)]["ms"], int8[1][(m, k, n)]["ms"]))
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
            print(f"{name.upper()} int8 per {arch} layer "
                  f"({sum(c for *_, c in shapes)} projections): "
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
    serving_phases(model, params, qc, args.seed, gen)
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
    with phase("moe"):
        moe = moe_phase(gen, args.seed)
    with phase("ssm"):
        ssm, _ = ssm_phase(gen, args.seed)
    with phase("train"):
        train_phase(args.seed)

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

    def launches(key):     # the main path: qwen's three runs, and the
        # train phase's serve run of the converted model
        return (sum(c[key] for c in counts.values())
                + PATH_LAUNCHES[TRAIN_LABEL][key])

    def moe_launches(key):           # deepseek-moe-16b's three runs
        name = deepseek_moe_16b.config().name
        return sum(PATH_LAUNCHES[f"{name} {run}"].get(key + "_grouped", 0)
                   for run in ("fused", "two-pass", "vq-kv"))

    def moe_row(name, key, source, replaces):
        """A grouped kernel over one deepseek-moe-16b layer's six expert
        projections at decode (MOE_CASES' counts)."""
        def layer(f):
            return sum(moe[label][key][f] * cnt
                       for label, *_, cnt in MOE_CASES)
        lib = None if key != "b4" else layer("library_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": moe_launches(key),
                "max_abs_err": max(r[key]["err"] for r in moe.values()),
                "ms": layer("ms"), "plain_ms": layer("plain_ms"),
                "bound_ms": layer("bound_ms"),
                "bound_by": "bytes" if all(
                    moe[label][key]["bound_by"] == "bytes"
                    for label, *_, cnt in MOE_CASES if cnt)
                else "operations", "library_ms": lib}
    def ssm_launches(key):           # the three recurrent serve runs
        return sum(PATH_LAUNCHES[f"{name} {run}"][key]
                   for name, run in (("mamba2-2.7b", "fused"),
                                     ("mamba2-2.7b", "two-pass"),
                                     ("zamba2-1.2b", "fused")))

    def ssm_row(name, key, source, replaces):
        """A kernel over one mamba2-2.7b layer's in_proj + out_proj at
        decode (M=8)."""
        rows = [ssm[(label, SLOTS)][key] for label, *_ in SSM_CASES
                if label.startswith("mamba2-2.7b")]
        lib = (None if key != "b4"
               else sum(r["library_ms"] for r in rows))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": ssm_launches(key),
                "max_abs_err": max(r[key]["err"] for r in ssm.values()),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows)
                else "operations", "library_ms": lib}
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
        moe_row("vq_amm grouped (B1 with a leading expert axis, one "
                "deepseek-moe-16b layer's 3 routed (E=64) + 3 shared (E=2) "
                "expert projections at decode M=8; launches: its grouped "
                "launches in the three MoE serve runs)", "b1",
                "src/repro_torch/csrc/fused_amm.cu",
                "src/repro/kernels/fused_amm.py:87"),
        moe_row("vq_assign grouped (B3 with a leading expert axis, the same "
                "6 expert projections)", "b3",
                "src/repro_torch/csrc/assign.cu",
                "src/repro/kernels/assign.py:54"),
        moe_row("lut_gemm grouped (B4 with a leading expert axis, the same "
                "6 expert projections)", "b4",
                "src/repro_torch/csrc/lut_gemm.cu",
                "src/repro/kernels/lut_gemm.py:61"),
        ssm_row("vq_amm (B1, one mamba2-2.7b layer's in_proj 2560->10576 + "
                "out_proj 5120->2560 at decode M=8; launches: the mamba2-2.7b "
                "fused and two-pass and zamba2-1.2b fused serve runs)", "b1",
                "src/repro_torch/csrc/fused_amm.cu",
                "src/repro/kernels/fused_amm.py:87"),
        ssm_row("vq_assign (B3, the same 2 mamba2-2.7b projections)", "b3",
                "src/repro_torch/csrc/assign.cu",
                "src/repro/kernels/assign.py:54"),
        ssm_row("lut_gemm (B4, the same 2 mamba2-2.7b projections)", "b4",
                "src/repro_torch/csrc/lut_gemm.cu",
                "src/repro/kernels/lut_gemm.py:61"),
    ]
    print(f"launches by serve run: {json.dumps(PATH_LAUNCHES)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _restore(tree, saved):
    """Copy ``saved`` (a :func:`_clone` of ``tree``) back in place."""
    tree_map(lambda t, v: t.copy_(v), tree, saved)


def _map_float(tree, dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


_leaves = tree_leaves


if __name__ == "__main__":
    sys.exit(main())
