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
cut to its first SERVING_LAYERS layers (the prefix phase to
SHALLOW_LAYERS; its weights shared; the phases check policy, not depth,
and are host-bound, so their time is the depth's) through the rest of the serving stack, each also in float32 cut
to 4 layers where streams must be identical: prefix (a shared system prompt,
copy-on-write forks, a resumed chunk past max_seq; cold and warm on the
fp and the code pool; one decode step over slots sharing physical pages
against the plain versions), policy (a bounded priority queue,
deadlines, the degradation ladder on a speculative engine), chaos (two
replicas on one card under the canned fault schedule), baseline (the
batch-to-completion engine beside the continuous one; B1 at its prefill
rows) and obs (timers and tracer on). Then a phase, moe, serves
full-width deepseek-moe-16b fused (fp pool) at full depth and, cut to
SERVING_LAYERS, two-pass (tokens equal to a fused run's at that depth)
and fused on a code pool: one decode step's launches by kernel, a bf16
logit check of each against the plain versions, how many routed pairs
overflow their expert's capacity in the two-pass run: real tokens and
pad rows apart, by layer, with the experts a call chose, its largest
load and the share of its router logits that its tokens have in
common. It then holds B1, B3 and B4 in their grouped form (a leading
expert axis, one launch for all experts) at deepseek-moe-16b's routed
and shared expert shapes and at dbrx-132b's expert layer (and 18 of its
experts, whose int8 table passes 2^31 bytes) against their plain
versions on full buffers, and the routed shapes again at a decode
buffer with live-row counts (deepseek's from its two-pass run's decode
steps, dbrx's from a seeded route of 8 tokens): live rows bit for bit
the launch without counts, dead rows zero; and serves a float32-LUT
copy cut to 4 layers twice (tokens and logits bitwise equal). A phase,
ssm, holds
B1, B3 and B4 at the projection shapes mamba2-2.7b and zamba2-1.2b add
(their in_proj's dt columns, which the last column tile holds, on their
own too), serves full-width, full-depth mamba2-2.7b (fused; and cut
to SERVING_LAYERS fused and two-pass, with the same tokens) and
zamba2-1.2b (fused), each with one decode step's launches and a bf16
logit check, and a float32-LUT copy of each cut in
depth twice (bitwise) and with 8 concurrent requests on 4 slots (each
stream equal to the request served alone). A last phase, train, runs
LUTBoost on full-width, full-depth qwen1.5-4b in bf16: stage 1 (k-means
of each projection's inputs in the dense forward: 280 of 280 codebooks
changed and closer to their rows), three centroid-only steps (every
other leaf bit for bit), three joint steps (every weight moved), one
block's loss and gradients in float32 on the card against the CPU, a
checkpoint of a 2-layer copy (bf16 bit for bit), then int8 LUTs of the
result served through the engine with B1 and B2 (one decode step's
launches, a bf16 logit check). A phase, scale (after the first serve
runs), serves qwen1.5-4b tensor-parallel over a (1, 2) mesh of the card
cut to SERVING_LAYERS and, cut to SCALE_LAYERS, under the sync guard,
two-pass,
on a code pool and through a (2, 2) router, then deepseek-moe-16b EP-2
and mamba2-2.7b TP-2 cut in depth, each against its unsharded run, and
holds B1-B5 at the shard shapes. A phase, train_scale, runs the sharded
LUTBoost step on the train phase's converted params: its stage-2 and
stage-3 steps over a (1, 2) mesh of the card at full width and depth
(loss, ce, recon and grad_norm beside the unsharded run's, step ms,
collectives, peak memory; stage 2 leaves every other leaf bit for bit;
one gradient with and without remat, bit for bit, peaks beside),
a float32 copy cut to 8 layers on (1, 2) and (2, 2) on the unsharded
run's centroid assignments (every gathered gradient leaf against the
unsharded float32 step's), how far bf16 rounding moves each run from
float32 there, an elastic checkpoint (a (1, 2) state saved as global
arrays, restored unsharded and on (2, 2) bit for bit, a resumed step
against the one that never stopped), int8 LUTs of the sharded-trained
model served TP-2 (B1 and B2, the unsharded engine's tokens) and a
4-stage GPipe pipeline of full-width blocks against the sequential
loop.
A last phase, families, runs paligemma-3b (vlm: 256 image patches that
attend each other both ways before the text) and musicgen-large (audio:
frame embeddings in, 4 codebook heads out) at full width and depth:
forward, the dense-cache prefill and 8 decode steps (fused, and for
paligemma two-pass with the same greedy tokens; one decode step's
launches, every kernel call one kernel), in float32 every B1 call
(the chain's and the forward's) against its plain version on the same
operands, each step's logits against a plain twin from the same cache,
the forward's assignments against the chain's row for row, and the
chain's logits against the forward's (rows no differing assignment
reached, and every row of a forward on the chain's assignments), then
LUTBoost stage 1 and one lut_train loss_and_grads; over a (1, 2) mesh
(paligemma in the head_dim layout, musicgen's heads sharded on V) the
dense-cache prefill and 8 decode steps against the unsharded chain in
bf16 and float32 (equal in float32), and a float32 lut_train gradient
at 4 layers against the unsharded one. The kernel phase holds B1, B3 and B4 at both configs'
projection shapes at their decode and prefill rows. A phase, analysis
(after the serving phases), runs the sync guard (repro_torch.analysis:
a dispatch-level recorder of host syncs, host <-> device copies and
kernel builds, and the card's sync debug mode) over full-width qwen1.5-4b
serving: fused, two-pass, vq-kv and ngram-speculative at
SHALLOW_LAYERS; one host read a decode step and a finished prefill, at
most two a speculative round, no sync, transfer or float64 op inside a
model entry point, no kernel build in the steady state; then one call of
each paged entry point on fp and code pools (no float64, no transfer,
the pool updated in place). A phase, launch (after analysis), runs the
dry run (repro_torch.launch: one rank's program on meta tensors, costed
at H100 peaks) of three cells, counts one decode step of the full-width
qwen1.5-4b engine on the card and on meta copies of its inputs (flops,
CUDA-core ops, bytes and kernel calls must be equal) beside its measured
time and roofline-ideal time, and runs qwen1.5-4b cut to 4 layers over a
(1, 8) mesh of the card, whose 20 kv heads take the head_dim layout,
against the unsharded run. A phase, attention (after launch), runs one
full-width qwen1.5-4b attention layer over a 32768-token sequence
through the chunked online softmax (its peak beside the 85.9 GB of one
float32 score tensor), holds the chunked and block-local forms and the
chunked backward against one float32 softmax at 4096 tokens, prints a
2-layer train step's peak chunked and with one softmax, and counts a
32768-row dense-cache decode step on the card and on meta (equal). A
last phase, examples, runs the five
example twins (examples/torch_*.py) at the JAX examples' defaults.

    python3 chip_smoke.py [--seed N]

Imports nothing of JAX and nothing of the JAX package. Exits non-zero,
without a result line, when there is no CUDA device or any check fails.
Its last line is ``{"ok": true, "device": {...}}``; the two before it
are the per-kernel JSON record (times in ms, measured in this run, with
the bound computed from this run's inputs; launches of the main path,
qwen1.5-4b's three serve runs (B1, B2: and the train phase's serve run
of the converted model), for the grouped rows the grouped
launches of deepseek-moe-16b's three, for the SSM rows the launches of
the three recurrent runs, for B2s / B2a the (1, 8) fused run's) and
the card's name and power limit.
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
    dbrx_132b, deepseek_moe_16b, gemma3_4b, gemma3_27b, mamba2_2p7b, musicgen_large,
    paligemma_3b, qwen1p5_4b, yi_9b, zamba2_1p2b)
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, load_pytree, save_pytree)
from repro_torch.analysis import (  # noqa: E402
    run_invariants, run_sync_guard)
from repro_torch.core.lut import (  # noqa: E402
    DENSE, QuantConfig, strip_for_inference)
from repro_torch.core.lutboost import (  # noqa: E402
    capture_activations, convert, precompute_model)
from repro_torch.core import similarity  # noqa: E402
from repro_torch.core.similarity import (  # noqa: E402
    pairwise_distance_subspaces)
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.device import enqueued  # noqa: E402
from repro_torch.kernels import _build, ops, ref, work  # noqa: E402
from repro_torch.kernels.work import nbytes  # noqa: E402
from repro_torch.core.kv_codebook import KVCodebook, kv_encode  # noqa
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    vq_assign_cuda, vq_assign_geometry)
from repro_torch.kernels.fused_amm import (  # noqa: E402
    vq_amm_cuda, vq_amm_geometry)
from repro_torch.kernels.lut_gemm import (  # noqa: E402
    lut_gemm_cuda, lut_gemm_geometry)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.parallel import collectives as tcol  # noqa: E402
from repro_torch.parallel.pipeline import run_pipeline  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    opt_pspecs, serving_layout, shard_batch, shard_cache, shard_tree,
    unshard_tree)
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.op_cost import program_cost  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import hd_fallback  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import RECURRENT, Model  # noqa: E402
from repro_torch.obs import Obs, Tracer, validate_trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchToCompletionEngine, Engine, FaultInjector, FaultSchedule,
    FinishReason, ReplicaHealth, ReplicaRouter, Request)
from repro_torch.serve.speculative import Drafter, SpecConfig  # noqa
from repro_torch.train import (  # noqa: E402
    TrainConfig, Trainer, cosine_lr, global_norm, init_opt_state,
    make_train_step)
from repro_torch.train.trainer import (  # noqa: E402
    loss_and_grads, reduce_grads, shared_entries, sharded_loss_and_grads)
from repro_torch.tree import (  # noqa: E402
    tree_flatten_with_path, tree_leaves, tree_map)

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
# paligemma-3b (wq wo, wk wv: one kv head of 256, wg wu, wd: nc = 2048) and
# musicgen-large (wq wk wv wo, wg wu, wd)
PALIGEMMA_PROJ_SHAPES = [(2048, 2048, 2), (2048, 256, 2), (2048, 16384, 2),
                         (16384, 2048, 1)]
MUSICGEN_PROJ_SHAPES = [(2048, 2048, 4), (2048, 8192, 2), (8192, 2048, 1)]
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


def bound(work_):
    """(ms, what bounds it) of a kernel call's work (``kernels.work``:
    bytes, CUDA-core operations) at the card's published peaks
    (``launch.roofline``: HBM, FP32 CUDA cores)."""
    bytes_, ops_ = work_
    t_b, t_o = bytes_ / roofline.HBM_BW, ops_ / roofline.CORE_OPS
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
    "b2s": (fd, "flash_decode_hd_scores_cuda",
            fd.flash_decode_hd_scores_plain),
    "b2a": (fd, "flash_decode_hd_attend_cuda",
            fd.flash_decode_hd_attend_plain),
}
WRAPPERS = {"b1": vq_amm_cuda, "b3": vq_assign_cuda, "b4": lut_gemm_cuda,
            "b2": fd.flash_decode_paged_cuda,
            "b5": fd.flash_decode_paged_kvq_cuda,
            "b2s": fd.flash_decode_hd_scores_cuda,
            "b2a": fd.flash_decode_hd_attend_cuda}


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


def live_buffer(counts, m, most, *xs):
    """A decode buffer: each x of ``xs`` (E, m, ...) with its rows past
    each expert's count zeroed, as the dispatch leaves them, the counts as
    the kernels take them (``live``: keyword arguments) and the live-row
    mask (E, m). Without counts: the xs, no arguments, every row."""
    if counts is None:
        return xs, {}, None
    c = torch.tensor(counts, dtype=torch.int64, device=DEV)
    mask = torch.arange(m, device=DEV)[None] < c[:, None]
    shape = mask.shape + (1,) * (xs[0].dim() - 2)
    return ([(x * mask.reshape(shape)).contiguous() for x in xs],
            {"counts": c, "most_live": most}, mask)


def live_text(counts, most, m):
    """The decode buffer's line: live rows, experts, their bound."""
    if counts is None:
        return ""
    cap = [min(c, m) for c in counts]
    return (f", decode buffer: {sum(cap)} live rows on "
            f"{sum(c > 0 for c in cap)} experts (T x k = {most})")


def b1_case(gen, m, k, n, flush, e=None, label=None, tag="moe",
            scaled=True, counts=None, most_live=None):
    """B1 at one main-path shape (with ``e``: its grouped form, one launch
    for e experts, ``label`` naming the expert projection; lines tagged
    ``tag``). ``scaled=False``: the int8 LUT without its scale, as a
    row-parallel shard launches it (the exact integer sums, equal to the
    plain version's bit for bit). ``counts`` (E ints) and ``most_live``:
    a decode buffer (the rows past each count zero) through the live-row
    launch, whose live rows must equal the launch without counts bit for
    bit and its dead rows 0.0, timed beside that launch. Returns a result
    dict."""
    nc = k // V
    lead = () if e is None else (e,)
    what = (case_text(m, k, n, e) + ("" if scaled else ", no scale")
            + live_text(counts, most_live, m))
    head, tail = case_tags(label, tag)
    x, z, lut, scale, xr = vq_inputs(gen, m, k, n, e)
    (x, xr), kw, mask = live_buffer(counts, m, most_live, x, xr)
    if not scaled:
        scale = None

    idx_plain = ref.assign_ref(x, z, **kw)
    probe, ones = index_probe(nc, lead)
    idx_kernel = torch.round(vq_amm_cuda(x, z, probe, ones, **kw)).to(
        torch.int32)
    check(torch.equal(idx_kernel, idx_plain),
          f"B1 {what}: kernel indices differ from the plain argmin at "
          f"{int((idx_kernel != idx_plain).sum())} of {idx_plain.numel()}")
    out_k = vq_amm_cuda(x, z, lut, scale, **kw)
    out_p = ref.vq_amm_ref(x, z, lut, scale, **kw)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    # both sides are exact int32/fp32 integer sums times the same scale
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    check(err <= tol, f"B1 {what}: max abs err {err} > {tol}")
    check(scaled or torch.equal(out_k, out_p),
          f"B1 {what}: unscaled integer sums differ from the plain ones")
    if mask is not None:
        every = vq_amm_cuda(x, z, lut, scale)
        check(torch.equal(out_k[mask], every[mask]),
              f"B1 {what}: live rows differ from the launch without counts")
        check(not out_k[~mask].any(), f"B1 {what}: a dead row is not 0.0")

    flips = float((torch.round(vq_amm_cuda(xr, z, probe, ones, **kw)).to(
        torch.int32) != ref.assign_ref(xr, z, **kw)).float().mean())
    off = float(((vq_amm_cuda(xr, z, lut, scale, **kw)
                  - ref.vq_amm_ref(xr, z, lut, scale, **kw)).abs() > 1e-3)
                .float().mean())
    check(flips < 1e-3, f"B1 {what}: {flips:.2%} of random-x "
          "assignments differ (a near-tie flip rate is ~1e-4)")
    del probe, ones

    def call():
        return vq_amm_cuda(x, z, lut, scale, **kw)
    ms = time_ms(call, 30, flush)
    warm_ms = graph_ms(call)
    plain_ms = time_ms(lambda: ref.vq_amm_ref(x, z, lut, scale, **kw), 5,
                       flush)
    host = host_us(call)
    calls = enqueued(call)
    check(calls == ONE_KERNEL, f"B1 {what}: a call enqueues {calls}")
    geo = vq_amm_geometry(x, z, lut, **kw)
    # bytes this data needs: x, z, the LUT rows some (live) row selects
    # (of each expert), scale, out
    rows = work.selected_rows(idx_plain, C, counts)
    lut_bytes = rows * n * lut.element_size()
    bms, by = bound(work.vq_amm(x, z, lut, scale, rows=rows, counts=counts))
    every_ms = (None if mask is None else
                time_ms(lambda: vq_amm_cuda(x, z, lut, scale), 30, flush))
    print(f"{head}B1 vq_amm {what}: kernel {ms * 1e3:.1f} us "
          f"(warm, 30 calls in one graph: {warm_ms * 1e3:.1f} us a call)"
          + ("" if every_ms is None else
             f", without counts (every row) {every_ms * 1e3:.1f} us")
          + f", plain {plain_ms * 1e3:.1f} us, bound {bms * 1e3:.2f} us "
          f"({by}; {lut_bytes / 1e6:.2f} MB of LUT rows selected of "
          f"{nbytes(lut) / 1e6:.2f}), host {host:.1f} us/call, enqueues "
          f"{calls}, {cluster_text(geo)}, max abs err "
          f"{err:.3g}" + ("" if mask is None else
                          "; live rows bitwise the launch without counts, "
                          "dead rows 0.0")
          + f"; random x: {flips:.2e} index flips, {off:.2%} of outputs "
          f"off by >1e-3{tail}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "err": err, "warm_ms": warm_ms, "host": host,
            "every_ms": every_ms}


def cluster_text(geo):
    tiled = (f" (tile clusters of {geo['tile_cluster']} tiles)"
             if geo.get("tile_cluster") else "")
    return (f"cluster {geo['cluster']} x {geo['tiles']} column tiles x "
            f"{geo['row_groups']} row groups{tiled}, {geo['subspaces']} "
            f"subspaces and {geo['smem']} B of shared memory a block")


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


def b34_case(gen, m, k, n, flush, e=None, label=None, tag="moe",
             scaled=True, counts=None, most_live=None):
    """B3 then B4 (the two-pass path) at one main-path shape (with ``e``:
    their grouped forms, as in :func:`b1_case`): B3's indices equal the
    plain argmin on margin inputs and B1's own on random ones (they share
    one distance and argmin code), B4's int8 sums are exact, and
    B4(B3(x)) equals B1(x) bit for bit (``scaled=False``: without the
    scale, as a row-parallel shard). ``counts`` and ``most_live``: a
    decode buffer, as in :func:`b1_case` (B3's live rows equal the launch
    without counts, dead rows index 0; B4's dead rows 0.0; the yardstick
    sums the live rows' bags). Returns two result dicts."""
    dev = DEV
    nc = k // V
    lead = () if e is None else (e,)
    tail_text = live_text(counts, most_live, m)
    what = case_text(m, k, n, e) + ("" if scaled else ", no scale") \
        + tail_text
    whatk = case_text(m, k, None, e) + tail_text
    head, tail = case_tags(label, tag)
    x, z, lut, scale, xr = vq_inputs(gen, m, k, n, e)
    (x, xr), kw, mask = live_buffer(counts, m, most_live, x, xr)
    if not scaled:
        scale = None
    idx_k = vq_assign_cuda(x, z, **kw)
    idx_p = ref.assign_ref(x, z, **kw)
    check(torch.equal(idx_k, idx_p),
          f"B3 {whatk}: kernel indices differ from the plain argmin at "
          f"{int((idx_k != idx_p).sum())} of {idx_p.numel()}")
    out_k = lut_gemm_cuda(idx_k, lut, scale, **kw)
    out_p = ref.lut_gemm_onehot(idx_p, lut, scale, **kw)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    check(err <= tol, f"B4 {what}: max abs err {err} > {tol}")
    if mask is not None:
        check(torch.equal(idx_k[mask], vq_assign_cuda(x, z)[mask])
              and not idx_k[~mask].any(),
              f"B3 {whatk}: live rows differ from the launch without "
              "counts, or a dead row's index is not 0")
        check(not out_k[~mask].any(), f"B4 {what}: a dead row is not 0.0")
    for name, xx in (("margin", x), ("random", xr)):
        two = lut_gemm_cuda(vq_assign_cuda(xx, z, **kw), lut, scale, **kw)
        check(torch.equal(two, vq_amm_cuda(xx, z, lut, scale, **kw)),
              f"B4(B3(x)) != B1(x) at {what} on {name} x")
    idx_r = vq_assign_cuda(xr, z, **kw)
    probe, ones = index_probe(nc, lead)
    b1_r = torch.round(vq_amm_cuda(xr, z, probe, ones, **kw)).to(
        torch.int32)
    del probe, ones
    check(torch.equal(idx_r, b1_r),
          f"B3 {whatk}: indices differ from B1's on random x")
    flips = float((idx_r != ref.assign_ref(xr, z, **kw)).float().mean())
    check(flips < 1e-3, f"B3 {whatk}: {flips:.2%} of random-x "
          "assignments differ from the plain argmin")

    # embedding_bag's table: every (expert, subspace, centroid) row; its
    # bags: every row's (a decode buffer: the live rows')
    lut_f = lut.float().reshape(-1, n)
    offs = idx_k.long() + C * torch.arange(nc, device=dev)
    if e is not None:
        offs = offs + (nc * C * torch.arange(e, device=dev))[:, None, None]
    keep = torch.ones(out_k.shape[:-1], dtype=torch.bool, device=dev) \
        if mask is None else mask
    offs = offs[keep].reshape(-1, nc)
    lib = torch.nn.functional.embedding_bag(offs, lut_f, mode="sum")
    check(torch.allclose(lib * (1.0 if scale is None else scale[..., None, :]
                                .expand(out_k.shape)[keep]),
                         out_k[keep], rtol=1e-6, atol=0.0),
          f"B4 {what}: embedding_bag yardstick disagrees")
    calls3 = enqueued(lambda: vq_assign_cuda(x, z, **kw))
    check(calls3 == ONE_KERNEL, f"B3 {whatk}: a call enqueues {calls3}")
    calls4 = enqueued(lambda: lut_gemm_cuda(idx_k, lut, scale, **kw))
    check(calls4 == ONE_KERNEL, f"B4 {what}: a call enqueues {calls4}")
    r3 = {"ms": time_ms(lambda: vq_assign_cuda(x, z, **kw), 30, flush),
          "warm_ms": graph_ms(lambda: vq_assign_cuda(x, z, **kw)),
          "plain_ms": time_ms(lambda: ref.assign_ref(x, z, **kw), 5, flush),
          "host": host_us(lambda: vq_assign_cuda(x, z, **kw)), "err": 0.0,
          "library_ms": None,
          "every_ms": None if mask is None else time_ms(
              lambda: vq_assign_cuda(x, z), 30, flush)}
    r4 = {"ms": time_ms(lambda: lut_gemm_cuda(idx_k, lut, scale, **kw), 30,
                        flush),
          "warm_ms": graph_ms(lambda: lut_gemm_cuda(idx_k, lut, scale,
                                                    **kw)),
          "plain_ms": time_ms(lambda: ref.lut_gemm_onehot(idx_k, lut, scale,
                                                          **kw), 5, flush),
          "host": host_us(lambda: lut_gemm_cuda(idx_k, lut, scale, **kw)),
          "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
              offs, lut_f, mode="sum"), 30, flush),
          "err": err}
    del lut_f, lib
    # B3 must read x and z and write the indices; B4 read the indices,
    # the LUT rows they select (of each expert) and the scale, and write
    # out (a decode buffer: of the live rows, and the experts with one)
    r3["bound_ms"], r3["bound_by"] = bound(work.vq_assign(x, z,
                                                          counts=counts))
    r4["bound_ms"], r4["bound_by"] = bound(work.lut_gemm(
        idx_k, lut, scale, rows=work.selected_rows(idx_k, C, counts),
        counts=counts))
    every = "" if mask is None else (
        f", without counts (every row) {r3['every_ms'] * 1e3:.1f} us")
    print(f"{head}B3 vq_assign {whatk}: kernel {r3['ms'] * 1e3:.1f} us (warm,"
          f" 30 calls in one graph: {r3['warm_ms'] * 1e3:.1f} us a "
          f"call){every}, plain {r3['plain_ms'] * 1e3:.1f} us, bound "
          f"{r3['bound_ms'] * 1e3:.3f} us ({r3['bound_by']}), host "
          f"{r3['host']:.1f} us/call, enqueues {calls3}, "
          f"{assign_text(vq_assign_geometry(x, z, **kw))}; random x: "
          f"{flips:.2e} flips vs plain, indices equal to B1's{tail}")
    print(f"{head}B4 lut_gemm {what}: kernel {r4['ms'] * 1e3:.1f} us "
          f"(warm, 30 calls in one graph: {r4['warm_ms'] * 1e3:.1f} us a "
          f"call), plain {r4['plain_ms'] * 1e3:.1f} us, embedding_bag "
          f"(float32 copy of the int8 table, no scale) "
          f"{r4['library_ms'] * 1e3:.1f} us, bound "
          f"{r4['bound_ms'] * 1e3:.2f} us ({r4['bound_by']}), host "
          f"{r4['host']:.1f} us/call, enqueues {calls4}, "
          f"{cluster_text(lut_gemm_geometry(idx_k, lut, **kw))} (B1: "
          f"{cluster_text(vq_amm_geometry(x, z, lut, **kw))}), max abs err "
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
            flush, timed, ps=PAGE, sp=None):
    """B2 at one shape (``sp`` pages a split; default the split rule's
    choice for ``kvh`` kv heads), against its plain version."""
    q, kp, vp, kn, vn, phys, pos, ks = b2_inputs(gen, b, h, kvh, d, np_,
                                                 positions, kv_start, ps)
    g = h // kvh
    sp = sp or fd.split_pages_for(b, kvh, np_)
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
    tms, tby = bound(work.flash_decode_splits(qg, kp, phys_p, tk,
                                              live=live))
    # the whole call: K/V rows, q, the new token's rows, page ids, out
    bms, by = bound(work.flash_decode(q, kp, kn, phys, live=live))
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
            flush, timed, exact_c=None, ps=PAGE, sp=None):
    """B5 at one shape, against its plain version (triples and output)
    and the dequantize-then-reference oracle, all in float32."""
    q, kc, vc, cb_l, kn, vn, phys, pos, ks = b5_inputs(
        gen, b, h, kvh, d, np_, positions, kv_start, ps, exact_c)
    g = h // kvh
    sp = sp or fd.split_pages_for(b, kvh, np_, kvq=True)
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
    tms, tby = bound(work.flash_decode_splits(qg, kc, phys_p, tk,
                                              codebook=cb_l, live=live_t))
    bms, by = bound(work.flash_decode(q, kc, kn, phys, codebook=cb_l,
                                      live=live_t))
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
# The families phase (paligemma-3b, musicgen-large; dense cache): the
# forward batch's rows and length (text tokens after the image prefix, or
# frames), then the serve runs' rows, prompt and decode steps
FAM_FORWARD = 2, {"vlm": 64, "audio": 256}
# (8 decode steps since PR 32, 16 before: the families' (1, 2) runs took
# the time; every check holds at any step count)
FAM_ROWS, FAM_PROMPT, FAM_STEPS = 4, {"vlm": 32, "audio": 64}, 8
# the families over a model axis: the mesh, the decode steps of the
# sharded dense-cache chain (fed the unsharded chain's inputs) and the
# depth of the float32 lut_train gradient check (held at the train_scale
# phase's TRAIN_F32_REL); a bf16 row whose argmax differs from the
# unsharded run's counts as a near-tie when its two logits in the
# unsharded row lie within FAM_MESH_TIE of the row's largest |logit|
# (two bfloat16 ulps)
FAM_MESH, FAM_MESH_STEPS, FAM_MESH_LAYERS = (1, 2), 8, 4
FAM_MESH_TIE = 2.0 ** -7
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
    # the families phase's dense-cache runs: decode (B rows) and prefill
    # (B x (patches + prompt tokens), B x prompt frames)
    "paligemma-3b": (PALIGEMMA_PROJ_SHAPES, [
        FAM_ROWS, FAM_ROWS * (paligemma_3b.config().num_patches
                              + FAM_PROMPT["vlm"])]),
    "musicgen-large": (MUSICGEN_PROJ_SHAPES, [FAM_ROWS,
                                              FAM_ROWS * FAM_PROMPT["audio"]]),
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
          spec=None, hook=None, tag="serve", mesh=None):
    """Serve ``load`` through the engine under ``qc`` (speculatively with
    ``spec``); every kernel in ``launched`` must launch, none in ``idle``,
    and no plain version may run. ``hook(eng)``, when given, may wrap the
    engine's methods before the run (after the step timers). The result
    line starts ``{tag} [{label}]``. Over a ``mesh`` the engine's
    placement is measured too: ``stats["place_peak"]`` and
    ``["place_held"]`` are the card's peak and held bytes over those
    before it (collect earlier engines first, so that none is freed
    inside the span), ``["setup_s"]`` its seconds. Returns (counts,
    tokens, engine)."""
    vocab = model.cfg.vocab_size
    reqs = load_requests(load, seed, vocab)
    torch.cuda.synchronize()
    if mesh is not None:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = Engine(model, params, qc, batch_size=load.slots,
                 max_seq=load.max_seq, page_size=PAGE,
                 prefill_chunk=load.chunk, seed=seed, spec_decode=spec,
                 mesh=mesh)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    place = {"place_peak": torch.cuda.max_memory_allocated() - base,
             "place_held": torch.cuda.memory_allocated() - base}
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
                 "step_ms": 1e3 * float(np.mean(dec)),
                 "chunk_ms": 1e3 * float(np.mean(pre)),
                 "steps": len(dec), "chunks": len(pre), "setup_s": setup,
                 **place}
    eng.requests = reqs
    return counts, [r.out_tokens for r in reqs], eng


def pool_text(kv) -> str:
    """A serve line's account of the engine's cache: bytes a token of a
    page pool, or the size of the slot state of a recurrent family."""
    shards = (f" in {len(kv.pools)} shards" if len(kv.pools) > 1 else "")
    if kv.paged:
        return (f"KV pool {kv.bytes_per_token} B per token "
                f"({kv.pools[0]['k'].dtype}){shards}")
    return (f"slot state {sum(nbytes(t) for t in _leaves(kv.pools)) / 1e6:.1f}"
            f" MB for {kv.num_slots} slots (no pages){shards}")


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
    per entry of ``runs`` (label -> (qc, launched, idle), or (qc,
    launched, idle, layers) for a run cut to its first ``layers``
    layers); its peak device memory; then a logit check of each run's
    path in each dtype of ``logits``, and in float32 a verify check of
    each fp-pool run (``verify_check``); the model freed."""
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
    cuts = {}                 # label -> (model, params) of a cut run
    for label, (qc_r, launched, idle, *layers) in runs.items():
        m_r, p_r, name = model, params, f"{cfg.name} {label}"
        if layers:
            m_r, p_r = cuts[label] = cut_depth(model, params, layers[0])
            name = f"{cfg.name} {label}, {layers[0]} layers"
        _, _, eng = serve(m_r, p_r, qc_r, seed, name, launched, idle, load)
        if qc_r.kv_quant == "vq":
            codebook = eng.kv_codebook
        del eng
    print(f"peak device memory, {cfg.name} (init and serving): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # the float32 copy at SERVING_LAYERS, as qwen1.5-4b's (the script's
    # time budget)
    models = {"bfloat16": (model, params, codebook, "")}
    if "float32" in logits:
        cut, cut_params = cut_depth(model, params, SERVING_LAYERS)
        models["float32"] = (
            Model(cut.cfg.replace(dtype="float32")),
            _map_float(cut_params, torch.float32),
            None if codebook is None else KVCodebook(
                **{k: v[:SERVING_LAYERS]
                   for k, v in codebook.tree().items()}),
            f", {SERVING_LAYERS} layers")
        del cut, cut_params
    for label, (qc_r, _, _, *layers) in runs.items():
        vq = qc_r.kv_quant == "vq"
        for dt in logits:
            m, p, cb, depth = models[dt]
            if layers and dt == "bfloat16":
                m, p = cuts[label]
                depth = f", {layers[0]} layers"
                if cb is not None:
                    cb = KVCodebook(**{k: v[:layers[0]]
                                       for k, v in cb.tree().items()})
            logit_check(m, p, qc_r, seed, f"{cfg.name} {label}{depth}",
                        cb if vq else None, load)
        if "float32" in logits and not vq:
            m, p, _, depth = models["float32"]
            verify_check(m, p, qc_r, seed, f"{cfg.name} {label}{depth}",
                         load)
    del model, params, codebook, models, cuts
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
    decode_logit_check(model, params, qc, eng.kv.pools[0],
                       eng.kv.table_device(), toks, positions, label,
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
    check(all(e.params[0] is params for e in router.engines),
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
#: depth of the prefix phase's runs and of the analysis phase's guard runs:
#: what they check (hits, forks, host reads, syncs and uploads a step) does
#: not depend on depth, and at SERVING_LAYERS they took 40 s more of the
#: script's 1197 on a slow host
SHALLOW_LAYERS = 4


def cut_depth(model, params, layers):
    """``model`` and ``params`` cut to their first ``layers`` layers, at
    full width: a new Model over the same weight tensors (nothing is
    copied)."""
    return (Model(model.cfg.replace(num_layers=layers)),
            {**params, "blocks": params["blocks"][:layers]})


def serving_phases(model, params, qc, seed, gen):
    """The prefix, policy, chaos, baseline and obs phases on full-width
    qwen1.5-4b (``model``, int8 LUTs) cut to SERVING_LAYERS layers (the
    prefix phase to SHALLOW_LAYERS), each with its float32 runs on one
    4-layer float32 model."""
    model, params = cut_depth(model, params, SERVING_LAYERS)
    f32 = f32_model(seed)
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    with phase("prefix"):
        prefix_phase(*cut_depth(model, params, SHALLOW_LAYERS), qc, f32,
                     seed)
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

# (label, experts, rows, K, N, launches per deepseek-moe-16b decode step's
# layer) of the grouped cases on full buffers (every row random, no
# counts): the routed experts (64, capacity 8 at decode and at the
# 32-token chunk; a decode step runs them at the decode buffer,
# MOE_LIVE_CASES), the shared experts (2, the step's rows: 8 at decode, 32
# a chunk; all rows live), one dbrx-132b expert layer (16 experts; its
# int8 w1 table is 2.11e9 bytes, just below 2^31), and 18 experts of
# dbrx's w1 shape, whose table (2.38e9 bytes) passes 2^31: the 64-bit
# expert offsets
MOE_CASES = [
    ("routed wg/wu", 64, 8, 2048, 1408, 0),
    ("routed wd", 64, 8, 1408, 2048, 0),
    ("shared wg/wu", 2, 8, 2048, 1408, 2), ("shared wd", 2, 8, 1408, 2048, 1),
    ("shared wg/wu chunk", 2, 32, 2048, 1408, 0),
    ("shared wd chunk", 2, 32, 1408, 2048, 0),
    ("dbrx-132b w1", 16, 8, 6144, 10752, 0),
    ("dbrx-132b w2", 16, 8, 10752, 6144, 0),
    ("dbrx-132b w1 x 18 experts, past 2^31", 18, 8, 6144, 10752, 0)]
# the routed cases again at a decode buffer (the rows a decode step of 8
# tokens fills, with their live-row counts: deepseek-moe-16b's from its
# two-pass run's decode steps, dbrx-132b's from a seeded route of 8
# tokens, top-4 of 16), as its decode step launches them; the last field
# names the counts' source
MOE_LIVE_CASES = [
    ("routed wg/wu", 64, 8, 2048, 1408, 2, "deepseek-moe-16b"),
    ("routed wd", 64, 8, 1408, 2048, 1, "deepseek-moe-16b"),
    ("dbrx-132b w1", 16, 8, 6144, 10752, 0, "dbrx-132b"),
    ("dbrx-132b w2", 16, 8, 10752, 6144, 0, "dbrx-132b")]


@contextlib.contextmanager
def drop_tally(model, calls, loads=None):
    """Record each MoE layer call's routing while ``model`` serves through
    prefill_paged and decode_paged: (layer, T, capacity, counts) appended
    to ``calls`` and, with ``loads``, (layer, T, capacity, live rows) to
    ``loads``, the live rows each expert's buffer takes (route's counts
    clamped to the capacity, a device vector); counts a device vector
    (real pairs dropped, pad pairs
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
        if loads is not None:
            loads.append((state["layer"], t, cap, out[4].clamp(max=cap)))
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
    """Full-width deepseek-moe-16b (int8 LUTs) through the engine on
    MAIN_LOAD: fused on an fp pool (B1 grouped, B2) at full depth; cut to
    SERVING_LAYERS, two-pass (B3 + B4 grouped; its routing tallied,
    drop_tally; tokens must equal a fused run's at that depth) and fused
    on a VQ code pool (B5); each run's launches in one decode step
    (fused: 280 B1, 168 of them grouped, and 28 B2) and a bf16 logit
    check of one decode_paged step through the kernels against the plain
    versions. Returns the live rows of one routed call of a decode step
    of the two-pass run (E ints; of the decode calls, the one with the
    median number of experts with a live row), the moe phase's decode
    buffer. Cuts for the script's time (the train_scale phase's room):
    the routing was tallied in a fourth fused run (13.3 s on an H100), now
    in the
    two-pass run (whose step time then holds the tally's ops), and the
    two-pass and code-pool runs were at full depth (14.0 and 14.6 s of
    serving on an H100, each with its logit check; the grouped kernels and B5
    are the same at any depth)."""
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
    depth = {"fused": cfg.num_layers, "two-pass": SERVING_LAYERS,
             "vq-kv": SERVING_LAYERS}

    def want_step(label):
        n = depth[label]
        proj, grouped = n * (4 + experts), n * experts
        return {"fused": {"b1": proj, "b1_grouped": grouped, "b2": n},
                "two-pass": {"b3": proj, "b4": proj, "b3_grouped": grouped,
                             "b4_grouped": grouped, "b2": n},
                "vq-kv": {"b1": proj, "b1_grouped": grouped,
                          "b5": n}}[label]
    tokens, codebook, drops, loads = {}, None, [], []
    for label, (qc_r, launched, idle) in runs.items():
        m_r, p_r = ((model, params) if depth[label] == cfg.num_layers
                    else cut_depth(model, params, depth[label]))
        name = (cfg.name if depth[label] == cfg.num_layers
                else f"{cfg.name} ({depth[label]} layers)")
        tally = (drop_tally(m_r, drops, loads) if label == "two-pass"
                 else contextlib.nullcontext())
        with tally:
            counts, tokens[label], eng = serve(
                m_r, p_r, qc_r, seed, f"{name} {label}", launched, idle,
                tag="moe")
        if qc_r.kv_quant == "vq":
            codebook = eng.kv_codebook
        del eng
        kv, table, toks, positions, lengths = prefilled_pool(
            m_r, p_r, qc_r, seed, codebook if qc_r.kv_quant == "vq"
            else None)
        got = step_launches(m_r, p_r, qc_r, kv, table, toks, positions)
        print(f"moe [{name} {label}]: one decode step launches {got} "
              f"(expected {want_step(label)}) [{SMI}]")
        check(got == want_step(label),
              f"moe {label}: one decode step launches {got}, expected "
              f"{want_step(label)}")
        decode_logit_check(m_r, p_r, qc_r, kv, table, toks, positions,
                           f"logit check, {name} {label}",
                           f"{SLOTS} slots at lengths {lengths.tolist()}",
                           tag="moe")
        del kv
    m8, p8 = cut_depth(model, params, SERVING_LAYERS)
    _, fused8, eng = serve(m8, p8, qc, seed,
                           f"{cfg.name} ({SERVING_LAYERS} layers) fused",
                           *runs["fused"][1:], tag="moe")
    del eng, m8, p8
    check(tokens["two-pass"] == fused8,
          "moe: two-pass tokens differ from the fused run's")
    print(f"moe [{cfg.name} routing, the two-pass run]: "
          f"{drop_text(drops, cfg.top_k, cfg.num_experts)} [{SMI}]")
    decode = [row.tolist() for _, t, _, row in loads if t == SLOTS]
    check(bool(decode), "moe: the two-pass run recorded no decode call")
    decode.sort(key=lambda r: sum(n > 0 for n in r))
    live = decode[len(decode) // 2]
    print(f"moe [{cfg.name} decode buffer]: of {len(decode)} routed decode "
          f"calls (T={SLOTS}, top-{cfg.top_k}), experts with a live row "
          f"min / median / max {sum(n > 0 for n in decode[0])} / "
          f"{sum(n > 0 for n in live)} / "
          f"{sum(n > 0 for n in decode[-1])}; the median call's live rows "
          f"{live} [{SMI}]")
    print(f"moe [{cfg.name}]: two-pass tokens identical to the fused run's "
          f"at {SERVING_LAYERS} layers (10 requests, "
          f"{sum(map(len, fused8))} tokens); peak "
          f"device memory (init and serving) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{pbytes / 1e9:.2f} GB of params [{SMI}]")
    del model, params, codebook
    free()
    return live


def dbrx_decode_rows(gen):
    """dbrx-132b's live rows at a decode step of SLOTS tokens: a seeded
    route (random router logits, top-4 of 16) into buffers of its decode
    capacity (8), as moe_ffn computes it."""
    cfg = dbrx_132b.config()
    t, e, k = SLOTS, cfg.num_experts, cfg.top_k
    cap = min(t, max(int(cfg.capacity_factor * t * k / e), 8))
    probs = torch.softmax(torch.randn((t, e), generator=gen, device=DEV), -1)
    return moe_mod.route(probs, k, cap)[4].clamp(max=cap).tolist()


def moe_phase(gen, seed):
    """The MoE phase: the deepseek-moe-16b serve runs, the grouped kernel
    cases on full buffers, the routed ones again at a decode buffer with
    live-row counts, and the float32-LUT copy cut to 4 layers served
    twice. Returns the kernel cases' results: by label, and the decode
    buffers' under "<label> decode"."""
    live = {"deepseek-moe-16b": moe_serve(seed),
            "dbrx-132b": dbrx_decode_rows(gen)}
    most = {"deepseek-moe-16b": SLOTS * deepseek_moe_16b.config().top_k,
            "dbrx-132b": SLOTS * dbrx_132b.config().top_k}
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
    for label, e, m, k, n, _, src in MOE_LIVE_CASES:
        kw = dict(counts=live[src], most_live=most[src])
        r1 = b1_case(gen, m, k, n, flush, e, f"{label} decode", **kw)
        r3, r4 = b34_case(gen, m, k, n, flush, e, f"{label} decode", **kw)
        cases[f"{label} decode"] = {"b1": r1, "b3": r3, "b4": r4}
        free()
    del flush
    for key in ("b1", "b3", "b4"):
        def layer(f, full=False):
            return sum(cases[label + ("" if full else " decode")][key][f]
                       * cnt for label, *_, cnt, _ in MOE_LIVE_CASES
                       if cnt) + sum(cases[label][key][f] * cnt
                                     for label, *_, cnt in MOE_CASES if cnt)
        print(f"moe [{key.upper()} grouped per deepseek-moe-16b layer at "
              f"decode, 3 routed (decode buffer) + 3 shared expert "
              f"projections]: {layer('ms') * 1e3:.1f} us flushed, "
              f"{layer('warm_ms') * 1e3:.1f} us warm, bound "
              f"{layer('bound_ms') * 1e3:.2f} us; with the routed ones on "
              f"full buffers {layer('ms', True) * 1e3:.1f} us flushed, "
              f"{layer('warm_ms', True) * 1e3:.1f} us warm, bound "
              f"{layer('bound_ms', True) * 1e3:.2f} us [{SMI}]")
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


def ssm_serve(cfg, runs, seed, name=None):
    """A full-width, full-depth recurrent config (int8 LUTs) through the
    engine on MAIN_LOAD, once per entry of ``runs`` (label -> (qc,
    launched, idle, one decode step's launches)): each run's one decode
    step launches, counted on a state prefilled to MAIN_LOAD.check
    lengths, and a bf16 logit check of one decode_paged step through the
    kernels against the plain versions; two-pass tokens must equal the
    fused run's. ``name`` (default the config's) starts the runs'
    labels."""
    name = name or cfg.name
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
                                      f"{name} {label}", launched, idle,
                                      tag="ssm")
        stats[label] = eng.stats
        del eng
        kv, table, toks, positions, lengths = prefilled_pool(
            model, params, qc_r, seed)
        got = step_launches(model, params, qc_r, kv, table, toks, positions)
        print(f"ssm [{name} {label}]: one decode step launches {got} "
              f"(expected {want}) [{SMI}]")
        check(got == want, f"ssm {name} {label}: one decode step "
              f"launches {got}, expected {want}")
        decode_logit_check(model, params, qc_r, kv, table, toks, positions,
                           f"logit check, {name} {label}",
                           f"{SLOTS} slots at lengths {lengths.tolist()}",
                           tag="ssm")
        del kv
    if "two-pass" in tokens:
        check(tokens["two-pass"] == tokens["fused"],
              f"ssm {name}: two-pass tokens differ from the fused run's")
    print(f"ssm [{name}]: "
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
        "fused": (qc, {"b1"}, {"b2", "b3", "b4", "b5"}, {"b1": m2_proj})},
        seed)
    # two-pass against fused at SERVING_LAYERS: at full depth the two-pass
    # run took ~22 s of the script's 1200 on an H100 (15.7 s serving, then its
    # pool, launches and logit check), which the train_scale phase needs
    m8 = m2.replace(num_layers=SERVING_LAYERS)
    m8_proj = 2 * SERVING_LAYERS
    ssm_serve(m8, {
        "fused": (qc, {"b1"}, {"b2", "b3", "b4", "b5"}, {"b1": m8_proj}),
        "two-pass": (qc.replace(fuse=False), {"b3", "b4"},
                     {"b1", "b2", "b5"}, {"b3": m8_proj, "b4": m8_proj})},
        seed, f"{m8.name}, {SERVING_LAYERS} layers")
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


@contextlib.contextmanager
def _rank_assignments(replay=None, keep=None):
    """Record every subspace STE call's centroid indices by rank, in each
    rank's call order (``{rank: [indices on the CPU, ...]}``; rank 0
    outside a runner). With ``replay`` (an unsharded run's list), each
    rank's k-th call takes the k-th recorded indices in place of its own
    argmin, cut to the rank's rows (its data group's) and, for a
    row-parallel shard, to its subspaces: every rank then runs on the
    unsharded run's assignments. With ``keep`` (a dict), the inputs (x,
    z) of each rank's first LAYER_CALLS calls (layer 0's) go into it, on
    the CPU, by rank."""
    calls: dict = {}
    own = similarity.assign_subspaces

    def assign(x, z, metric):
        tp = tcol.current()
        mine = calls.setdefault(tp.me, [])
        if keep is not None and len(mine) < LAYER_CALLS:
            keep.setdefault(tp.me, []).append((x.detach().cpu(),
                                               z.detach().cpu()))
        if replay is None:
            idx = own(x, z, metric)
        else:
            idx = replay[len(mine)]
            b, n = x.shape[0], x.shape[-2]
            if idx.shape[0] != b:
                g = tp.data.rank
                idx = idx[g * b:(g + 1) * b]
            if idx.shape[-1] != n:
                idx = idx[..., tp.rank * n:(tp.rank + 1) * n]
            idx = idx.to(x.device)
        mine.append(idx.cpu())
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


def checkpoint_check(cfg, params):
    """A copy of the trained params cut to CKPT_LAYERS layers (full width):
    save_pytree / load_pytree bit for bit (every leaf bf16). The Trainer's
    checkpoint, restore and resume against the run that never stopped
    are the train_scale phase's elastic check (a Trainer on (1, 2) saves,
    a Trainer on (2, 2) and an unsharded one resume): run here too they
    took ~27 s of the script's 1200 on an H100 (one step and a checkpoint
    10.5 s, the restore 16.5 s)."""
    cut = {"embed": params["embed"], "final_norm": params["final_norm"],
           "blocks": params["blocks"][:CKPT_LAYERS]}
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
        print(f"train [checkpoint]: {cfg.name} cut to {CKPT_LAYERS} "
              f"layers, {nb / 1e9:.2f} GB of bf16 params: saved in "
              f"{t_save:.1f} s, loaded in {t_load:.1f} s, every leaf bit for "
              f"bit [{SMI}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del cut, back
    free()


def train_phase(seed):
    """LUTBoost on full-width qwen1.5-4b (lut_train, v=8 c=16 l2): stage 1
    (convert: k-means of each projection's inputs captured in the dense
    forward of one calibration batch), stage 2 (centroids only), stage 3
    (joint); the
    card-vs-CPU block check; a checkpoint round trip on a copy cut to
    CKPT_LAYERS layers (the resume is the train_scale phase's); then int8
    LUTs (precompute_model) served
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
    # the train_scale phase starts from the same converted params
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    print(f"train [host copy]: the converted params copied to the host in "
          f"{time.perf_counter() - t0:.2f} s, for the train_scale phase "
          f"[{SMI}]")

    # stages 2 and 3
    tc = TrainConfig(total_steps=sum(TRAIN_STEPS.values()), lr=TRAIN_LR,
                     warmup=0, weight_decay=0.01, grad_clip=1.0)
    opt = init_opt_state(params, tc)
    frozen = {path: t.clone() for path, t in tree_flatten_with_path(params)
              if not path.endswith("['z']")}
    z_before = {path: t.clone() for path, t in
                tree_flatten_with_path(params) if path.endswith("['z']")}
    times, step, steps = {2: [], 3: []}, 0, []
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
            steps.append({"loss": loss, "ce": float(met["ce"]),
                          "recon": float(met["recon"]), "grad_norm": gn,
                          "ms": 1e3 * times[stage][-1]})
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

    peak = torch.cuda.max_memory_allocated()
    block_check(model, params["blocks"][0], qc, seed)
    free()
    checkpoint_check(cfg, params)

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
    return host, steps, peak


# ---------------------------------------------------------------------------
# train_scale phase: the sharded LUTBoost train step on the one card
# ---------------------------------------------------------------------------

# The sharded bf16 steps against the unsharded ones of the train phase
# (the same converted params, batches and steps), relative. Once the
# float32 check has shown that the two compute the same function, what
# is left is bf16 rounding in other orders (a row-parallel sum of float32
# partials rounded once, against one bf16 matmul), which the recon loss
# feels most: it is a mean of squared differences of two nearly equal
# projections, and rounding noise adds to it. The float32 check prints
# how far each bf16 run's recon lies from the float32 value on the same
# params (8 layers); at full depth the two bf16 runs' recon differed by
# 11% at the first step on an H100. loss = ce + 0.05 recon follows. These
# hold the first step, where both runs start from the same params.
TRAIN_SCALE_REL = {"loss": 1e-1, "ce": 1e-2, "recon": 2e-1,
                   "grad_norm": 5e-2}
# After one update the two runs are two trajectories, not one
# computation: a param a last bit apart decides a near-tied centroid the
# other way (which is why the CPU tests start every step from the
# reference's state), and in bf16 at lr 1e-4 an update under half an ulp
# is lost. Their later steps are printed beside each other and held only
# finite (stage 2 must also leave every leaf but the centroids bit for
# bit); a bound there held chaos, not the step (grad_norm 4.7e-2 apart
# at the fourth step with float32 gradient sums, 1.1e-1 with the
# reference's bf16 ones, on an H100). The sharded step's correctness
# after the first step is the float32 check's: its gradients and one
# update against the unsharded step's on the same assignments.
# the float32 check: a copy cut to this many layers, on (1, 2) and (2, 2),
# on the unsharded run's centroid assignments; every gathered gradient
# leaf, loss, ce, recon and grad_norm within this relative L2 of the
# unsharded float32 step's (sums in other orders: the train phase's
# card-vs-CPU block check holds one layer at 1e-4)
TRAIN_F32_LAYERS = 8
TRAIN_F32_REL = 1e-4
# the subspace STE calls of one qwen1.5-4b layer (q, k, v, o, gate, up,
# down)
LAYER_CALLS = 7
# the serve run of the sharded-trained model: 4 requests of 16-48 prompt
# tokens, 5 new tokens each (one from the prefill, 4 decode steps)
TRAIN_SCALE_LOAD = Load(n=4, prompt=(16, 49), new=5, hot=-1)
# the pipeline: full-width qwen1.5-4b dense blocks in float32 (TF32 off),
# one a stage, over 8 rows of 64 tokens in 4 microbatches; against the
# sequential loop (the same blocks on other row counts: other cuBLAS
# kernels, so not bit for bit)
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS, PIPE_SEQ = 4, 4, 8, 64
PIPE_REL = 1e-5


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _cut(params, layers):
    """``params`` with the first ``layers`` blocks (the same tensors)."""
    return {k: (v[:layers] if k == "blocks" else v)
            for k, v in params.items()}


def sharded_grads(model, params, batch, qc, mesh):
    """The sharded step's gradient (every entry summed over its copies),
    gathered, with its loss, metrics and global norm, for ``params`` (full
    leaves) placed on ``mesh``."""
    layout = serving_layout(params, model.cfg, mesh.shape["model"])
    shards = shard_tree(params, layout, mesh, copy=True)
    runner = tcol.RankRunner(mesh=mesh)
    loss, met, parts = sharded_loss_and_grads(
        model, runner, shards, shard_batch(batch, model.cfg, mesh), qc)
    del shards
    shared = shared_entries(layout)

    def reduce(tp):
        g = reduce_grads(parts[tp.me], shared)
        parts[tp.me] = None
        return g, global_norm(g, shared)
    with torch.no_grad():
        outs = runner.run(reduce)
    full = unshard_tree([g for g, _ in outs], layout, mesh)
    return loss, met, full, outs[0][1], runner.collectives


def _flip_gaps(mine, full, inputs):
    """Rank 0's layer-0 assignments (``mine``, one a call) against the
    unsharded run's (``full``) on the unsharded run's inputs (``inputs``,
    its (x, z) a call): (flips, the largest flip_gap relative gap), each
    gap on float64 distances. Rank 0 holds the first rows (its data
    group's) and, cut by subspace, the first subspaces."""
    flips, worst = 0, 0.0
    for ic, iw, (x, z) in zip(mine, full, inputs):
        b, n = ic.shape[0], ic.shape[-1]
        iw = iw[:b, ..., :n]
        off = ic != iw
        flips += int(off.sum())
        if off.any():
            sub = off.nonzero()[:, -1]
            xs = x[:b, ..., :n, :][off]
            rel, _, _ = flip_gap(xs, z[sub, iw[off].long()],
                                 z[sub, ic[off].long()])
            worst = max(worst, float(rel.max()))
    return flips, worst


def _update_off(got, want, lr, tol):
    """For a param leaf after one update against the reference's: how
    many elements miss ``tol`` (relative to the element and to the leaf's
    largest value) and the largest miss over ``lr``. Adam divides each
    gradient element by its own magnitude, so an element whose gradient
    nearly cancels may take another update (by up to 2 lr) while the
    gradient agrees within ``tol``; a wrong update moves every element."""
    w = want.double()
    diff = (got.double() - w).abs()
    scale = max(float(w.abs().max()), 1e-6)
    off = diff > tol * w.abs() + tol * scale
    return int(off.sum()), float(diff.max()) / lr


def train_f32_check(seed, host, qc, tc):
    """A float32 copy of the converted params cut to TRAIN_F32_LAYERS: the
    gradient of the first training batch and one stage-3 update,
    unsharded and sharded on (1, 2) and (2, 2). The lut_train forward of
    converted params is chaotic: a last-bit difference (a row-parallel sum
    in another order) decides a near-tied centroid the other way, the
    forward value then jumps by a centroid's difference, and the next
    layers' inputs part further (how many assignments a sharded run
    decides otherwise is printed, layer by layer; each of layer 0's must
    be a near-tie on float64 distances, FLIP_REL). So each sharded run is
    held on the unsharded run's assignments (``_rank_assignments``):
    every gathered gradient leaf, loss, ce, recon and grad_norm within
    TRAIN_F32_REL (TF32 off); after the update, the gathered params as
    the CPU tests hold a step (``_update_off``), counted over the whole
    tree: at most 1 element in 1000 off TRAIN_F32_REL, none by more than 3
    lr (a leaf of small gradients, as a k bias, may have more than its
    thousandth near Adam's eps); the moments within TRAIN_F32_REL, the
    count equal."""
    cfg = qwen1p5_4b.config().replace(num_layers=TRAIN_F32_LAYERS,
                                      dtype="float32")
    model = Model(cfg)
    params = tree_map(lambda t: t.to(DEV, torch.float32),
                      _cut(host, TRAIN_F32_LAYERS))
    batch = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                             device=DEV).batch(1)
    inputs = {}
    with _rank_assignments(keep=inputs) as rec:
        loss, met, grads = loss_and_grads(model, params, batch, qc)
    record = rec[0]
    norm = global_norm(grads)
    want = {"loss": loss, "ce": met["ce"], "recon": met["recon"],
            "grad_norm": norm}
    lr = cosine_lr(0, tc.lr, tc.warmup, tc.total_steps)
    one = _clone(params)
    one_opt = init_opt_state(one, tc)
    with _rank_assignments(record):
        make_train_step(model, qc, tc, 3)(one, one_opt, batch, 0)
    layout = serving_layout(params, cfg, TP)
    st_layout = (layout, opt_pspecs(layout, tc))
    for shape in ((1, TP), (2, TP)):
        mesh = make_test_mesh(shape, device=DEV)
        with _rank_assignments() as own:
            sharded_grads(model, params, batch, qc, mesh)
        free()
        flips = []                  # rank 0's calls against the record
        for mine, full in zip(own[0], record):
            b, n = mine.shape[0], mine.shape[-1]
            flips.append(int((mine != full[:b, ..., :n]).sum()))
        per_layer = [sum(flips[i:i + LAYER_CALLS])
                     for i in range(0, len(flips), LAYER_CALLS)]
        n0, gap0 = _flip_gaps(own[0][:LAYER_CALLS], record, inputs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _rank_assignments(record):
            l2, met2, full, n2, coll = sharded_grads(model, params, batch,
                                                     qc, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"loss": l2, "ce": met2["ce"], "recon": met2["recon"],
               "grad_norm": n2}
        rels = {k: abs(float(got[k]) - float(want[k]))
                / abs(float(want[k])) for k in want}
        leaf = [(_rel(a, b), p) for (p, a), (_, b) in zip(
            tree_flatten_with_path(full), tree_flatten_with_path(grads))]
        worst, where = max(leaf)
        del full
        # one stage-3 update through the sharded step, gathered
        shards = shard_tree(params, layout, mesh, copy=True)
        opt = init_opt_state(shards, tc, mesh=mesh)
        with _rank_assignments(record):
            shards, opt, _ = make_train_step(model, qc, tc, 3, mesh=mesh,
                                             layout=layout)(shards, opt,
                                                            batch, 0)
        p_s, o_s = unshard_tree(list(zip(shards, opt)), st_layout, mesh)
        del shards, opt
        upd = [(_update_off(a, b, lr, TRAIN_F32_REL), a.numel(), p)
               for (p, a), (_, b) in zip(tree_flatten_with_path(p_s),
                                         tree_flatten_with_path(one))]
        n_off = sum(o for (o, _), _, _ in upd)
        n_all = sum(n for _, n, _ in upd)
        most = max(upd, key=lambda u: u[0][0])
        over_lr = max(d for (_, d), _, _ in upd)
        mom = max(_rel(a, b) for a, b in zip(
            _leaves([o_s["adam"]["m"], o_s["adam"]["v"]]),
            _leaves([one_opt["adam"]["m"], one_opt["adam"]["v"]])))
        counts = (int(o_s["adam"]["count"]), int(one_opt["adam"]["count"]))
        print(f"train_scale [float32 check, {TRAIN_F32_LAYERS} layers, "
              f"{shape}]: left to itself, rank 0 decides "
              f"{sum(per_layer)} of its {sum(m.numel() for m in own[0])} "
              f"centroid assignments otherwise than the unsharded run, by "
              f"layer {per_layer} (layer 0's {n0} within {gap0:.2e} of a "
              f"tie on float64 distances); on the unsharded run's "
              f"assignments, {len(leaf)} gathered gradient leaves against "
              f"the unsharded float32 step's: worst relative L2 "
              f"{worst:.2e} ({where}), median "
              f"{float(np.median([r for r, _ in leaf])):.2e}; loss "
              f"{rels['loss']:.2e}, ce {rels['ce']:.2e}, recon "
              f"{rels['recon']:.2e}, grad_norm {rels['grad_norm']:.2e} "
              f"relative; {coll} collectives, {secs:.2f} s; after one "
              f"update, params: {n_off} of {n_all} elements off "
              f"{TRAIN_F32_REL} (most in {most[2]}: {most[0][0]} of "
              f"{most[1]}), the largest miss {over_lr:.3f} lr; "
              f"moments within relative L2 {mom:.2e}, counts {counts} "
              f"[{SMI}]")
        check(n0 == 0 or gap0 <= FLIP_REL,
              f"train_scale float32 {shape}: a layer-0 assignment flipped "
              f"{gap0:.2e} from a tie (> {FLIP_REL}): not a near-tie")
        check(worst <= TRAIN_F32_REL and max(rels.values()) <= TRAIN_F32_REL,
              f"train_scale float32 {shape}: gradients or metrics off the "
              f"unsharded step's by more than {TRAIN_F32_REL}")
        check(n_off <= max(1, n_all // 1000) and over_lr <= 3
              and mom <= TRAIN_F32_REL and counts == (1, 1),
              f"train_scale float32 {shape}: the sharded update is off the "
              f"unsharded one ({n_off} of {n_all} param elements off, by up "
              f"to {over_lr:.2f} lr; moments {mom:.2e}, counts {counts})")
        del own, p_s, o_s
        free()
    del params, grads, record, rec, one, one_opt, inputs
    free()
    # the same params and batch in bf16, forward only, unsharded and on
    # (1, 2): how far bf16 rounding moves each run's metrics from the
    # float32 values (what TRAIN_SCALE_REL allows for at full depth)
    cfg16 = cfg.replace(dtype="bfloat16")
    m16 = Model(cfg16)
    p16 = tree_map(lambda t: t.to(DEV), _cut(host, TRAIN_F32_LAYERS))
    mesh = make_test_mesh((1, TP), device=DEV)
    with torch.no_grad():
        _, one = m16.loss(p16, batch, qc)
        shards = shard_tree(p16, serving_layout(p16, cfg16, TP), mesh,
                            copy=True)
        parts = shard_batch(batch, cfg16, mesh)
        two = tcol.RankRunner(mesh=mesh).run(
            lambda tp: m16.loss(shards[tp.me], parts[tp.me], qc))[0][1]
    off = {k: ((float(one[k]) - float(want[k])) / abs(float(want[k])),
               (float(two[k]) - float(want[k])) / abs(float(want[k])))
           for k in ("loss", "ce", "recon")}
    print(f"train_scale [bf16 rounding, {TRAIN_F32_LAYERS} layers]: the "
          f"same params and batch in bf16 against the float32 values, "
          f"unsharded / (1, {TP}): "
          + ", ".join(f"{k} {a:+.2e} / {b:+.2e}" for k, (a, b) in off.items())
          + f" [{SMI}]")
    del p16, shards, m16
    free()


class _KeepRestored(CheckpointManager):
    """A trainer's checkpoint manager that keeps a host copy of the state
    it restores (``restored``: the step then updates it in place) and
    writes no checkpoint of its own: a resumed run's final save is the
    save that the first run already drove, and skipping it saves ~12 s a
    resume (5.48 GB at 2 layers) on an H100 host."""

    def restore(self, tree_like, step=None, mesh=None, layout=None):
        out = super().restore(tree_like, step, mesh, layout)
        self.restored = tree_map(lambda t: t.to("cpu", copy=True), out[0])
        return out

    def save(self, step, tree, extra=None, mesh=None, layout=None):
        return None


def train_elastic_check(seed, host, qc, tc):
    """The elastic checkpoint through the driver, at CKPT_LAYERS layers
    (full width): ``Trainer(mesh=(1, 2), checkpoint_dir=)`` takes one step
    and saves its state as global arrays; a ``Trainer`` on (2, 2) and an
    unsharded one resume from that checkpoint (each restore bit for bit
    the first run's state) and take the second step, each against a
    trainer on the same mesh that takes the second step from the first
    run's state handed over in memory (the run that never stopped): bit
    for bit, or (the embedding's backward sums with atomics on the card)
    its updates and moments within relative L2 1e-2."""
    cfg = qwen1p5_4b.config().replace(num_layers=CKPT_LAYERS)
    model = Model(cfg)
    cut = tree_map(lambda t: t.to(DEV), _cut(host, CKPT_LAYERS))
    ds = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed + 1,
                          device=DEV)
    tc = dataclasses.replace(tc, checkpoint_every=100, log_every=100)
    quiet = dict(log_fn=lambda _: None)
    m12 = make_test_mesh((1, TP), device=DEV)
    m22 = make_test_mesh((2, TP), device=DEV)
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_scale_", dir=base)
    lines, ok = [], True
    try:
        ck = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        first = Trainer(model, ds, qc, tc, checkpoint_dir=ck, mesh=m12,
                        **quiet).run(cut, num_steps=1)[:2]
        t_first = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ck) for f in fs)
        for name, mesh in ((f"(2, {TP})", m22), ("unsharded", None)):
            tr = Trainer(model, ds, qc, tc, checkpoint_dir=ck, mesh=mesh,
                         **quiet)
            tr.ckpt = _KeepRestored(ck)
            t0 = time.perf_counter()
            got = tr.run(cut, num_steps=1)[:2]
            secs = time.perf_counter() - t0
            same = all(a.dtype == b.dtype and torch.equal(_bits(a.cpu()),
                                                          _bits(b))
                       for a, b in zip(_leaves(first),
                                       _leaves(tr.ckpt.restored)))
            del tr
            free()
            handed = (first if mesh is not None
                      else _clone(first))     # trained in place unsharded
            want = Trainer(model, ds, qc, tc, mesh=mesh, **quiet).run(
                *handed, start_step=1, num_steps=1)[:2]
            del handed
            bitwise = all(torch.equal(_bits(a), _bits(b))
                          for a, b in zip(_leaves(got), _leaves(want)))
            upd = max(_rel(a.float() - c.float(), b.float() - c.float())
                      for a, b, c in zip(_leaves(got[0]), _leaves(want[0]),
                                         _leaves(first[0]))
                      if not torch.equal(b, c))
            mom = max(_rel(a, b) for a, b in zip(
                _leaves([got[1]["adam"]["m"], got[1]["adam"]["v"]]),
                _leaves([want[1]["adam"]["m"], want[1]["adam"]["v"]])))
            counts = (int(got[1]["adam"]["count"]),
                      int(want[1]["adam"]["count"]))
            lines.append(
                f"resumed {name} in {secs:.1f} s (restore "
                f"{'bit for bit' if same else 'NOT bit for bit'}), the "
                f"second step {'' if bitwise else 'not '}bit for bit the "
                f"run that never stopped (updates within relative L2 "
                f"{upd:.2e}, moments {mom:.2e}, counts {counts})")
            ok = ok and same and upd <= 1e-2 and mom <= 1e-2 \
                and counts == (2, 2)
            del got, want
            free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train_scale [elastic checkpoint]: {cfg.name} cut to "
          f"{CKPT_LAYERS} layers, Trainer(mesh=(1, {TP})) one step and its "
          f"state saved as global arrays ({ck_bytes / 1e9:.2f} GB) in "
          f"{t_first:.1f} s; " + "; ".join(lines) + f" [{SMI}]")
    check(ok, "train_scale elastic checkpoint: a restore differs from the "
          "saved state, or a resumed step is off the run that never "
          "stopped")
    del first, cut, model
    free()


def train_serve_check(seed, trained):
    """int8 LUTs of the sharded-trained params (gathered), served through
    a TP-2 engine and an unsharded one on TRAIN_SCALE_LOAD: B1 and B2
    launched, no plain version, the same greedy tokens."""
    cfg = qwen1p5_4b.config()
    qi = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="int8")
    model = Model(cfg)
    served = _strip(precompute_model(trained, qi))
    free()
    lab = "qwen1.5-4b sharded-trained, int8"
    _, toks_tp, eng = tp_serve(model, served, qi, seed, f"{lab}, TP-{TP}",
                               {"b1", "b2"}, {"b3", "b4", "b5"},
                               make_test_mesh((1, TP), device=DEV),
                               load=TRAIN_SCALE_LOAD, tag="train_scale")
    steps = eng.stats["steps"]
    del eng
    free()
    _, toks, eng = serve(model, served, qi, seed, f"{lab}, unsharded",
                         {"b1", "b2"}, {"b3", "b4", "b5"},
                         load=TRAIN_SCALE_LOAD, tag="train_scale")
    del eng
    same = toks_tp == toks
    print(f"train_scale [{lab}]: TP-{TP} greedy tokens "
          f"{'equal to' if same else 'NOT equal to'} the unsharded "
          f"engine's ({len(toks)} requests, {steps} decode steps) [{SMI}]")
    check(same and steps >= 4, f"train_scale serve: TP-{TP} tokens differ "
          f"from the unsharded engine's, or {steps} decode steps < 4")
    del served, model
    free()


def train_pipeline_check(seed, host):
    """``run_pipeline`` over PIPE_STAGES ranks sharing the card, each a
    full-width qwen1.5-4b block (dense, float32), against the sequential
    loop of the same blocks."""
    cfg = qwen1p5_4b.config().replace(num_layers=PIPE_STAGES,
                                      dtype="float32")
    model = Model(cfg)
    blocks = [tree_map(lambda t: t.to(DEV, torch.float32), b)
              for b in host["blocks"][:PIPE_STAGES]]
    stacked = tree_map(lambda *ts: torch.stack(ts), *blocks)

    def block_fn(p, x):
        return model._train_layer(p, 0, None, DENSE, x)[0]
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    x = torch.randn((PIPE_ROWS, PIPE_SEQ, cfg.d_model), generator=gen,
                    device=DEV)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = x
        for b in blocks:
            want = block_fn(b, want)
        torch.cuda.synchronize()
        t_seq = time.perf_counter() - t0
    mesh = make_test_mesh((PIPE_STAGES,), ("stage",), device=DEV)
    t0 = time.perf_counter()
    got = run_pipeline(mesh, block_fn, stacked, x, PIPE_MICRO)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    rel = _rel(got, want)
    print(f"train_scale [pipeline]: GPipe over {PIPE_STAGES} stage ranks on "
          f"the one card, a full-width {cfg.name} block each (float32), "
          f"{PIPE_ROWS} x {PIPE_SEQ} tokens in {PIPE_MICRO} microbatches "
          f"({PIPE_MICRO + PIPE_STAGES - 1} ticks): relative L2 {rel:.2e} "
          f"against the sequential loop; {1e3 * t_pipe:.1f} ms (the loop "
          f"{1e3 * t_seq:.1f} ms) [{SMI}]")
    check(bool(torch.isfinite(got).all()) and rel <= PIPE_REL,
          f"train_scale pipeline: relative L2 {rel:.2e} > {PIPE_REL}")
    del blocks, stacked, got, want, x, model
    free()


def remat_check(cfg, qc, shards, mesh, batch):
    """The (1, TP) step's gradient of one batch with and without
    ``cfg.remat`` (every rank recomputes a layer together in the
    backward, its collectives run again): the loss and every rank's
    gradient bit for bit, each run's peak above what it started from,
    its ms and collectives."""
    runs = {}
    for remat in (False, True):
        model = Model(cfg.replace(remat=remat))
        runner = tcol.RankRunner(mesh=mesh)
        parts = shard_batch(batch, cfg, mesh)
        free()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _, grads = sharded_loss_and_grads(model, runner, shards, parts,
                                                qc)
        torch.cuda.synchronize()
        runs[remat] = (loss, grads, time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() - base,
                       runner.collectives)
        del grads
    same = torch.equal(runs[False][0], runs[True][0]) and all(
        torch.equal(_bits(a), _bits(b)) for a, b in
        zip(_leaves(runs[False][1]), _leaves(runs[True][1])))
    print("train_scale [remat]: one gradient of full-width, full-depth "
          f"{cfg.name} on (1, {TP}): " + "; ".join(
              f"{'with' if r else 'without'} remat peak "
              f"{runs[r][3] / 1e9:.2f} GB above the placement, "
              f"{1e3 * runs[r][2]:.1f} ms, {runs[r][4]} collectives"
              for r in (False, True))
          + f"; loss and every rank's gradient bit for bit: {same} [{SMI}]")
    check(same, "train_scale remat: the gradients with remat differ from "
          "those without it")
    del runs
    free()


def train_scale_phase(seed, host, unsharded, unsharded_peak):
    """The sharded LUTBoost train step on the one card: the train phase's
    converted params (``host``, its stage-1 result) placed on a (1, 2)
    mesh, its stage-2 and stage-3 steps run sharded on the same batches
    (loss, ce, recon and grad_norm beside the unsharded run's, the first
    step's within TRAIN_SCALE_REL), then the float32 gradient and update
    check, the elastic checkpoint through ``Trainer``, the sharded-trained
    model served TP-2 and the GPipe pipeline."""
    cfg = qwen1p5_4b.config()
    qc = QuantConfig(mode="lut_train", v=V, c=C, metric="l2")
    model = Model(cfg)
    tc = TrainConfig(total_steps=sum(TRAIN_STEPS.values()), lr=TRAIN_LR,
                     warmup=0, weight_decay=0.01, grad_clip=1.0)
    ds = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                          device=DEV)
    mesh = make_test_mesh((1, TP), device=DEV)
    layout = serving_layout(host, cfg, TP)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards = shard_tree(host, layout, mesh, copy=True)
    opt = init_opt_state(shards, tc, mesh=mesh)
    torch.cuda.synchronize()
    print(f"train_scale [placement]: full-width, full-depth {cfg.name} "
          f"(lut_train v={V} c={C} l2, {cfg.dtype}) placed from the host "
          f"on a (1, {TP}) mesh of the one card in "
          f"{time.perf_counter() - t0:.2f} s, with its AdamW state: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB [{SMI}]")
    remat_check(cfg, qc, shards, mesh, ds.batch(0))
    step = 0
    for stage, n in TRAIN_STEPS.items():
        fn = make_train_step(model, qc, tc, stage, mesh=mesh, layout=layout)
        for _ in range(n):
            c0 = fn.runner.collectives
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shards, opt, met = fn(shards, opt, ds.batch(1 + step), step)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            u = unsharded[step]
            got = {k: float(met[k]) for k in TRAIN_SCALE_REL}
            rels = {k: abs(got[k] - u[k]) / abs(u[k]) for k in got}
            print(f"train_scale [stage {stage}] step {step}, (1, {TP}): "
                  + ", ".join(f"{k} {got[k]:.4f} (unsharded {u[k]:.4f}, "
                              f"{rels[k]:.1e})" for k in got)
                  + f"; {ms:.1f} ms (unsharded {u['ms']:.1f}); "
                  f"{fn.runner.collectives - c0} collectives; peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{SMI}]")
            check(all(math.isfinite(v) for v in got.values()),
                  f"train_scale stage {stage}: non-finite metrics")
            check(step > 0 or all(rels[k] <= TRAIN_SCALE_REL[k]
                                  for k in rels),
                  f"train_scale stage {stage} step {step}: sharded metrics "
                  f"off the unsharded run's by {rels} (bounds "
                  f"{TRAIN_SCALE_REL})")
            step += 1
        now = dict(tree_flatten_with_path(unshard_tree(shards, layout,
                                                       mesh)))
        was = dict(tree_flatten_with_path(host))
        z = [p for p in was if p.endswith("['z']")]
        w = [p for p in was if p.endswith("['w']")]

        def same(p):
            return torch.equal(_bits(now[p]), _bits(was[p].to(DEV)))
        if stage == 2:
            kept = sum(same(p) for p in was if p not in z)
            moved = sum(not same(p) for p in z)
            print(f"train_scale [stage 2]: {kept} of {len(was) - len(z)} "
                  f"non-centroid leaves bit for bit unchanged, {moved} of "
                  f"{len(z)} z moved (gathered) [{SMI}]")
            check(kept == len(was) - len(z) and moved == len(z),
                  f"train_scale stage 2: {kept} frozen leaves kept, {moved}"
                  " z moved")
        else:
            moved = sum(not same(p) for p in w)
            print(f"train_scale [stage 3]: {moved} of {len(w)} weights "
                  f"changed (gathered) [{SMI}]")
            check(moved == len(w), f"train_scale stage 3: {moved} of "
                  f"{len(w)} w changed")
        del now, was
    print(f"train_scale [steps]: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB over the "
          f"placement, the remat check and {step} steps (the train "
          f"phase's unsharded run: "
          f"{unsharded_peak / 1e9:.2f} GB) [{SMI}]")
    trained = unshard_tree(shards, layout, mesh)
    del shards, opt, fn, model
    free()
    train_f32_check(seed, host, qc, tc)
    train_elastic_check(seed, host, qc, tc)
    train_serve_check(seed, trained)
    del trained
    train_pipeline_check(seed, host)


# ---------------------------------------------------------------------------
# families phase: paligemma-3b (vlm) and musicgen-large (audio), dense cache
# ---------------------------------------------------------------------------

# Float32 copies (LUTs stay int8): each step of the chain through the
# kernels against its twin through the plain versions from the same cache
# state; a sequence with no near-tie argmin flip in that step gives the
# same logits (every projection the same exact int8 sum, the rest the same
# plain torch), within FAM_PLAIN_ATOL. A flipped assignment must be a near-
# tie: its two centroids' squared distances (in float64) within FLIP_REL
# of |x|^2 + |z|^2, ~100 float32 ulps of the terms that the kernel (fma
# chain) and the plain version (a matmul) sum in other orders.
FAM_PLAIN_ATOL = 1e-4
FLIP_REL = 1e-5
# decode against forward: the JAX package's tolerances for that
# (tests/test_models.py: 3e-4 for the prefill, 5e-3 for a decode step);
# a forward's B1 input in a row that no differing assignment has reached
# is the chain's within FWD_X_REL of its norm (only the order of the
# attention and ``in_proj`` sums differs)
FAM_FORWARD_TOL = (3e-4, 5e-3)
FWD_X_REL = 1e-4


def family_batch(cfg, rows, length, seed, step):
    """A SyntheticDataset batch of the family's kind on the card: vlm
    patch embeddings and ``length`` text tokens; audio ``length`` frames
    and their labels."""
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    return SyntheticDataset(cfg, rows, prefix + length, seed=seed,
                            device=DEV).batch(step)


def family_chain(model, params, qc, prompt, frames=None, spare=0):
    """The dense-cache serve of a vlm or audio model: prefill ``prompt``
    (a batch dict), then FAM_STEPS decode steps, each fed the next of
    ``frames`` (audio, (B, FAM_STEPS, D)) or else greedily the argmax of
    the step before (vlm). The cache keeps ``spare`` rows more. Returns (the logits of the prefill and of
    each step, the inputs fed, prefill s, each decode step's s, the
    cache)."""
    cfg = model.cfg
    rows = next(iter(prompt.values())).shape[0]
    n = (prompt["embeds"].shape[1] if cfg.family == "audio"
         else cfg.num_patches + prompt["tokens"].shape[1])
    cache = model.init_cache(rows, n + FAM_STEPS + spare)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, prompt, cache, qc)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    logits, inputs, times = [lg], [], []
    for t in range(FAM_STEPS):
        x = (frames[:, t:t + 1] if frames is not None
             else lg.argmax(-1)[:, None].to(torch.int32))
        t0 = time.perf_counter()
        lg, cache = model.decode(params, x, cache, qc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        logits.append(lg)
        inputs.append(x)
    return logits, inputs, t_pre, times, cache


def kernel_calls(fn, keys):
    """Run ``fn`` with every call of the kernels ``keys`` (of "b1", "b3",
    "b4") tapped: for each distinct set of operand shapes, what one call
    enqueues (``device.enqueued``, which launches it twice more). Returns
    {key: {shapes: enqueued}}."""
    seen = {k: {} for k in keys}
    saved = {k: getattr(DISPATCH[k][0], DISPATCH[k][1]) for k in keys}

    def tap(key, orig):
        def call(*a, **kw):
            sig = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))
            if sig not in seen[key]:
                seen[key][sig] = enqueued(lambda: orig(*a, **kw))
            return orig(*a, **kw)
        return call
    for k in keys:
        mod, attr, _ = DISPATCH[k]
        setattr(mod, attr, tap(k, saved[k]))
    try:
        fn()
    finally:
        for k in keys:
            setattr(DISPATCH[k][0], DISPATCH[k][1], saved[k])
    return seen


class FlipTap:
    """While entered, every B1 call (``ops.vq_amm_cuda``) is also held
    against its plain versions on the same operands: B3 gives B1's own
    assignments (bit for bit: ``b34_case``), ``ref.assign_ref`` the plain
    ones. In every row the output must be the plain gather-sum
    (``ref.lut_gemm_onehot``) over B1's own assignments, and an
    assignment that differs from the plain one must be a near-tie
    (FLIP_REL; the l2 metric). With ``keep`` each call's (x, assignments,
    z) is kept in ``kept``; ``hook``, when set, is called with them.
    :meth:`take` returns the sequences (``seqs`` of them, each a block of
    a call's rows) with a flip since the last take."""

    def __init__(self, seqs, keep=False):
        self.seqs = seqs
        self.flipped = set()
        self.calls = self.assignments = self.flips = 0
        self.worst = 0.0                      # largest relative flip gap
        self.bad = []
        self.kept = [] if keep else None
        self.hook = None

    def __enter__(self):
        self._orig = ops.vq_amm_cuda
        ops.vq_amm_cuda = self._call
        return self

    def __exit__(self, *exc):
        ops.vq_amm_cuda = self._orig

    def take(self):
        out, self.flipped = self.flipped, set()
        return out

    def _call(self, x, z, lut, scale=None, metric="l2"):
        y = self._orig(x, z, lut, scale, metric)
        idx_k = vq_assign_cuda(x, z, metric)
        idx_p = ref.assign_ref(x, z, metric)
        y_k = ref.lut_gemm_onehot(idx_k, lut, scale)
        err = float((y - y_k).abs().max())
        if err > 1e-5 * max(1.0, float(y_k.abs().max())):
            self.bad.append(f"B1 {tuple(x.shape)}: off the plain gather-sum "
                            f"over its own assignments by {err}")
        diff = idx_k != idx_p                               # (M, nc)
        self.calls += 1
        self.assignments += diff.numel()
        n = int(diff.sum())
        self.flips += n
        if n:
            r, c = diff.nonzero(as_tuple=True)
            rel = float(flip_gap(x[r, c], z[c, idx_k[r, c].long()],
                                 z[c, idx_p[r, c].long()])[0].max())
            self.worst = max(self.worst, rel)
            if metric != "l2" or rel > FLIP_REL:
                self.bad.append(f"B1 {tuple(x.shape)}: an assignment off "
                                f"the plain one by {rel:.2e} of |x|^2 + "
                                f"|z|^2 (not a near-tie)")
            self.flipped.update((r // (x.shape[0] // self.seqs)).tolist())
        if self.kept is not None:
            self.kept.append((x.clone(), idx_k, z))
        if self.hook is not None:
            self.hook(x, idx_k, z)
        return y


def flip_gap(x, a, b):
    """For inputs x (F, v) that chose centroid a over b: the gap
    |x - b|^2 - |x - a|^2 (float64) over |x|^2 + max(|a|^2, |b|^2), and
    that size."""
    x, a, b = x.double(), a.double(), b.double()
    gap = ((x - b) ** 2).sum(-1) - ((x - a) ** 2).sum(-1)
    size = (x ** 2).sum(-1) + torch.maximum((a ** 2).sum(-1),
                                            (b ** 2).sum(-1))
    return gap.abs() / size, gap, size


def chain_calls(kept, per_pass, seqs):
    """The chain's B1 calls (:class:`FlipTap` ``kept``: the prefill's
    pass, then each decode step's) laid out as the forward's: for each
    call of a pass, (x, assignments, z) over every row of the sequences,
    the prefill's then each step's."""
    check(len(kept) % per_pass == 0,
          f"the chain made {len(kept)} B1 calls, not passes of {per_pass}")
    out = []
    for i in range(per_pass):
        parts = kept[i::per_pass]
        check(all(p[2].data_ptr() == parts[0][2].data_ptr() for p in parts),
              f"B1 call {i} of a pass takes other centroids step by step")

        def seq(t):
            return torch.cat([q.reshape(seqs, -1, *q.shape[1:]) for q in t],
                             1).flatten(0, 1)
        out.append((seq([p[0] for p in parts]), seq([p[1] for p in parts]),
                    parts[0][2]))
    kept.clear()
    return out


class ChainMatch:
    """The forward's B1 calls against the chain's (:func:`chain_calls`),
    call for call and row for row. A row is clean while no assignment
    has differed, in an earlier call, at its position or before it in its
    sequence (a vlm's prefix attends both ways, so a difference there
    reaches every row). A clean row's input must be the chain's within
    FWD_X_REL of its norm, and an assignment that differs there must be
    one that input difference explains: its gap on the forward's input at
    most 2 |dx| |a - b| + FLIP_REL (|x|^2 + |z|^2). ``first[b]`` is the
    first position of sequence b that is no longer clean."""

    def __init__(self, chain, seqs, prefix):
        self.chain, self.seqs, self.prefix = chain, seqs, prefix
        self.i = self.flips = self.clean_flips = self.assignments = 0
        self.worst_dx = self.worst_gap = 0.0
        self.first = None
        self.bad = []

    def __call__(self, x, idx, z):
        if self.i == len(self.chain):
            self.bad.append(f"the forward made more than {self.i} B1 calls")
            return
        xc, ic, zc = self.chain[self.i]
        self.i += 1
        if (z.data_ptr(), x.shape) != (zc.data_ptr(), xc.shape):
            self.bad.append(f"B1 call {self.i - 1}: the forward's operands "
                            f"{tuple(x.shape)} are not the chain's "
                            f"{tuple(xc.shape)}")
            return
        s = x.shape[0] // self.seqs
        if self.first is None:
            self.first = torch.full((self.seqs,), s, device=x.device)
        rows = torch.arange(x.shape[0], device=x.device)
        clean = rows % s < self.first[rows // s]
        dx = x.double() - xc.double()
        dx_row = dx.flatten(1).norm(dim=1)[clean]
        x_row = xc.double().flatten(1).norm(dim=1)[clean]
        if dx_row.numel():
            self.worst_dx = max(self.worst_dx, float(
                (dx_row / x_row.clamp_min(1e-30)).max()))
            if bool((dx_row > FWD_X_REL * x_row).any()):
                self.bad.append(f"B1 call {self.i - 1}: a clean row's input "
                                f"off the chain's by more than {FWD_X_REL} "
                                "of its norm")
        diff = idx != ic
        self.assignments += diff.numel()
        n = int(diff.sum())
        if not n:
            return
        self.flips += n
        r, c = diff.nonzero(as_tuple=True)
        k = clean[r]
        rk, ck = r[k], c[k]
        if rk.numel():
            a, b = z[ck, idx[rk, ck].long()], z[ck, ic[rk, ck].long()]
            rel, gap, size = flip_gap(x[rk, ck], a, b)
            allowed = (2 * dx[rk, ck].norm(dim=-1)
                       * (a.double() - b.double()).norm(dim=-1)
                       + FLIP_REL * size)
            self.clean_flips += rk.numel()
            self.worst_gap = max(self.worst_gap, float(rel.max()))
            if bool((gap.abs() > allowed).any()):
                self.bad.append(f"B1 call {self.i - 1}: an assignment "
                                "differs from the chain's by more than the "
                                "input difference explains")
        pos = r % s
        pos = torch.where(pos < self.prefix, 0, pos)
        self.first.scatter_reduce_(0, r // s, pos, reduce="amin")


@contextlib.contextmanager
def replayed(chain):
    """Every B1 call takes the assignments of the chain's call at its
    place (:func:`chain_calls`) and sums them with B4: a forward then
    makes the chain's LUT sums in every row."""
    calls = iter(chain)
    orig = ops.vq_amm_cuda

    def call(x, z, lut, scale=None, metric="l2"):
        _, idx, zc = next(calls)
        check((z.data_ptr(), x.shape[0]) == (zc.data_ptr(), idx.shape[0]),
              "a replayed B1 call's operands are not the chain's")
        return ops.lut_gemm_cuda(idx, lut, scale)
    ops.vq_amm_cuda = call
    try:
        yield
    finally:
        ops.vq_amm_cuda = orig


def family_serve(model, params, qc, prompt, frames, n_proj):
    """The bf16 dense-cache serve runs of one model: fused (B1), and for
    a vlm two-pass (B3 + B4, greedy tokens equal to the fused run's).
    Each run counts its launches (PATH_LAUNCHES, 7 x layers a prefill and
    a decode step); then one more decode step counts its own, and one
    more has every kernel call's enqueue checked (ONE_KERNEL)."""
    cfg = model.cfg
    audio = cfg.family == "audio"
    runs = {"fused": (qc, ("b1",), {"b2", "b3", "b4", "b5"})}
    if not audio:
        runs["two-pass"] = (qc.replace(fuse=False), ("b3", "b4"),
                            {"b1", "b2", "b5"})
    tokens, fused = {}, None
    for run, (qc_r, keys, idle) in runs.items():
        label = f"{cfg.name} {run}"
        with torch.no_grad():
            (logits, inputs, t_pre, times, cache), wall, counts = path_run(
                label, lambda: family_chain(model, params, qc_r, prompt,
                                            frames, spare=2),
                set(keys), idle)
            check(all(bool(torch.isfinite(lg).all()) for lg in logits),
                  f"{label}: non-finite logits")
            if run == "fused":
                fused = (logits, inputs)
            want = {k: n_proj * (FAM_STEPS + 1) for k in keys}
            got = {k: counts[k] for k in keys}
            check(got == want, f"{label}: the prefill and {FAM_STEPS} "
                  f"decode steps launched {got}, expected {want}")
            x = (frames[:, -1:] if audio
                 else logits[-1].argmax(-1)[:, None].to(torch.int32))
            reset_counts()
            model.decode(params, x, cache, qc_r)
            torch.cuda.synchronize()
            step = {k: n for k, n in read_counts().items()
                    if n and not k.endswith("_grouped")}
            check(step == {k: n_proj for k in keys},
                  f"{label}: one decode step launches {step}, expected "
                  f"{n_proj} of each of {keys}")
            calls = kernel_calls(lambda: model.decode(params, x, cache, qc_r),
                                 keys)
        shapes = {k: len(v) for k, v in calls.items()}
        check(all(calls.values()) and all(
            e == ONE_KERNEL for v in calls.values() for e in v.values()),
              f"{label}: each kernel call must enqueue {ONE_KERNEL}: "
              f"{calls}")
        if not audio:
            tokens[run] = [x.flatten().tolist() for x in inputs] + [
                logits[-1].argmax(-1).tolist()]
        dec = 1e3 * np.array(times)
        print(f"families [{label}]: dense-cache prefill of {FAM_ROWS} x "
              + (f"{FAM_PROMPT['audio']} frames"
                 if audio else f"({cfg.num_patches} patches + "
                 f"{FAM_PROMPT['vlm']} tokens)")
              + f" in {1e3 * t_pre:.1f} ms, {FAM_STEPS} decode steps "
              + ("fed the next frames" if audio else "greedy")
              + f": mean {dec.mean():.1f} ms, median {np.median(dec):.1f} "
              f"ms ({FAM_ROWS * FAM_STEPS / (1e-3 * dec.sum()):.1f} tokens/s"
              f" decoded); run launches {PATH_LAUNCHES[label]}; one decode "
              f"step launches {step}, every call one kernel "
              f"({ONE_KERNEL}) at each of {shapes} operand shapes [{SMI}]")
    if not audio:
        check(tokens["two-pass"] == tokens["fused"],
              f"{cfg.name}: two-pass greedy tokens differ from the fused "
              "run's")
        print(f"families [{cfg.name}]: two-pass greedy tokens equal the "
              f"fused run's ({FAM_ROWS} rows x {FAM_STEPS + 1} tokens)")
    return fused


def family_mesh(model, params, qc, prompt, ref, fed):
    """The dense-cache serve over FAM_MESH (paligemma-3b: its one kv head
    takes the head_dim layout, the image prefix re-sharded by sequence;
    musicgen-large: heads, its ``heads`` sharded on V): the prefill and
    FAM_MESH_STEPS decode steps fed the unsharded chain's inputs
    (``fed``), each call's logits (gathered) against that chain's
    (``ref``): relative L2 by row, and argmax agreement with the
    disagreeing rows that are near-ties (FAM_MESH_TIE) counted apart. In
    float32 the two must agree (every row within LOGIT_ROW_REL_TOL, every
    argmax equal): the sharded program is the same function. In bf16
    they are printed and held finite: another order of float32 sums
    (the head_dim layout's partial scores, a product's split over the
    head_dim) moves a bf16 value by an ulp, which can flip a near-tied
    centroid assignment of a later projection and so the rest of that
    row (PR 32: bit for bit in float32, rows off by ~0.1 in bf16 from a
    step on). Prints the collectives a decode step."""
    cfg = model.cfg
    strict = cfg.dtype == "float32"
    mesh = make_test_mesh(FAM_MESH, device=DEV)
    shards = shard_tree(params, serving_layout(params, cfg, FAM_MESH[1]),
                        mesh)
    n = ref[0].shape[0]
    rows = (prompt["embeds"].shape[1] if cfg.family == "audio"
            else cfg.num_patches + prompt["tokens"].shape[1])
    caches = shard_cache(model.init_cache(n, rows + FAM_MESH_STEPS), cfg, n,
                         mesh)
    runner = tcol.RankRunner(mesh=mesh)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = runner.run(lambda tp: model.prefill(shards[tp.me], prompt,
                                                   caches[tp.me], qc))
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        got, caches = [outs[0][0]], [o[1] for o in outs]
        c0, times = runner.collectives, []
        for x in fed[:FAM_MESH_STEPS]:
            t0 = time.perf_counter()
            outs = runner.run(lambda tp: model.decode(shards[tp.me], x,
                                                      caches[tp.me], qc))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got.append(outs[0][0])
            caches = [o[1] for o in outs]
    per_step = (runner.collectives - c0) / FAM_MESH_STEPS
    del shards, caches, outs
    label = f"families [{cfg.name} over {FAM_MESH}, {cfg.dtype}]"
    worst, agree, ties, total = [], 0, 0, 0
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.float().reshape(-1, g.shape[-1])
        r = r.float().reshape(-1, r.shape[-1])
        check(g.shape == r.shape and bool(torch.isfinite(g).all()),
              f"{label} call {i}: logits {tuple(g.shape)} or not finite")
        rel = ((g - r).norm(dim=-1) / r.norm(dim=-1)).tolist()
        worst.append(max(rel))
        a_g, a_r = g.argmax(-1), r.argmax(-1)
        total += len(rel)
        agree += int((a_g == a_r).sum())
        for row in (a_g != a_r).nonzero().flatten().tolist():
            gap = float(r[row, a_r[row]] - r[row, a_g[row]])
            ties += gap <= FAM_MESH_TIE * float(r[row].abs().max())
        if strict:
            check(max(rel) <= LOGIT_ROW_REL_TOL and torch.equal(a_g, a_r),
                  f"{label} call {i}: rows off the unsharded run's by "
                  f"{rel} (bound {LOGIT_ROW_REL_TOL}), argmax equal "
                  f"{torch.equal(a_g, a_r)}")
    dec = 1e3 * np.array(times)
    print(f"{label}: "
          + ("head_dim layout" if hd_fallback(cfg, FAM_MESH[1]) else
             "heads layout, heads sharded on V")
          + f"; prefill {1e3 * t_pre:.1f} ms, {FAM_MESH_STEPS} decode steps "
          f"fed the unsharded chain's inputs: mean {dec.mean():.1f} ms; "
          f"{per_step:.1f} collectives a decode step; logits against the "
          f"unsharded run: worst row relative L2 a call "
          f"{[float(f'{w:.3g}') for w in worst]}; argmax equal in {agree} "
          f"of {total} rows, of the others {ties} near-ties (within "
          f"{FAM_MESH_TIE} of the row's largest |logit|) [{SMI}]")


def family_mesh_train(cfg, seed):
    """One lut_train gradient over FAM_MESH in float32, full width, cut to
    FAM_MESH_LAYERS layers: the sharded step's gathered gradient and loss
    against the unsharded ``loss_and_grads`` on the same params and batch,
    the sharded run on the unsharded run's centroid assignments
    (``_rank_assignments``): the loss and every leaf within relative L2
    TRAIN_F32_REL."""
    c = cfg.replace(num_layers=FAM_MESH_LAYERS, dtype="float32")
    model = Model(c, device=DEV)
    qt = QuantConfig(mode="lut_train", v=V, c=C, metric="l2")
    params = model.init(torch.Generator(device=DEV).manual_seed(seed + 2),
                        qt)
    batch = family_batch(c, 2, FAM_PROMPT[c.family], seed, 4)
    with _rank_assignments() as rec:
        loss, _, grads = loss_and_grads(model, params, batch, qt)
    mesh = make_test_mesh(FAM_MESH, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _rank_assignments(replay=rec[0]):
        s_loss, _, s_grads, _, coll = sharded_grads(model, params, batch, qt,
                                                    mesh)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    want = dict(tree_flatten_with_path(grads))
    got = dict(tree_flatten_with_path(s_grads))
    check(set(got) == set(want), f"families [{c.name} lut_train over "
          f"{FAM_MESH}]: gradient leaves differ")
    rels = {p: _rel(got[p], want[p]) for p in want
            if float(want[p].float().norm()) > 0}
    worst = max(rels, key=rels.get)
    l_rel = abs(float(s_loss) - float(loss)) / abs(float(loss))
    print(f"families [{c.name} lut_train over {FAM_MESH}, {FAM_MESH_LAYERS} "
          f"layers, float32]: loss {float(s_loss):.6f} (unsharded "
          f"{float(loss):.6f}, {l_rel:.1e}); {len(rels)} gradient leaves, "
          f"the farthest {worst} at relative L2 {rels[worst]:.2e}; "
          f"{coll} collectives; {1e3 * t_s:.1f} ms sharded [{SMI}]")
    check(l_rel <= TRAIN_F32_REL and rels[worst] <= TRAIN_F32_REL,
          f"families [{c.name} lut_train over {FAM_MESH}]: loss {l_rel}, "
          f"gradient {worst} {rels[worst]} beyond {TRAIN_F32_REL}")
    del model, params, grads, s_grads
    free()


def chain_forward(model, params, qc, prompt, frames, fed):
    """The model's forward over the prompt and what a chain fed it, at
    the chain's positions (the prompt's last row, then each step's)."""
    if model.cfg.family == "audio":
        whole = {"embeds": torch.cat([prompt["embeds"], frames], 1)}
        first = prompt["embeds"].shape[1] - 1
    else:
        whole = {"patch_embeds": prompt["patch_embeds"],
                 "tokens": torch.cat([prompt["tokens"]] + fed, 1)}
        first = model.cfg.num_patches + prompt["tokens"].shape[1] - 1
    full, _ = model.forward(params, whole, qc)
    return full[:, first:].clone(), first


def forward_agreement(chain, full):
    """Each of the chain's logits (the prefill's, then each decode
    step's) against the forward's at its position, at FAM_FORWARD_TOL:
    (within, argmax equal), each (steps, sequences), and the largest
    |difference| a step."""
    ok, same, mx = [], [], []
    for i, lg in enumerate(chain):
        tol = FAM_FORWARD_TOL[i > 0]
        want = full[:, i].float()
        d = (lg.float() - want).abs()
        ok.append((d <= tol + tol * want.abs()).reshape(FAM_ROWS, -1).all(1))
        same.append((lg.argmax(-1) == want.argmax(-1))
                    .reshape(FAM_ROWS, -1).all(1))
        mx.append(float(d.max()))
    return torch.stack(ok), torch.stack(same), mx


def family_float32(model32, params32, qc, prompt, frames):
    """Float32 (LUTs int8), every B1 call tapped (:class:`FlipTap`): the
    prefill and FAM_STEPS decode steps through the kernels, each step's
    twin through the plain versions (``plain_kernels``) from the same
    cache state and inputs; a sequence with no flip in that step must
    give the plain logits within FAM_PLAIN_ATOL and the same argmax.
    Then the model's forward over the same sequences, tapped too, its B1
    calls held against the chain's (:class:`ChainMatch`): the chain's
    logits must be the forward's at FAM_FORWARD_TOL in every row still
    clean, and in every row those of a forward that takes the chain's
    assignments (:func:`replayed`)."""
    cfg = model32.cfg
    audio = cfg.family == "audio"
    n = (prompt["embeds"].shape[1] if audio
         else cfg.num_patches + prompt["tokens"].shape[1])
    tap = FlipTap(FAM_ROWS, keep=True)
    steps, fed = [], []
    with torch.no_grad():
        with plain_kernels():
            lg_p, _ = model32.prefill(params32, prompt,
                                      model32.init_cache(FAM_ROWS, n), qc)
        cache = model32.init_cache(FAM_ROWS, n + FAM_STEPS)
        with tap:
            lg, cache = model32.prefill(params32, prompt, cache, qc)
        steps.append((lg, lg_p, tap.take()))
        for t in range(FAM_STEPS):
            x = (frames[:, t:t + 1] if audio
                 else lg.argmax(-1)[:, None].to(torch.int32))
            twin = {"layers": {k: v.clone()
                               for k, v in cache["layers"].items()},
                    "pos": cache["pos"]}
            with plain_kernels():
                lg_p, _ = model32.decode(params32, x, twin, qc)
            del twin
            with tap:
                lg, cache = model32.decode(params32, x, cache, qc)
            steps.append((lg, lg_p, tap.take()))
            fed.append(x)
        del cache
        chain_tap = (tap.calls, tap.flips, tap.assignments)
        chain = chain_calls(tap.kept, 7 * cfg.num_layers, FAM_ROWS)
        tap.kept = None
        tap.hook = match = ChainMatch(chain, FAM_ROWS,
                                      0 if audio else cfg.num_patches)
        with tap:
            full, first = chain_forward(model32, params32, qc, prompt,
                                        frames, fed)
        tap.hook = None
        with replayed(chain):
            full_r, _ = chain_forward(model32, params32, qc, prompt, frames,
                                      fed)
        calls, n_chain = match.i, len(chain)
        del chain
    torch.cuda.synchronize()
    clean = ok = same = off = off_same = 0
    worst_clean = worst_off = 0.0
    for lg, lg_p, seqs in steps:
        d = (lg.float() - lg_p.float()).abs().reshape(FAM_ROWS, -1).amax(1)
        am = (lg.argmax(-1) == lg_p.argmax(-1)).reshape(FAM_ROWS, -1).all(1)
        for b in range(FAM_ROWS):
            if b in seqs:
                off += 1
                off_same += bool(am[b])
                worst_off = max(worst_off, float(d[b]))
            else:
                clean += 1
                ok += float(d[b]) <= FAM_PLAIN_ATOL
                same += bool(am[b])
                worst_clean = max(worst_clean, float(d[b]))
    print(f"families [{cfg.name}] float32 kernels vs plain versions, "
          f"step by step from one cache: {chain_tap[0]} B1 calls, "
          f"{chain_tap[1]} of {chain_tap[2]} assignments flipped at near-"
          f"ties; {ok}/{clean} rows without a flip within {FAM_PLAIN_ATOL} "
          f"(max |diff| {worst_clean:.2e}), argmax equal in {same}/{clean}; "
          f"{off} rows with a flip in their step (max |diff| "
          f"{worst_off:.3g}, argmax equal in {off_same}); the forward's "
          f"{tap.calls - chain_tap[0]} B1 calls: {tap.flips - chain_tap[1]} "
          f"of {tap.assignments - chain_tap[2]} flipped; largest gap of "
          f"all {tap.worst:.2e} of |x|^2 + |z|^2 [{SMI}]")
    check(not tap.bad, f"{cfg.name} float32 B1 against plain: "
          f"{tap.bad[:3]}")
    check(ok == clean and same == clean,
          f"{cfg.name} float32 kernels vs plain: {ok} / {same} of {clean} "
          "rows without a flip within tolerance / with the same argmax")

    chain_lg = [lg for lg, _, _ in steps]
    f_ok, f_same, f_max = forward_agreement(chain_lg, full)
    r_ok, r_same, r_max = forward_agreement(chain_lg, full_r)
    reached = (match.first.tolist() if match.first is not None
               else [None] * FAM_ROWS)
    pos = first + torch.arange(len(steps), device=full.device)[:, None]
    kept = (pos < match.first[None, :] if match.first is not None
            else torch.zeros_like(f_ok))
    rows = f_ok.numel()
    print(f"families [{cfg.name}] float32 int8-LUT forward vs the chain: "
          f"{calls} B1 calls matched call for call; {match.flips} of "
          f"{match.assignments} assignments differ, {match.clean_flips} in "
          f"clean rows (largest gap {match.worst_gap:.2e} of |x|^2 + "
          f"|z|^2, each within what its input's difference explains; clean "
          f"inputs within {match.worst_dx:.2e} of their norm); first "
          f"position reached by a difference, by sequence {reached} (chain "
          f"rows from position {first}); {int(kept.sum())}/{rows} rows "
          f"clean, {int(f_ok[kept].sum())} of them within {FAM_FORWARD_TOL}"
          f" and {int(f_same[kept].sum())} with the same argmax (all rows: "
          f"{int(f_ok.sum())} within, max |diff| {max(f_max):.2e}); the "
          f"forward on the chain's assignments: {int(r_ok.sum())}/{rows} "
          f"within, argmax equal in {int(r_same.sum())}/{rows}, max |diff| "
          f"by step {[f'{m:.1e}' for m in r_max]} [{SMI}]")
    check(not match.bad and calls == n_chain,
          f"{cfg.name} forward against the chain: {calls} of {n_chain} B1 "
          f"calls; {match.bad[:3]}")
    check(bool(f_ok[kept].all()) and bool(f_same[kept].all()),
          f"{cfg.name} int8-LUT decode vs forward: rows no differing "
          "assignment reached off tolerance or argmax")
    check(bool(r_ok.all()) and bool(r_same.all()),
          f"{cfg.name} int8-LUT decode vs the forward on the chain's "
          f"assignments: {int(r_ok.sum())} / {int(r_same.sum())} of {rows} "
          "rows within tolerance / with the same argmax")


def batch_tokens(batch):
    """The tokens a batch trains on, for tokens/s: its text tokens (a
    vlm's image patches, which the loss does not predict, are not
    counted), or an audio batch's frames."""
    if "embeds" in batch:
        return batch["embeds"].shape[0] * batch["embeds"].shape[1]
    return batch["tokens"].numel()


def family_train(cfg, seed):
    """LUTBoost on the full-width model in bf16: stage 1 (``convert``
    through the dense forward on one batch of the family's kind: every
    block projection's z changes; ``in_proj`` / ``heads`` / ``embed``
    carry no z and stay the same tensors), then one ``loss_and_grads`` in
    lut_train: loss, ce, recon and the gradient norm finite, recon > 0."""
    qt = QuantConfig(mode="lut_train", v=V, c=C, metric="l2")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed + 1),
                        qt)
    rows, length = FAM_FORWARD[0], FAM_FORWARD[1][cfg.family]
    calib = family_batch(cfg, rows, length, seed, 2)
    batch = family_batch(cfg, rows, length, seed, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = convert(lambda p, b: model.forward(p, b, DENSE), params, calib,
                   qt, seed=seed)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    n_proj = 7 * cfg.num_layers
    changed = sum(not torch.equal(a["z"], b["z"]) for a, b in
                  zip(_lut_layers(params), _lut_layers(conv)))
    dense = [k for k in ("embed", "in_proj", "heads") if k in params]
    kept = all(conv[k] is params[k] for k in dense)
    del params
    free()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, met, grads = loss_and_grads(model, conv, batch, qt)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    gn = math.sqrt(sum(float(g.float().pow(2).sum())
                       for g in _leaves(grads)))
    vals = {k: float(met[k]) for k in ("loss", "ce", "recon")}
    tokens = batch_tokens(batch)
    print(f"families [{cfg.name} lut_train]: convert ({rows} x "
          + (f"{length} frames" if cfg.family == "audio" else
             f"({cfg.num_patches} patches + {length} tokens)")
          + f" through the dense forward) {t_conv:.2f} s, z changed in "
          f"{changed} of {n_proj}, {dense} kept; one loss_and_grads "
          f"{1e3 * t_step:.1f} ms ({tokens / t_step:.0f} training tokens/s"
          f", {tokens} {'frames' if cfg.family == 'audio' else 'text tokens'}"
          f" a batch): loss {vals['loss']:.4f} (ce {vals['ce']:.4f}, recon "
          f"{vals['recon']:.4f}), grad_norm {gn:.4g}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{SMI}]")
    check(changed == n_proj and kept,
          f"{cfg.name} convert: z changed in {changed} of {n_proj}, dense "
          f"leaves kept: {kept}")
    check(all(math.isfinite(v) for v in vals.values()) and math.isfinite(gn)
          and vals["recon"] > 0,
          f"{cfg.name} lut_train: loss {vals}, grad_norm {gn}")
    del conv, grads, model
    free()


def family_run(cfg, seed):
    """One full-width, full-depth vlm or audio config from a seed (int8
    LUTs, v=V c=C l2, bf16): forward on FAM_FORWARD, the dense-cache serve
    runs (:func:`family_serve`), the float32 checks
    (:func:`family_float32`), then LUTBoost (:func:`family_train`)."""
    qc = QuantConfig(mode="lut_infer", v=V, c=C, metric="l2",
                     lut_dtype="int8")
    audio = cfg.family == "audio"
    n_proj = 7 * cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), qc)
    torch.cuda.synchronize()
    pbytes = sum(nbytes(t) for t in _leaves(params))
    extra = (f"{cfg.num_codebooks} codebook heads" if audio
             else f"{cfg.num_patches} patches a prefix")
    print(f"families [{cfg.name}]: full-width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} kv, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {extra}; "
          f"{cfg.param_count() / 1e9:.3f} B params) lut_infer int8 v={V} "
          f"c={C} built on the card in {time.perf_counter() - t0:.1f} s, "
          f"{pbytes / 1e9:.2f} GB of params [{SMI}]")

    rows, length = FAM_FORWARD[0], FAM_FORWARD[1][cfg.family]
    batch = family_batch(cfg, rows, length, seed, 0)
    with torch.no_grad():
        model.forward(params, batch, qc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = model.forward(params, batch, qc)
        torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    want = ((rows, length, cfg.num_codebooks, cfg.vocab_size) if audio
            else (rows, cfg.num_patches + length, cfg.vocab_size))
    check(tuple(lg.shape) == want and bool(torch.isfinite(lg).all()),
          f"{cfg.name} forward: logits {tuple(lg.shape)} (expected {want}) "
          "or not finite")
    print(f"families [{cfg.name}]: forward of {rows} x "
          + (f"{length} frames" if audio else
             f"({cfg.num_patches} patches + {length} tokens)")
          + f" ({rows * want[1]} rows a projection) in {1e3 * t_fwd:.1f} ms,"
          f" logits {want} [{SMI}]")
    del lg, batch

    p_len = FAM_PROMPT[cfg.family]
    serve_in = family_batch(cfg, FAM_ROWS,
                            p_len + (FAM_STEPS if audio else 0), seed, 1)
    if audio:
        prompt = {"embeds": serve_in["embeds"][:, :p_len]}
        frames = serve_in["embeds"][:, p_len:]
    else:
        prompt, frames = serve_in, None
    logits, fed = family_serve(model, params, qc, prompt, frames, n_proj)
    family_mesh(model, params, qc, prompt, logits, fed)
    del logits, fed
    print(f"families [{cfg.name}]: peak device memory (init, forward, "
          f"serving) {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{SMI}]")
    params32 = _map_float(params, torch.float32)
    del params
    free()
    model32 = Model(cfg.replace(dtype="float32"), device=DEV)
    with torch.no_grad():
        ref32, fed32, *_ = family_chain(model32, params32, qc, prompt,
                                        frames)
    family_mesh(model32, params32, qc, prompt, ref32, fed32)
    del ref32, fed32
    family_float32(model32, params32, qc, prompt, frames)
    del params32, model32, model
    free()
    family_train(cfg, seed)
    family_mesh_train(cfg, seed)


def families_phase(seed, cfgs=None):
    """paligemma-3b (vlm) and musicgen-large (audio) at full width and
    depth (:func:`family_run` each, freed before the next)."""
    for cfg in cfgs or (paligemma_3b.config(), musicgen_large.config()):
        with phase(f"families, {cfg.name}"):
            family_run(cfg, seed)
        free()


# ---------------------------------------------------------------------------
# analysis phase: the sync guard and the entry points' invariants on the card
# ---------------------------------------------------------------------------

# The guard's warmup: 3 of MAIN_LOAD's requests, 8 tokens each, prompts
# from another seed. Its shape classes are the steady state's (8 decode
# lanes, 32-token chunks, a temperature slot); every kernel is built and
# loaded before the phase, so it has nothing else to pay.
ANALYSIS_WARMUP = dataclasses.replace(MAIN_LOAD, n=3, new=8, hot=1)
ANALYSIS_WARMUP_SEED = 1000


def analysis_run(model, params, qc, seed, label, launched, idle, spec=None,
                 mesh=None, keep=None):
    """The sync guard over one engine: ANALYSIS_WARMUP, then MAIN_LOAD
    (its requests appended to ``keep`` when given). Fails on any finding:
    a sync inside a model entry point, a read count off its expected one,
    a steady-state kernel build, a float64 op."""
    vocab = model.cfg.vocab_size
    eng = Engine(model, params, qc, **engine_kw(seed=seed, spec_decode=spec,
                                                mesh=mesh))
    warm = load_requests(ANALYSIS_WARMUP, seed + ANALYSIS_WARMUP_SEED,
                         vocab)
    steady = load_requests(MAIN_LOAD, seed, vocab)
    rep, wall, counts = path_run(
        f"analysis {label}", lambda: run_sync_guard(eng, warm, steady),
        launched, idle)
    print(f"analysis [{label}]: {rep.summary()} [{SMI}]")
    print(f"analysis [{label}]: launches (warmup + steady) "
          f"{ {k: v for k, v in counts.items() if k in WRAPPERS} }, "
          f"{wall:.1f} s [{SMI}]")
    for n, op, path, line, ph in rep.debug_sites():
        print(f"analysis [{label}]: sync outside the read: {n} x {op} at "
              f"{path}:{line} ({ph}) [{SMI}]")
    for f in rep.findings:
        print(f"analysis [{label}]: FINDING {f.render()}")
    check(rep.ok, f"analysis [{label}]: {len(rep.findings)} finding(s)")
    check(all(r.done for r in steady), f"{label}: steady requests unserved")
    if keep is not None:
        keep.extend(steady)
    del eng
    return rep.counts


# ---------------------------------------------------------------------------
# launch phase: the dry run, one decode step's cost on the card and on meta,
# the head_dim layout on the card
# ---------------------------------------------------------------------------

#: (arch, shape, multi-pod) of the dry-run cells the phase runs on meta
LAUNCH_CELLS = (("qwen1.5-4b", "decode_32k", False),
                ("qwen1.5-4b", "train_4k", False),
                ("yi-9b", "decode_32k", True))
#: one H100's device memory, bytes
CARD_BYTES = 80e9
#: the head_dim layout's run: qwen1.5-4b cut to FALLBACK_LAYERS layers over
#: a (1, 8) mesh of the one card (20 heads and 20 kv heads over 8 ranks:
#: head_dim 128 / 8 = 16 a rank), a dense-cache prefill of FALLBACK_BATCH x
#: FALLBACK_PROMPT tokens and FALLBACK_STEPS decode steps
FALLBACK_MESH = (1, 8)
FALLBACK_LAYERS = 4
FALLBACK_BATCH, FALLBACK_PROMPT, FALLBACK_STEPS = 4, 64, 8


def fullest_decode_step(eng):
    """A ``serve`` hook: the inputs of the decode call with the most lanes
    decoding (its tokens, positions and page table, cloned) in
    ``eng.decode_args``."""
    call = eng._decode_call
    eng.decode_args, live = None, [0]

    def grab(toks, positions):
        n = len(eng.scheduler.decode_slots())     # host state: no sync
        if n > live[0]:
            live[0] = n
            eng.decode_args = (toks.clone(), positions.clone(),
                               eng.kv.table_device().clone())
        return call(toks, positions)
    eng._decode_call = grab


def launch_phase(model, params, qc, seed, eng):
    """(a) the dry run (``repro_torch.launch``, meta tensors, no card) of
    LAUNCH_CELLS: each must be ``ok``; its roofline and memory, and
    whether the rank's arguments plus temp fit the card. (b) one decode
    step of the serve phase's fused engine ``eng`` (full-width
    qwen1.5-4b, int8 LUTs; :func:`step_cost`). (c) the head_dim layout on
    the card (:func:`fallback_run`)."""
    for arch, shape, multi in LAUNCH_CELLS:
        res = run_cell(arch, shape, make_production_mesh(multi_pod=multi),
                       "lut", verbose=False)
        check(res["status"] == "ok", f"dry run {arch} x {shape}: {res}")
        mem = res["memory"]
        need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        print(f"launch [dry run {arch} x {shape} x {res['mesh']}]: trace "
              f"{res['trace_s']} s on the host, kernel calls "
              f"{res['kernels']}; roofline {json.dumps(res['roofline'])}; "
              f"memory {json.dumps(mem)}; arguments + temp "
              f"{need / 1e9:.2f} GB {'fit' if need <= CARD_BYTES else 'do not fit'}"  # noqa: E501
              f" in {CARD_BYTES / 1e9:.0f} GB [{SMI}]")
    step_cost(model, qc, eng)
    fallback_run(model, params, qc, seed)


def step_cost(model, qc, eng):
    """Part (b) of :func:`launch_phase`: the decode call of ``eng``'s run
    with the most lanes decoding (:func:`fullest_decode_step`), on its
    pool now, counted by ``program_cost`` on the card and on meta copies
    of its params, pool and inputs: flops, CUDA-core ops, bytes and
    kernel calls must be equal. Beside it the step's roofline-ideal time
    at H100 peaks (``model_flops_for`` / ``model_bytes_for``) and its
    measured time (median of 5, host clock, synchronised)."""
    cfg = model.cfg
    check(eng.decode_args is not None, "step cost: no decode step")
    toks, positions, table = eng.decode_args
    slots, max_seq = eng.num_slots, eng.max_seq

    def card_step():
        return eng._run(lambda p, kv, loc: model.decode_paged(
            p, loc(toks), kv, loc(table), loc(positions), qc))
    card_step()
    torch.cuda.synchronize()
    card = program_cost(card_step)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        card_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(times))

    def meta(t):
        return t.to("meta")
    with torch.no_grad():
        dry = program_cost(Model(cfg, device="meta").decode_paged,
                           tree_map(meta, eng.params[0]), meta(toks),
                           tree_map(meta, eng.kv.pools[0]), meta(table),
                           meta(positions), qc)
    fields = ("flops", "core_ops", "bytes")
    for f in fields:
        check(getattr(card, f) == getattr(dry, f),
              f"step cost: {f} {getattr(card, f)} on the card, "
              f"{getattr(dry, f)} on meta")
    check(dict(card.kernels) == dict(dry.kernels),
          f"step cost: kernel calls {dict(card.kernels)} on the card, "
          f"{dict(dry.kernels)} on meta")
    param_bytes = float(nbytes(*_leaves(eng.params[0])))
    cache_bytes = float(nbytes(*_leaves(eng.kv.pools[0])))
    rep = roofline.analyze(
        card, 1, roofline.model_flops_for(cfg, "decode", slots, max_seq),
        roofline.model_bytes_for(cfg, "decode", slots, max_seq,
                                 param_bytes, cache_bytes))
    print(f"launch [step cost {cfg.name} fused, {slots} slots at "
          f"{positions.tolist()}]: card == meta: flops {card.flops:.6g}, "
          f"CUDA-core ops {card.core_ops:.6g}, bytes {card.bytes:.6g}, "
          f"kernel calls {dict(card.kernels)}; bound of the counted step "
          f"{1e3 * max(rep.t_compute, rep.t_memory):.3f} ms "
          f"({rep.bottleneck}); roofline-ideal step (model_flops_for / "
          f"model_bytes_for: {param_bytes / 1e9:.3f} GB params, "
          f"{cache_bytes / 1e9:.3f} GB pool) {1e3 * rep.t_ideal:.3f} ms; "
          f"measured step {step_ms:.2f} ms (median of 5, host clock, "
          f"synchronised); share of the roofline "
          f"{rep.t_ideal / (step_ms / 1e3):.4f} [{SMI}]")
    print("launch [step cost]: costliest lines by bytes: " + "; ".join(
        f"{r['op']} @ {r['site']} x{r['count']}: {r['bytes'] / 1e6:.1f} MB"
        for r in card.top_cost_lines(6)))


def fallback_run(model, params, qc, seed):
    """Part (c) of :func:`launch_phase`: qwen1.5-4b cut to FALLBACK_LAYERS
    layers, int8 LUTs (B1 on every rank's shards), over a FALLBACK_MESH
    mesh of the one card, where its 20 kv heads do not divide the 8 ranks
    (the head_dim layout): a dense-cache prefill and FALLBACK_STEPS decode
    steps fed the unsharded run's greedy tokens, every step's logits held
    against the unsharded run's by the logit check's row rule."""
    cut, cut_params = cut_depth(model, params, FALLBACK_LAYERS)
    cfg = cut.cfg
    mesh = make_test_mesh(FALLBACK_MESH, device=DEV)
    check(hd_fallback(cfg, mesh.shape["model"]),
          f"{cfg.name} over {FALLBACK_MESH} does not take the head_dim layout")
    rng = np.random.default_rng(seed + 30)
    b, s, n = FALLBACK_BATCH, FALLBACK_PROMPT, FALLBACK_STEPS
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).to(DEV)
    counts0 = vq_amm_cuda.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = cut.init_cache(b, s + n)
        lg, cache = cut.prefill(cut_params, {"tokens": prompt}, cache, qc)
        ref, toks = [lg.float()], [lg.argmax(-1)]
        for _ in range(n):
            lg, cache = cut.decode(cut_params, toks[-1][:, None].int(),
                                   cache, qc)
            ref.append(lg.float())
            toks.append(lg.argmax(-1))
        del cache
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        shards = shard_tree(cut_params, serving_layout(cut_params, cfg,
                                                       mesh.shape["model"]),
                            mesh)
        caches = shard_cache(cut.init_cache(b, s + n), cfg, b, mesh)
        runner = tcol.RankRunner(mesh=mesh)
        launches0 = vq_amm_cuda.launches
        t0 = time.perf_counter()
        outs = runner.run(lambda tp: cut.prefill(
            shards[tp.me], {"tokens": prompt}, caches[tp.me], qc))
        got, caches = [outs[0][0].float()], [o[1] for o in outs]
        for i in range(n):
            t = toks[i][:, None].int()
            outs = runner.run(lambda tp: cut.decode(shards[tp.me], t,
                                                    caches[tp.me], qc))
            got.append(outs[0][0].float())
            caches = [o[1] for o in outs]
        torch.cuda.synchronize()
        t_tp = time.perf_counter() - t0
    launches = vq_amm_cuda.launches - launches0
    allowed = LOGIT_ROWS_OFF[cfg.dtype]
    worst = []
    for step, (a, r) in enumerate(zip(got, ref)):
        check(bool(torch.isfinite(a).all()), f"fallback step {step}: "
              "non-finite logits")
        rel = ((a - r).norm(dim=-1) / r.norm(dim=-1)).tolist()
        agreeing = sum(x <= LOGIT_ROW_REL_TOL for x in rel)
        worst.append(max(rel))
        check(agreeing >= b - allowed,
              f"fallback step {step}: {agreeing} of {b} rows within "
              f"relative L2 {LOGIT_ROW_REL_TOL}, rows {rel}")
    sharded_toks = [g.argmax(-1).tolist() for g in got]
    print(f"launch [head_dim layout {cfg.name}, {FALLBACK_LAYERS} layers over "
          f"{FALLBACK_MESH}, {cfg.num_kv_heads} kv heads, head_dim "
          f"{cfg.head_dim // mesh.shape['model']} a rank]: prefill {b} x {s} "
          f"+ {n} decode steps against the unsharded run: every step's rows "
          f"within relative L2 {LOGIT_ROW_REL_TOL} (all but {allowed} "
          f"allowed), worst row a step {[round(w, 5) for w in worst]}; "
          f"greedy tokens sharded {sharded_toks} unsharded "
          f"{[t.tolist() for t in toks]}; B1 launches {launches} "
          f"({launches0 - counts0} unsharded); {t_tp:.2f} s sharded, "
          f"{t_one:.2f} s unsharded (host clock) [{SMI}]")
    del shards, caches, runner
    free()


# ---------------------------------------------------------------------------
# attention phase: bounded-memory attention (the chunked online softmax,
# the block-local window path, a dense cache read as a view of its rows)
# ---------------------------------------------------------------------------

#: tokens of the long whole-sequence layer and rows of the long decode's
#: dense cache
ATTN_LONG = 32768
#: tokens of the comparisons against one float32 softmax, and the window
#: of the block-local form there (gemma3-4b's)
ATTN_CMP, ATTN_WINDOW = 4096, 1024
#: relative L2 of the chunked and the block-local forms against a float32
#: one softmax of the same q, k, v: in bf16, and in float32
ATTN_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
#: relative L2 of the chunked backward's float32 q / k / v gradients
#: against autograd of the float32 one softmax
ATTN_GRAD_REL = 1e-5
#: one float32 score tensor of the one-softmax form over ATTN_LONG tokens
#: at qwen1.5-4b's 20 heads, GB
ONE_SOFTMAX_GB = 20 * ATTN_LONG ** 2 * 4 / 1e9
#: the train step of the phase: qwen1.5-4b cut to this depth, one row of
#: this many tokens
ATTN_TRAIN_LAYERS, ATTN_TRAIN_SEQ = 2, 4096


def one_softmax(q, k, v, window=0):
    """Float32 attention of q (B, S, H, D) over k / v (B, S, KVH, D) in one
    softmax (causal, within ``window`` when it is > 0): the plain
    yardstick, differentiable."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * d ** -0.5
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask = mask & (i[None, :] > i[:, None] - window)
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(b, s, h, d)


def event_ms(fn):
    """(fn's result, its device ms: CUDA events around one call)."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def peak_gb(fn):
    """(fn's result, the card's peak allocated GB during the call above
    what was allocated before it, its device ms)."""
    free()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, ms = event_ms(fn)
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9, ms


def attention_phase(model, params, qc, seed):
    """Bounded-memory attention on the card: (a) one full-width
    qwen1.5-4b attention layer (int8 LUTs, bf16) over an ATTN_LONG-token
    whole sequence through ``layers.attention`` (the chunked online
    softmax), its peak beside the one float32 score tensor the one
    softmax would need; (b) the chunked form (qwen1.5-4b heads) and the
    block-local form (gemma3-4b heads, window ATTN_WINDOW) at ATTN_CMP tokens
    against a float32 one softmax of the same q, k, v, in bf16 and in
    float32, and the chunked backward's float32 gradients against
    autograd of it; (c) the peak of a qwen1.5-4b train step cut to
    ATTN_TRAIN_LAYERS layers at 1 x ATTN_TRAIN_SEQ tokens, chunked
    beside ``attn_impl="naive"``; (d) one dense-cache decode step at
    ATTN_LONG rows of full-width qwen1.5-4b, counted by ``program_cost``
    on the card and on meta copies (flops, bytes, kernel calls equal)."""
    cfg = model.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 40)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEV)).to(
            dtype)

    # (a) the long whole-sequence layer
    x = randn(1, ATTN_LONG, cfg.d_model)
    b1_0 = vq_amm_cuda.launches
    with torch.no_grad():
        out, gb, ms = peak_gb(lambda: tlayers.attention(
            params["blocks"][0]["attn"], x, cfg, qc, 0, None, None, None))
    check(tuple(out.shape) == tuple(x.shape)
          and bool(torch.isfinite(out).all()),
          f"attention [{ATTN_LONG} tokens]: non-finite or misshapen output")
    check(vq_amm_cuda.launches - b1_0 == 4,
          "attention [long layer]: not 4 B1 launches (wq wk wv wo)")
    print(f"attention [{cfg.name} layer 0, int8 LUTs, bf16, 1 x {ATTN_LONG} "
          f"tokens, chunks of {cfg.attn_chunk}]: peak {gb:.2f} GB above "
          f"the {torch.cuda.memory_allocated() / 1e9:.2f} GB held (one "
          f"float32 score tensor of the one softmax: {ONE_SOFTMAX_GB:.1f} "
          f"GB); {ms:.1f} ms on the device, 4 B1 launches [{SMI}]")
    del x, out
    # (b) against a float32 one softmax at ATTN_CMP tokens
    cases = (("chunked", cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 0),
             ("local", 8, 4, 256, ATTN_WINDOW))   # gemma3-4b's local layer
    for form, h, kvh, d, w in cases:
        q = randn(1, ATTN_CMP, h, d)
        k, v = randn(1, ATTN_CMP, kvh, d), randn(1, ATTN_CMP, kvh, d)
        with torch.no_grad():
            want, plain_ms = event_ms(lambda: one_softmax(q, k, v, w))
            rels, times = {}, {}
            for dt in (torch.bfloat16, torch.float32):
                qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
                got, times[dt] = event_ms(
                    (lambda: tlayers._sdpa(qq, kk, vv, 0, w,
                                           chunk=cfg.attn_chunk))
                    if form == "chunked" else
                    (lambda: tlayers._sdpa_local(qq, kk, vv, w)))
                rels[dt] = _rel(got, want)
                check(rels[dt] <= ATTN_REL[dt],
                      f"attention [{form} {dt}]: relative L2 {rels[dt]} "
                      f"against one float32 softmax, limit {ATTN_REL[dt]}")
        print(f"attention [{form}, 1 x {ATTN_CMP} tokens, {h} heads / {kvh}"
              f" kv, head_dim {d}" + (f", window {w}" if w else
                                      f", chunks of {cfg.attn_chunk}")
              + f"]: relative L2 against one float32 softmax "
              f"{rels[torch.bfloat16]:.3e} in bf16 (limit "
              f"{ATTN_REL[torch.bfloat16]}), {rels[torch.float32]:.3e} in "
              f"float32 (limit {ATTN_REL[torch.float32]}); "
              f"{times[torch.bfloat16]:.2f} / {times[torch.float32]:.2f} ms "
              f"(bf16 / float32) against the one softmax's {plain_ms:.2f} "
              f"ms [{SMI}]")
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    leaves = [randn(1, ATTN_CMP, n, d, dtype=torch.float32).requires_grad_()
              for n in (h, kvh, kvh)]
    ct = randn(1, ATTN_CMP, h, d, dtype=torch.float32)
    grads = []
    for fn in (lambda q, k, v: tlayers._sdpa(q, k, v, 0, 0,
                                             chunk=cfg.attn_chunk),
               one_softmax):
        (fn(*leaves) * ct).sum().backward()
        grads.append([t.grad for t in leaves])
        for t in leaves:
            t.grad = None
    rel = [_rel(a, b) for a, b in zip(*grads)]
    check(max(rel) <= ATTN_GRAD_REL,
          f"attention [chunked backward]: q / k / v gradients {rel} against"
          f" autograd of one float32 softmax, limit {ATTN_GRAD_REL}")
    print(f"attention [chunked backward, float32, 1 x {ATTN_CMP} tokens]: "
          f"q / k / v gradients within relative L2 "
          f"{', '.join(f'{r:.3e}' for r in rel)} of autograd of one float32"
          f" softmax (limit {ATTN_GRAD_REL}) [{SMI}]")
    del leaves, ct, grads
    # (c) the train step's peak, chunked and one softmax
    tqc = QuantConfig(mode="lut_train", v=V, c=C, metric="l2",
                      lut_dtype="float32")
    cut_cfg = cfg.replace(num_layers=ATTN_TRAIN_LAYERS)
    tparams = Model(cut_cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(seed + 41), tqc)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, ATTN_TRAIN_SEQ),
                                     generator=gen, device=DEV,
                                     dtype=torch.int32)}
    steps = {}
    for impl in ("chunked", "naive"):
        m = Model(cut_cfg.replace(attn_impl=impl), device=DEV)
        loss_and_grads(m, tparams, batch, tqc)          # a warm-up step
        (loss, _, g), gb, ms = peak_gb(
            lambda: loss_and_grads(m, tparams, batch, tqc))
        check(math.isfinite(loss.item()), f"attention [train {impl}]: "
              f"loss {loss.item()}")
        steps[impl] = (loss.item(), gb, ms)
        del g
    print(f"attention [train step, {cfg.name} cut to {ATTN_TRAIN_LAYERS} "
          f"layers, lut_train float32 LUTs, bf16, 1 x {ATTN_TRAIN_SEQ} "
          f"tokens]: peak {steps['chunked'][1]:.2f} GB chunked (chunks of "
          f"{cfg.attn_chunk}), {steps['naive'][1]:.2f} GB with one softmax "
          f"(attn_impl naive); step {steps['chunked'][2]:.1f} / "
          f"{steps['naive'][2]:.1f} ms on the device (after a warm-up step)"
          f"; loss {steps['chunked'][0]:.6f} / "
          f"{steps['naive'][0]:.6f} [{SMI}]")
    del tparams, batch
    # (d) one decode step over ATTN_LONG rows of a dense cache
    free()
    cache = model.init_cache(1, ATTN_LONG)
    for t in cache["layers"].values():
        t.copy_(randn(*t.shape, scale=0.5))
    cache["pos"] = ATTN_LONG - 1
    toks = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                         device=DEV, dtype=torch.int32)

    def step():
        return model.decode(params, toks, cache, qc)[0]
    with torch.no_grad():
        lg = step()
        check(bool(torch.isfinite(lg).all()), "attention [long decode]: "
              "non-finite logits")
        card = program_cost(step)
        _, ms = event_ms(step)

        def meta(t):
            return t.to("meta")
        dry = program_cost(Model(cfg, device="meta").decode,
                           tree_map(meta, params), meta(toks),
                           dict(cache, layers=tree_map(meta,
                                                       cache["layers"])), qc)
    for f in ("flops", "core_ops", "bytes"):
        check(getattr(card, f) == getattr(dry, f),
              f"attention [long decode]: {f} {getattr(card, f)} on the "
              f"card, {getattr(dry, f)} on meta")
    check(dict(card.kernels) == dict(dry.kernels),
          f"attention [long decode]: kernel calls {dict(card.kernels)} on "
          f"the card, {dict(dry.kernels)} on meta")
    cache_gb = sum(nbytes(t) for t in cache["layers"].values()) / 1e9
    print(f"attention [dense-cache decode step, {cfg.name}, 1 row at "
          f"{ATTN_LONG - 1} of {ATTN_LONG}, {cache_gb:.2f} GB cache]: card "
          f"== meta: flops {card.flops:.6g}, bytes {card.bytes:.6g}, kernel"
          f" calls {dict(card.kernels)}; {ms:.1f} ms on the device (one "
          f"call after a warm-up) [{SMI}]")
    print("attention [long decode]: costliest lines by bytes: " + "; ".join(
        f"{r['op']} @ {r['site']} x{r['count']}: {r['bytes'] / 1e9:.3f} GB"
        for r in card.top_cost_lines(6)))
    del cache
    free()


def analysis_phase(model, params, qc, seed):
    """The guard on full-width qwen1.5-4b's first SHALLOW_LAYERS layers
    fused, two-pass, vq-kv and ngram-speculative (the fused guard at full
    depth took 43 s of the phase's 70 on an H100, cut for the scale
    phase's time); then the invariants of the three paged entry points on fp and code
    pools at full depth."""
    out = {}
    n = model.cfg.num_layers
    cut, cut_params = cut_depth(model, params, SHALLOW_LAYERS)
    out["fused"] = analysis_run(
        cut, cut_params, qc, seed, f"qwen1.5-4b fused, {SHALLOW_LAYERS} "
        "layers", {"b1", "b2"}, {"b3", "b4", "b5"})
    for name, qc_r, spec, launched, idle in (
            ("two-pass", qc.replace(fuse=False), None, {"b3", "b4", "b2"},
             {"b1", "b5"}),
            ("vq-kv", qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C), None,
             {"b1", "b5"}, {"b2", "b3", "b4"}),
            (f"ngram k={SPEC_K}", qc,
             SpecConfig(k=SPEC_K, drafter="ngram"), {"b1"},
             {"b3", "b4", "b5"})):
        out[name] = analysis_run(
            cut, cut_params, qc_r, seed,
            f"qwen1.5-4b {name}, {SHALLOW_LAYERS} layers", launched, idle,
            spec)
    t0 = time.perf_counter()
    rep = run_invariants(model, params, qc)
    for r in rep.rows:
        print(f"invariants [qwen1.5-4b {r['pool']} pool, {n} layers] "
              f"{r['entry']}: records {r['records']}, transfers "
              f"{r['transfers']}, float64 ops {r['float64']}, pool-sized "
              f"allocations {r['big_allocs']}, pool pointers unchanged "
              f"{r['pool_ptrs_same']} [{SMI}]")
    for f in rep.findings:
        print(f"invariants: FINDING {f.render()}")
    print(f"invariants: {len(rep.rows)} calls in "
          f"{time.perf_counter() - t0:.1f} s")
    check(rep.ok, f"invariants: {len(rep.findings)} finding(s)")
    del cut, cut_params
    free()
    return out


# ---------------------------------------------------------------------------
# scale phase: tensor-parallel serving over a mesh of the one card
# ---------------------------------------------------------------------------

#: The model axis of the scale phase's engines. The card is one H100, so
#: both ranks of a TP-2 engine (and the four of the (2, 2) router) share
#: it: the phase shows the sharded program's correctness and cost, not
#: scaling.
TP = 2
#: qwen1.5-4b's projections as a TP-2 rank runs them, (K, N, calls a
#: layer, scaled): column-parallel wq / wk / wv and wg / wu (N halved),
#: row-parallel wo and wd (K halved: nc 160 and 432), launched without
#: the scale (their integer partials are all-reduced, then scaled once)
TP_QWEN_SHAPES = [(2560, 1280, 3, True), (2560, 3456, 2, True),
                  (1280, 2560, 1, False), (3456, 2560, 1, False)]
#: deepseek-moe-16b's per-rank groups: EP-2 routed experts (32 of 64, at
#: the decode buffers of 8 rows) and the TP-2 shared experts (N of wg / wu
#: halved, K of wd halved, wd without the scale); (label, E, M, K, N,
#: calls a layer, scaled)
TP_MOE_CASES = [("EP-2 routed wg/wu", 32, 8, 2048, 1408, 2, True),
                ("EP-2 routed wd", 32, 8, 1408, 2048, 1, True),
                ("TP-2 shared wg/wu", 2, 8, 2048, 704, 2, True),
                ("TP-2 shared wd", 2, 8, 704, 2048, 1, False)]
#: depth of the scale phase's deepseek-moe-16b and mamba2-2.7b runs (full
#: width; qwen1.5-4b runs at full depth and at SCALE_LAYERS)
TP_MOE_LAYERS, TP_SSM_LAYERS = 4, 8
#: depth of the scale phase's cut qwen1.5-4b runs (the guard over TP-2, a
#: second TP-2 run, two-pass, vq-kv, the (2, 2) router, each beside its
#: unsharded run): 8 layers before, cut to 4 for the train_scale
#: phase's room (at 8 they took ~63 s of the script's 1200, the TP-2 guard
#: 26.8 of them, on an H100)
SCALE_LAYERS = 4
#: the labels of the scale phase's sharded runs (their launches make the
#: kernels line's TP rows)
SCALE_LABELS: list = []


def tp_kernel_cases(gen, flush, seed):
    """B1, B3 and B4 at the shard shapes (qwen1.5-4b at M = SLOTS and
    CHUNK, deepseek-moe-16b's per-rank expert groups at decode), each
    against its plain version; B2 and B5 at a rank's 10 kv heads with the
    pages a split the engine passes there (the full model's 20-head
    choice)."""
    qwen = {"b1": {}, "b3": {}, "b4": {}}
    for k, n, _, scaled in TP_QWEN_SHAPES:
        label = (f"qwen1.5-4b TP-{TP} "
                 + ("column shard" if scaled else "row shard"))
        for m in (SLOTS, CHUNK):
            qwen["b1"][(m, k, n)] = b1_case(gen, m, k, n, flush, label=label,
                                            tag="scale", scaled=scaled)
            qwen["b3"][(m, k, n)], qwen["b4"][(m, k, n)] = b34_case(
                gen, m, k, n, flush, label=label, tag="scale",
                scaled=scaled)
    moe = {}
    for label, e, m, k, n, _, scaled in TP_MOE_CASES:
        lab = f"deepseek-moe-16b {label}"
        moe[label] = {"b1": b1_case(gen, m, k, n, flush, e, lab, "scale",
                                    scaled)}
        moe[label]["b3"], moe[label]["b4"] = b34_case(
            gen, m, k, n, flush, e, lab, "scale", scaled)
    rng = np.random.default_rng(seed)
    pos = sorted(rng.integers(32, MAX_SEQ, SLOTS).tolist())
    np_ = MAX_SEQ // PAGE
    kvh = qwen1p5_4b.config().num_kv_heads // TP
    b2 = b2_case(gen, f"TP-{TP} rank B=8 KVH={kvh} G=1 D=128 NP=32",
                 SLOTS, kvh, kvh, 128, np_, pos, 0, [0] * SLOTS, flush, True,
                 sp=fd.split_pages_for(SLOTS, 2 * kvh, np_))
    b5 = b5_case(gen, f"TP-{TP} rank B=8 KVH={kvh} G=1 D=128 NP=32 nc=32 "
                 "c=16", SLOTS, kvh, kvh, 128, np_, pos, 0, [0] * SLOTS,
                 flush, True,
                 sp=fd.split_pages_for(SLOTS, 2 * kvh, np_, kvq=True))
    # the head_dim layout's decode (B2s, B2a) at a rank's slice over
    # HD_MESH: qwen1.5-4b's main path (20 kv heads, D/m 16), timed, and
    # gemma3-4b's (4 kv heads, D/m 32, its 1024 window, kv_start and a
    # pos = -1 lane)
    m = HD_MESH[1]
    g_pos = sorted(rng.integers(*GEMMA_LOAD.check, SLOTS).tolist())
    g_pos[1] = -1
    hd = hd_case(gen, f"qwen1.5-4b over {HD_MESH}: B=8 KVH=20 G=1 D/m="
                 f"{128 // m} NP=32", SLOTS, 20, 20, 128, m, np_, pos, 0,
                 [0] * SLOTS, flush, True)
    hd_checks = [hd_case(gen, f"gemma3-4b over {HD_MESH}: B=8 KVH=4 G=2 "
                         f"D/m={256 // m} NP=128 window=1024 kv_start>0, "
                         "a pos=-1 lane", SLOTS, 8, 4, 256, m,
                         GEMMA_LOAD.max_seq // PAGE, g_pos, 1024,
                         [0, 0, 7, 0, 300, 0, 0, 12], flush, True)]
    return {"qwen": qwen, "moe": moe, "b2": b2, "b5": b5, "hd": hd,
            "hd_checks": hd_checks}


#: the head_dim layout's paged serving: qwen1.5-4b's 20 kv heads over a
#: (1, 8) mesh of the one card (head_dim 128 / 8 = 16 a rank), cut to
#: SCALE_LAYERS, on HD_LOAD: 4 requests of 32-96 prompt tokens, 8 new
#: each (one to three prefill chunks, every lane decoding at once); on
#: MAIN_LOAD the two (1, 8) runs took 50 s of the script on an H100
#: (eight ranks take turns: a step 13.6x the unsharded one)
HD_MESH = (1, 8)
HD_LOAD = Load(n=4, prompt=(32, 97), new=8, hot=-1)


def hd_case(gen, name, b, h, kvh, d, m, np_, positions, window, kv_start,
            flush, timed, ps=PAGE):
    """B2s and B2a at rank 0's slice (head_dim ``d`` / ``m``) of a bf16
    pool, q in bf16: B2s against its plain version (float32 scores within
    2e-5 of their scale; a pos = -1 lane's and dead keys' 0); B2a on the
    scores of the whole head_dim (what the all-reduce gives) against its
    plain version (within 2e-5 of the scale plus a bfloat16 ulp; a pos =
    -1 lane exactly its v_new slice); three launches of each bit for bit
    equal; each call one kernel (``device.enqueued``); each launch's
    geometry (``fd.hd_geometry``: cluster size, clusters, how many the
    card holds at once). ``timed``: each flushed (mean, median of 30),
    warm in a graph, its plain version's time and its bound; B2s's
    library yardstick, one ``torch.matmul`` of the q slice with the K
    slice already gathered (dead rows zero, k_new the last row: B2s's
    function), and SDPA over the whole heads' K / V already gathered as
    the pair's; a sweep of B2s's pages a block and B2a's cluster size
    beside the plan's choice."""
    q, kp, vp, kn, vn, phys, pos, ks = b2_inputs(gen, b, h, kvh, d, np_,
                                                 positions, kv_start, ps)
    ds = d // m

    def cut(t):
        return t[..., :ds].contiguous()
    qs, kps, vps, kns, vns = (cut(t) for t in (q, kp, vp, kn, vn))
    scale = d ** -0.5

    def scores():
        return fd.flash_decode_hd_scores_cuda(qs, kps, kns, phys, pos,
                                              window, ks)

    def scores_plain():
        return fd.flash_decode_hd_scores_plain(qs, kps, kns, phys, pos,
                                               window, ks)
    sc_full = fd.flash_decode_hd_scores_plain(q, kp, kn, phys, pos, window,
                                              ks)

    def attend():
        return fd.flash_decode_hd_attend_cuda(sc_full, vps, vns, phys, pos,
                                              window, ks, scale, q.dtype)

    def attend_plain():
        return fd.flash_decode_hd_attend_plain(sc_full, vps, vns, phys, pos,
                                               window, ks, scale, q.dtype)
    sc, sc_p, sc2, sc3 = scores(), scores_plain(), scores(), scores()
    out, out_p, again, third = attend(), attend_plain(), attend(), attend()
    torch.cuda.synchronize()
    check(torch.equal(sc, sc2) and torch.equal(sc, sc3),
          f"B2s {name}: three launches differ")
    check(torch.equal(out, third), f"B2a {name}: the third launch differs")
    geo = fd.hd_geometry(qs, kps, phys)
    err_s = float((sc - sc_p).abs().max())
    check(err_s <= 2e-5 * (1.0 + float(sc_p.abs().max())),
          f"B2s {name}: max abs err {err_s}")
    dead = (pos < 0).nonzero().flatten().tolist()
    g = h // kvh
    for lane in dead:
        check(bool((sc[lane, :, :-1] == 0).all()),
              f"B2s {name}: pos=-1 lane {lane} scores not 0")
        check(torch.equal(out[lane, 0], vns[lane, 0].repeat_interleave(g,
                                                                       0)),
              f"B2a {name}: pos=-1 lane {lane} is not exactly its v_new")
    err_a = float((out.float() - out_p.float()).abs().max())
    mx = float(out_p.float().abs().max())
    check(torch.equal(out, again), f"B2a {name}: two launches differ")
    check(err_a <= 2e-5 * (1.0 + mx) + 2.0 ** -7 * mx,
          f"B2a {name}: max abs err {err_a} (bf16 out)")
    for label, call in (("B2s", scores), ("B2a", attend)):
        calls = enqueued(call)
        check(calls == ONE_KERNEL, f"{label} {name}: enqueues {calls}")
    res = {"b2s": {"err": err_s}, "b2a": {"err": err_a}}
    print(f"hd [{name}]: plan {geo['plan']}; " + "; ".join(
        f"{key.upper()} cluster {k['cluster']} x {k['clusters']} clusters, "
        f"{k['resident']} at once on the card, {k['smem']} B shared, "
        f"{k['registers']} registers" for key, k in
        (("b2s", geo["b2s"]), ("b2a", geo["b2a"]))) + f" [{SMI}]")
    if not timed:
        print(f"hd [{name}]: B2s max abs err {err_s:.3g} (float32 scores), "
              f"B2a {err_a:.3g} (bf16 out); one kernel a call; three "
              f"launches equal; pos=-1 lanes exact [{SMI}]")
        return res
    t = np_ * ps
    live_t = fd._live_keys(pos, window, ks, t)
    live = int(live_t.sum())
    for key, call, plain, wk in (
            ("b2s", scores, scores_plain,
             work.flash_decode_hd_scores(qs, kps, phys, live=live)),
            ("b2a", attend, attend_plain,
             work.flash_decode_hd_attend(sc_full, vps, phys, q.dtype,
                                         live=live))):
        times = device_times(call, 30, flush)
        bms, by = bound(wk)
        res[key].update({"ms": float(np.mean(times)),
                         "med_ms": float(np.median(times)),
                         "warm_ms": graph_ms(call), "host": host_us(call),
                         "plain_ms": time_ms(plain, 5, flush),
                         "bound_ms": bms, "bound_by": by,
                         "library_ms": None})
    kg = kp[phys.long()].reshape(b, t, kvh, d).transpose(1, 2).contiguous()
    vg = vp[phys.long()].reshape(b, t, kvh, d).transpose(1, 2).contiguous()
    mask = live_t[:, None, None]
    qh = q.transpose(1, 2).contiguous()
    sdpa_ms = time_ms(lambda: torch.nn.functional.
                      scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                   enable_gqa=h != kvh),
                      30, flush)
    res["b2a"]["library_ms"] = sdpa_ms
    # B2s's yardstick: the q slice times the rank's K slice gathered, dead
    # rows zero and k_new the last row, in one matmul (B, KVH, G, T + 1)
    ks_g = torch.cat([kps[phys.long()].reshape(b, t, kvh, ds)
                      * live_t[:, :, None, None], kns], 1)
    ks_g = ks_g.permute(0, 2, 3, 1).float().contiguous()   # (B, KVH, D, T+1)
    qg_s = qs.reshape(b, kvh, g, ds).float().contiguous()
    mm = torch.matmul(qg_s, ks_g).reshape(b, h, t + 1)
    check(float((mm - sc_p).abs().max())
          <= 2e-5 * (1.0 + float(sc_p.abs().max())),
          f"B2s {name}: the matmul yardstick is not B2s's function")
    res["b2s"]["library_ms"] = time_ms(lambda: torch.matmul(qg_s, ks_g), 30,
                                       flush)
    plan = geo["plan"]

    def scores_at(pages):
        return lambda: fd.flash_decode_hd_scores_cuda(
            qs, kps, kns, phys, pos, window, ks, pages=pages)

    def attend_at(cs):
        return lambda: fd.flash_decode_hd_attend_cuda(
            sc_full, vps, vns, phys, pos, window, ks, scale, q.dtype,
            cluster=cs)
    sweep = [f"B2s {p} pages a block "
             f"{1e3 * time_ms(scores_at(p), 30, flush):.1f} us"
             for p in sorted({1, 2, 4, 8, plan["pages"]}) if p <= np_]
    sweep += [f"B2a cluster {cs} "
              f"{1e3 * time_ms(attend_at(cs), 30, flush):.1f} us"
              for cs in sorted({1, 2, 4, 8, 16, plan["cluster"]})]
    print(f"hd [{name}] sweep, flushed (the plan: B2s {plan['pages']} pages "
          f"a block, B2a cluster {plan['cluster']}): " + ", ".join(sweep)
          + f" [{SMI}]")
    print(f"hd [{name}]: " + "; ".join(
        f"{key.upper()} {r['ms'] * 1e3:.1f} us flushed (median "
        f"{r['med_ms'] * 1e3:.1f}), {r['warm_ms'] * 1e3:.1f} us warm in a "
        f"graph, host {r['host']:.1f} us/call, bound "
        f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), plain "
        f"{r['plain_ms'] * 1e3:.1f} us, max abs err {r['err']:.3g}"
        for key, r in (("b2s", res["b2s"]), ("b2a", res["b2a"])))
        + f"; one kernel a call; three launches equal; {live} live tokens; "
        f"B2s's matmul yardstick {res['b2s']['library_ms'] * 1e3:.1f} us; "
        f"SDPA over the whole heads' K / V already gathered (the pair's "
        f"function on one device) {sdpa_ms * 1e3:.1f} us [{SMI}]")
    return res


def collective_host_us(devices, n=2000) -> float:
    """Host µs of one all-reduce of a one-element tensor across a rank
    runner over ``devices``: the turn handoffs and the rank-order add,
    with no layer work between collectives."""
    runner = tcol.RankRunner(devices)
    t = torch.ones((1,), device=devices[0])

    def many(tp):
        out = t
        for _ in range(n):
            out = tp.all_reduce(out)
        return out
    runner.run(many)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run(many)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / n


def step_collectives(eng):
    """A ``serve`` hook: each decode call's (collectives, bytes) in
    ``eng.coll_steps``."""
    eng.coll_steps = []
    call = eng._decode_call

    def wrapper(*a):
        c0 = eng.collectives
        out = call(*a)
        c1 = eng.collectives
        eng.coll_steps.append((c1[0] - c0[0], c1[1] - c0[1]))
        return out
    eng._decode_call = wrapper


def collective_device_ms(cfg, flush) -> float:
    """Device ms of one decode step's collectives on one card (TP-2, 8
    slots): the adds of 2 all-reduces a layer of (8, d_model) float32
    partials, the embedding's all-reduce (bf16) and the logits' gather."""
    d, v = cfg.d_model, cfg.vocab_size
    a = torch.randn((SLOTS, d), device=DEV)
    e = torch.randn((SLOTS, d), device=DEV).to(torch.bfloat16)
    g = torch.randn((SLOTS, v // TP), device=DEV).to(torch.bfloat16)
    add = time_ms(lambda: a + a, 30, flush)
    emb = time_ms(lambda: e + e, 30, flush)
    cat = time_ms(lambda: torch.cat([g, g], -1), 30, flush)
    return 2 * cfg.num_layers * add + emb + cat


def compare_tokens(label, got, want, skip=()):
    """Print whether two runs' token lists agree (``skip``: request
    indices left out) and return how many requests differ."""
    idx = [i for i in range(len(want)) if i not in skip]
    bad = [i for i in idx if got[i] != want[i]]
    first = ""
    if bad:
        i = bad[0]
        j = next(t for t, (a, b) in enumerate(zip(got[i], want[i]))
                 if a != b)
        first = f"; first: request {i} at token {j}"
    print(f"scale [{label}]: tokens of {len(idx) - len(bad)} of {len(idx)} "
          f"requests identical{first} [{SMI}]")
    return len(bad)


def tp_serve(model, params, qc, seed, label, launched, idle, mesh,
             load=MAIN_LOAD, tag="scale"):
    """``serve`` over ``mesh``, labelled as a sharded run (its launches
    join the kernels line's TP rows), each decode call's collectives
    recorded."""
    SCALE_LABELS.append(label)
    out = serve(model, params, qc, seed, label, launched, idle, load=load,
                tag=tag, mesh=mesh, hook=step_collectives)
    eng = out[2]
    steps = eng.coll_steps
    eng.stats["coll_per_step"] = float(np.mean([c for c, _ in steps]))
    eng.stats["coll_bytes_per_step"] = float(np.mean([b for _, b in steps]))
    return out


def hd_serve(cut, cut_params, qc, seed):
    """The paged head_dim layout on the card: ``cut`` (full-width
    qwen1.5-4b at SCALE_LAYERS: its 20 kv heads do not divide the 8 ranks
    of HD_MESH) served on HD_LOAD fused (each rank's fp pool the head_dim
    slice of every kv head: B1, B2s and B2a, no B2) and on a code pool
    (replicated: B1 and B5 over every head), each against the unsharded
    engine's run on that load at that depth: greedy tokens equal, the
    step ms and collectives beside."""
    mesh = make_test_mesh(HD_MESH, device=DEV)
    check(hd_fallback(cut.cfg, HD_MESH[1]),
          f"{cut.cfg.name} over {HD_MESH} does not take the head_dim layout")
    for name, qc_r, launched, idle in (
            ("fused", qc, {"b1", "b2s", "b2a"}, {"b2", "b3", "b4", "b5"}),
            ("vq-kv", qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
             {"b1", "b5"}, {"b2", "b2s", "b2a", "b3", "b4"})):
        lab = (f"qwen1.5-4b {name}, {SCALE_LAYERS} layers, head_dim layout "
               f"over {HD_MESH}")
        one = (launched - {"b2s", "b2a"}) | ({"b2"} if name == "fused"
                                             else set())
        _, want, ref = serve(cut, cut_params, qc_r, seed,
                             f"qwen1.5-4b {name}, {SCALE_LAYERS} layers, "
                             "HD_LOAD", one, (idle | {"b2s", "b2a"}) - one,
                             load=HD_LOAD,
                             tag="scale")
        ref = ref.stats
        _, got, eng = tp_serve(cut, cut_params, qc_r, seed, lab, launched,
                               idle, mesh, load=HD_LOAD)
        st = eng.stats
        pool = eng.kv.pools[0]["k"]
        del eng
        free()
        print(f"scale [{lab}]: decode step {st['step_ms']:.1f} ms "
              f"(unsharded {ref['step_ms']:.1f}, "
              f"{st['step_ms'] / ref['step_ms']:.2f}x), prefill chunk "
              f"{st['chunk_ms']:.1f} ms ({ref['chunk_ms']:.1f}), "
              f"{st['tokens_per_s']:.1f} generated tokens/s "
              f"({ref['tokens_per_s']:.1f}); collectives a decode step "
              f"{st['coll_per_step']:.1f} "
              f"({st['coll_bytes_per_step'] / 1e6:.2f} MB); a rank's pool "
              f"{tuple(pool.shape)} {pool.dtype}; launches "
              f"{PATH_LAUNCHES[lab]} [{SMI}]")
        check(compare_tokens(f"{lab} vs unsharded, greedy", got,
                             want) == 0,
              f"{lab}: greedy tokens differ from the unsharded run's")


def scale_phase(model, params, qc, seed, gen):
    """Tensor-parallel serving on the one card: the shard-shape kernel
    cases; full-width qwen1.5-4b int8 cut to SERVING_LAYERS TP-2 fused on
    MAIN_LOAD, placed from the host (greedy tokens equal to an unsharded
    fused run's at that depth bit for bit; at full depth the TP-2 run took
    53 of the script's 1197 s on a slow host, 2x its host time a call, and
    the check does not depend on depth); at SCALE_LAYERS the sync guard over a TP-2 fused engine and a
    second TP-2 fused run (the temperature request the same in both; the
    greedy tokens the unsharded engine's), two-pass and vq-kv TP-2
    against unsharded runs, the (2, 2) router against the unsharded
    engine; the head_dim layout over HD_MESH at SCALE_LAYERS, fused and
    vq-kv (:func:`hd_serve`); deepseek-moe-16b EP-2 and mamba2-2.7b TP-2
    cut in depth against their unsharded runs. Returns the kernel
    cases."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    cases = tp_kernel_cases(gen, flush, seed)
    cfg = model.cfg
    mesh = make_test_mesh((1, TP), device=DEV)
    hot = MAIN_LOAD.hot
    deep, deep_params = cut_depth(model, params, SERVING_LAYERS)
    _, ref_tokens, ref = serve(deep, deep_params, qc, seed,
                               f"qwen1.5-4b fused, {SERVING_LAYERS} layers",
                               {"b1", "b2"}, {"b3", "b4", "b5"},
                               tag="scale")
    ref_stats = ref.stats
    del ref
    # placed from the host, as a model larger than the card would be:
    # each rank's shards and pool are made on the card, nothing whole
    free()
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.cpu(), deep_params)
    host_s = time.perf_counter() - t0
    _, toks, eng = tp_serve(deep, host, qc, seed,
                            f"qwen1.5-4b TP-{TP} fused, {SERVING_LAYERS} "
                            "layers", {"b1", "b2"}, {"b3", "b4", "b5"}, mesh)
    st = eng.stats
    model_b = nbytes(*_leaves(deep_params))
    shard_b = nbytes(*{t.data_ptr(): t for t in _leaves(eng.params)
                       }.values())
    pool_b = nbytes(*_leaves(eng.kv.pools))
    leaf_b = max(nbytes(t) for t in _leaves(eng.params))
    print(f"scale [qwen1.5-4b TP-{TP} fused, {SERVING_LAYERS} layers]: "
          f"placement from the host in {st['setup_s']:.2f} s (the host "
          f"copy of the params {host_s:.2f} s before it): the card's peak "
          f"{st['place_peak'] / 1e9:.3f} GB over the engine's construction, "
          f"held "
          f"{st['place_held'] / 1e9:.3f} GB (the ranks' shards "
          f"{shard_b / 1e9:.3f} GB, replicated leaves once, + pool shards "
          f"{pool_b / 1e9:.3f} GB); the params {model_b / 1e9:.3f} GB, "
          f"largest shard leaf {leaf_b / 1e6:.1f} MB [{SMI}]")
    check(st["place_peak"] <= shard_b + pool_b + leaf_b,
          f"TP-{TP} placement from the host peaked at {st['place_peak']} B"
          f" on the card, over its shards and pool ({shard_b + pool_b} B)"
          " and one leaf")
    del eng, host, deep, deep_params
    free()
    check(compare_tokens(f"qwen1.5-4b TP-{TP} fused, {SERVING_LAYERS} "
                         "layers, vs unsharded, greedy",
                         toks, ref_tokens, skip=(hot,)) == 0,
          "TP-2 greedy tokens differ from the unsharded run's")
    same_hot = toks[hot] == ref_tokens[hot]
    coll_ms = collective_device_ms(cfg, flush)
    coll_us = collective_host_us(list(mesh.devices.flat))
    print(f"scale [qwen1.5-4b TP-{TP} fused, {SERVING_LAYERS} layers]: "
          f"decode step {st['step_ms']:.1f} ms (unsharded "
          f"{ref_stats['step_ms']:.1f}), prefill chunk {st['chunk_ms']:.1f} "
          f"ms ({ref_stats['chunk_ms']:.1f}), {st['tokens_per_s']:.1f} "
          f"generated tokens/s ({ref_stats['tokens_per_s']:.1f}); "
          f"collectives a decode step {st['coll_per_step']:.1f} "
          f"({st['coll_bytes_per_step'] / 1e6:.2f} MB gathered; device "
          f"{coll_ms:.3f} ms of adds and the logits' gather on one card; "
          f"host {coll_us:.1f} us a collective alone, its turn handoffs "
          f"included, {st['coll_per_step'] * coll_us / 1e3:.2f} ms a "
          f"step); the temperature request "
          f"{'equal' if same_hot else 'not equal'} to the unsharded "
          f"one's [{SMI}]")
    cut, cut_params = cut_depth(model, params, SCALE_LAYERS)
    lab = f"qwen1.5-4b fused, {SCALE_LAYERS} layers"
    _, solo, _ = serve(cut, cut_params, qc, seed, lab, {"b1", "b2"},
                       {"b3", "b4", "b5"}, tag="scale")
    guarded = []
    glab = f"qwen1.5-4b TP-{TP} fused, {SCALE_LAYERS} layers"
    SCALE_LABELS.append(f"analysis {glab}")
    analysis_run(cut, cut_params, qc, seed, glab, {"b1", "b2"},
                 {"b3", "b4", "b5"}, mesh=mesh, keep=guarded)
    _, again, eng = tp_serve(cut, cut_params, qc, seed, f"{lab}, TP-{TP}",
                             {"b1", "b2"}, {"b3", "b4", "b5"}, mesh)
    # the placement: the engine's shards put back together are the params
    back = unshard_tree(eng.params, serving_layout(cut_params, cut.cfg, TP),
                        mesh)
    pairs = list(zip(_leaves(cut_params), _leaves(back)))
    check(all(torch.equal(a, b) for a, b in pairs),
          f"{lab}: unshard_tree of the TP-{TP} shards differs from the "
          "params")
    print(f"scale [{lab}, TP-{TP}]: unshard_tree of the engine's shards "
          f"equals the params in all {len(pairs)} leaves [{SMI}]")
    del eng, back, pairs
    check(compare_tokens(f"{lab} TP-{TP}, two runs (the sync guard's and "
                         "a plain one)", again,
                         [r.out_tokens for r in guarded]) == 0,
          f"{lab}: the two TP-{TP} runs differ (the temperature request "
          "is not reproducible)")
    check(compare_tokens(f"{lab} TP-{TP} vs unsharded, greedy", again,
                         solo, skip=(hot,)) == 0,
          f"{lab}: TP-{TP} greedy tokens differ from the unsharded run's")
    for name, qc_r, launched, idle in (
            ("two-pass", qc.replace(fuse=False), {"b3", "b4", "b2"},
             {"b1", "b5"}),
            ("vq-kv", qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
             {"b1", "b5"}, {"b2", "b3", "b4"})):
        lab = f"qwen1.5-4b {name}, {SCALE_LAYERS} layers"
        _, one, _ = serve(cut, cut_params, qc_r, seed, lab, launched, idle,
                          tag="scale")
        _, two, _ = tp_serve(cut, cut_params, qc_r, seed,
                             f"{lab}, TP-{TP}", launched, idle, mesh)
        check(compare_tokens(f"{lab} TP-{TP} vs unsharded, greedy", two,
                             one, skip=(hot,)) == 0,
              f"{lab}: TP-{TP} tokens differ from the unsharded run's")
    hd_serve(cut, cut_params, qc, seed)
    router = ReplicaRouter.from_mesh(
        cut, cut_params, qc, mesh=make_test_mesh((2, TP), device=DEV),
        **engine_kw(seed=seed))
    reqs = load_requests(MAIN_LOAD, seed, cfg.vocab_size)
    rlab = f"qwen1.5-4b fused, {SCALE_LAYERS} layers, router over (2, {TP})"
    SCALE_LABELS.append(rlab)
    _, wall, counts = path_run(rlab, in_stages(router, [reqs]), {"b1", "b2"},
                               {"b3", "b4", "b5"})
    used = [e.emitted_tokens for e in router.engines]
    check(len(used) == 2 and all(used), f"{rlab}: replicas used {used}")
    print(f"scale [{rlab}]: {len(reqs)} requests in {wall:.2f} s, tokens "
          f"emitted by replica {used}, launches {counts} [{SMI}]")
    check(compare_tokens(f"{rlab} vs one unsharded engine, greedy",
                         [r.out_tokens for r in reqs], solo,
                         skip=(hot,)) == 0,
          f"{rlab}: greedy tokens differ from the unsharded engine's")
    del router, cut, cut_params
    free()
    for mod, layers, launched in (
            (deepseek_moe_16b, TP_MOE_LAYERS, {"b1", "b2"}),
            (mamba2_2p7b, TP_SSM_LAYERS, {"b1"})):
        c = mod.config().replace(num_layers=layers)
        m = Model(c)
        p = m.init(torch.Generator(device=DEV).manual_seed(seed), qc)
        way = "EP" if c.family == "moe" else "TP"
        lab = f"{c.name} fused, {layers} layers"
        idle = {"b3", "b4", "b5"} | ({"b2"} if "b2" not in launched
                                     else set())
        _, one, _ = serve(m, p, qc, seed, lab, launched, idle, tag="scale")
        _, two, _ = tp_serve(m, p, qc, seed, f"{lab}, {way}-{TP}", launched,
                             idle, mesh)
        check(compare_tokens(f"{lab} {way}-{TP} vs unsharded", two,
                             one) == 0,
              f"{lab}: {way}-{TP} tokens differ from the unsharded run's")
        del m, p
        free()
    del flush
    return cases


# ---------------------------------------------------------------------------
# examples phase: the five example twins on the card
# ---------------------------------------------------------------------------

EXAMPLES = (
    # (twin, argv beyond --device / paths, kernels it must launch)
    ("torch_quickstart", [], {"b1", "b3", "b4"}),
    ("torch_dse_search", [], set()),
    ("torch_lutboost_convert", [], {"b1"}),
    ("torch_train_lm", [], set()),
    ("torch_serve_demo", [], {"b1", "b2"}),
    ("torch_serve_demo", ["--chaos"], {"b2"}),
)


def load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase():
    """Each twin's ``main`` at its JAX defaults on the card (the DSE
    heatmap, the training checkpoints and the serve demo's traces go to
    a scratch directory under build/, removed after): its report lines,
    its seconds, the kernels it launched."""
    scratch = os.path.join(ROOT, "build", f"examples_smoke_{os.getpid()}")
    os.makedirs(scratch, exist_ok=True)
    try:
        for name, extra, launched in EXAMPLES:
            mod = load_example(name)
            argv = ["--device", DEV, *extra]
            if name == "torch_dse_search":
                argv += ["--csv", os.path.join(scratch, "dse.csv")]
            if name == "torch_train_lm":
                argv += ["--ckpt-dir", os.path.join(scratch, "ckpt")]
            if name == "torch_serve_demo":
                argv += ["--trace", os.path.join(
                    scratch, f"trace{'_chaos' if extra else ''}.json")]
            label = " ".join([name, *extra])
            print(f"examples [{label}]: {' '.join(argv)}")
            out, wall, counts = path_run(
                f"example {label}", lambda: mod.main(argv), launched,
                set() if launched else set(WRAPPERS))
            check(out is not None and out != 1,
                  f"examples [{label}]: main returned {out!r}")
            print(f"examples [{label}]: exit 0 in {wall:.1f} s, launches "
                  f"{ {k: v for k, v in counts.items() if k in WRAPPERS} } "
                  f"[{SMI}]")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
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
    step_eng = None              # the fused engine, for the launch phase
    for label, (qc_r, launched, idle) in runs.items():
        counts[label], tokens[label], eng = serve(
            model, params, qc_r, args.seed, label, launched, idle,
            hook=fullest_decode_step if label == "fused" else None)
        bpt[label] = eng.kv.bytes_per_token
        if qc_r.kv_quant == "vq":
            codebook = eng.kv_codebook
        if label == "fused":
            step_eng = eng
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
    # the float32 copies (LUTs stay int8) at SERVING_LAYERS: at full depth
    # they add 20 s or more to the phase on an H100, which the whole
    # script's time budget does not leave beside the scale phase
    cut32, cut32_params = cut_depth(model, params, SERVING_LAYERS)
    params32 = _map_float(cut32_params, torch.float32)
    model32 = Model(cfg.replace(dtype="float32", num_layers=SERVING_LAYERS))
    cb32 = None if codebook is None else KVCodebook(
        **{k: v[:SERVING_LAYERS] for k, v in codebook.tree().items()})
    for label, (qc_r, _, _) in runs.items():
        cb = codebook if qc_r.kv_quant == "vq" else None
        logit_check(model, params, qc_r, args.seed, label, cb)
        # the same step in float32 (LUTs stay int8): what is left of the
        # difference without bf16 rounding
        logit_check(model32, params32, qc_r, args.seed,
                    f"{label}, {SERVING_LAYERS} layers",
                    cb32 if cb is not None else None)
        if cb is None:
            verify_check(model32, params32, qc_r, args.seed,
                         f"{label}, {SERVING_LAYERS} layers")
    del model32, params32, cut32, cut32_params, codebook, cb, cb32
    print(f"phase [qwen1.5-4b serve]: {time.perf_counter() - t_qwen:.1f} s")
    with phase("scale"):
        scale = scale_phase(model, params, qc, args.seed, gen)
    # at SERVING_LAYERS, the model drafter's early exit at 4 of them: at
    # full depth (draft_layers=10) the phase took 47-59 s of the script's
    # 991-1159 s on an H100, next to the 1200 s limit
    with phase(f"speculative, qwen1.5-4b int8, {SERVING_LAYERS} layers"):
        cut, cut_params = cut_depth(model, params, SERVING_LAYERS)
        spec_runs(
            cut, cut_params, qc, args.seed,
            f"qwen1.5-4b int8, {SERVING_LAYERS} layers", [
                (f"ngram k={SPEC_K}", SpecConfig(k=SPEC_K, drafter="ngram"),
                 {"b1"}, None),
                (f"model k={SPEC_K} draft_layers=4",
                 SpecConfig(k=SPEC_K, drafter="model", draft_layers=4),
                 {"b1", "b2"}, None),
                (f"rejected drafter k={SPEC_K}", SpecConfig(k=SPEC_K),
                 {"b1"}, ShiftDrafter())], Load(hot=-1))
        del cut, cut_params
    serving_phases(model, params, qc, args.seed, gen)
    with phase("analysis"):
        analysis_phase(model, params, qc, args.seed)
    with phase("launch"):
        launch_phase(model, params, qc, args.seed, step_eng)
    with phase("attention"):
        attention_phase(model, params, qc, args.seed)
    del model, params, step_eng
    free()
    with phase("float32 LUTs, qwen1.5-4b cut to 4 layers"):
        float_lut_serve(args.seed)
        spec_float32(args.seed)
    with phase("yi-9b"):
        dense_config(
            yi_9b.config(), qc, args.seed, MAIN_LOAD,
            {"fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"})})
    # its code-pool run at SERVING_LAYERS (its first global layer among
    # them): at full depth it took ~15 s of the script's 1200 on an H100, room
    # the train_scale phase needs
    with phase("gemma3-4b"):
        dense_config(
            gemma3_4b.config(), qc, args.seed, GEMMA_LOAD,
            {"fused": (qc, {"b1", "b2"}, {"b3", "b4", "b5"}),
             "vq-kv": (qc.replace(kv_quant="vq", kv_v=KV_V, kv_c=KV_C),
                       {"b1", "b5"}, {"b2", "b3", "b4"}, SERVING_LAYERS)})
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
        host, unsharded, peak = train_phase(args.seed)
    with phase("train_scale"):
        train_scale_phase(args.seed, host, unsharded, peak)
    del host
    with phase("families"):
        families_phase(args.seed)
    with phase("examples"):
        examples_phase()

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
        cut = f"{name} ({SERVING_LAYERS} layers)"
        return sum(PATH_LAUNCHES[lab].get(key + "_grouped", 0)
                   for lab in (f"{name} fused", f"{cut} two-pass",
                               f"{cut} vq-kv", f"{cut} fused"))

    def moe_row(name, key, source, replaces):
        """A grouped kernel over one deepseek-moe-16b layer's six expert
        projections at decode: the routed ones at the decode buffer
        (MOE_LIVE_CASES), the shared ones (MOE_CASES), by their counts a
        layer."""
        def layer(f):
            return sum(moe[label + " decode"][key][f] * cnt
                       for label, *_, cnt, _ in MOE_LIVE_CASES if cnt) + sum(
                moe[label][key][f] * cnt for label, *_, cnt in MOE_CASES
                if cnt)
        lib = None if key != "b4" else layer("library_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": moe_launches(key),
                "max_abs_err": max(r[key]["err"] for r in moe.values()),
                "ms": layer("ms"), "plain_ms": layer("plain_ms"),
                "bound_ms": layer("bound_ms"),
                "bound_by": "bytes" if all(
                    moe[label][key]["bound_by"] == "bytes"
                    for label in [lab + " decode" for lab, *_, cnt, _ in
                                  MOE_LIVE_CASES if cnt]
                    + [lab for lab, *_, cnt in MOE_CASES if cnt])
                else "operations", "library_ms": lib}
    def ssm_launches(key):           # the recurrent serve runs
        cut = f"mamba2-2.7b, {SERVING_LAYERS} layers"
        return sum(PATH_LAUNCHES[f"{name} {run}"][key]
                   for name, run in (("mamba2-2.7b", "fused"),
                                     (cut, "fused"), (cut, "two-pass"),
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
    def scale_launches(key):         # the scale phase's sharded runs
        return sum(PATH_LAUNCHES[lab][key] for lab in SCALE_LABELS)

    def scale_proj_row(name, key, source, replaces):
        """One TP-2 rank's 7 qwen1.5-4b projections at decode (M=8) at
        their shard shapes."""
        res = scale["qwen"][key]
        rows = [(res[(SLOTS, k, n)], cnt) for k, n, cnt, _ in
                TP_QWEN_SHAPES]
        lib = (None if key != "b4"
               else sum(r["library_ms"] * c for r, c in rows))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": scale_launches(key),
                "max_abs_err": max(r["err"] for r in res.values()),
                "ms": sum(r["ms"] * c for r, c in rows),
                "plain_ms": sum(r["plain_ms"] * c for r, c in rows),
                "bound_ms": sum(r["bound_ms"] * c for r, c in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r, _ in rows)
                else "operations", "library_ms": lib}

    def scale_moe_row(name, key, source, replaces):
        """A rank's 6 deepseek-moe-16b expert projections (EP-2 routed,
        TP-2 shared) at decode."""
        moe_s = scale["moe"]
        rows = [(moe_s[label][key], cnt)
                for label, *_, cnt, _ in TP_MOE_CASES]
        lib = (None if key != "b4"
               else sum(r["library_ms"] * c for r, c in rows))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(PATH_LAUNCHES[lab].get(key + "_grouped", 0)
                                for lab in SCALE_LABELS),
                "max_abs_err": max(r["err"] for r, _ in rows),
                "ms": sum(r["ms"] * c for r, c in rows),
                "plain_ms": sum(r["plain_ms"] * c for r, c in rows),
                "bound_ms": sum(r["bound_ms"] * c for r, c in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r, _ in rows)
                else "operations", "library_ms": lib}
    kernels += [
        scale_proj_row(f"vq_amm (B1) at the TP-{TP} shard shapes: one rank's "
                       "7 qwen1.5-4b projections at decode M=8 (column "
                       "2560->1280 x3, 2560->3456 x2; row nc 160 and 432 "
                       "without the scale); launches: the scale phase's "
                       "sharded runs, every rank", "b1",
                       "src/repro_torch/csrc/fused_amm.cu",
                       "src/repro/kernels/fused_amm.py:87"),
        scale_proj_row(f"vq_assign (B3) at the TP-{TP} shard shapes, the "
                       "same 7 projections", "b3",
                       "src/repro_torch/csrc/assign.cu",
                       "src/repro/kernels/assign.py:54"),
        scale_proj_row(f"lut_gemm (B4) at the TP-{TP} shard shapes, the "
                       "same 7 projections", "b4",
                       "src/repro_torch/csrc/lut_gemm.cu",
                       "src/repro/kernels/lut_gemm.py:61"),
        attn_row(f"flash_decode_paged_cuda (B2) at a TP-{TP} rank's 10 kv "
                 "heads, 8 slots, the 20-head split; launches: the scale "
                 "phase's sharded runs", scale["b2"], [scale["b2"]["err"]],
                 "src/repro_torch/csrc/flash_decode.cu",
                 "src/repro/kernels/flash_decode.py:183",
                 scale_launches("b2")),
        attn_row(f"flash_decode_paged_kvq_cuda (B5) at a TP-{TP} rank's 10 "
                 "kv heads, 8 slots, nc=32 c=16", scale["b5"],
                 [scale["b5"]["err"]],
                 "src/repro_torch/csrc/flash_decode_kvq.cu",
                 "src/repro/kernels/flash_decode.py:294",
                 scale_launches("b5")),
        scale_moe_row(f"vq_amm grouped (B1) at a rank's deepseek-moe-16b "
                      f"expert groups: EP-{TP} routed E=32, TP-{TP} shared "
                      "E=2 (wd without the scale), decode M=8; launches: "
                      "grouped, the EP run", "b1",
                      "src/repro_torch/csrc/fused_amm.cu",
                      "src/repro/kernels/fused_amm.py:87"),
    ]
    hd = scale["hd"]
    for key, what in (
            ("b2s", "flash_decode_hd_scores_cuda (B2s: a rank's partial "
             "decode scores in the head_dim layout, qwen1.5-4b over "
             f"{HD_MESH}: 8 slots, 20 kv heads, D/m 16, bf16; launches: the "
             f"{HD_MESH} fused serve run, every rank)"),
            ("b2a", "flash_decode_hd_attend_cuda (B2a: the softmax of the "
             "all-reduced scores and a rank's V slice, the same shapes; "
             "library: SDPA over the whole heads' K / V already gathered, "
             "the pair's function on one device)")):
        # B2s's library: one torch.matmul of the q slice with the K slice
        # already gathered (dead rows zero, k_new the last row)
        kernels.append(attn_row(
            what, hd[key], [hd[key]["err"]] + [c[key]["err"] for c in
                                               scale["hd_checks"]],
            "src/repro_torch/csrc/flash_decode_hd.cu",
            "src/repro/kernels/flash_decode.py:183", scale_launches(key)))
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
