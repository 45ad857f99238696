"""The sync guard over one config's serving (``repro_torch.analysis``):
where the host waits for the card, and what it uploads, a step.

Usage:  python3 scripts/guard_serve.py --config deepseek-moe-16b \\
            [--layers N] [--mode fused|two-pass|vq-kv] [--ngram K] \\
            [--seed 0] [--smoke --device cpu]

``--smoke`` takes the config's smoke size and a small load (a CPU
rehearsal of the card run).

Builds the config at full width (its first ``--layers`` layers when
given; random weights from ``--seed``, int8 LUTs v=8 c=16) and serves,
through the continuous-batching engine (8 slots, 512 tokens a slot, page
16, chunk 32), a warmup of 3 requests of 8 tokens, then 10 requests of
32-256 random prompt tokens and 32 new tokens each, one at temperature
0.8 (``chip_smoke.py``'s serve load), inside
:func:`~repro_torch.analysis.sync_guard.run_sync_guard`. Prints the
card's name and power limit, the steady state's counts, every sync
outside the engine's read funnel by site, and each finding; exits 1 on a
finding. ``chip_smoke.py``'s ``analysis`` phase runs the same guard on
qwen1.5-4b; this script takes any paged config (the MoE, SSM and hybrid
families too).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import run_sync_guard  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.lut import QuantConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Engine, Request, SpecConfig  # noqa: E402

SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 512, 16, 32


def requests(rng, vocab, n, prompt, new, hot):
    return [Request(tokens=rng.integers(0, vocab, int(k)).tolist(),
                    max_new_tokens=new,
                    temperature=0.8 if i == hot else 0.0)
            for i, k in enumerate(rng.integers(*prompt, n))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="qwen1.5-4b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mode", default="fused",
                    choices=("fused", "two-pass", "vq-kv"))
    ap.add_argument("--ngram", type=int, default=0,
                    help="speculate with an n-gram drafter of this k")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke size and a small load: 4 "
                         "requests of 8-40 prompt tokens, 8 new each "
                         "(a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    cfg = (get_smoke_config if args.smoke else get_config)(args.config)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    qc = QuantConfig(mode="lut_infer", v=8, c=16, lut_dtype="int8")
    qc = {"fused": qc, "two-pass": qc.replace(fuse=False),
          "vq-kv": qc.replace(kv_quant="vq")}[args.mode]
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        qc)
    spec = SpecConfig(k=args.ngram, drafter="ngram") if args.ngram else None
    eng = Engine(model, params, qc, batch_size=SLOTS, max_seq=MAX_SEQ,
                 page_size=PAGE, prefill_chunk=CHUNK, seed=args.seed,
                 spec_decode=spec)
    print(f"{cfg.name} ({cfg.num_layers} layers, {args.mode}"
          f"{f', ngram k={args.ngram}' if spec else ''}) on {dev} in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)
    n, prompt, new = (4, (8, 41), 8) if args.smoke else (10, (32, 257), 32)
    steady = requests(rng, cfg.vocab_size, n, prompt, new, 3)
    warm = requests(rng, cfg.vocab_size, 3, prompt, 8, 1)
    t0 = time.perf_counter()
    rep = run_sync_guard(eng, warm, steady)
    print(f"guard: {rep.summary()} ({time.perf_counter() - t0:.1f} s)")
    for n, op, path, line, ph in rep.debug_sites():
        print(f"guard: sync outside the read: {n} x {op} at {path}:{line} "
              f"({ph})")
    for f in rep.findings:
        print(f"guard: FINDING {f.render()}")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
