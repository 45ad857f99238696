"""Streaming serving demo of the PyTorch port: Poisson arrivals through
the continuous engine (twin of ``examples/serve_demo.py``).

Trains a small model briefly, converts it to LUT-int8 (the paper's deploy
form), then replays the same Poisson-arrival trace through the continuous
batching engine for both the dense and the lut-int8 operating points and
prints a throughput / latency report. On a CUDA device every LUT
projection runs kernel B1 and decode attention kernel B2.

The engine-step counter doubles as the clock: requests whose arrival time
has passed are submitted before each step, so admission happens mid-decode
exactly as it would under live traffic.

A final pass demonstrates SELF-SPECULATIVE decoding: the dense target is
served again with its own weights drafting through the coarse LUT-int8
path — no second checkpoint, the draft tables ARE the deploy tables — and
the report adds the measured acceptance rate and tokens per verify call.
Output is token-identical to the plain dense pass (greedy acceptance).

``--chaos`` replays a burstier trace — priorities, per-request deadlines,
bounded queues — through a 2-replica router while ``FaultSchedule.canned``
squeezes one replica's page pool, injects a decode failure and crashes
the other replica mid-decode. The report shows completed / retried / shed
counts, the deadline-miss rate, and per-replica health.

Latency reporting comes straight off the engine's metrics registry
(``repro_torch.obs``): TTFT and completion latency in BOTH clocks —
engine steps and wall seconds — plus per-decoded-token TPOT.

``--trace out.json`` records every pass into one shared tracer and
exports a Chrome/Perfetto ``trace_event`` timeline — request lifecycle
spans, step-phase spans, and (with ``--chaos``) fault/degradation/
preemption annotations. Open it at ``ui.perfetto.dev``.

Where it differs from the JAX example: the LUT params carry the trained
dense weights and centroids (``tree_overlay`` over a lut_train init; the
JAX example converts the dense tree, which has no centroids), and
``--train-steps`` sets the dense training (150, the JAX example's count).

Run: PYTHONPATH=src python examples/torch_serve_demo.py [--chaos]
     [--trace out.json] [--device cpu]
"""
import argparse

import sys

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.lut import DENSE, QuantConfig
from repro_torch.core.lutboost import convert, precompute_model
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import Obs, Tracer, validate_trace
from repro_torch.serve import (Engine, FaultInjector, FaultSchedule,
                               FinishReason, ReplicaRouter, Request,
                               SpecConfig)
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import tree_overlay

SLOTS = 4
MEAN_INTERARRIVAL = 2.0        # engine steps between arrivals (Poisson)
N_REQUESTS = 12


def poisson_trace(rng: np.random.Generator):
    """(arrival_step, prompt, max_new) tuples with exponential gaps."""
    t = 0.0
    trace = []
    for i in range(N_REQUESTS):
        t += rng.exponential(MEAN_INTERARRIVAL)
        prompt = [int(x) for x in (5 * i + np.arange(3)) % 200 + 2]
        max_new = int(rng.integers(4, 16))
        trace.append((int(t), prompt, max_new))
    return trace


def serve_trace(engine: Engine, trace):
    """Drive the engine with arrivals gated on the step counter.

    Returns (requests, peak_pages_in_use)."""
    pending = list(trace)
    reqs = []
    peak_pages = 0
    while pending or engine.scheduler.has_work:
        while pending and pending[0][0] <= engine.step_count:
            arrival, prompt, max_new = pending.pop(0)
            req = Request(tokens=prompt, max_new_tokens=max_new,
                          arrival=arrival)
            reqs.append(req)
            engine.submit(req)
        # step() advances step_count even when idle, so time always moves
        # toward the next arrival
        engine.step()
        peak_pages = max(peak_pages, engine.kv.live_pages)
    return reqs, peak_pages


def report(tag: str, reqs, eng: Engine):
    """Throughput + latency report straight off the engine registry.

    One accounting: the step-clock and wall-clock families both come
    from the histograms ``repro_torch.serve.engine._observe_request``
    fills at finish time."""
    met = eng.obs.metrics
    toks = met.counters().get("engine.emitted_tokens", 0)
    makespan = max(r.finish_step for r in reqs) - min(r.arrival for r in reqs)
    print(f"[{tag}] {len(reqs)} requests, {toks} tokens, "
          f"makespan {makespan} steps "
          f"({toks / max(makespan, 1):.2f} tok/step)")

    def fam(label, steps_name, wall_name):
        hs = met.get_histogram(steps_name)
        hw = met.get_histogram(wall_name)
        line = f"  {label}:"
        if hs is not None and hs.count:
            line += (f" mean {hs.mean:.1f} p95 "
                     f"{hs.percentile(0.95):.1f} steps")
        if hw is not None and hw.count:
            line += (f" | mean {hw.mean * 1e3:.1f} p95 "
                     f"{hw.percentile(0.95) * 1e3:.1f} ms wall")
        print(line)

    fam("time-to-first-token", "req.ttft_steps", "req.ttft_s")
    fam("completion latency ", "req.latency_steps", "req.latency_s")
    tpot = met.get_histogram("req.tpot_s")
    if tpot is not None and tpot.count:
        print(f"  per-token (TPOT):    mean {tpot.mean * 1e3:.1f} p95 "
              f"{tpot.percentile(0.95) * 1e3:.1f} ms/token")
    for r in reqs[:4]:
        print(f"  t={r.arrival:>3} prompt={r.tokens} -> {r.out_tokens}")


def chaos_trace(rng: np.random.Generator, n_requests: int = 16):
    """A burstier arrival trace with priorities and (some) deadlines."""
    t = 0.0
    trace = []
    for i in range(n_requests):
        t += rng.exponential(1.0)
        prompt = [int(x) for x in (5 * i + np.arange(3)) % 200 + 2]
        max_new = int(rng.integers(4, 16))
        # every third request carries an SLO; the rest can wait
        deadline = int(rng.integers(10, 40)) if i % 3 == 0 else None
        trace.append((int(t), prompt, max_new, i % 2, deadline))
    return trace


def chaos_demo(model, params, tracer=None) -> dict:
    """Serve the bursty trace through 2 replicas under the canned faults."""
    print("\n=== chaos: canned fault schedule over a 2-replica router ===")
    router = ReplicaRouter(
        [Engine(model, params, DENSE, batch_size=SLOTS, max_seq=96,
                page_size=16, prefill_chunk=16, max_queue=4,
                obs=Obs(tracer=tracer) if tracer is not None else None)
         for _ in range(2)])
    inj = FaultInjector(FaultSchedule.canned(replicas=2)).attach(router)
    pending = chaos_trace(np.random.default_rng(1))
    reqs = []
    while pending or router.has_work:
        while pending and pending[0][0] <= router.step_count:
            _, prompt, max_new, prio, deadline = pending.pop(0)
            req = Request(tokens=prompt, max_new_tokens=max_new,
                          priority=prio, deadline_steps=deadline)
            reqs.append(req)
            router.submit(req)      # sheds cleanly if every queue is full
        router.step()

    assert all(r.done for r in reqs), "chaos demo lost requests"
    by_reason = {}
    for r in reqs:
        by_reason[r.finish_reason.name] = \
            by_reason.get(r.finish_reason.name, 0) + 1
    slo = [r for r in reqs if r.deadline_steps is not None]
    missed = sum(r.finish_reason is FinishReason.DEADLINE for r in slo)
    print(f"[chaos] {len(reqs)} requests -> "
          + ", ".join(f"{v} {k.lower()}"
                      for k, v in sorted(by_reason.items())))
    print(f"  recovery retries: {router.retried_requests} "
          f"(requests with retries>0: "
          f"{sum(r.retries > 0 for r in reqs)})")
    print(f"  deadline-miss rate: {missed}/{len(slo)} of SLO'd requests "
          f"({100.0 * missed / max(len(slo), 1):.0f}%)")
    for i, rep in enumerate(router.stats()["replicas"]):
        print(f"  replica {i}: {rep['health']}"
              + (f" ({rep['death_reason']})" if rep["death_reason"] else "")
              + f", {rep['recovered_requests']} requests recovered")
    fired = inj.report()["by_kind"]
    print(f"  faults fired: {fired}")
    return {"by_reason": by_reason, "faults": fired}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chaos", action="store_true",
                    help="serve a bursty SLO'd trace through 2 replicas "
                         "under the canned fault schedule and report "
                         "completed/retried/shed counts + deadline misses")
    ap.add_argument("--trace", default="",
                    help="export the run as Chrome/Perfetto trace_event "
                         "JSON to this path (open at ui.perfetto.dev)")
    ap.add_argument("--train-steps", type=int, default=150,
                    help="dense training steps before serving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tracer = Tracer(enabled=True) if args.trace else None

    cfg = get_smoke_config("qwen1.5-4b")
    model = Model(cfg, device=dev)
    ds = SyntheticDataset(cfg, global_batch=16, seq_len=64, device=str(dev))
    params = model.init(torch.Generator(device=dev).manual_seed(0), DENSE)
    tc = TrainConfig(total_steps=args.train_steps, lr=3e-3,
                     warmup=min(10, args.train_steps), log_every=50)
    params, _, _ = Trainer(model, ds, DENSE, tc).run(params)

    if args.chaos:
        out = chaos_demo(model, params, tracer)
        if tracer is not None:
            out["trace_events"] = _export_trace(tracer, args.trace)
        return out

    qi = QuantConfig(mode="lut_infer", v=4, c=16, lut_dtype="int8")
    # NOTE: in production you'd run LUTBoost stages ②③ before deploying;
    # here we convert directly to show the serving path.
    qt = qi.replace(mode="lut_train")
    lut_params = tree_overlay(
        model.init(torch.Generator(device=dev).manual_seed(1), qt), params)
    lut_params = convert(lambda p, b: model.forward(p, b, DENSE),
                         lut_params, ds.batch(0), qt)
    lut_params = precompute_model(lut_params, qi)

    trace = poisson_trace(np.random.default_rng(0))
    streams = {}
    for tag, ps, qc, spec in [
            ("dense", params, DENSE, None),
            ("lut-int8", lut_params, qi, None),
            # self-speculative: dense target, its OWN lut-int8 tables
            # drafting (same params tree — the drafter shares the
            # target's codebooks)
            ("dense+lut-draft", lut_params, DENSE,
             SpecConfig(k=4, draft_qc=qi))]:
        eng = Engine(model, ps, qc, batch_size=SLOTS, max_seq=96,
                     page_size=16, prefill_chunk=16, spec_decode=spec,
                     obs=Obs(tracer=tracer) if tracer is not None else None)
        reqs, peak = serve_trace(eng, trace)
        report(tag, reqs, eng)
        streams[tag] = [r.out_tokens for r in reqs]
        print(f"  peak pages in use: {peak} "
              f"(pool {eng.kv.table.allocator.num_pages}, dense cache "
              f"would pin {SLOTS * eng.kv.table.pages_per_slot})")
        if spec is not None:
            print(f"  speculative: acceptance "
                  f"{eng.acceptance_rate:.2f}, "
                  f"{eng.tokens_per_verify:.2f} tokens/verify over "
                  f"{eng.spec_rounds} rounds")
    # greedy speculation is exact: replay the trace through a plain dense
    # engine over the SAME checkpoint and demand identical tokens
    ref_eng = Engine(model, lut_params, DENSE, batch_size=SLOTS,
                     max_seq=96, page_size=16, prefill_chunk=16)
    ref_reqs, _ = serve_trace(ref_eng, trace)
    assert streams["dense+lut-draft"] == [r.out_tokens for r in ref_reqs], \
        "speculative pass diverged from plain greedy decoding"
    print("speculative pass is token-identical to plain greedy decoding")
    out = {"streams": streams}
    if tracer is not None:
        out["trace_events"] = _export_trace(tracer, args.trace)
    return out


def _export_trace(tracer, path: str) -> int:
    doc = tracer.export(path)
    problems = validate_trace(doc)
    assert not problems, f"exported trace invalid: {problems[:5]}"
    print(f"trace: {len(doc['traceEvents'])} events -> {path} "
          f"(valid; open at ui.perfetto.dev)")
    return len(doc["traceEvents"])


if __name__ == "__main__":
    main(sys.argv[1:])
