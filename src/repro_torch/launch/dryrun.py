"""Multi-pod dry run (port of ``repro.launch.dryrun``): one rank's program
of every (arch x shape) cell on the 16x16 or 2x16x16 mesh, run on meta
tensors and costed at H100 peaks.

Where the JAX package lowers and compiles each cell for 256 or 512
placeholder devices and costs the partitioned HLO, the port runs the
program itself on the meta device: the params, optimizer state, batch
and cache of ``launch.specs`` cut to rank 0's shards by the port's
sharding rules (``parallel.sharding``), the train step
(``make_train_step(mesh=, runner=)``) or the dense-cache ``prefill`` /
``decode`` (the ssm and hybrid families: ``prefill_paged`` /
``decode_paged`` over slot state) through the one-rank ``CostRunner``,
whose collectives record their bytes, under ``launch.op_cost.OpCost``.
Nothing is computed and nothing is allocated: a cell takes seconds.

A cell's result has the JAX keys (``status``, ``mesh``, ``chips``,
``memory``, ``roofline``), with ``trace_s`` (the run's wall time) for
``lower_s`` / ``compile_s``. ``memory``: the rank's argument and output
bytes, the bytes updated in place (``alias``: the cache; the params and
optimizer state of a train step) and ``temp_size_in_bytes``, the peak
of the meta storages the run made and held. A cell whose layout the
port refuses (``check_tensor_parallel``; none of the production cells
since every family runs under a model axis) has ``status: "refused"``
and the refusal's text; the CLI counts it apart from ``"error"`` and
exits 1 on any error.

    python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape decode_32k --mesh single

Needs no card: the meta device runs on any machine.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.lut import QuantConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.specs import (SHAPES, cell_is_runnable, meta_model,
                                      serve_input_specs, train_input_specs)
from repro_torch.models.model import RECURRENT
from repro_torch.parallel.collectives import CostRunner
from repro_torch.parallel.sharding import (P, check_tensor_parallel,
                                           serving_cache_layout,
                                           serving_layout, shard_cache,
                                           shard_tree)
from repro_torch.train.trainer import (TrainConfig, init_opt_state,
                                       make_train_step)
from repro_torch.tree import tree_leaves, tree_map

#: Where the CLI writes one JSON file a cell (git-ignored).
OUT_DIR = "results/dryrun_torch"


def quant_config(mode: str, kind: str) -> QuantConfig:
    """The paper's technique operating point per step kind: fused
    lut_infer v=8 c=16 l2 with int8 LUTs to serve, lut_train with
    float32 LUTs to train; or dense."""
    if mode == "dense":
        return QuantConfig(mode="dense")
    lut_mode = "lut_train" if kind == "train" else "lut_infer"
    return QuantConfig(mode=lut_mode, v=8, c=16, metric="l2",
                       lut_dtype="int8" if kind != "train" else "float32")


def tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in tree_leaves(tree) if torch.is_tensor(t)))


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.devices.shape)


def _data_size(mesh) -> int:
    dp = 1
    for a in data_axes(mesh):
        dp *= mesh.shape[a]
    return dp


def _rows(tree, batch: int, mesh, runner, dim: int = 0):
    """Rank 0's part of per-row inputs (rows along ``dim``): its data
    group's rows when the batch covers the data axes (the cache's
    layout), else every row."""
    da = data_axes(mesh)
    dp = _data_size(mesh)
    if not (batch % dp == 0 and batch >= dp):
        return tree
    spec = P(*([None] * dim), da if len(da) > 1 else da[0])
    return shard_tree(tree, tree_map(lambda _: spec, tree), mesh,
                      only=runner.ranks)[0]


def _train(model, qc, case, tc, mesh, runner):
    """(the global params, no cache, rank 0's arguments, the call) of one
    train step of rank 0."""
    cfg = model.cfg
    p_s, _, b_s, step = train_input_specs(model, qc, case, tc)
    layout = serving_layout(p_s, cfg, mesh.shape["model"])
    shards = shard_tree(p_s, layout, mesh, only=runner.ranks)
    opt = [init_opt_state(shards[0], tc)]
    fn = make_train_step(model, qc, tc, stage=3, mesh=mesh, layout=layout,
                         runner=runner)
    rank_batch = _rows(b_s, case.batch, mesh, runner)
    args = (shards[0], opt[0], rank_batch)

    def call():
        _, new_opt, metrics = fn(shards, opt, b_s, step)
        return shards[0], new_opt[0], metrics
    return p_s, None, args, call


def _serve(model, qc, case, mesh, runner):
    """(the global params, the global cache, rank 0's arguments, the
    call) of one prefill or decode of rank 0."""
    cfg = model.cfg
    p_s, in2, cache = serve_input_specs(model, qc, case)
    msize = mesh.shape["model"]
    shards = shard_tree(p_s, serving_layout(p_s, cfg, msize), mesh,
                        only=runner.ranks)[0]
    x = _rows(in2, case.batch, mesh, runner)
    if cfg.family in RECURRENT:
        state = _rows(cache, case.batch, mesh, runner, dim=1)
        state = shard_tree(state, serving_cache_layout(cfg, mesh), mesh,
                           only=runner.ranks)[0]
        slots = tree_leaves(state)[0].shape[1]
        table = torch.empty((slots, 1), dtype=torch.int32, device="meta")
        if case.kind == "prefill":
            def call():      # one chunk a slot: the whole prompt
                return [model.prefill_paged(shards, x["tokens"][i:i + 1],
                                            state, table, i, 0, case.seq,
                                            qc) for i in range(slots)]
        else:
            positions = torch.empty((slots,), dtype=torch.int32,
                                    device="meta")

            def call():
                return model.decode_paged(shards, x, state, table,
                                          positions, qc)
        return p_s, cache, (shards, x, state), call
    local = shard_cache(cache, cfg, case.batch, mesh, only=runner.ranks)[0]
    if case.kind == "prefill":
        def call():
            return model.prefill(shards, x, local, qc)
    else:
        local["pos"] = case.seq - 1     # one new token against seq rows

        def call():
            return model.decode(shards, x, local, qc)
    return p_s, cache, (shards, x, local), call


def run_cell(arch: str, shape_name: str, mesh, quant: str = "lut",
             tc: Optional[TrainConfig] = None, verbose: bool = True,
             cfg_overrides: Optional[dict] = None):
    """Run and cost one (arch x shape) cell's rank-0 program on ``mesh``
    (a ``launch.mesh.Mesh``, the meta device). Returns a dict."""
    case = SHAPES[shape_name]
    cfg = get_config(arch)
    runnable, why = cell_is_runnable(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name, "quant": quant,
              "mesh": _mesh_name(mesh), "chips": mesh.size}
    if not runnable:
        result.update({"status": "skipped", "reason": why})
        return result
    overrides = dict(cfg_overrides or {})
    if case.kind == "train":
        overrides.setdefault("remat", True)
    cfg = cfg.replace(**overrides)
    model = meta_model(cfg)
    qc = quant_config(quant, case.kind)
    try:
        check_tensor_parallel(cfg, mesh.shape["model"], qc)
    except NotImplementedError as e:
        result.update({"status": "refused", "reason": str(e)})
        return result
    runner = CostRunner(mesh)
    t0 = time.perf_counter()
    if case.kind == "train":
        tc = tc or TrainConfig()
        p_s, cache, args, call = _train(model, qc, case, tc, mesh, runner)
        with OpCost() as cost:
            outs = runner.run(lambda tp: call())[0]
        alias = tree_bytes(args[:2])
    else:
        p_s, cache, args, call = _serve(model, qc, case, mesh, runner)
        with torch.no_grad(), OpCost() as cost:
            outs = runner.run(lambda tp: call())[0]
        alias = tree_bytes(args[2])
    trace_s = time.perf_counter() - t0
    mem = {"argument_size_in_bytes": int(tree_bytes(args)),
           "output_size_in_bytes": int(tree_bytes(outs)),
           "alias_size_in_bytes": int(alias),
           "temp_size_in_bytes": int(cost.peak_temp_bytes)}
    param_bytes = tree_bytes(p_s)
    cache_bytes = tree_bytes(cache) if cache is not None else 0.0
    mf = rl.model_flops_for(cfg, case.kind, case.batch, case.seq)
    mb = rl.model_bytes_for(cfg, case.kind, case.batch, case.seq,
                            param_bytes, cache_bytes)
    report = rl.analyze(cost, chips=mesh.size, model_flops=mf,
                        model_bytes=mb)
    result.update({"status": "ok", "trace_s": round(trace_s, 2),
                   "memory": mem, "roofline": report.to_dict(),
                   "kernels": dict(cost.kernels)})
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']} ({quant}) "
              f"OK -- trace {trace_s:.1f}s bottleneck={report.bottleneck} "
              f"frac={report.roofline_fraction:.3f}")
        print(f"  memory: {mem}")
        print(f"  flops={report.flops:.3e} core_ops={report.core_ops:.3e} "
              f"bytes={report.bytes_accessed:.3e} "
              f"coll={report.total_coll_bytes:.3e} kernels={result['kernels']}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LUT-DLA multi-pod dry run of "
                                 "the PyTorch port (meta device)")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="lut", choices=["lut", "dense"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have results")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures, refused = [], []
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        mesh_tag = "multi" if multi else "single"
        for arch in archs:
            for shape in shapes:
                tag = f"{mesh_tag}__{args.quant}__{arch}__{shape}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] {tag}: cached, skipping")
                    continue
                try:
                    res = run_cell(arch, shape, mesh, args.quant)
                except Exception as e:     # noqa: BLE001 -- the CLI's report
                    res = {"arch": arch, "shape": shape,
                           "quant": args.quant, "mesh": mesh_tag,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures.append(tag)
                    print(f"[dryrun] {tag}: FAILED -- {e!r}")
                if res["status"] == "refused":
                    refused.append(tag)
                    print(f"[dryrun] {tag}: refused -- {res['reason']}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    if refused:
        print(f"[dryrun] {len(refused)} refused: {refused}")
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
