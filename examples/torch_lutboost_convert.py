"""LUTBoost model conversion with the PyTorch port (paper §V): dense LM →
LUT-based LM (twin of ``examples/lutboost_convert.py``).

Stage ① k-means init from calibration activations, stage ② centroid-only
training, stage ③ joint fine-tune, then int8-LUT precompute + evaluation of
every similarity metric.

Where it differs from the JAX example, which does not do what it says
(ROADMAP.md queue C): the lut_train params carry the trained dense
weights AND centroids (the JAX example converts the DENSE tree, which has
no centroids), and stage ① calibrates through the dense forward and
captures every projection's real input, so the three lut_train runs
start from k-means centroids of real activations (the JAX capture gets
nothing under ``lax.scan``, so its stage ② trains random centroids). The
report adds one line a metric: the projections stage ① captured.

Run: PYTHONPATH=src python examples/torch_lutboost_convert.py [--steps N]
     [--metrics l2,l1,chebyshev] [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.lut import DENSE, QuantConfig
from repro_torch.core.lutboost import (LutBoostSchedule, capture_activations,
                                       kmeans_init_from_capture,
                                       precompute_model)
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import tree_flatten_with_path, tree_overlay


def lut_layers(params):
    """Every LutLinear sub-dict (holds ``w`` and ``z``) of a tree."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            if "w" in t and "z" in t:
                out.append(t)
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(params)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--v", type=int, default=4)
    ap.add_argument("--c", type=int, default=16)
    ap.add_argument("--stage2-steps", type=int, default=30)
    ap.add_argument("--stage3-steps", type=int, default=70)
    ap.add_argument("--metrics", default="l2,l1,chebyshev",
                    help="comma-separated similarity metrics to convert")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("qwen1.5-4b")
    model = Model(cfg, device=dev)
    ds = SyntheticDataset(cfg, global_batch=16, seq_len=64, device=str(dev))

    # 0) a trained dense model (the conversion input)
    params = model.init(torch.Generator(device=dev).manual_seed(0), DENSE)
    dense_tc = TrainConfig(total_steps=args.steps, lr=3e-3, warmup=10,
                           log_every=10**9)
    params, _, dh = Trainer(model, ds, DENSE, dense_tc,
                            log_fn=lambda _: None).run(params)
    dense_loss = float(np.mean(dh["loss"][-10:]))
    print(f"dense model CE: {dense_loss:.4f}")

    out = {"dense_ce": dense_loss, "metrics": {}}
    for metric in args.metrics.split(","):
        qc = QuantConfig(mode="lut_train", v=args.v, c=args.c, metric=metric,
                         recon_weight=0.05)
        # the trained dense weights, with centroids beside every projection
        lut_params = tree_overlay(
            model.init(torch.Generator(device=dev).manual_seed(1), qc),
            params)
        # stage ①: one calibration pass through the dense forward, every
        # projection's input captured, then k-means per projection
        layers = lut_layers(lut_params)
        with torch.no_grad(), capture_activations() as captured:
            model.forward(lut_params, ds.batch(0), DENSE)
        n_cap = sum(id(p["z"]) in captured for p in layers)
        rows = sorted({captured[id(p["z"])].shape[0] for p in layers
                       if id(p["z"]) in captured})
        with torch.no_grad():
            lut_params = kmeans_init_from_capture(lut_params, captured, qc)
        # stages ② + ③
        sched = LutBoostSchedule(stage2_steps=args.stage2_steps,
                                 stage3_steps=args.stage3_steps)
        tc = TrainConfig(total_steps=sched.total_steps, lr=1e-3, warmup=0,
                         log_every=10**9)
        lut_params, _, hist = Trainer(model, ds, qc, tc, lutboost=sched,
                                      log_fn=lambda _: None).run(lut_params)
        # deploy at int8 tables
        qi = qc.replace(mode="lut_infer", lut_dtype="int8")
        pi = precompute_model(lut_params, qi)
        with torch.no_grad():
            ev = float(np.mean([float(model.loss(pi, ds.batch(200 + i),
                                                 qi)[0])
                                for i in range(4)]))
        print(f"  {metric:9s}: stage ① captured {n_cap} of {len(layers)} "
              f"projections ({'/'.join(map(str, rows))} rows each)")
        print(f"  {metric:9s}: converted CE {ev:.4f} "
              f"(drop {ev - dense_loss:+.4f}, "
              f"equivalent bits {np.ceil(np.log2(args.c)) / args.v:.2f})")
        out["metrics"][metric] = {
            "captured": n_cap, "projections": len(layers), "ce": ev,
            "z_leaves": sum(path.endswith("['z']") for path, _ in
                            tree_flatten_with_path(lut_params))}
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
