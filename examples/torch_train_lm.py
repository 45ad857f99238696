"""End-to-end training with the PyTorch port: a ~100M-parameter LM on
the synthetic pipeline, with checkpoint/restart and optional LUT-mode
(LUTBoost stage ③) (twin of ``examples/train_lm.py``).

Default invocation runs a short smoke (25 steps). The full recipe
(~100M params, few hundred steps) is:

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --full

Fault tolerance: kill the process at any point and re-run — it resumes
from the latest checkpoint in --ckpt-dir (default ``build/torch_train_lm``
under the repository root).
"""
import argparse
import os
import sys

import torch

from repro_torch.core.lut import DENSE, QuantConfig
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model_config(full: bool) -> ModelConfig:
    if full:
        # ~110M params: 12L × d768 × ff3072, vocab 32k
        return ModelConfig(name="lm-100m", family="dense", num_layers=12,
                           d_model=768, num_heads=12, num_kv_heads=12,
                           d_ff=3072, vocab_size=32000)
    return ModelConfig(name="lm-smoke", family="dense", num_layers=4,
                       d_model=256, num_heads=8, num_kv_heads=8,
                       d_ff=1024, vocab_size=1024)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true", help="~100M config")
    ap.add_argument("--lut", action="store_true",
                    help="train in LUT mode (stage ③ joint)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.full)
    model = Model(cfg, device=dev)
    qc = (QuantConfig(mode="lut_train", v=8, c=16, metric="l2")
          if args.lut else DENSE)
    params = model.init(torch.Generator(device=dev).manual_seed(0), qc)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params, lut={args.lut}")

    ds = SyntheticDataset(cfg, global_batch=args.batch, seq_len=args.seq,
                          device=str(dev))
    tc = TrainConfig(total_steps=args.steps, lr=args.lr,
                     warmup=max(args.steps // 10, 1),
                     checkpoint_every=max(args.steps // 4, 10),
                     log_every=max(args.steps // 20, 1))
    trainer = Trainer(model, ds, qc, tc, checkpoint_dir=args.ckpt_dir)
    params, _, hist = trainer.run(params)
    if hist["loss"]:
        times = sorted(hist["step_time"])
        print(f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} "
              f"({len(hist['loss'])} steps, "
              f"median {times[len(times) // 2] * 1e3:.0f} ms/step)")
    else:
        print("nothing to do (already trained to --steps; "
              "delete --ckpt-dir to restart)")
    return hist


if __name__ == "__main__":
    main(sys.argv[1:])
