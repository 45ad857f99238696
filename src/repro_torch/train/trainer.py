"""Training loop (port of ``repro.train.trainer``): the LUTBoost-staged
train step and the fault-tolerant driver.

``make_train_step`` builds the step: gradient accumulation over
microbatches (in fp32), optional bf16 gradient compression with error
feedback, clipping by the global norm of *all* gradients, the cosine LR,
AdamW, and the LUTBoost stage mask. In stage ② the mask freezes every
leaf but the centroids inside AdamW; the weights' gradients are still
computed, enter the global norm and so scale the centroids' update, as
in the JAX package (freezing them with ``requires_grad=False`` would
change the result). The step updates ``params`` and the optimizer state
in place (see ``optimizer.adamw_update``) and returns them.

``Trainer`` is the driver: deterministic resumable data, checkpoint and
restart, NaN / loss-spike detection with batch skip, and periodic and
final checkpoints. A skipped batch leaves params and state untouched: the
step checks the loss (which the forward gives before any update) before
it applies the update.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.lut import QuantConfig
from repro_torch.core.lutboost import LutBoostSchedule, stage_mask
from repro_torch.tree import tree_leaves, tree_map
from .compression import ef_compress
from .optimizer import adamw_init, adamw_update, clip_by_global_norm, cosine_lr


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    lr: float = 3e-4
    warmup: int = 100
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    microbatches: int = 1              # gradient accumulation
    compress_grads: bool = False       # bf16 + error feedback
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    log_every: int = 10
    loss_spike_factor: float = 10.0    # skip batches whose loss spikes
    seed: int = 0


def loss_and_grads(model, params, batch, qc: QuantConfig):
    """(loss, metrics, grads): the gradient of ``model.loss`` with respect
    to every leaf of ``params`` (a tree of the same structure, each in its
    leaf's dtype; zeros where a leaf does not reach the loss)."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    loss, metrics = model.loss(tracked, batch, qc)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, leaves))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def make_train_step(model, qc: QuantConfig, tc: TrainConfig,
                    stage: int = 3) -> Callable:
    """Returns ``step_fn(params, opt_state, batch, step, accept=None) ->
    (params, opt_state, metrics)``.

    stage: LUTBoost stage (2 = centroids only, 3 = joint); ignored in
    dense mode. ``accept(loss)``, when given, sees the batch's loss first;
    if it returns False the update is not applied (params and state stay
    as they were) and ``metrics["skipped"]`` is True.
    """

    def step_fn(params, opt_state, batch, step, accept=None):
        if tc.microbatches > 1:
            n = tc.microbatches
            gsum, lsum = None, 0.0
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, _, g = loss_and_grads(model, params, mb, qc)
                g = tree_map(lambda t: t.float(), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = lsum + loss_i.float()
            inv = 1.0 / n
            grads = tree_map(lambda t: t * inv, gsum)
            loss = lsum * inv
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch, qc)
        metrics = dict(metrics)
        if accept is not None and not accept(float(loss)):
            metrics.update(loss=loss, skipped=True)
            return params, opt_state, metrics

        new_opt = dict(opt_state)
        if tc.compress_grads:
            grads, new_opt["ef"] = ef_compress(grads, opt_state.get("ef"))
            grads = tree_map(lambda g: g.float(), grads)
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        lr = cosine_lr(step, tc.lr, tc.warmup, tc.total_steps)
        mask = stage_mask(params, 2) if qc.is_lut and stage == 2 else None
        params, new_opt["adam"] = adamw_update(
            grads, opt_state["adam"], params, lr,
            weight_decay=tc.weight_decay, mask=mask)
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss": loss,
                        "skipped": False})
        return params, new_opt, metrics

    return step_fn


def init_opt_state(params, tc: TrainConfig) -> Dict[str, Any]:
    opt: Dict[str, Any] = {"adam": adamw_init(params)}
    if tc.compress_grads:
        opt["ef"] = tree_map(lambda p: torch.zeros_like(p,
                                                        dtype=torch.float32),
                             params)
    return opt


class Trainer:
    """Fault-tolerant training driver."""

    def __init__(self, model, dataset, qc: QuantConfig, tc: TrainConfig,
                 checkpoint_dir: Optional[str] = None,
                 lutboost: Optional[LutBoostSchedule] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.dataset = dataset
        self.qc = qc
        self.tc = tc
        self.lutboost = lutboost
        self.log = log_fn
        self.ckpt = (CheckpointManager(checkpoint_dir, tc.keep_checkpoints)
                     if checkpoint_dir else None)
        self._steps = {}

    def _step_fn(self, stage: int):
        if stage not in self._steps:
            self._steps[stage] = make_train_step(self.model, self.qc,
                                                 self.tc, stage)
        return self._steps[stage]

    def _stage(self, step: int) -> int:
        if self.lutboost is None or not self.qc.is_lut:
            return 3
        return self.lutboost.stage(step)

    def run(self, params, opt_state=None, start_step: int = 0,
            num_steps: Optional[int] = None) -> Tuple[Any, Any, Dict]:
        """Train from ``start_step`` (or the latest checkpoint) for
        ``num_steps`` steps (default: up to ``tc.total_steps``). Returns
        (params, opt_state, {"loss": [...], "step_time": [...]}) over the
        steps taken."""
        tc = self.tc
        if opt_state is None:
            opt_state = init_opt_state(params, tc)

        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            (params, opt_state), step0, _ = self.ckpt.restore(
                (params, opt_state))
            start_step = step0
            self.log(f"[trainer] resumed from step {start_step}")

        end = (start_step + num_steps if num_steps is not None
               else tc.total_steps)
        history = {"loss": [], "step_time": []}
        ema_loss = None
        step = start_step

        def accept(loss: float) -> bool:
            return math.isfinite(loss) and not (
                ema_loss is not None
                and loss > tc.loss_spike_factor * ema_loss)

        while step < end:
            batch = self.dataset.batch(step)
            stage = self._stage(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(stage)(
                params, opt_state, batch, step, accept)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            if metrics["skipped"]:
                self.log(f"[trainer] step {step}: bad loss {loss:.4f} "
                         f"(ema {ema_loss}), skipping batch")
                step += 1
                continue
            ema_loss = loss if ema_loss is None else \
                0.95 * ema_loss + 0.05 * loss
            history["loss"].append(loss)
            history["step_time"].append(dt)

            if step % tc.log_every == 0:
                self.log(f"[trainer] step {step} stage {stage} "
                         f"loss {loss:.4f} ({dt*1e3:.1f} ms)")
            if self.ckpt is not None and step > start_step and \
                    step % tc.checkpoint_every == 0:
                self.ckpt.save(step, (params, opt_state),
                               extra={"ema_loss": ema_loss})
            step += 1

        if self.ckpt is not None:
            self.ckpt.save(step, (params, opt_state),
                           extra={"ema_loss": ema_loss})
        return params, opt_state, history
