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

``make_train_step(..., mesh=, layout=)`` is the sharded step, the
counterpart of the reference's ``jax.jit(make_train_step(...),
in_shardings=...)`` over ``param_pspecs`` / ``batch_pspecs``: the params
and the optimizer state are lists of per-rank shards (``layout`` is the
params' spec tree, ``parallel.sharding.serving_layout``; the optimizer
state's is ``opt_pspecs``), and the global batch is cut over the data
axes (``shard_batch``). One :class:`~repro_torch.parallel.collectives.
RankRunner` over the whole mesh runs every rank's forward; the
collectives hand over live tensors, so the loss of each data group (its
``model`` rank 0's) is an autograd function of every rank's shards, and
ONE ``torch.autograd.grad`` of the data groups' mean loss, on the calling
thread, gives every rank's shard its gradient. No collective runs in the
backward. An entry that several ranks hold (a replicated leaf: norms,
column-parallel ``z``, the router; a Mamba2 ``in_proj``'s B and C
columns; every leaf across the data groups) gets one part of its
gradient on each copy; the parts are summed, over the ``model`` axis
first, then by ``compression.psum_hierarchical`` over ``data`` and
``pod``, which is the GSPMD gradient. Gradients keep their leaf's dtype
(float32 only where microbatches accumulate, as in the reference). Then
each rank clips (the norm over the logical tree,
``optimizer.clip_by_global_norm(shared=)``) and updates its shards in
place; copies stay equal bit for bit. Without a mesh the step is the
same code on one rank, where every collective is the identity.

``Trainer`` is the driver: deterministic resumable data, checkpoint and
restart, NaN / loss-spike detection with batch skip, and periodic and
final checkpoints. A skipped batch leaves params and state untouched: the
step checks the loss (which the forward gives before any update) before
it applies the update. ``Trainer(mesh=)`` drives the sharded step, as the
JAX ``Trainer`` runs sharded when its params are; its checkpoints hold
global arrays and restore onto any mesh (``checkpoint.manager``).
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
from repro_torch.parallel.collectives import RankRunner, current
from repro_torch.parallel.sharding import (Columns, P,
                                           check_tensor_parallel,
                                           model_shared, opt_pspecs,
                                           serving_layout, shard_batch,
                                           shard_tree, unshard_tree)
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from .compression import ef_compress, psum_hierarchical
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
    leaf's dtype; zeros where a leaf does not reach the loss): the
    one-rank case of :func:`sharded_loss_and_grads`."""
    runner = RankRunner([tree_leaves(params)[0].device])
    loss, metrics, (grads,) = sharded_loss_and_grads(model, runner, [params],
                                                     [batch], qc)
    return loss, metrics, grads


def _microbatches(batch, n: int):
    """The global batch's ``n`` microbatches (rows [i B/n, (i+1) B/n))."""
    if n == 1:
        return [batch]
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(model, qc: QuantConfig, tc: TrainConfig,
                    stage: int = 3, mesh=None, layout=None,
                    runner=None) -> Callable:
    """Returns ``step_fn(params, opt_state, batch, step, accept=None) ->
    (params, opt_state, metrics)``.

    stage: LUTBoost stage (2 = centroids only, 3 = joint); ignored in
    dense mode. ``accept(loss)``, when given, sees the batch's loss first;
    if it returns False the update is not applied (params and state stay
    as they were) and ``metrics["skipped"]`` is True.

    With ``mesh`` (a ``launch.mesh.Mesh`` with a ``model`` axis and any
    of ``pod`` / ``data``) the step is sharded: ``params`` and
    ``opt_state`` are lists of per-rank trees in the order of
    ``mesh.devices.flat`` (``shard_tree(params, layout, mesh,
    copy=True)``, ``init_opt_state(..., mesh=)``), ``layout`` the params'
    spec tree, ``batch`` the global batch on any device. Metrics are on
    rank 0's device. Without one, ``params`` and ``opt_state`` are trees
    and the step is the same code on one rank (a runner over the params'
    device), where every collective is the identity.
    """
    shared = None
    if mesh is not None:
        if layout is None:
            raise ValueError("a sharded train step needs the params' "
                             "layout (parallel.sharding.serving_layout)")
        if "model" not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no 'model' axis")
        check_tensor_parallel(model.cfg, mesh.shape["model"], qc)
        runner = runner or RankRunner(mesh=mesh)
        shared = shared_entries(layout)
    n = tc.microbatches

    def ranked(run, params, opt_state, batch, step, accept):
        _own_storage(list(zip(params, opt_state)))
        gsum, lsum = None, None
        for mb in _microbatches(batch, n):
            parts = ([mb] if mesh is None else
                     shard_batch(mb, model.cfg, mesh, only=run.ranks))
            loss, metrics, g = sharded_loss_and_grads(model, run, params,
                                                      parts, qc)
            if n > 1:           # accumulated in fp32, as the reference
                g = [tree_map(lambda t: t.float(), x) for x in g]
                loss = loss.float()
            lsum = loss if lsum is None else lsum + loss
            gsum = g if gsum is None else [tree_map(torch.add, a, b)
                                           for a, b in zip(gsum, g)]
            del g
        if n > 1:
            loss = lsum * (1.0 / n)
            metrics = {"loss": loss}
        metrics = dict(metrics)
        if accept is not None and not accept(float(loss)):
            metrics.update(loss=loss, skipped=True)
            return params, opt_state, metrics
        lr = cosine_lr(step, tc.lr, tc.warmup, tc.total_steps)

        def update(tp):
            r = tp.me
            grads = reduce_grads(gsum[r], shared)
            gsum[r] = None
            if n > 1:
                grads = tree_map(lambda t: t * (1.0 / n), grads)
            new_opt = dict(opt_state[r])
            if tc.compress_grads:
                grads, new_opt["ef"] = ef_compress(grads,
                                                   opt_state[r].get("ef"))
                grads = tree_map(lambda g: g.float(), grads)
            grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, shared)
            mask = (stage_mask(params[r], 2) if qc.is_lut and stage == 2
                    else None)
            _, new_opt["adam"] = adamw_update(
                grads, opt_state[r]["adam"], params[r], lr,
                weight_decay=tc.weight_decay, mask=mask)
            return new_opt, gnorm

        with torch.no_grad():
            outs = run.run(update)
        metrics.update({"grad_norm": outs[0][1], "lr": lr, "loss": loss,
                        "skipped": False})
        return params, [o for o, _ in outs], metrics

    def step_fn(params, opt_state, batch, step, accept=None):
        if mesh is not None:
            return ranked(runner, params, opt_state, batch, step, accept)
        one = RankRunner([tree_leaves(params)[0].device])
        _, (opt_state,), metrics = ranked(one, [params], [opt_state], batch,
                                          step, accept)
        return params, opt_state, metrics

    step_fn.runner = runner
    return step_fn


def sharded_loss_and_grads(model, runner: RankRunner, shards, parts,
                           qc: QuantConfig):
    """Every rank's forward through ``runner`` (``shards`` and ``parts``
    one tree a rank), then one ``torch.autograd.grad`` of the data groups'
    mean loss (each group's loss taken once, from its ``model`` rank 0).
    Returns (loss, metrics averaged over the data groups, one gradient
    tree a rank, each leaf in its dtype). An entry that several ranks hold
    has one part of its gradient on each copy (:func:`reduce_grads` sums
    them)."""
    lives = [[t.detach().requires_grad_(True) for t in tree_leaves(tree)]
             for tree in shards]
    tracked = []
    for tree, live in zip(shards, lives):
        it = iter(live)
        tracked.append(tree_map(lambda _: next(it), tree))
    outs = runner.run(lambda tp: model.loss(tracked[tp.me], parts[tp.me],
                                            qc))
    heads = [r for r, h in enumerate(runner.handles) if h.rank == 0]
    dev = runner.devices[0]

    def mean(values):
        total = values[0].to(dev)
        for v in values[1:]:
            total = total + v.to(dev)
        return total / len(values) if len(values) > 1 else total
    loss = mean([outs[r][0] for r in heads])
    flat = [t for live in lives for t in live]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    metrics = {key: mean([outs[r][1][key].detach() for r in heads])
               for key in outs[heads[0]][1]}
    it = iter(torch.zeros_like(t) if g is None else g
              for g, t in zip(grads, flat))
    del grads
    return (loss.detach(), metrics,
            [tree_map(lambda _: next(it), tree) for tree in shards])


@torch.no_grad()
def reduce_grads(grads, shared):
    """Inside a rank of the sharded step: the rank's gradient parts summed
    over their copies: over the ``model`` axis where ``shared`` (the tree
    of ``parallel.sharding.model_shared``; None on one rank) says every
    rank of the axis holds the entry, then over ``data`` and ``pod``
    (``psum_hierarchical``). Returns the tree of the GSPMD gradient's
    shards."""
    tp = current()

    def model_sum(g, sh):
        if sh is None or tp.size == 1:
            return g
        if sh == "all":
            return tp.all_reduce(g)
        # out of place: the other ranks read this rank's part after it
        # has gone on
        n = g.shape[sh.axis]
        return torch.cat([g.narrow(sh.axis, 0, sh.lo),
                          tp.all_reduce(g.narrow(sh.axis, sh.lo,
                                                 sh.hi - sh.lo)),
                          g.narrow(sh.axis, sh.hi, n - sh.hi)], sh.axis)
    if shared is not None:
        grads = tree_map(model_sum, grads, shared)
    return psum_hierarchical(grads)


def shared_entries(layout):
    """The tree of ``parallel.sharding.model_shared`` of every spec of
    ``layout``: what :func:`reduce_grads` and the norm of
    ``optimizer.clip_by_global_norm`` read."""
    return tree_map_with_path(lambda _, spec: model_shared(spec), layout,
                              leaf=lambda x: isinstance(x, (P, Columns)))


def _own_storage(shards) -> None:
    """Refuse shards (params and optimizer state, one tree a rank) that
    share storage across ranks: each rank updates its own in place."""
    seen = {}
    for r, tree in enumerate(shards):
        for t in tree_leaves(tree):
            if not t.numel():
                continue
            key = (t.device, t.untyped_storage().data_ptr())
            if seen.setdefault(key, r) != r:
                raise ValueError(
                    "two ranks' shards share storage (a replicated leaf "
                    "placed once a device): place training shards with "
                    "shard_tree(..., copy=True)")


def init_opt_state(params, tc: TrainConfig, mesh=None) -> Dict[str, Any]:
    """AdamW's zero state (and zero error-feedback residuals with
    ``tc.compress_grads``); with ``mesh``, ``params`` is the list of
    per-rank shards and so is the result."""
    if mesh is not None:
        return [init_opt_state(p, tc) for p in params]
    opt: Dict[str, Any] = {"adam": adamw_init(params)}
    if tc.compress_grads:
        opt["ef"] = tree_map(lambda p: torch.zeros_like(p,
                                                        dtype=torch.float32),
                             params)
    return opt


class Trainer:
    """Fault-tolerant training driver.

    With ``mesh`` it drives the sharded step: :meth:`run` takes the global
    params (and optimizer state, if any) on any device, the host
    included, places each rank's shards (``serving_layout``; copies, so
    the params given are not changed), trains, and returns the global
    params and optimizer state on the device of the params given. Its
    checkpoints hold global arrays; a resume re-places them onto this
    trainer's mesh, whatever mesh (or none) saved them.
    """

    def __init__(self, model, dataset, qc: QuantConfig, tc: TrainConfig,
                 checkpoint_dir: Optional[str] = None,
                 lutboost: Optional[LutBoostSchedule] = None,
                 log_fn: Callable[[str], None] = print, mesh=None):
        self.mesh = mesh
        self.layout = None
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
            self._steps[stage] = make_train_step(
                self.model, self.qc, self.tc, stage, self.mesh,
                self.layout)
        return self._steps[stage]

    def _stage(self, step: int) -> int:
        if self.lutboost is None or not self.qc.is_lut:
            return 3
        return self.lutboost.stage(step)

    def _place(self, state):
        """The global (params, optimizer state) in the step's form: the
        trees themselves without a mesh, else the lists of every rank's
        copy of its cut."""
        if self.mesh is None:
            return state
        ranks = shard_tree(state, self._state_layout(), self.mesh,
                           copy=True)
        return [p for p, _ in ranks], [o for _, o in ranks]

    def _gather(self, params, opt_state, device):
        """:meth:`_place` undone: the global (params, optimizer state)."""
        if self.mesh is None:
            return params, opt_state
        return unshard_tree(list(zip(params, opt_state)),
                            self._state_layout(), self.mesh, device)

    def _state_layout(self):
        return self.layout, opt_pspecs(self.layout, self.tc)

    def run(self, params, opt_state=None, start_step: int = 0,
            num_steps: Optional[int] = None) -> Tuple[Any, Any, Dict]:
        """Train from ``start_step`` (or the latest checkpoint) for
        ``num_steps`` steps (default: up to ``tc.total_steps``). Returns
        (params, opt_state, {"loss": [...], "step_time": [...]}) over the
        steps taken."""
        tc = self.tc
        home = tree_leaves(params)[0].device
        if self.mesh is not None:
            self.layout = serving_layout(params, self.model.cfg,
                                         self.mesh.shape["model"])
            self._steps = {}
        if opt_state is None:
            # under a mesh the zeros are made shard by shard (meta leaves)
            opt_state = init_opt_state(
                params if self.mesh is None else
                tree_map(lambda t: t.to("meta"), params), tc)
        state = (params, opt_state)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, start_step, _ = self.ckpt.restore(state)
            self.log(f"[trainer] resumed from step {start_step}")
        params, opt_state = self._place(state)
        del state

        def save(step, ema):
            self.ckpt.save(step, self._gather(params, opt_state, "cpu"),
                           extra={"ema_loss": ema})

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
                save(step, ema_loss)
            step += 1

        if self.ckpt is not None:
            save(step, ema_loss)
        params, opt_state = self._gather(params, opt_state, home)
        return params, opt_state, history
