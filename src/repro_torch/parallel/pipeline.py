"""GPipe pipeline parallelism over a ``stage`` axis of ranks (port of
``repro.parallel.pipeline``), forward only, as the reference is.

Each rank along the ``stage`` axis holds one slice of the layer stack;
microbatches stream through with :meth:`~repro_torch.parallel.
collectives.TP.permute` (the reference's ``collective_permute``) moving
activations stage to stage. The schedule is the classic GPipe
fill / steady / drain of ``n_micro + n_stages - 1`` ticks, tick for tick
the reference's: on every tick every stage applies its block to the
activation it holds (zeros before the first microbatch reaches it, as in
the reference), stage 0 takes in microbatch t while t < n_micro, and the
last stage keeps the output of microbatch ``t - n_stages + 1``. The
ranks of one :class:`~repro_torch.parallel.collectives.RankRunner` run
the stages (several may share one card).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.collectives import RankRunner, current
from repro_torch.tree import tree_map


def pipeline(block_fn: Callable, n_stages: int, n_micro: int,
             axis: str = "stage") -> Callable:
    """Build a pipelined forward to run inside a rank of a runner whose
    mesh has ``axis``: ``f(stage_params, x_micro) -> y_micro``.

    ``block_fn(params, x) -> y`` applies one stage's layers;
    ``stage_params`` is this rank's stage's params (the slice along the
    stacked leading dim), ``x_micro`` (n_micro, mb, ...) the replicated
    microbatches. Returns (n_micro, mb, ...): on the axis' rank 0 the
    last stage's outputs (the reference's closing permute)."""

    def staged(params_me, x_micro):
        tp = current().over(axis)
        if tp.size != n_stages:
            raise ValueError(f"axis {axis!r} has {tp.size} ranks, the "
                             f"pipeline {n_stages} stages")
        stage = tp.rank
        state = torch.zeros_like(x_micro[0])          # current activation
        outputs = torch.zeros_like(x_micro)           # kept at last stage
        shift = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        for t in range(n_micro + n_stages - 1):
            if stage == 0 and t < n_micro:            # inject microbatch t
                state = x_micro[t]
            y = block_fn(params_me, state)
            if stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = y
            state = tp.permute(y, shift)              # stage i -> i + 1
        return tp.permute(outputs, [((n_stages - 1 + i) % n_stages, i)
                                    for i in range(n_stages)])

    return staged


def run_pipeline(mesh, block_fn: Callable, stage_params, x: torch.Tensor,
                 n_micro: int, axis: str = "stage") -> torch.Tensor:
    """Place ``stage_params`` (a tree whose leaves have a leading dim of
    ``mesh.shape[axis]``, one slice a stage) and ``x`` (B, ...) on the
    ranks of ``mesh``, cut ``x`` into ``n_micro`` microbatches, run the
    pipeline, and return its (B, ...) output from the first rank."""
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} "
                         "microbatches")
    x_micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    runner = RankRunner(mesh=mesh)
    staged = pipeline(block_fn, n_stages, n_micro, axis)

    def rank(tp):
        stage = tp.over(axis).rank
        mine = tree_map(lambda t: t[stage].to(tp.device), stage_params)
        return staged(mine, tp.local(x_micro))

    with torch.no_grad():
        y_micro = runner.run(rank)[0]
    return y_micro.reshape(b, *x.shape[1:])
