"""AdamW, gradient clipping and the cosine LR schedule (port of
``repro.train.optimizer``).

State is a plain tree ``{"m": ..., "v": ..., "count": 0-d int32}`` (fp32
moments) so it checkpoints with the same machinery as the params. A
trainable mask (LUTBoost stage ②, centroids only) leaves the frozen
leaves and their moments bit for bit as they were.

Where the JAX package returns new trees, :func:`adamw_update` writes the
new values into ``params`` and the moments in place and returns them, and
:func:`clip_by_global_norm` scales the gradients in place: a full-width
model's moments are four times its bf16 weights, and a second copy of
any of them would not fit on the card beside them.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params) -> dict:
    """Zero fp32 moments on each leaf's device, and a count of 0."""
    def zeros(p):
        return tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                        p)
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(grads, state, params, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mask: Optional[Any] = None) -> Tuple[Any, dict]:
    """One AdamW step, in place. Returns (params, state).

    mask: optional tree of bools; a False leaf is left untouched (its
    gradient ignored, its moments frozen), as LUTBoost stage ② needs. The
    count advances either way, as in the JAX package.
    """
    count = int(state["count"]) + 1
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    lr = float(lr)
    g_l, m_l, v_l, p_l = (tree_leaves(t) for t in (grads, state["m"],
                                                   state["v"], params))
    keep = ([True] * len(p_l) if mask is None else tree_leaves(mask))
    for g, m, v, p, k in zip(g_l, m_l, v_l, p_l, keep):
        if not k:
            continue
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        del g32
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            update += weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
    state["count"] = torch.tensor(count, dtype=torch.int32)
    return params, state


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / ||grads||), the norm over
    all leaves in fp32, in place (a second copy of a full-width model's
    gradients would not fit beside its moments). Returns (grads, the norm
    as a 0-d fp32 tensor)."""
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in leaves:
        g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


def cosine_lr(step, base_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1) -> float:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``."""
    step = float(step)
    if step < warmup:
        return base_lr * min(1.0, step / max(warmup, 1))
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                      * (1 + math.cos(math.pi * t)))
