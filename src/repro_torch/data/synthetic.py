"""Synthetic token pipeline, deterministic and stateless to resume (port of
``repro.data.synthetic``).

A batch is a pure function of (seed, step, host_index): after a restart
at step k the pipeline replays batch k exactly, which with the checkpoint
manager gives a bit-exact resume. ``num_hosts`` / ``host_index`` split
the global batch, each host drawing its own shard.

The token stream is a successor chain, t[i] = (t[i-1] + 1) % V with 10%
random jumps: structured enough that a model measurably learns, and fully
synthetic. The draws come from a ``torch.Generator`` on the CPU (seeded
from (seed, step, host_index) through numpy's SeedSequence), so a batch
is the same whatever device it lands on; the JAX package's stream
differs. Audio and vlm batches wait for their families (ROADMAP.md queue
A item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _generator(seed: int, step: int, host_index: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, host_index]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1))


def _successor_tokens(gen: torch.Generator, b: int, s: int,
                     v: int) -> torch.Tensor:
    """(b, s) int32: each row starts one past a random token and steps by
    +1 (mod v), except where a jump (probability 0.1) draws a fresh
    token. Vectorised: a token is its last jump's value plus the steps
    since."""
    t0 = torch.randint(0, v, (b,), generator=gen)
    jumps = torch.rand((b, s), generator=gen) < 0.1
    rand = torch.randint(0, v, (b, s), generator=gen)
    idx = torch.arange(s).expand(b, s)
    last = torch.cummax(torch.where(jumps, idx, torch.full_like(idx, -1)),
                        dim=1).values                         # (b, s)
    base = torch.where(last >= 0,
                       torch.gather(rand, 1, last.clamp_min(0)),
                       t0[:, None] + 1)
    steps = torch.where(last >= 0, idx - last, idx)
    return ((base + steps) % v).to(torch.int32)


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide across hosts")
        if self.cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"{self.cfg.family} batches are not ported yet: ROADMAP.md "
                "queue A item 9 (Other families)")
        self.host_batch = self.global_batch // self.num_hosts

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This host's batch for ``step``: {"tokens": (host_batch,
        seq_len) int32} on ``device``."""
        gen = _generator(self.seed, step, self.host_index)
        toks = _successor_tokens(gen, self.host_batch, self.seq_len,
                                self.cfg.vocab_size)
        return {"tokens": toks.to(resolve_device(self.device))}
