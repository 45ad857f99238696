"""Slot-level scheduler for continuous batching (port of
``repro.serve.scheduler``, without priorities, deadlines, load shedding or
a bounded queue; ROADMAP.md queue A lists them).

Pure host-side policy: it never touches device tensors. It owns a FIFO
waiting queue and ``num_slots`` slots, each a small state machine::

    FREE ──admit──▶ PREFILL ──last chunk──▶ DECODE ──EOS/max_new──▶ FREE
                       ▲                       │
                       └────── preempt ◀───────┘   (pages reclaimed,
                                                    request re-queued with
                                                    its generated tokens
                                                    folded into the prompt)

A request is admitted the moment a slot frees, mid-decode included, as
long as the page pool can hold its prompt. Prefill is chunked (the engine
interleaves one chunk with each decode step).

Eviction rules:
  * EOS sampled (when ``eos_id`` is configured)         -> evict, free pages.
  * ``len(out_tokens) == max_new_tokens``               -> evict, free pages.
  * the sequence reached ``max_seq``                    -> evict (truncated).
  * page pool exhausted mid-decode                      -> preempt the slot
    with the fewest cached tokens (recompute-style: its prompt + generated
    tokens re-enter the queue at the front, nothing is lost).
"""
from __future__ import annotations

import dataclasses
import enum
import logging
from collections import deque
from typing import Deque, List, Optional

from .kv_cache import PagedKVCache

log = logging.getLogger(__name__)


class FinishReason(enum.Enum):
    """Why a request's ``done`` flag was set."""
    COMPLETED = "completed"     # EOS sampled or max_new_tokens reached
    TRUNCATED = "truncated"     # max_seq / pool can never grow the sequence


@dataclasses.dataclass
class Request:
    """One generation request.

    Attributes:
      tokens: prompt token ids.
      max_new_tokens: generation budget.
      temperature: 0 = greedy; >0 = categorical over logits / T.
      out_tokens: generated ids (appended by the engine).
      done / finish_reason: set once, when the request finishes.
    """
    tokens: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[FinishReason] = None

    def finish(self, reason: FinishReason) -> None:
        """Stamp a terminal outcome (first reason wins)."""
        if not self.done:
            self.done = True
            self.finish_reason = reason


class SlotPhase(enum.Enum):
    FREE = "free"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclasses.dataclass
class Slot:
    """One batch lane. ``pos`` counts the tokens whose KV is cached;
    ``next_token`` is the sampled-but-not-yet-decoded token id; ``prompt``
    is the admission-time prompt (request tokens + any re-queued generated
    tokens)."""
    idx: int
    phase: SlotPhase = SlotPhase.FREE
    req: Optional[Request] = None
    pos: int = 0
    prefill_len: int = 0
    prompt: List[int] = dataclasses.field(default_factory=list)
    next_token: Optional[int] = None

    @property
    def free(self) -> bool:
        return self.phase is SlotPhase.FREE


class SlotScheduler:
    """Admission / eviction / preemption policy over a fixed slot set."""

    def __init__(self, num_slots: int):
        self.slots = [Slot(i) for i in range(num_slots)]
        self.waiting: Deque[Request] = deque()
        self.preemptions = 0

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(not s.free for s in self.slots)

    def prefill_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.phase is SlotPhase.PREFILL]

    def decode_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.phase is SlotPhase.DECODE]

    def admit(self, kv: PagedKVCache) -> List[Slot]:
        """Move waiting requests into free slots while pages allow.

        Stops at the first request whose prompt pages don't fit right now
        (FIFO, no skipping, so no starvation). Raises
        :class:`~repro_torch.serve.kv_cache.PagePoolExhausted` for a
        request that could never fit.
        """
        table = kv.table
        admitted: List[Slot] = []
        for slot in self.slots:
            if not self.waiting:
                break
            if not slot.free:
                continue
            req = self.waiting[0]
            prompt = list(req.tokens) + list(req.out_tokens)
            table.check_admissible(len(prompt))
            if not table.can_fit(len(prompt)):
                break                              # wait for evictions
            self.waiting.popleft()
            table.ensure(slot.idx, len(prompt))
            slot.req = req
            slot.phase = SlotPhase.PREFILL
            slot.pos = 0
            slot.prefill_len = len(prompt)
            slot.prompt = prompt
            slot.next_token = None
            admitted.append(slot)
        return admitted

    def next_prefill(self) -> Optional[Slot]:
        """Slot to run the next prefill chunk for (least remaining first,
        so short prompts reach decode, and free their lane, sooner)."""
        cands = self.prefill_slots()
        if not cands:
            return None
        return min(cands, key=lambda s: (s.prefill_len - s.pos, s.idx))

    def prompt_chunk(self, slot: Slot, chunk: int) -> List[int]:
        """The next ``chunk`` prompt tokens of a PREFILL slot (unpadded)."""
        return slot.prompt[slot.pos:slot.pos + chunk]

    def finish_prefill(self, slot: Slot, first_token: int) -> None:
        """Prefill complete: switch to DECODE with the sampled token."""
        slot.phase = SlotPhase.DECODE
        slot.next_token = int(first_token)

    def evict(self, slot: Slot, kv: PagedKVCache) -> None:
        """Release a slot: pages back to the pool, slot FREE."""
        kv.table.release(slot.idx)
        slot.req = None
        slot.phase = SlotPhase.FREE
        slot.pos = 0
        slot.prefill_len = 0
        slot.prompt = []
        slot.next_token = None

    def preempt_youngest(self, kv: PagedKVCache,
                         exclude: Optional[int] = None) -> Optional[Slot]:
        """Reclaim pages by preempting the occupied slot with the fewest
        cached tokens (least recompute lost), decoding or still
        prefilling. Its request re-enters the queue at the FRONT; its
        generated tokens are folded into the prompt on re-admission.

        exclude: slot index that must not be preempted (the slot the pages
        are being reclaimed for)."""
        cands = [s for s in self.slots if not s.free and s.idx != exclude]
        if not cands:
            return None
        victim = min(cands, key=lambda s: (s.pos, -s.idx))
        req = victim.req
        log.info("preempting slot %d (%s, %d cached tokens) to reclaim "
                 "pages; %s", victim.idx, victim.phase.value, victim.pos,
                 kv.table.occupancy())
        self.preemptions += 1
        self.evict(victim, kv)
        self.waiting.appendleft(req)
        return victim
