"""Slot-level scheduler for continuous batching (port of
``repro.serve.scheduler``).

Pure host-side policy: it never touches device tensors. It owns a
bounded, priority-ordered waiting queue and ``num_slots`` slots, each a
small state machine::

    FREE ──admit──▶ PREFILL ──last chunk──▶ DECODE ──EOS/max_new──▶ FREE
                       ▲                       │
                       └────── preempt ◀───────┘   (pages reclaimed,
                                                    request re-queued with
                                                    its generated tokens
                                                    folded into the prompt)

A request is admitted the moment a slot frees, mid-decode included, as
long as the page pool can hold its prompt; a prompt that shares a
page-aligned prefix with cached pages maps them and starts prefill past
them. Prefill is chunked (the engine interleaves one chunk with each
decode step).

Fault tolerance:
  * the waiting queue is ordered by ``(-priority, submission order)``:
    higher priority admits first, FIFO within a priority class;
  * the queue is bounded (``max_queue``): overflow sheds the
    lowest-priority, newest request with ``finish_reason = LoadShedded``
    instead of raising, so no request is silently lost;
  * requests carry a ``deadline_steps`` budget; the engine evicts
    past-deadline slots (and expires queued requests) with
    ``finish_reason = FinishReason.DEADLINE``, keeping partial output;
  * ``retries`` counts re-admissions (preemption, replica crash
    recovery); the :class:`~repro_torch.serve.router.ReplicaRouter`
    backs off by it.

Eviction rules:
  * EOS sampled (when ``eos_id`` is configured)         -> evict, free pages.
  * ``len(out_tokens) == max_new_tokens``               -> evict, free pages.
  * the sequence reached ``max_seq``                    -> evict (truncated).
  * deadline expired                                    -> evict (expired).
  * page pool exhausted mid-decode                      -> preempt the slot
    with the fewest cached tokens (recompute-style: its prompt + generated
    tokens re-enter the queue at the front, nothing is lost).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import logging
import time
from collections import deque
from typing import Deque, List, Optional

from repro_torch.obs import Obs

from .kv_cache import PagedKVCache

log = logging.getLogger(__name__)

_SUBMIT_SEQ = itertools.count()


class FinishReason(enum.Enum):
    """Why a request's ``done`` flag was set (``Request.finish_reason``).

    Every request an engine or router ever accepted ends with exactly one
    of these — the fault-tolerance contract is that *no request is
    silently lost*; chaos tests assert it.
    """
    COMPLETED = "completed"     # EOS sampled or max_new_tokens reached
    TRUNCATED = "truncated"     # max_seq / pool can never grow the sequence
    LOAD_SHED = "load_shed"     # dropped by bounded-queue admission control
    DEADLINE = "deadline"       # deadline_steps expired before completion


#: Alias for the shed outcome — ``req.finish_reason is LoadShedded``.
LoadShedded = FinishReason.LOAD_SHED


@dataclasses.dataclass
class Request:
    """One generation request.

    Attributes:
      tokens: prompt token ids.
      max_new_tokens: generation budget.
      temperature: 0 = greedy; >0 = categorical over logits/T.
      priority: admission priority (higher admits first; load shedding
        drops the lowest first). Default 0.
      deadline_steps: optional completion deadline in engine steps,
        relative to ``arrival``: a request still unfinished once
        ``step - arrival >= deadline_steps`` is evicted with
        ``finish_reason = FinishReason.DEADLINE`` (its partial
        ``out_tokens`` are kept). ``None`` = no deadline.
      out_tokens: generated ids (appended by the engine).
      done: set once the request finishes (see ``finish_reason``).
      finish_reason: why ``done`` was set (:class:`FinishReason`).
      arrival / first_token_step / finish_step: engine-step timestamps for
        latency reporting (arrival is caller-settable; ``Engine.submit``
        stamps the current step when unset, which also anchors the
        deadline clock).
      cached_tokens: prompt tokens served from the prefix cache instead of
        being prefilled, accumulated across (re-)admissions — the
        per-request cache-hit stat surfaced in results.
      retries: re-admissions of this request — preemption requeues and
        replica-crash recoveries. The router's requeue backoff is
        ``min(cap, base · 2^(retries-1))`` router steps.
      arrival_ts / first_token_ts / finish_ts: wall-clock
        (``perf_counter``) twins of the step stamps, taken at the same
        already-host points — the ``req.*_s`` latency families in
        ``obs.metrics`` come from these.
    """
    tokens: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    priority: int = 0
    deadline_steps: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[FinishReason] = None
    arrival: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    cached_tokens: int = 0
    retries: int = 0
    arrival_ts: Optional[float] = dataclasses.field(default=None,
                                                    repr=False)
    first_token_ts: Optional[float] = dataclasses.field(default=None,
                                                        repr=False)
    finish_ts: Optional[float] = dataclasses.field(default=None,
                                                   repr=False)
    # queue tiebreaker: submission order within a priority class
    _seq: int = dataclasses.field(default=-1, repr=False, compare=False)

    def finish(self, reason: FinishReason, step: Optional[int]) -> None:
        """Stamp a terminal outcome (exactly once — first reason wins)."""
        if self.done:
            return
        self.done = True
        self.finish_reason = reason
        self.finish_ts = time.perf_counter()
        if self.finish_step is None:
            self.finish_step = step

    def past_deadline(self, step: int) -> bool:
        """Whether ``deadline_steps`` expired at engine step ``step``."""
        return (self.deadline_steps is not None
                and self.arrival is not None
                and step - self.arrival >= self.deadline_steps)

    @property
    def shed(self) -> bool:
        return self.finish_reason is LoadShedded


class SlotPhase(enum.Enum):
    FREE = "free"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclasses.dataclass
class Slot:
    """One batch lane. ``pos`` counts the tokens whose KV/state is cached;
    ``next_token`` is the sampled-but-not-yet-decoded token id;
    ``prompt`` is the admission-time prompt (request tokens + any
    re-queued generated tokens), built once instead of per chunk."""
    idx: int
    phase: SlotPhase = SlotPhase.FREE
    req: Optional[Request] = None
    pos: int = 0
    prefill_len: int = 0          # prompt length incl. re-queued tokens
    prompt: List[int] = dataclasses.field(default_factory=list)
    next_token: Optional[int] = None

    @property
    def free(self) -> bool:
        return self.phase is SlotPhase.FREE


class SlotScheduler:
    """Admission / eviction / preemption policy over a fixed slot set.

    ``max_queue`` bounds the waiting queue: a ``submit`` that would
    overflow it sheds the lowest-priority (newest within a class)
    request — possibly the incoming one — and returns it so the caller
    can surface the :data:`LoadShedded` outcome. ``None`` = unbounded
    (the pre-fault-tolerance behaviour). Requeues of already-admitted
    work (preemption, crash recovery) are exempt from the bound — a
    request that made it into a slot is never shed on its way back.
    """

    def __init__(self, num_slots: int, max_queue: Optional[int] = None,
                 obs: Optional[Obs] = None):
        self.slots = [Slot(i) for i in range(num_slots)]
        self.waiting: Deque[Request] = deque()
        self.max_queue = max_queue
        # The engine passes its Obs so scheduler tallies land in the same
        # registry; a standalone scheduler gets a private one — the
        # counters below are live either way (tests construct bare
        # schedulers and read shed_count/expired_count).
        self.obs = obs if obs is not None else Obs()
        met = self.obs.metrics
        self._c_shed = met.counter("sched.shed_requests", unit="requests",
                                   desc="requests dropped by the bounded "
                                        "admission queue")
        self._c_expired = met.counter("sched.expired_requests",
                                      unit="requests",
                                      desc="requests past deadline_steps")
        self._c_preempt = met.counter("sched.preemptions",
                                      unit="preemptions")

    @property
    def shed_count(self) -> int:
        return self._c_shed.value

    @property
    def expired_count(self) -> int:
        return self._c_expired.value

    @property
    def preemptions(self) -> int:
        return self._c_preempt.value

    # -- queue --------------------------------------------------------------
    def _insert(self, req: Request) -> None:
        """Keep ``waiting`` sorted by (-priority, submission seq)."""
        if req._seq < 0:
            req._seq = next(_SUBMIT_SEQ)
        key = (-req.priority, req._seq)
        for i, r in enumerate(self.waiting):
            if (-r.priority, r._seq) > key:
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def submit(self, req: Request) -> Optional[Request]:
        """Enqueue a request (priority order, FIFO within a class).

        Returns the request shed to stay within ``max_queue`` (``None``
        when nothing was dropped). The shed request — the lowest-priority,
        newest one, possibly ``req`` itself — comes back marked
        ``done`` with ``finish_reason = LoadShedded``; the caller stamps
        its ``finish_step``."""
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            if req._seq < 0:
                req._seq = next(_SUBMIT_SEQ)
            # shed the least valuable: lowest priority, then newest
            victim = min([*self.waiting, req],
                         key=lambda r: (r.priority, -r._seq))
            if victim is not req:
                self.waiting.remove(victim)
                self._insert(req)
            victim.finish(LoadShedded, None)
            self._c_shed.inc()
            log.info("load-shed request (priority=%d, queue=%d/%s)",
                     victim.priority, len(self.waiting), self.max_queue)
            return victim
        self._insert(req)
        return None

    def requeue(self, req: Request, front: bool = True,
                count_retry: bool = True) -> None:
        """Re-enter an already-admitted request (preemption / crash
        recovery): exempt from the queue bound, placed at the FRONT by
        default to keep completion order close to FIFO. Counts a retry
        unless the caller already did (``count_retry=False``)."""
        if count_retry:
            req.retries += 1
        if front:
            self.waiting.appendleft(req)
        else:
            self._insert(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(not s.free for s in self.slots)

    @property
    def queue_room(self) -> float:
        """Free waiting-queue capacity (``inf`` when unbounded)."""
        if self.max_queue is None:
            return float("inf")
        return max(0, self.max_queue - len(self.waiting))

    def prefill_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.phase is SlotPhase.PREFILL]

    def decode_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.phase is SlotPhase.DECODE]

    def occupied_slots(self) -> List[Slot]:
        return [s for s in self.slots if not s.free]

    # -- deadlines ----------------------------------------------------------
    def expire_deadlines(self, step: int, kv: PagedKVCache) -> List[Request]:
        """Evict slots and drop queued requests whose deadline passed.

        Returns the expired requests (each finished with
        ``FinishReason.DEADLINE``; partial output is kept). Called at the
        top of every engine step, before admission — an expired queued
        request never wastes prefill work."""
        expired: List[Request] = []
        for slot in self.occupied_slots():
            if slot.req.past_deadline(step):
                req = slot.req
                req.finish(FinishReason.DEADLINE, step)
                log.info("deadline expired in slot %d after %d tokens",
                         slot.idx, len(req.out_tokens))
                self.evict(slot, kv)
                expired.append(req)
        if self.waiting:
            keep: List[Request] = []
            for req in self.waiting:
                if req.past_deadline(step):
                    req.finish(FinishReason.DEADLINE, step)
                    expired.append(req)
                else:
                    keep.append(req)
            if len(keep) != len(self.waiting):
                self.waiting = deque(keep)
        self._c_expired.inc(len(expired))
        return expired

    # -- admission ----------------------------------------------------------
    def admit(self, kv: PagedKVCache) -> List[Slot]:
        """Move waiting requests into free slots while pages allow.

        Called at the top of every engine step, so a request is admitted on
        the very step its slot was evicted (admission mid-decode). Stops at
        the first request whose prompt pages don't fit *right now* (the
        queue is priority-ordered; no skipping within it, so no starvation
        inside a priority class). Raises :class:`PagePoolExhausted` via
        ``check_admissible`` for requests that could never fit.

        Prefix caching: the request's prompt is probed against the page
        index first; matched pages are mapped read-shared (only UNSHARED
        pages count against capacity) and the slot starts prefill at the
        first uncached token (``slot.pos``).
        """
        admitted: List[Slot] = []
        for slot in self.slots:
            if not self.waiting:
                break
            if not slot.free:
                continue
            req = self.waiting[0]
            prompt = list(req.tokens) + list(req.out_tokens)
            # The prompt itself must fit; a prompt of exactly max_seq is
            # still servable (it truncates after its first sampled token —
            # the engine's eviction rule), and a preempted request can
            # legitimately come back at that boundary.
            kv.check_admissible(len(prompt))
            match = kv.match_prefix(prompt)
            if not kv.can_fit(len(prompt), match):
                break                              # wait for evictions
            self.waiting.popleft()
            matched = kv.adopt_prefix(slot.idx, match)
            kv.ensure(slot.idx, len(prompt))
            slot.req = req
            slot.phase = SlotPhase.PREFILL
            slot.pos = matched           # prefill starts past the reuse
            slot.prefill_len = len(prompt)
            slot.prompt = prompt
            slot.next_token = None
            req.cached_tokens += matched
            admitted.append(slot)
        if (self.waiting and not admitted
                and all(s.free for s in self.slots)):
            # Nothing running, nothing admitted. With unit-size pages an
            # idle pool can always satisfy any statically-servable
            # request, so this is either a genuine capacity error
            # (check_admissible raises with the pool accounting) or pages
            # are transiently held OUTSIDE the scheduler (fault
            # injection / an external holder) — then wait, don't error.
            req = self.waiting[0]
            kv.check_admissible(len(req.tokens) + len(req.out_tokens))
        return admitted

    # -- prefill ------------------------------------------------------------
    def next_prefill(self) -> Optional[Slot]:
        """Slot to run the next prefill chunk for (lowest remaining first,
        so short prompts reach decode — and free their lane — sooner)."""
        cands = self.prefill_slots()
        if not cands:
            return None
        return min(cands, key=lambda s: (s.prefill_len - s.pos, s.idx))

    def prompt_chunk(self, slot: Slot, chunk: int) -> List[int]:
        """The next ``chunk`` prompt tokens for a PREFILL slot (unpadded).

        A preempted request's already-generated tokens are part of the
        prompt here (``slot.prompt``, built once at admission) —
        recompute-style resumption."""
        return slot.prompt[slot.pos:slot.pos + chunk]

    def finish_prefill(self, slot: Slot, first_token: int) -> None:
        """Prefill complete: switch to DECODE with the sampled token."""
        slot.phase = SlotPhase.DECODE
        slot.next_token = int(first_token)

    # -- eviction / preemption ----------------------------------------------
    def evict(self, slot: Slot, kv: PagedKVCache) -> None:
        """Release a finished slot: decref its pages, slot FREE.

        A page shared with another slot stays live (its refcount is still
        positive); an unreferenced page that the prefix cache indexes is
        parked for future reuse; everything else returns to the free
        list."""
        kv.release(slot.idx)
        slot.req = None
        slot.phase = SlotPhase.FREE
        slot.pos = 0
        slot.prefill_len = 0
        slot.prompt = []
        slot.next_token = None

    def preempt(self, slot: Slot, kv: PagedKVCache) -> Request:
        """Preempt one occupied slot: pages reclaimed, request re-queued
        at the front with its generated tokens folded into the prompt on
        re-admission (recompute-style — nothing is lost, greedy output
        stays token-identical). Idempotent with respect to request state:
        everything the resumed prefill needs is derivable from
        ``req.tokens + req.out_tokens``; ``arrival`` / ``cached_tokens``
        / ``first_token_step`` stamps are untouched."""
        req = slot.req
        log.info(
            "preempting slot %d (%s, %d cached tokens) to reclaim pages; %s",
            slot.idx, slot.phase.value, slot.pos, kv.occupancy())
        self._c_preempt.inc()
        self.obs.annotate("preempt", slot=slot.idx,
                          phase=slot.phase.value, cached=slot.pos)
        self.evict(slot, kv)
        self.requeue(req, front=True)
        return req

    def preempt_youngest(self, kv: PagedKVCache,
                         exclude: Optional[int] = None) -> Optional[Slot]:
        """Reclaim pages by preempting the occupied slot with the fewest
        cached tokens (least recompute lost) — decoding or still
        prefilling (a prefilling slot can hold several prompt pages and
        must be preemptible, or a decode step that needs one page with
        only prefill neighbours would dead-end). The request re-enters
        the waiting queue at the FRONT, keeping FIFO completion order
        close; generated tokens (if any) are folded into the prompt on
        re-admission, so nothing is lost.

        exclude: slot index that must not be preempted (the slot the pages
        are being reclaimed *for*)."""
        cands = [s for s in self.slots
                 if not s.free and s.idx != exclude]
        if not cands:
            return None
        victim = min(cands, key=lambda s: (s.pos, -s.idx))
        self.preempt(victim, kv)
        return victim

    # -- crash recovery -----------------------------------------------------
    def drain_requests(self, kv: PagedKVCache) -> List[Request]:
        """Pull every in-flight request out of this scheduler (crash
        recovery: the router requeues them onto healthy replicas).

        Slots are evicted (host-side page bookkeeping — harmless even
        when the device state is gone) and the waiting queue is cleared.
        Returns the unfinished requests in deterministic order: waiting
        queue first (they were next in line nowhere else), then slots by
        index. ``out_tokens`` / ``arrival`` / ``cached_tokens`` stamps
        travel with each request — re-prefill on the adopting replica
        folds the generated tokens into the prompt exactly like a
        preemption requeue, so greedy output is token-identical."""
        out: List[Request] = [r for r in self.waiting if not r.done]
        self.waiting.clear()
        for slot in self.occupied_slots():
            req = slot.req
            try:
                self.evict(slot, kv)
            except Exception:          # crashed replica: best-effort cleanup
                log.exception("evict during crash recovery failed "
                              "(slot %d)", slot.idx)
                slot.req, slot.phase = None, SlotPhase.FREE
                slot.pos, slot.prefill_len = 0, 0
                slot.prompt, slot.next_token = [], None
            if req is not None and not req.done:
                out.append(req)
        # a request can appear once only (a slot's req is never queued),
        # but be defensive about double-recovery
        seen, uniq = set(), []
        for r in out:
            if id(r) not in seen:
                seen.add(id(r))
                uniq.append(r)
        return uniq
