"""Serving: continuous-batching engine over a paged LUT-aware KV cache
(port of ``repro.serve``).

Public surface:
  * :class:`Engine`: slot-scheduled continuous batching (the default),
    with prefix caching, a bounded priority queue with deadlines, the
    degradation ladder and optional speculative decoding.
  * :class:`ReplicaRouter`: data-parallel dispatch across engine
    replicas, with per-replica health (:class:`ReplicaHealth`), a step
    watchdog, graceful drain and crash recovery.
  * :class:`BatchToCompletionEngine`: the fixed-batch baseline.
  * :class:`Request`: one generation request (``priority``,
    ``deadline_steps``, ``finish_reason``: :class:`FinishReason`).
  * :class:`PagedKVCache` / :class:`PageAllocator` /
    :class:`PagePoolExhausted`: the paged cache, with ref-counted pages
    and shared-prefix reuse (:class:`PrefixCache` / :class:`PrefixMatch`).
  * :class:`SlotScheduler`: admission, eviction and preemption policy.
  * :class:`DegradationPolicy`: the pressure-driven degradation ladder.
  * :class:`FaultSchedule` / :class:`FaultInjector`: deterministic fault
    injection (crashes, step errors, pool squeezes).
"""
from .engine import (BatchToCompletionEngine, DegradationPolicy, Engine,
                     MODE_NO_SPEC, MODE_NORMAL, MODE_SHRINK_PREFILL,
                     MODE_STOP_ADMIT, greedy_generate)
from .faults import Fault, FaultInjector, FaultSchedule, ReplicaCrashed
from .kv_cache import (PageAllocator, PagePoolExhausted, PagedKVCache,
                       PageTable, PrefixCache, PrefixMatch)
from .router import ReplicaHealth, ReplicaRouter, ReplicaStatus
from .scheduler import (FinishReason, LoadShedded, Request, Slot, SlotPhase,
                        SlotScheduler)
from .speculative import (Drafter, ModelDrafter, NgramDrafter, SpecConfig,
                          accept_tokens)

__all__ = [
    "BatchToCompletionEngine", "DegradationPolicy", "Drafter", "Engine",
    "Fault", "FaultInjector", "FaultSchedule", "FinishReason",
    "LoadShedded", "MODE_NORMAL", "MODE_NO_SPEC", "MODE_SHRINK_PREFILL",
    "MODE_STOP_ADMIT", "ModelDrafter", "NgramDrafter", "PageAllocator",
    "PagePoolExhausted", "PagedKVCache", "PageTable", "PrefixCache",
    "PrefixMatch", "ReplicaCrashed", "ReplicaHealth", "ReplicaRouter",
    "ReplicaStatus", "Request", "Slot", "SlotPhase", "SlotScheduler",
    "SpecConfig", "accept_tokens", "greedy_generate",
]
