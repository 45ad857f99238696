"""Data-parallel replica routing over continuous-batching engines (port of
``repro.serve.router``).

Each replica owns a full :class:`~repro_torch.serve.engine.Engine`: its
own :class:`SlotScheduler`, page pool and step loop, and the
:class:`ReplicaRouter` dispatches each incoming request to the replica
holding the longest cached prefix of its prompt, else the least loaded,
FIFO within a replica. Replica-level data parallelism keeps the
scheduler's host-side state machine per replica: admission, eviction and
preemption never need a cross-replica barrier. Replicas built on one
card (:meth:`ReplicaRouter.build`) share one params dict and each hold
their own page pool.

Fault tolerance: each replica carries a health state::

    HEALTHY ──step exception──▶ DEGRADED ──repeated / crash / stall──▶ DEAD
       ▲                           │                                    │
       └──── clean steps ◀─────────┘            in-flight requests ─────┘
                                                requeued w/ backoff onto
                                                healthy replicas
    HEALTHY/DEGRADED ──drain()──▶ DRAINING (no new admissions, finishes
                                  in-flight) ──undrain()──▶ HEALTHY

A step-level watchdog wraps every ``Engine.step``: an exception counts a
failure (DEGRADED; DEAD after ``max_step_failures`` consecutive ones or a
:class:`~repro_torch.serve.faults.ReplicaCrashed`), and a replica whose
progress marker does not move for ``stall_steps`` while it has work is
declared DEAD too. A dead replica's in-flight requests are drained
host-side and requeued onto the surviving replicas with capped
exponential backoff; re-prefill (through each replica's prefix cache)
resumes exactly, so greedy output stays token-identical.

:meth:`ReplicaRouter.step` steps replicas one after another, and each
engine step ends in a blocking device -> host read, so replicas stepped
by one host process do not overlap in wall-clock time: the router adds
capacity and isolation, not the throughput of one process.
:meth:`ReplicaRouter.from_mesh` builds one tensor-parallel engine a data
group of a mesh, all in this process (data parallelism over replicas,
tensor parallelism inside each).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import logging
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.lut import DENSE, QuantConfig
from repro_torch.obs import Obs

from .engine import Engine
from .faults import ReplicaCrashed
from .kv_cache import PagePoolExhausted
from .scheduler import Request

log = logging.getLogger(__name__)


class ReplicaHealth(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"    # recent step failures; still serving
    DRAINING = "draining"    # no new admissions; finishing in-flight
    DEAD = "dead"            # out of rotation; requests were requeued


#: Health states that accept new requests.
ADMITTING = (ReplicaHealth.HEALTHY, ReplicaHealth.DEGRADED)


@dataclasses.dataclass
class ReplicaStatus:
    """Watchdog bookkeeping for one replica (host-side only)."""
    health: ReplicaHealth = ReplicaHealth.HEALTHY
    consecutive_failures: int = 0
    total_failures: int = 0
    clean_steps: int = 0           # successful steps since the last failure
    last_progress_step: int = 0    # router step the marker last moved at
    last_marker: int = 0           # engine.progress_marker snapshot
    recovered_requests: int = 0    # requests drained out at death
    death_reason: Optional[str] = None


class ReplicaRouter:
    """Prefix-affine, least-loaded dispatch of requests to engine replicas,
    with per-replica health tracking and crash recovery.

    Dispatch: each replica's prefix cache is local — pages cached on
    replica 0 are invisible to replica 1 — so dispatch probes every
    ADMITTING replica's page index and routes a request to the replica
    holding the LONGEST cached prefix of its prompt (cache-hit tokens
    beat a small load imbalance: they skip whole prefill chunks).
    Requests with no cached prefix anywhere fall back to least-loaded,
    FIFO within a replica; ties pick the lowest replica index. Replicas
    with waiting-queue room are preferred over full ones (a request is
    load-shed only when EVERY admitting replica's queue is full), and
    HEALTHY replicas over DEGRADED ones. Pass ``prefix_affinity=False``
    for pure least-loaded dispatch (e.g. to measure the affinity win).

    All replicas must be configured identically (same ``max_seq``, page
    pool, ...): admissibility is checked against whichever replica a
    request is dispatched to. An oversized request raises
    :class:`~repro_torch.serve.kv_cache.PagePoolExhausted` at :meth:`submit`
    only after every admitting replica refused it — a replica-level
    refusal (e.g. injected pool exhaustion) falls through to the
    next-best replica instead of escaping to the caller.

    Watchdog knobs:
      max_step_failures: consecutive step exceptions before a replica is
        declared dead (a :class:`ReplicaCrashed` kills it immediately).
      stall_steps: router steps without progress (while the replica has
        work) before it is declared dead. ``None`` disables.
      recover_after: clean steps for DEGRADED to return to HEALTHY.
      retry_backoff / retry_backoff_cap: a recovered request re-enters
        dispatch after ``min(cap, backoff · 2^(retries-1))`` router steps
        — capped exponential backoff keyed on the request's own retry
        count.
    """

    def __init__(self, engines: Sequence[Engine],
                 prefix_affinity: bool = True,
                 affinity_load_slack: Optional[int] = None,
                 max_step_failures: int = 3,
                 stall_steps: Optional[int] = 16,
                 recover_after: int = 3,
                 retry_backoff: int = 1,
                 retry_backoff_cap: int = 16,
                 obs: Optional[Obs] = None):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines: List[Engine] = list(engines)
        # Router-level observability: its own registry for cluster-wide
        # tallies (retries, health transitions); per-replica counters
        # stay in each engine's registry. Each engine's trace track gets
        # the replica index as pid.
        self.obs = obs if obs is not None else Obs()
        met = self.obs.metrics
        self._c_retried = met.counter("router.retried_requests",
                                      unit="requests")
        self._c_health = {
            h: met.counter(f"router.health.to_{h.value}",
                           unit="transitions") for h in ReplicaHealth}
        for i, e in enumerate(self.engines):
            e.obs.pid = i
            e.obs.tracer.name_process(i, f"replica {i}")
        self.prefix_affinity = prefix_affinity
        # Affinity must not collapse DP onto one hot replica: only
        # replicas within `slack` load of the least-loaded are affinity
        # candidates. One slot-batch of queueing is roughly where waiting
        # starts to cost more than the prefill a cache hit saves.
        self.affinity_load_slack = (affinity_load_slack
                                    if affinity_load_slack is not None
                                    else self.engines[0].num_slots)
        self.max_step_failures = max_step_failures
        self.stall_steps = stall_steps
        self.recover_after = recover_after
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        self.status: List[ReplicaStatus] = [ReplicaStatus()
                                            for _ in self.engines]
        self.step_count = 0
        # (ready_step, seq, request) — seq keeps heap order deterministic
        self._retries: List[Tuple[int, int, Request]] = []
        self._retry_seq = itertools.count()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, model, params, qc: QuantConfig = DENSE, *,
              replicas: int, mesh=None, router_kw: Optional[dict] = None,
              **engine_kw) -> "ReplicaRouter":
        """``replicas`` identical engines over one ``params`` dict (on one
        card they share the weights; each has its own page pool). Each
        gets ``mesh`` (usually a per-replica TP submesh is wanted instead,
        :meth:`from_mesh`: one shared mesh here repeats the serving work
        on the same ranks, it does not split it). ``router_kw`` forwards
        to the router constructor (watchdog and backoff knobs)."""
        return cls([Engine(model, params, qc, mesh=mesh, **engine_kw)
                    for _ in range(replicas)], **(router_kw or {}))

    @classmethod
    def from_mesh(cls, model, params, qc: QuantConfig = DENSE, *, mesh,
                  router_kw: Optional[dict] = None,
                  **engine_kw) -> "ReplicaRouter":
        """One tensor-parallel engine per data slice of ``mesh``, all in
        this process.

        ``mesh`` must carry a trailing ``model`` axis; every other (data)
        axis is flattened into replica groups
        (``launch.mesh.replica_submeshes``). A ``(2, 2)`` mesh therefore
        yields 2 replicas of TP-2. Each replica places its own shards of
        ``params`` on its group's devices (each group holds its own copy:
        that is data parallelism's memory cost; on one card the copies
        share storage where a shard is a contiguous slice).
        """
        from repro_torch.launch.mesh import replica_submeshes
        return cls([Engine(model, params, qc, mesh=sub, **engine_kw)
                    for sub in replica_submeshes(mesh)],
                   **(router_kw or {}))

    # ------------------------------------------------------------------
    # health
    # ------------------------------------------------------------------
    def health(self, i: int) -> ReplicaHealth:
        return self.status[i].health

    @property
    def retried_requests(self) -> int:
        return self._c_retried.value

    def _set_health(self, i: int, health: ReplicaHealth,
                    note: str = "") -> None:
        """THE health-transition funnel: counts the flip and annotates
        the replica's trace track; no-op when the state is unchanged."""
        st = self.status[i]
        if st.health is health:
            return
        self._c_health[health].inc()
        self.engines[i].obs.annotate("health", frm=st.health.value,
                                     to=health.value, note=note)
        st.health = health

    @property
    def alive_replicas(self) -> List[int]:
        return [i for i, st in enumerate(self.status)
                if st.health is not ReplicaHealth.DEAD]

    def _admitting(self) -> List[int]:
        return [i for i, st in enumerate(self.status)
                if st.health in ADMITTING]

    def drain(self, i: int) -> None:
        """Graceful drain: replica ``i`` stops admitting new requests and
        finishes (only) its in-flight work — queued and slotted requests
        keep stepping. Use before a planned replica restart; check
        :meth:`drained` for completion, :meth:`undrain` to restore."""
        st = self.status[i]
        if st.health is ReplicaHealth.DEAD:
            raise ValueError(f"replica {i} is dead, nothing to drain")
        log.info("draining replica %d (%s, load %d)", i,
                 st.health.value, self.engines[i].load)
        self._set_health(i, ReplicaHealth.DRAINING, "drain()")

    def drained(self, i: int) -> bool:
        """Whether a draining replica has finished its in-flight work."""
        return (self.status[i].health is ReplicaHealth.DRAINING
                and not self.engines[i].scheduler.has_work)

    def undrain(self, i: int) -> None:
        """Return a draining replica to rotation."""
        st = self.status[i]
        if st.health is not ReplicaHealth.DRAINING:
            raise ValueError(
                f"replica {i} is {st.health.value}, not draining")
        self._set_health(i, ReplicaHealth.HEALTHY, "undrain()")
        st.consecutive_failures = 0
        st.clean_steps = 0
        st.last_progress_step = self.step_count

    def _mark_dead(self, i: int, reason: str) -> None:
        """Declare replica ``i`` dead and requeue its in-flight requests
        onto the surviving replicas (capped exponential backoff)."""
        eng, st = self.engines[i], self.status[i]
        self._set_health(i, ReplicaHealth.DEAD, reason)
        st.death_reason = reason
        reqs = eng.scheduler.drain_requests(eng.kv)
        st.recovered_requests += len(reqs)
        log.warning("replica %d marked dead (%s); requeueing %d in-flight "
                    "request(s)", i, reason, len(reqs))
        for r in reqs:
            r.retries += 1
            delay = min(self.retry_backoff_cap,
                        self.retry_backoff * (1 << (r.retries - 1)))
            heapq.heappush(self._retries,
                           (self.step_count + delay,
                            next(self._retry_seq), r))

    def _record_failure(self, i: int, exc: BaseException) -> None:
        st = self.status[i]
        st.total_failures += 1
        st.consecutive_failures += 1
        st.clean_steps = 0
        crashed = isinstance(exc, ReplicaCrashed)
        if crashed or st.consecutive_failures >= self.max_step_failures:
            self._mark_dead(
                i, f"{type(exc).__name__}: {exc}" if crashed else
                f"{st.consecutive_failures} consecutive step failures "
                f"(last: {type(exc).__name__}: {exc})")
        else:
            if st.health is ReplicaHealth.HEALTHY:
                log.warning("replica %d degraded: step failed (%s: %s)",
                            i, type(exc).__name__, exc)
                self._set_health(i, ReplicaHealth.DEGRADED,
                                 f"{type(exc).__name__}: {exc}")

    def _watch_progress(self, i: int) -> None:
        """Stall detection + degraded-replica recovery after a clean step."""
        eng, st = self.engines[i], self.status[i]
        st.consecutive_failures = 0
        st.clean_steps += 1
        marker = eng.progress_marker
        if marker != st.last_marker:
            st.last_marker = marker
            st.last_progress_step = self.step_count
            if (st.health is ReplicaHealth.DEGRADED
                    and st.clean_steps >= self.recover_after):
                log.info("replica %d recovered (healthy)", i)
                self._set_health(i, ReplicaHealth.HEALTHY,
                                 f"{st.clean_steps} clean steps")
        elif (self.stall_steps is not None
              and eng.scheduler.has_work
              and self.step_count - st.last_progress_step
              >= self.stall_steps):
            self._mark_dead(
                i, f"stalled: no progress in {self.stall_steps} steps "
                f"with work pending")

    def stats(self) -> Dict[str, object]:
        """Health / load / failure surface for dashboards and tests."""
        return {
            "step": self.step_count,
            "retried_requests": self.retried_requests,
            "pending_retries": len(self._retries),
            "replicas": [
                {"health": st.health.value, "load": e.load,
                 "mode": e.mode, "pressure": round(e.pressure, 3),
                 "total_failures": st.total_failures,
                 "recovered_requests": st.recovered_requests,
                 "death_reason": st.death_reason}
                for e, st in zip(self.engines, self.status)],
        }

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._retries) or any(
            e.scheduler.has_work for i, e in enumerate(self.engines)
            if self.status[i].health is not ReplicaHealth.DEAD)

    @property
    def load(self) -> int:
        return sum(e.load for e in self.engines)

    def _ranked_replicas(self, req: Request) -> List[Engine]:
        """Admitting replicas, best-first.

        Order: queue room beats a full queue (shedding is a last resort),
        HEALTHY beats DEGRADED, then longest cached prompt prefix among
        near-idle replicas (affinity is bounded: a replica more than
        ``affinity_load_slack`` requests busier than the least-loaded one
        is skipped even on a hit — otherwise a workload where EVERY
        request shares one system prompt would serialize onto the first
        replica that cached it while the rest sit idle), then load, then
        index. The probe (``kv.match_prefix``) is read-only — no pages
        are retained until the chosen replica's scheduler actually admits
        the request (it re-matches then, so a probe gone stale by
        eviction only costs the affinity, never correctness)."""
        cand = self._admitting()
        if not cand:
            return []
        tokens = list(req.tokens) + list(req.out_tokens)
        load_cap = min(self.engines[i].load for i in cand) \
            + self.affinity_load_slack
        keys = []
        for i in cand:
            eng = self.engines[i]
            hit = 0
            if self.prefix_affinity and eng.load <= load_cap:
                hit = eng.kv.match_prefix(tokens).tokens
            keys.append((0 if eng.scheduler.queue_room > 0 else 1,
                         0 if self.status[i].health
                         is ReplicaHealth.HEALTHY else 1,
                         -hit, eng.load, i))
        return [self.engines[i] for *_, i in sorted(keys)]

    def submit(self, req: Request) -> Engine:
        """Dispatch ``req`` to the best admitting replica (see
        :meth:`_ranked_replicas`). Returns the engine it landed on — note
        a full cluster may land it as a ``LoadShedded`` result (every
        admitting replica's queue full; the chosen engine sheds by
        priority). Raises :class:`PagePoolExhausted` only when EVERY
        admitting replica refused the request — a single replica's
        refusal falls through to the next-best one — and
        :class:`RuntimeError` when no replica admits at all (all
        draining / dead)."""
        ranked = self._ranked_replicas(req)
        last_err: Optional[PagePoolExhausted] = None
        for eng in ranked:
            try:
                eng.submit(req)
                return eng
            except PagePoolExhausted as e:
                last_err = e
        if last_err is not None:
            raise last_err
        raise RuntimeError("no admitting replicas (all draining or dead)")

    def _dispatch_retries(self) -> None:
        """Re-admit recovered requests whose backoff expired. Uses the
        bound-exempt :meth:`Engine.requeue` path: a request the cluster
        already accepted is never load-shed by the act of rescuing it."""
        while self._retries and self._retries[0][0] <= self.step_count:
            _, _, req = heapq.heappop(self._retries)
            if req.done:               # expired while waiting
                continue
            ranked = self._ranked_replicas(req)
            if not ranked:
                raise RuntimeError(
                    "cannot recover request: no admitting replicas "
                    "(all draining or dead)")
            ranked[0].requeue(req)
            self._c_retried.inc()
            log.info("requeued recovered request (retry %d) onto "
                     "replica %d", req.retries,
                     self.engines.index(ranked[0]))

    def step(self) -> bool:
        """One engine iteration on every live replica with work, under
        the watchdog: a step exception degrades (or kills) the replica
        instead of propagating, and a dead replica's in-flight requests
        are requeued with backoff. Returns whether any replica did work.
        """
        self.step_count += 1
        self._dispatch_retries()
        progressed = False
        for i, e in enumerate(self.engines):
            st = self.status[i]
            if st.health is ReplicaHealth.DEAD or not e.scheduler.has_work:
                continue
            try:
                progressed = e.step() or progressed
            except Exception as exc:       # watchdog: contain the blast
                self._record_failure(i, exc)
                continue
            self._watch_progress(i)
        return progressed

    # Steps tolerated with work pending but nothing progressing before
    # run_until_idle errors out — must cover a retry-backoff window plus
    # a stall-watchdog window (transient faults stall legitimately).
    STALL_LIMIT = 512

    def run_until_idle(self) -> None:
        stalled = 0
        while self.has_work:
            if self.step():
                stalled = 0
            else:
                stalled += 1
                if stalled > self.STALL_LIMIT:
                    raise RuntimeError(
                        f"router made no progress in {stalled} steps "
                        f"({self.stats()})")

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests to completion across the replicas."""
        for r in requests:
            self.submit(r)
        self.run_until_idle()
        return requests
