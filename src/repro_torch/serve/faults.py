"""Deterministic fault injection for the serving stack (port of
``repro.serve.faults``).

Chaos testing a serving engine is only useful when the chaos replays
exactly: a flaky repro is worse than no repro. Everything here is
clock-driven — a :class:`FaultSchedule` names faults at absolute step
numbers, and the :class:`FaultInjector` advances its clock once per
``step()`` of whatever it is attached to (a single
:class:`~repro_torch.serve.engine.Engine` or a whole
:class:`~repro_torch.serve.router.ReplicaRouter`). No wall time, no RNG at
injection time; the optional :meth:`FaultSchedule.random` generator is
seeded, so "random" chaos is a pure function of ``(seed, params)``.

Fault kinds:

==============  ========================================================
kind            effect while active (``[step, step + duration)``)
==============  ========================================================
``crash``       the replica's ``step()`` raises
                :class:`ReplicaCrashed` — permanently (duration is
                ignored). The router watchdog marks the replica dead and
                requeues its in-flight requests.
``step_error``  the first decode/verify device call at or after ``step``
                raises, exactly once — injected BEFORE the engine's
                device call (``Engine._decode_call`` /
                ``_verify_call``) runs, so slot and page state stay
                consistent and the next step retries the same decode.
``slow``        ``step()`` returns without doing any work (the replica
                is alive but stalled). Long windows trip the router's
                stall watchdog.
``pool_exhaust``  every free page of the replica's pool (including
                reclaimable parked prefix pages) is held by the injector
                for the window, forcing transient
                :class:`PagePoolExhausted` pressure: decode growth
                preempts, admission waits, degradation modes engage.
``submit_error``  the replica's ``submit()`` raises
                :class:`PagePoolExhausted` during the window — exercises
                the router's fall-through to the next-best replica.
==============  ========================================================

Usage::

    sched = FaultSchedule([Fault(step=12, kind="crash", replica=1),
                           Fault(step=4, kind="pool_exhaust", replica=0,
                                 duration=6)])
    inj = FaultInjector(sched)
    inj.attach(router)          # or inj.attach(engine)
    router.run(requests)        # faults fire at the scheduled steps
    print(inj.report())

Attach wraps ``step``/``submit``/device-call entry points in place on
the given objects; it is one-shot per injector (make a fresh injector
per run — the clock is not reusable).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .kv_cache import PagePoolExhausted

__all__ = ["ReplicaCrashed", "Fault", "FaultSchedule", "FaultInjector",
           "FAULT_KINDS"]


class ReplicaCrashed(RuntimeError):
    """A replica process died mid-step (simulated). Unlike an ordinary
    step exception — which merely degrades the replica — the router
    watchdog treats this as immediately fatal: the replica is marked
    dead and its in-flight requests are requeued elsewhere."""


FAULT_KINDS = ("crash", "step_error", "slow", "pool_exhaust",
               "submit_error")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    step: injector-clock step the fault activates at (the clock ticks
      once per attached ``step()`` call, starting at 1).
    kind: one of :data:`FAULT_KINDS`.
    replica: index into ``router.engines`` (0 for a standalone engine).
    duration: steps the fault stays active; ignored for ``crash``
      (permanent) and ``step_error`` (armed from ``step``, fires once).
    """
    step: int
    kind: str
    replica: int = 0
    duration: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick from "
                f"{FAULT_KINDS}")
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1, got {self.step}")
        if self.duration < 1:
            raise ValueError(
                f"fault duration must be >= 1, got {self.duration}")

    def active(self, clock: int) -> bool:
        # crash is permanent; step_error is armed from `step` onward and
        # consumed by its first firing (FaultInjector tracks the shot)
        if self.kind in ("crash", "step_error"):
            return clock >= self.step
        return self.step <= clock < self.step + self.duration


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, replayable list of faults."""
    faults: Tuple[Fault, ...]

    def __init__(self, faults):
        object.__setattr__(self, "faults", tuple(faults))

    def for_replica(self, i: int) -> List[Fault]:
        return [f for f in self.faults if f.replica == i]

    @property
    def max_replica(self) -> int:
        return max((f.replica for f in self.faults), default=0)

    @classmethod
    def canned(cls, replicas: int = 2) -> "FaultSchedule":
        """The standing chaos scenario (the JAX package's; the tests and
        ``chip_smoke.py``'s chaos phase run it): an early pool squeeze
        and a one-shot decode failure on replica 0, then a hard crash of
        the last replica mid-decode, plus a short slow window.
        Deterministic by construction: no seed involved."""
        victim = replicas - 1
        faults = [
            Fault(step=5, kind="pool_exhaust", replica=0, duration=4),
            Fault(step=7, kind="step_error", replica=0, duration=2),
            Fault(step=10, kind="slow", replica=victim, duration=2),
            Fault(step=14, kind="crash", replica=victim),
        ]
        return cls([f for f in faults if f.replica < replicas])

    @classmethod
    def random(cls, seed: int, *, steps: int = 64, replicas: int = 2,
               n_faults: int = 6, crash_at_most: int = 1,
               kinds: Tuple[str, ...] = FAULT_KINDS) -> "FaultSchedule":
        """A seeded pseudo-random schedule — same ``(seed, params)``,
        same faults, forever. ``crash_at_most`` bounds permanent crashes
        so a fuzzed schedule cannot kill every replica."""
        import numpy as np
        rng = np.random.default_rng(seed)
        faults, crashes = [], 0
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "crash":
                if crashes >= crash_at_most:
                    kind = "step_error"
                else:
                    crashes += 1
            faults.append(Fault(
                step=int(rng.integers(1, max(2, steps))),
                kind=kind,
                replica=int(rng.integers(replicas)),
                duration=int(rng.integers(1, 6))))
        return cls(faults)


class FaultInjector:
    """Wraps ``step``/``submit`` entry points to fire a
    :class:`FaultSchedule` deterministically.

    The clock ticks at the top of each attached ``step()`` call (router
    steps tick once for ALL replicas — the schedule is phrased in router
    steps, matching how the watchdog counts). ``fired`` logs every
    injection as ``(clock, fault, note)`` for reports and debugging.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.clock = 0
        self.fired: List[Tuple[int, Fault, str]] = []
        self._attached = False
        self._held_pages: Dict[int, List[int]] = {}
        self._shot: Set[int] = set()    # one-shot fault ids already fired
        self._engines: List[object] = []

    # ------------------------------------------------------------------
    def attach(self, target) -> "FaultInjector":
        """Instrument ``target`` (an Engine or a ReplicaRouter) in place.
        Returns ``self`` for chaining."""
        if self._attached:
            raise RuntimeError("FaultInjector.attach is one-shot; build "
                               "a fresh injector per run")
        self._attached = True
        engines = getattr(target, "engines", None)
        if engines is None:            # standalone engine
            self._engines = [target]
            self._wrap_engine(target, 0, tick=True)
        else:
            self._engines = list(engines)
            if self.schedule.max_replica >= len(self._engines):
                raise ValueError(
                    f"schedule names replica {self.schedule.max_replica} "
                    f"but the router only has {len(self._engines)}")
            orig_step = target.step

            def routed_step():
                self._tick()
                return orig_step()
            target.step = routed_step
            for i, eng in enumerate(self._engines):
                self._wrap_engine(eng, i, tick=False)
        return self

    def _wrap_engine(self, eng, i: int, tick: bool) -> None:
        orig_step, orig_submit = eng.step, eng.submit

        def step():
            if tick:
                self._tick()
            f = self._find(i, "crash")
            if f is not None:
                self._log(f, "step raised ReplicaCrashed")
                raise ReplicaCrashed(
                    f"replica {i} crashed (injected at step {f.step})")
            f = self._find(i, "slow")
            if f is not None:
                self._log(f, "step skipped (slow)")
                return True            # alive, but no work done
            return orig_step()
        eng.step = step

        def submit(req):
            f = self._find(i, "submit_error")
            if f is not None:
                self._log(f, "submit raised PagePoolExhausted")
                raise PagePoolExhausted(
                    f"injected: replica {i} refused admission "
                    f"(fault at step {f.step})")
            return orig_submit(req)
        eng.submit = submit

        # step_error: fail the next decode/verify device call inside the
        # window — BEFORE the call, so no state is touched and the retry
        # replays the identical computation.
        for attr in ("_decode_call", "_verify_call"):
            fn = getattr(eng, attr, None)
            if fn is None:
                continue

            def guarded(*a, _fn=fn, _i=i, **kw):
                f = self._find(_i, "step_error", one_shot=True)
                if f is not None:
                    self._log(f, "injected decode failure")
                    raise RuntimeError(
                        f"injected decode failure on replica {_i} "
                        f"(fault at step {f.step})")
                return _fn(*a, **kw)
            setattr(eng, attr, guarded)

    # ------------------------------------------------------------------
    def _tick(self) -> None:
        self.clock += 1
        for idx, f in enumerate(self.schedule.faults):
            if f.kind != "pool_exhaust":
                continue
            i = f.replica
            if self.clock == f.step and i < len(self._engines):
                self._squeeze(i, f)
            if self.clock == f.step + f.duration and i in self._held_pages:
                self._release(i)

    def _find(self, i: int, kind: str,
              one_shot: bool = False) -> Optional[Fault]:
        for idx, f in enumerate(self.schedule.faults):
            if f.replica != i or f.kind != kind:
                continue
            if one_shot and idx in self._shot:
                continue
            if f.active(self.clock):
                if one_shot:
                    self._shot.add(idx)
                return f
        return None

    def _log(self, fault: Fault, note: str) -> None:
        self.fired.append((self.clock, fault, note))
        # surface the injection on the victim replica's trace track so
        # chaos traces show *why* a span stalled or a request migrated
        if fault.replica < len(self._engines):
            obs = getattr(self._engines[fault.replica], "obs", None)
            if obs is not None:
                obs.annotate(f"fault.{fault.kind}", step=fault.step,
                             clock=self.clock, note=note)

    def _squeeze(self, i: int, fault: Fault) -> None:
        """Grab every free page of replica ``i``'s pool (reclaiming the
        parked prefix LRU first — those count as capacity) so the engine
        sees genuine transient exhaustion."""
        table = self._engines[i].kv.table
        if table.prefix is not None:
            while table.prefix.reclaimable:
                # fault injection reclaims parked refcount-0 prefix pages
                # exactly as the allocator's own reclaim does
                table.allocator.restore(table.prefix.pop_lru())
        held = table.allocator.alloc(table.allocator.available)
        self._held_pages[i] = held
        self._log(fault, f"holding {len(held)} page(s)")

    def _release(self, i: int) -> None:
        held = self._held_pages.pop(i)
        self._engines[i].kv.table.allocator.free(held)
        self.fired.append(
            (self.clock, Fault(step=self.clock, kind="pool_exhaust",
                               replica=i),
             f"released {len(held)} page(s)"))

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, object]:
        """Counts per fault kind actually fired, plus the raw log."""
        counts: Dict[str, int] = {}
        for _, f, note in self.fired:
            counts[f.kind] = counts.get(f.kind, 0) + 1
        return {"clock": self.clock, "by_kind": counts,
                "events": [(c, f.kind, f.replica, note)
                           for c, f, note in self.fired]}
