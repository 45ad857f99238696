"""Serving observability: metrics registry and tracing (port of
``repro.obs``, without the benchmark snapshot and the perf gate:
ROADMAP.md queue A item 8 keeps them for the benchmark).

:class:`Obs` is the per-engine bundle the serving stack records into:
one :class:`~repro_torch.obs.metrics.Registry` per engine (so
per-replica counters stay attributable) plus a
:class:`~repro_torch.obs.tracing.Tracer` that *may be shared* across
replicas to export one merged Perfetto timeline. ``Obs.pid`` is the
replica index (stamped by :class:`~repro_torch.serve.router.
ReplicaRouter`) and keys the trace track.

Hot-path contract: recording never reads a device value. Counters are
host ints, timestamps are ``perf_counter`` at points the engine already
runs host code, and with ``Obs.disabled()`` the timing layer collapses
to a shared no-op context manager (counters stay live: they double as
engine state that tests and schedulers read).
"""
from __future__ import annotations

import time
from typing import Optional

from .metrics import Counter, Gauge, Histogram, Registry, safe_ratio
from .tracing import (NULL_CTX, REQUEST_PID, Tracer, torch_annotation,
                      validate_trace)

__all__ = [
    "Obs", "Registry", "Counter", "Gauge", "Histogram", "Tracer",
    "safe_ratio", "torch_annotation", "validate_trace", "REQUEST_PID",
    "NULL_CTX",
]


class _Phase:
    """Times one engine step phase: feeds a histogram and, when the
    tracer is live, appends one ``X`` trace event."""

    __slots__ = ("obs", "name", "_t0")

    def __init__(self, obs: "Obs", name: str):
        self.obs, self.name = obs, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        obs = self.obs
        if obs.timing:
            obs._phase_hist(self.name).observe(t1 - self._t0)
        tr = obs.tracer
        if tr.enabled:
            tr._events.append(
                ("X", self.name, "phase", (self._t0 - tr._t0) * 1e6,
                 (t1 - self._t0) * 1e6, obs.pid, 0, None))
        return False


class Obs:
    """Per-engine observability bundle: registry + tracer + switches.

    * ``metrics``: always-live :class:`Registry` (engine counters are
      backed by it even when "disabled").
    * ``tracer``: ring-buffer :class:`Tracer`; pass a shared instance
      to merge replicas into one exported timeline.
    * ``timing``: when False, :meth:`phase` returns a shared no-op
      context manager and no histograms are touched.
    * ``torch_annotations``: also wrap phases in
      ``torch.profiler.record_function`` for ``torch.profiler`` traces
      (off by default; purely additive).

    A phase's time is host time. The engine's one device read a step
    (``Engine._device_read``) waits for the card, so the ``device_read``
    phase holds the device time the host did not hide.
    """

    def __init__(self, metrics: Optional[Registry] = None,
                 tracer: Optional[Tracer] = None, timing: bool = True,
                 torch_annotations: bool = False):
        self.metrics = metrics if metrics is not None else Registry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.timing = timing
        self.torch_annotations = torch_annotations
        self.pid = 0
        self._phase_hists = {}

    @classmethod
    def disabled(cls) -> "Obs":
        """Recording switched off: no timing, no tracing (counters stay
        live: they are engine state)."""
        return cls(timing=False)

    @property
    def active(self) -> bool:
        return self.timing or self.tracer.enabled

    def _phase_hist(self, name: str) -> Histogram:
        h = self._phase_hists.get(name)
        if h is None:
            h = self.metrics.histogram(f"engine.phase.{name}_s", unit="s",
                                       desc=f"host time in step phase "
                                            f"'{name}'")
            self._phase_hists[name] = h
        return h

    def phase(self, name: str):
        """Context manager timing one step phase (no-op when inactive)."""
        if not (self.timing or self.tracer.enabled):
            return NULL_CTX
        if self.torch_annotations:
            return _AnnotatedPhase(self, name)
        return _Phase(self, name)

    def annotate(self, name: str, **args) -> None:
        """Instant annotation event on this replica's trace track
        (degradation flip, preemption, copy-on-write fork, fault, health
        change)."""
        tr = self.tracer
        if tr.enabled:
            tr.instant(name, cat="annot", pid=self.pid,
                       args=args or None)

    def track(self, name: str, value: float) -> None:
        """Counter time-series sample on this replica's track."""
        tr = self.tracer
        if tr.enabled:
            tr.counter(name, value, pid=self.pid)


class _AnnotatedPhase(_Phase):
    """_Phase that also enters a ``torch.profiler.record_function``."""

    __slots__ = ("_ann",)

    def __enter__(self):
        self._ann = torch_annotation(self.name)
        self._ann.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._ann.__exit__(*exc)
        return False
