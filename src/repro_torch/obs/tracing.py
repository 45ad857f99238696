"""Request-lifecycle and step-phase tracing with Perfetto export (port of
``repro.obs.tracing``).

A :class:`Tracer` records compact event tuples into a bounded ring
buffer (a ``deque(maxlen=...)``: old events fall off, recording never
blocks or grows) and exports Chrome/Perfetto ``trace_event`` JSON that
``ui.perfetto.dev`` or ``chrome://tracing`` loads directly:

* ``X`` complete events: engine step phases (admit / prefill_chunk /
  decode / draft / verify / sample / device_read), one track per
  replica (``pid`` = replica index).
* ``b``/``e``/``n`` async events: request lifecycles, all on the
  :data:`REQUEST_PID` track, matched by the request's scheduler sequence
  number, so a request that moves replicas after a crash still renders
  as one span.
* ``i`` instant events: annotations (degradation-ladder transitions,
  preemptions, copy-on-write forks, replica health flips, injected
  faults).
* ``C`` counter events: pool pressure time series.

Timestamps are host ``perf_counter`` microseconds relative to the
tracer's construction, taken only where the engine already runs host
code, never forcing a device synchronisation. A disabled tracer's
recording methods return at once; :meth:`Tracer.span` hands back a shared
no-op context manager.

:func:`torch_annotation` wraps a block in
``torch.profiler.record_function`` so phase names show up in a
``torch.profiler`` trace of the card too (purely additive).
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: pid of the synthetic "requests" process in exported traces — request
#: lifecycle spans live here (not on a replica track) so cross-replica
#: migration after a crash cannot orphan a ``b`` without its ``e``.
REQUEST_PID = 999


class _NullCtx:
    """Shared do-nothing context manager (returned when tracing is off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_CTX = _NullCtx()


class _Span:
    """Times one block and appends a single ``X`` event on exit."""

    __slots__ = ("tracer", "name", "cat", "pid", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, pid: int,
                 tid: int, args: Optional[dict]):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.pid, self.tid, self.args = pid, tid, args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self.tracer
        tr._events.append(
            ("X", self.name, self.cat, (self._t0 - tr._t0) * 1e6,
             (t1 - self._t0) * 1e6, self.pid, self.tid, self.args))
        return False


class Tracer:
    """Bounded ring-buffer recorder + ``trace_event`` JSON exporter.

    One tracer may be shared by many engines (each replica stamps its
    own ``pid``); recording is append-only and single-threaded like the
    engines themselves.
    """

    def __init__(self, enabled: bool = False, capacity: int = 65536):
        self.enabled = enabled
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        self._names: Dict[int, str] = {}   # pid -> process label

    # -- recording ----------------------------------------------------------
    def _ts(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name: str, cat: str = "phase", pid: int = 0,
             tid: int = 0, args: Optional[dict] = None):
        """Context manager producing one complete (``X``) event."""
        if not self.enabled:
            return NULL_CTX
        return _Span(self, name, cat, pid, tid, args)

    def instant(self, name: str, cat: str = "annot", pid: int = 0,
                tid: int = 0, args: Optional[dict] = None) -> None:
        if self.enabled:
            self._events.append(("i", name, cat, self._ts(), pid, tid, args))

    def counter(self, name: str, value: float, pid: int = 0) -> None:
        if self.enabled:
            self._events.append(("C", name, self._ts(), pid, value))

    def request_begin(self, rid: int, name: str,
                      args: Optional[dict] = None) -> None:
        if self.enabled:
            self._events.append(("b", rid, name, self._ts(), args))

    def request_instant(self, rid: int, name: str, note: str,
                        args: Optional[dict] = None) -> None:
        if self.enabled:
            self._events.append(("n", rid, name, self._ts(),
                                 dict(args or {}, note=note)))

    def request_end(self, rid: int, name: str,
                    args: Optional[dict] = None) -> None:
        if self.enabled:
            self._events.append(("e", rid, name, self._ts(), args))

    def name_process(self, pid: int, label: str) -> None:
        """Label a pid's track in the exported trace (e.g. ``replica 1``)."""
        self._names[pid] = label

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- export -------------------------------------------------------------
    def chrome_events(self) -> List[dict]:
        """Render the ring buffer as ``trace_event`` dicts."""
        out: List[dict] = []
        pids = {REQUEST_PID}
        for ev in self._events:
            ph = ev[0]
            if ph == "X":
                _, name, cat, ts, dur, pid, tid, args = ev
                d = {"ph": "X", "name": name, "cat": cat, "ts": ts,
                     "dur": dur, "pid": pid, "tid": tid}
                pids.add(pid)
            elif ph == "i":
                _, name, cat, ts, pid, tid, args = ev
                d = {"ph": "i", "name": name, "cat": cat, "ts": ts,
                     "pid": pid, "tid": tid, "s": "p"}
                pids.add(pid)
            elif ph == "C":
                _, name, ts, pid, value = ev
                d = {"ph": "C", "name": name, "ts": ts, "pid": pid,
                     "tid": 0, "args": {"value": value}}
                pids.add(pid)
                args = None
            else:                          # b / n / e async request events
                ph_, rid, name, ts, args = ev
                d = {"ph": ph_, "cat": "request", "id": rid, "name": name,
                     "ts": ts, "pid": REQUEST_PID, "tid": 0}
            if args:
                d["args"] = dict(args)
            out.append(d)
        meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": self._names.get(
                     pid, "requests" if pid == REQUEST_PID
                     else f"replica {pid}")}}
                for pid in sorted(pids)]
        return meta + out

    def export(self, path: str) -> dict:
        """Write ``{"traceEvents": [...]}`` JSON; returns the document."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return doc


def torch_annotation(name: str, enabled: bool = True):
    """``torch.profiler.record_function(name)``: the phase's name as a
    range in a ``torch.profiler`` trace, beside the card's kernels.
    Purely additive; a no-op context when ``enabled`` is False."""
    if not enabled:
        return NULL_CTX
    import torch.profiler
    return torch.profiler.record_function(name)


def validate_trace(doc: Any) -> List[str]:
    """Structural checks on an exported trace document; returns problems
    (empty = valid). Used by the tests and ``chip_smoke.py``."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents"]
    events = doc["traceEvents"]
    open_async: Dict[tuple, int] = {}
    # X-event nesting per (pid, tid): sorted by ts, a span must close
    # before any span that started earlier on the same track closes
    tracks: Dict[tuple, List[tuple]] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            for k in ("ts", "dur", "pid", "tid", "name"):
                if k not in ev:
                    problems.append(f"X event missing {k}: {ev}")
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif ph == "b":
            open_async[(ev.get("cat"), ev.get("id"))] = \
                open_async.get((ev.get("cat"), ev.get("id")), 0) + 1
        elif ph == "e":
            key = (ev.get("cat"), ev.get("id"))
            if open_async.get(key, 0) <= 0:
                problems.append(f"async end without begin: {ev}")
            else:
                open_async[key] -= 1
    for (pid, tid), spans in tracks.items():
        stack: List[float] = []
        eps = 1e-3                        # µs slack for fp round-trip
        for ts, te, name in sorted(spans):
            while stack and stack[-1] <= ts + eps:
                stack.pop()
            if stack and te > stack[-1] + eps:
                problems.append(
                    f"span '{name}' on ({pid},{tid}) overlaps its parent "
                    f"(ends {te:.1f} after {stack[-1]:.1f})")
            stack.append(te)
    for key, n in open_async.items():
        if n > 0:
            problems.append(f"async begin without end: {key}")
    return problems
