"""Sync guard: steady-state serving must not make the host wait, except at
the engine's one counted read a step (port of ``repro.analysis.recompile``).

The JAX guard asserts that steady-state serving compiles nothing: every
step reuses a handful of compiled executables. The port runs eagerly, so
nothing compiles; its hazard is a host sync (the host waits for the card
to read a value), a host <-> device copy, or a kernel build in the steady
state. A sync inside a model entry point stalls the layer loop and makes
the decode step impossible to capture in a CUDA graph.

:class:`SyncLog` is a context manager over a ``TorchDispatchMode`` that
records every op that makes the host wait or moves bytes between host and
device: ``aten._local_scalar_dense`` (``.item()``, ``int()``, ``bool()``
of a tensor), ``aten.nonzero``, ``aten.masked_select``, ``aten.unique*``,
an index by a boolean mask, and ``_to_copy`` / ``copy_`` between ``cpu``
and ``cuda``. Each record carries the tags open when it ran: the ``Obs``
step phases and the model entry point it falls in. On a CUDA device the
block also runs under ``torch.cuda.set_sync_debug_mode("warn")``: each of
its warnings is kept with the op that raised it and the tags open then
(:class:`DebugSync`). They include syncs the dispatcher does not show as
an op of their own: a blocking host -> device copy waits for the stream,
and ``multinomial`` reads its probabilities' checks back inside its C++.
The two counts are reported side by side, not assumed equal. On the CPU
a ``.cpu()`` / ``.numpy()`` of a CPU tensor
dispatches nothing, so the CPU sees the model's syncs but not the
engine's own reads; the card sees both.

:func:`run_sync_guard` drives an engine through a warmup workload, then a
steady workload of the same shape classes inside a :class:`SyncLog`, and
reports :class:`~repro_torch.analysis.findings.Finding` records:

  * ``sync-steady`` — the engine's reads do not match
    :data:`EXPECTED_READS` (one a decode step, one a finished prefill, at
    most two a speculative round), or the recorder saw a host sync in the
    step loop outside ``Engine._device_read`` and the model;
  * ``sync-model`` — any sync or transfer inside a model entry point (a
    recorded op, or on the card a sync debug warning);
  * ``build-steady`` — a kernel build or library load in the steady state
    (``kernels._build.build.compiles`` / ``load.opens``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

#: Host reads the engine may make: per decode step, per finished prefill
#: and, at most, per speculative round (the JAX tests' counts,
#: ``tests/test_recompile_guard.py``).
EXPECTED_READS = {"decode": 1, "prefill": 1, "spec_round": 2}

#: Model entry points the log tags (their records are ``sync-model``).
ENTRY_POINTS = ("forward", "prefill", "decode", "prefill_paged",
                "decode_paged", "verify_paged")

_SYNC_OPS = {
    "_local_scalar_dense": "scalar_read",
    "nonzero": "nonzero",
    "masked_select": "masked_select",
    "_unique": "unique", "_unique2": "unique", "unique_dim": "unique",
    "unique_consecutive": "unique", "unique_dim_consecutive": "unique",
}
_INDEX_OPS = ("index", "index_put", "index_put_", "_index_put_impl_")
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(os.path.dirname(_PKG_DIR))
_SELF_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class SyncRecord:
    """One op that synced or crossed between host and device.

    kind: ``scalar_read`` | ``nonzero`` | ``masked_select`` | ``unique`` |
    ``bool_index`` (host waits) or ``download`` (device -> host, waits) |
    ``upload`` (host -> device). ``tags``: the open tags, outermost
    first. ``site``: (repo-relative path, line, function) of the
    innermost ``repro_torch`` frame outside this package's analysis."""
    op: str
    kind: str
    tags: Tuple[str, ...]
    site: Tuple[str, int, str]

    @property
    def entry_point(self) -> Optional[str]:
        for t in reversed(self.tags):
            if t.startswith("model."):
                return t
        return None

    @property
    def waits(self) -> bool:
        return self.kind != "upload"


@dataclasses.dataclass(frozen=True)
class DebugSync:
    """One ``set_sync_debug_mode("warn")`` warning (CUDA): the op that
    raised it (the op running, else the last one dispatched: the warning
    reaches Python as the op's binding returns), the open tags, and the
    site as in :class:`SyncRecord`."""
    op: str
    tags: Tuple[str, ...]
    site: Tuple[str, int, str]

    @property
    def entry_point(self) -> Optional[str]:
        return SyncRecord.entry_point.fget(self)


def _site() -> Tuple[str, int, str]:
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG_DIR) and not fn.startswith(_SELF_DIR):
            return (os.path.relpath(fn, _REPO).replace(os.sep, "/"),
                    f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return ("", 0, "<outside repro_torch>")


def _device_type(x) -> Optional[str]:
    return x.device.type if isinstance(x, torch.Tensor) else None


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)


class _Recorder(TorchDispatchMode):
    def __init__(self, log: "SyncLog"):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        log = self.log
        name = func.overloadpacket.__name__
        kind = _SYNC_OPS.get(name)
        if kind is None and name in _INDEX_OPS:
            idx = args[1] if len(args) > 1 else ()
            if any(t.dtype in (torch.bool, torch.uint8)
                   for t in _leaves(idx)):
                kind = "bool_index"
        elif name == "_to_copy":
            src = _device_type(args[0])
            dst = torch.device(kwargs["device"]).type \
                if kwargs.get("device") is not None else src
            kind = _crossing(src, dst)
        elif name == "copy_":
            kind = _crossing(_device_type(args[1]), _device_type(args[0]))
        if kind is not None:
            log.records.append(SyncRecord(str(func), kind, tuple(log._tags),
                                          _site()))
        prev, log._op = log._op, str(func)
        try:
            out = func(*args, **kwargs)
        finally:
            log._op, log._last = prev, str(func)
        if log.watch_dtypes:
            seen = {t.untyped_storage().data_ptr()
                    for t in _leaves(list(args) + list(kwargs.values()))
                    if t.device.type != "meta"}
            for t in _leaves(out):
                if t.dtype == torch.float64:
                    log.float64.append((str(func), tuple(log._tags),
                                        _site()))
                log._see_alloc(str(func), t, seen)
        return out


def _crossing(src: Optional[str], dst: Optional[str]) -> Optional[str]:
    if src is None or dst is None or src == dst:
        return None
    if src == "cpu":
        return "upload"
    if dst == "cpu":
        return "download"
    return None


class SyncLog:
    """Context manager recording host syncs and host <-> device copies.

    Attributes (filled while the block runs):
      records: :class:`SyncRecord` list, in order.
      float64: ``(op, tags, site)`` of every op that produced a float64
        tensor (``watch_dtypes``).
      big_allocs: ``(op, nbytes, tags, site)`` of op outputs of at least
        ``alloc_bytes`` bytes whose storage is none of ``keep_storages``
        (``watch_dtypes``; the invariants' "no second pool").
      debug: :class:`DebugSync` list, one per
        ``torch.cuda.set_sync_debug_mode("warn")`` warning (CUDA only);
        ``debug_warnings`` their number (None on the CPU).
      builds, loads: kernel sources compiled and libraries opened
        (``kernels._build`` counters) during the block.

    Tags: the ``Obs`` step phases (``phase.<name>``) and the model entry
    points (``model.<name>``) entered inside the block; :meth:`tag` opens
    one by hand.
    """

    def __init__(self, cuda: Optional[bool] = None,
                 watch_dtypes: bool = False, alloc_bytes: int = 0,
                 keep_storages: Sequence[int] = ()):
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        self.watch_dtypes = watch_dtypes
        self.alloc_bytes = alloc_bytes
        self.keep_storages = set(keep_storages)
        self.records: List[SyncRecord] = []
        self.float64: List[tuple] = []
        self.big_allocs: List[tuple] = []
        self.debug: List[DebugSync] = []
        self.debug_warnings: Optional[int] = None
        self._op = ""             # the op running now
        self._last = ""           # the last op that ran
        self.builds = 0
        self.loads = 0
        self._tags: List[str] = []
        self._stack: Optional[contextlib.ExitStack] = None

    # -- tagging --------------------------------------------------------
    @contextlib.contextmanager
    def tag(self, name: str):
        self._tags.append(name)
        try:
            yield
        finally:
            self._tags.pop()

    def _see_alloc(self, op: str, t: torch.Tensor, inputs) -> None:
        """Record ``t`` when it is a fresh allocation (its storage is no
        input's: not a view, not written in place) of at least
        ``alloc_bytes``."""
        if self.alloc_bytes <= 0 or t.device.type == "meta":
            return
        st = t.untyped_storage()
        if st.nbytes() >= self.alloc_bytes and \
                st.data_ptr() not in inputs and \
                st.data_ptr() not in self.keep_storages:
            self.big_allocs.append((op, st.nbytes(), tuple(self._tags),
                                    _site()))

    def _patch(self, stack: contextlib.ExitStack) -> None:
        from repro_torch import obs as obs_mod
        from repro_torch.models.model import Model
        log = self
        phase_cls = obs_mod._Phase
        enter, exit_ = phase_cls.__enter__, phase_cls.__exit__

        def p_enter(ph):
            log._tags.append(f"phase.{ph.name}")
            return enter(ph)

        def p_exit(ph, *exc):
            try:
                return exit_(ph, *exc)
            finally:
                log._tags.pop()

        _setattr(stack, phase_cls, "__enter__", p_enter)
        _setattr(stack, phase_cls, "__exit__", p_exit)
        for name in ENTRY_POINTS:
            orig = getattr(Model, name)

            def wrapped(*a, _orig=orig, _tag=f"model.{name}", **kw):
                with log.tag(_tag):
                    return _orig(*a, **kw)

            _setattr(stack, Model, name, functools.wraps(orig)(wrapped))

    # -- context --------------------------------------------------------
    def __enter__(self):
        from repro_torch.kernels import _build
        self._b0 = (_build.build.compiles, _build.load.opens)
        stack = contextlib.ExitStack()
        self._patch(stack)
        if self.cuda:
            stack.enter_context(warnings.catch_warnings())
            warnings.simplefilter("always")
            show = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None,
                            line=None):
                if "synchroniz" in str(message):
                    # a warning raised inside an op's C++ reaches Python
                    # as that op's binding returns: the last op dispatched
                    self.debug.append(DebugSync(self._op or self._last,
                                                tuple(self._tags), _site()))
                else:
                    show(message, category, filename, lineno, file, line)
            warnings.showwarning = showwarning
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, prev)
        stack.enter_context(_Recorder(self))
        self._stack = stack
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        self._stack.close()
        if self.cuda:
            self.debug_warnings = len(self.debug)
        self.builds = _build.build.compiles - self._b0[0]
        self.loads = _build.load.opens - self._b0[1]
        return False

    # -- summaries ------------------------------------------------------
    def in_model(self) -> List[SyncRecord]:
        return [r for r in self.records if r.entry_point is not None]

    def debug_by(self) -> Dict[str, int]:
        """The sync debug warnings by region and op: ``read`` (inside
        ``engine._device_read``), ``model`` (inside an entry point),
        ``other``; then ``op:<op>`` for each op."""
        out: Dict[str, int] = {"read": 0, "model": 0, "other": 0}
        for d in self.debug:
            region = ("read" if "engine._device_read" in d.tags else
                      "model" if d.entry_point is not None else "other")
            out[region] += 1
            key = f"op:{d.op or '<no op>'}"
            out[key] = out.get(key, 0) + 1
        return out

    def count(self, kind: str, tag: Optional[str] = None) -> int:
        return sum(r.kind == kind and (tag is None or tag in r.tags)
                   for r in self.records)


def _setattr(stack: contextlib.ExitStack, obj, name: str, value) -> None:
    old = obj.__dict__[name]
    setattr(obj, name, value)
    stack.callback(setattr, obj, name, old)


def model_findings(log: SyncLog, where: str) -> List[Finding]:
    """One ``sync-model`` finding per (site, entry point, kind) of the
    records, and of the sync debug warnings (kind ``debug_sync``), that
    fell inside a model entry point."""
    items = [(r.site, r.entry_point, r.kind, r.op) for r in log.in_model()]
    items += [(d.site, d.entry_point, "debug_sync", d.op) for d in log.debug
              if d.entry_point is not None]
    out, seen = [], {}
    for site, entry, kind, op in items:
        key = (site[0], site[2], entry, kind)
        if key in seen:
            seen[key][1] += 1
            continue
        seen[key] = [(site, op), 1]
    for (path, fn, entry, kind), ((site, op), n) in seen.items():
        out.append(Finding(
            "sync-model", path, site[1], fn, f"{entry}:{kind}",
            f"{n} x {kind} ({op}) inside {entry} during {where}", "error",
            "keep the value on the device (a tensor op in place of a "
            "host branch), or read it after the entry point returns"))
    return out


@dataclasses.dataclass
class GuardReport:
    """Outcome of one guard run. ``counts`` (steady state):

      decode_steps, prefills, spec_rounds   units the engine ran
                                            (prefills: finished ones);
      prefill_chunks                        prefill chunks run;
      device_reads                          the engine's own counter;
      reads_decode / reads_prefill / reads_spec   those reads by unit;
      reads_recorded                        ``_device_read`` calls the
                                            recorder saw download (card);
      step_syncs                            host syncs in the step loop
                                            outside the read funnel;
      model_records                         records inside an entry point;
      uploads, uploads.<phase>              host -> device copies, in all
                                            and by innermost Obs phase;
      float64                               ops that made float64;
      debug_warnings                        sync debug warnings (card;
                                            -1 on the CPU), and
                                            debug.<region> / debug.op:<op>
                                            (:meth:`SyncLog.debug_by`);
      builds, loads                         kernel builds / loads.
    """
    warmup: SyncLog
    steady: SyncLog
    counts: Dict[str, int]
    findings: List[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        """The steady state's counts as one line."""
        c = self.counts
        dec, pre, spec = c["decode_steps"], c["prefills"], c["spec_rounds"]
        unit = (f"{c['reads_decode']} over {dec} decode steps "
                f"({c['reads_decode'] / max(dec, 1):.2f} a step)" if dec
                else f"{c['reads_spec']} over {spec} speculative rounds "
                f"({c['reads_spec'] / max(spec, 1):.2f} a round)")
        ups = ", ".join(f"{k[len('uploads.'):]} {n}" for k, n in
                        sorted(c.items()) if k.startswith("uploads."))
        dbg = ", ".join(f"{k[len('debug.'):]} {n}" for k, n in
                        sorted(c.items()) if k.startswith("debug.") and n)
        units = max(dec + spec, 1)
        return (f"host reads (engine) {c['device_reads']}: {unit} + "
                f"{c['reads_prefill']} over {pre} finished prefills; "
                f"recorder downloads {c['reads_recorded']}; sync debug "
                f"warnings {c['debug_warnings']} ({dbg}); records in model "
                f"entry points {c['model_records']}; step-loop syncs "
                f"outside the read {c['step_syncs']}; uploads "
                f"{c['uploads']} ({c['uploads'] / units:.2f} a decode step "
                f"or round; by phase: {ups}) over {c['prefill_chunks']} "
                f"prefill chunks; float64 ops {c['float64']}; kernel "
                f"builds {c['builds']}, loads {c['loads']}")

    def debug_sites(self) -> List[Tuple[int, str, str, int, str]]:
        """The steady state's sync debug warnings outside the read funnel,
        by site: ``(count, op, path, line, innermost phase)``."""
        sites: Dict[tuple, int] = {}
        for d in self.steady.debug:
            if "engine._device_read" in d.tags:
                continue
            ph = next((t for t in reversed(d.tags)
                       if t.startswith("phase.")), "-")
            key = (d.op or "<no op>", d.site[0], d.site[1], ph)
            sites[key] = sites.get(key, 0) + 1
        return [(n, *key) for key, n in sorted(sites.items())]


class _EngineProbe:
    """Instance-level wrappers on one engine: which unit each read falls
    in, and how many units ran."""

    def __init__(self, engine, log_ref):
        self.engine = engine
        self.log_ref = log_ref           # () -> the SyncLog open now
        self.unit = None
        self.units = {"decode": 0, "prefill": 0, "spec_round": 0,
                      "chunk": 0}
        self.reads = {"decode": 0, "prefill": 0, "spec_round": 0,
                      "other": 0}
        self.reads_recorded = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        eng, probe = self.engine, self
        st = self._stack

        def around(name, unit):
            orig = getattr(eng, name)

            def run(*a, **kw):
                if unit == "prefill":
                    probe.units["chunk"] += 1
                prev, probe.unit = probe.unit, unit
                try:
                    return orig(*a, **kw)
                finally:
                    probe.unit = prev
            _inst(st, eng, name, run)

        around("_prefill_chunk_step", "prefill")
        around("_decode_step", "decode")
        around("_spec_decode_step", "spec_round")
        read = eng._device_read

        def device_read(t):
            log = probe.log_ref()
            probe.reads[probe.unit or "other"] += 1
            n0 = len(log.records) if log is not None else 0
            ctx = log.tag("engine._device_read") if log is not None \
                else contextlib.nullcontext()
            with ctx:
                out = read(t)
            if log is not None and any(
                    r.kind == "download" for r in log.records[n0:]):
                probe.reads_recorded += 1
            return out
        _inst(st, eng, "_device_read", device_read)
        for name, unit in (("_decode_call", "decode"),
                           ("_verify_call", "spec_round")):
            orig = getattr(eng, name)

            def call(*a, _orig=orig, _unit=unit, **kw):
                probe.units[_unit] += 1
                return _orig(*a, **kw)
            _inst(st, eng, name, call)
        fin = eng.scheduler.finish_prefill

        def finish_prefill(*a, **kw):
            probe.units["prefill"] += 1
            return fin(*a, **kw)
        _inst(st, eng.scheduler, "finish_prefill", finish_prefill)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False


def _inst(stack: contextlib.ExitStack, obj, name: str, value) -> None:
    """Shadow a method with an instance attribute; on exit the instance
    gets back what it had (its own attribute, or none)."""
    if name in obj.__dict__:
        stack.callback(setattr, obj, name, obj.__dict__[name])
    else:
        stack.callback(delattr, obj, name)
    setattr(obj, name, value)


def _drive(engine, requests) -> None:
    for r in requests:
        engine.submit(r)
    engine.run_until_idle()


def run_sync_guard(engine, warmup_requests, steady_requests,
                   expected: Optional[Dict[str, int]] = None
                   ) -> GuardReport:
    """Drive ``engine`` through warmup then steady state, each inside a
    :class:`SyncLog`, and check the steady state's host reads and syncs.

    Args:
      engine: a fresh :class:`repro_torch.serve.engine.Engine`.
      warmup_requests / steady_requests: two request lists of the SAME
        shape classes (the warmup pays every kernel build).
      expected: reads per unit, :data:`EXPECTED_READS` by default:
        exactly ``decode`` a decode step and ``prefill`` a finished
        prefill, at most ``spec_round`` a speculative round.

    Every steady-state op that makes a float64 tensor is an ``inv-f64``
    finding too.
    """
    exp = dict(EXPECTED_READS, **(expected or {}))
    current: List[Optional[SyncLog]] = [None]
    with SyncLog() as warm:
        current[0] = warm
        with _EngineProbe(engine, lambda: current[0]):
            _drive(engine, warmup_requests)
    reads0 = engine.device_reads
    with _EngineProbe(engine, lambda: current[0]) as probe:
        with SyncLog(watch_dtypes=True) as steady:
            current[0] = steady
            _drive(engine, steady_requests)
    current[0] = None
    log = steady
    step_syncs = [r for r in log.records
                  if r.waits and r.entry_point is None
                  and "engine._device_read" not in r.tags]
    counts = {
        "decode_steps": probe.units["decode"],
        "prefills": probe.units["prefill"],
        "prefill_chunks": probe.units["chunk"],
        "spec_rounds": probe.units["spec_round"],
        "device_reads": engine.device_reads - reads0,
        "reads_decode": probe.reads["decode"],
        "reads_prefill": probe.reads["prefill"],
        "reads_spec": probe.reads["spec_round"],
        "reads_other": probe.reads["other"],
        "reads_recorded": probe.reads_recorded,
        "step_syncs": len(step_syncs),
        "model_records": len(log.in_model()),
        "uploads": log.count("upload"),
        "float64": len(log.float64),
        "debug_warnings": -1 if log.debug_warnings is None
        else log.debug_warnings,
        "builds": log.builds, "loads": log.loads,
    }
    for r in log.records:
        if r.kind == "upload":
            ph = next((t for t in reversed(r.tags)
                       if t.startswith("phase.")), "phase.none")
            key = "uploads." + ph[len("phase."):]
            counts[key] = counts.get(key, 0) + 1
    if log.debug_warnings is not None:
        counts.update({f"debug.{k}": n for k, n in log.debug_by().items()})
    findings: List[Finding] = []

    def steady_finding(detail, msg):
        findings.append(Finding(
            "sync-steady", "", 0, "engine.run_until_idle", detail, msg,
            "error", "route the read through Engine._device_read, once a "
            "step"))

    c = counts
    if c["device_reads"] != sum(probe.reads.values()):
        steady_finding("reads-total",
                       f"device_reads {c['device_reads']} != reads seen "
                       f"{sum(probe.reads.values())}")
    if c["reads_decode"] != exp["decode"] * c["decode_steps"]:
        steady_finding("reads-decode",
                       f"{c['reads_decode']} reads over "
                       f"{c['decode_steps']} decode steps, expected "
                       f"{exp['decode']} a step")
    if c["reads_prefill"] != exp["prefill"] * c["prefills"]:
        steady_finding("reads-prefill",
                       f"{c['reads_prefill']} reads over {c['prefills']} "
                       f"finished prefills, expected {exp['prefill']} each")
    if c["reads_spec"] > exp["spec_round"] * c["spec_rounds"]:
        steady_finding("reads-spec",
                       f"{c['reads_spec']} reads over {c['spec_rounds']} "
                       f"speculative rounds, at most {exp['spec_round']} "
                       f"a round")
    if c["reads_other"]:
        steady_finding("reads-other", f"{c['reads_other']} reads outside "
                       f"a prefill, decode step or speculative round")
    if log.cuda and c["reads_recorded"] != c["device_reads"]:
        steady_finding("reads-recorded",
                       f"the recorder saw {c['reads_recorded']} reads "
                       f"download, the engine counted {c['device_reads']}")
    for r in step_syncs:
        path, line, fn = r.site
        findings.append(Finding(
            "sync-steady", path, line, fn, f"{r.kind}",
            f"{r.kind} ({r.op}) in the step loop outside "
            f"Engine._device_read, tags {list(r.tags)}", "error",
            "route the read through Engine._device_read"))
    findings.extend(model_findings(log, "steady-state serving"))
    for op, tags, site in log.float64:
        findings.append(Finding(
            "inv-f64", site[0], site[1], site[2], op,
            f"{op} made float64 in steady-state serving, tags {list(tags)}",
            "error", "keep float32"))
    if log.builds or log.loads:
        findings.append(Finding(
            "build-steady", "", 0, "engine.run_until_idle", "build-load",
            f"{log.builds} kernel build(s), {log.loads} library load(s) "
            f"in steady state", "error",
            "the warmup must launch every kernel the steady state "
            "launches"))
    return GuardReport(warm, steady, counts, findings)
