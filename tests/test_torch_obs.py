"""Port parity: serving observability (``repro_torch.obs``: ``Registry``,
``Histogram``, ``safe_ratio``, ``Tracer``, ``validate_trace``, ``Obs``;
the engines and the router recording into it) against the JAX package.

Mirrors ``tests/test_obs.py`` without its benchmark-snapshot, perf-gate
and AST-lint cases (those modules wait for the benchmark, ROADMAP.md
queue A item 8), and adds: the same observations give the JAX registry's
percentiles, snapshot and Prometheus text exactly; the same recording
gives the JAX tracer's events (timestamps aside) and ``validate_trace``
answers as the JAX one on valid and broken documents; the phases land in
a ``torch.profiler`` trace under ``Obs(torch_annotations=True)``.

Tolerances: equal (host arithmetic on the same floats).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.obs import Registry as JRegistry  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import validate_trace as j_validate_trace  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.obs import (NULL_CTX, Obs, Registry, Tracer,  # noqa: E402
                             safe_ratio, validate_trace)
from repro_torch.serve import (Engine, FaultInjector,  # noqa: E402
                               FaultSchedule, ReplicaRouter, Request,
                               SlotScheduler)

ENGINE_KW = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)


@pytest.fixture(scope="module")
def lut():
    jm = JModel(jcfg.smoke_config())
    qc_j = JQC(mode="lut_infer", lut_dtype="int8")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(6), JQC(mode="lut_train")), qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                 tm.cfg, device="cpu")
    return tm, params_t, TQC(mode="lut_infer", lut_dtype="int8")


def _mk_engine(lut, **kw):
    tm, params_t, qc_t = lut
    return Engine(tm, params_t, qc_t, **dict(ENGINE_KW, **kw))


# ---------------------------------------------------------------------------
# metrics: histogram accuracy, registry round-trip, guarded ratios
# ---------------------------------------------------------------------------

def test_histogram_percentile_error_bound():
    h = Registry().histogram("lat", growth=1.25)
    samples = np.exp(
        np.random.default_rng(0).normal(loc=-5.0, scale=2.0, size=4000))
    for v in samples:
        h.observe(float(v))
    for q in (0.5, 0.9, 0.99):
        exact = float(np.quantile(samples, q))
        est = h.percentile(q)
        assert abs(est - exact) / exact <= 2 * (h.growth - 1.0)
    assert h.count == len(samples)
    assert np.isclose(h.total, samples.sum())
    assert np.isclose(h.mean, samples.mean())


def test_histogram_under_overflow_and_empty():
    h = Registry().histogram("x", lo=1e-3, hi=1e3)
    assert h.percentile(0.5) == 0.0
    h.observe(1e-9)
    h.observe(5e8)
    assert h.percentile(0.0) == 1e-9 and h.percentile(1.0) == 5e8
    assert h.count == 2 and h.min == 1e-9 and h.max == 5e8


def _record(reg_cls):
    r = reg_cls()
    r.counter("a.b", unit="tokens", desc="things").inc(7)
    r.gauge("g", unit="B").set(3.5)
    h = r.histogram("h", unit="s")
    for v in np.exp(np.random.default_rng(1).normal(-4.0, 3.0, 500)):
        h.observe(float(v))
    for v in (1e-4, 2e-2, 5.0, 1e-8, 1e9):
        h.observe(v)
    r.histogram("steps", unit="steps", lo=1.0, hi=1e6).observe(17)
    return r


def test_registry_equals_jax_and_round_trips():
    r, j = _record(Registry), _record(JRegistry)
    assert r.snapshot() == j.snapshot()
    assert r.prometheus() == j.prometheus()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert r.get_histogram("h").percentile(q) == \
            j.get_histogram("h").percentile(q)
    r2 = Registry.from_snapshot(json.loads(json.dumps(r.snapshot())))
    assert r2.snapshot() == r.snapshot()
    prom = r.prometheus()
    assert "# TYPE a_b counter" in prom and "a_b 7" in prom
    assert '{quantile="0.99"}' in prom and "h_count 505" in prom


def test_ratios_guard_empty_denominators(lut):
    assert safe_ratio(3.0, 0.0) == 0.0
    assert safe_ratio(3.0, 0.0, default=1.0) == 1.0
    r = Registry()
    assert r.ratio("nope", "nothing") == 0.0
    r.counter("num").inc(4)
    assert r.ratio("num", "nothing") == 0.0
    eng = _mk_engine(lut)
    assert eng.prefix_hit_rate == 0.0
    assert eng.acceptance_rate == 0.0 and eng.tokens_per_verify == 0.0
    sched = SlotScheduler(2)
    assert (sched.shed_count, sched.expired_count, sched.preemptions) \
        == (0, 0, 0)


# ---------------------------------------------------------------------------
# tracer: JSON validity, ring bound, disabled no-op
# ---------------------------------------------------------------------------

def _trace(tr_cls):
    tr = tr_cls(enabled=True)
    tr.name_process(0, "replica 0")
    with tr.span("step", pid=0):
        with tr.span("decode", pid=0):
            tr.instant("degradation", pid=0, args={"to": "no_spec"})
    tr.request_begin(1, "req 1", {"prompt": 3})
    tr.request_instant(1, "req 1", "requeued")
    tr.request_end(1, "req 1", {"reason": "COMPLETED"})
    tr.counter("pressure", 0.5, pid=0)
    return tr


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_tracer_export_is_valid_and_equals_jax(tmp_path):
    tr = _trace(Tracer)
    path = tmp_path / "t.json"
    doc = tr.export(str(path))
    assert validate_trace(doc) == []
    on_disk = json.loads(path.read_text())
    assert validate_trace(on_disk) == []
    names = {e["name"] for e in on_disk["traceEvents"]}
    assert {"step", "decode", "degradation", "req 1", "pressure",
            "process_name"} <= names
    labels = {e["args"]["name"] for e in on_disk["traceEvents"]
              if e.get("ph") == "M"}
    assert {"replica 0", "requests"} <= labels
    assert _untimed(tr.chrome_events()) == \
        _untimed(_trace(JTracer).chrome_events())


def test_validate_trace_catches_breakage_as_jax_does():
    docs = [
        {},
        {"traceEvents": [{"ph": "e", "cat": "request", "id": 9, "name": "r",
                          "ts": 1.0, "pid": 999, "tid": 0}]},
        {"traceEvents": [
            {"ph": "X", "name": "a", "ts": 0.0, "dur": 10.0, "pid": 0,
             "tid": 0},
            {"ph": "X", "name": "b", "ts": 5.0, "dur": 10.0, "pid": 0,
             "tid": 0}]},
        {"traceEvents": [{"ph": "b", "cat": "request", "id": 3, "name": "r",
                          "ts": 1.0, "pid": 999, "tid": 0}]},
        {"traceEvents": _trace(Tracer).chrome_events()},
    ]
    got = [validate_trace(d) for d in docs]
    assert got == [j_validate_trace(d) for d in docs]
    assert got[0] == ["missing traceEvents"]
    assert any("without begin" in p for p in got[1])
    assert any("overlaps" in p for p in got[2])
    assert any("without end" in p for p in got[3])
    assert got[4] == []


def test_tracer_ring_buffer_is_bounded():
    tr = Tracer(enabled=True, capacity=16)
    for i in range(500):
        tr.instant(f"e{i}")
    assert len(tr) == 16


def test_disabled_obs_is_noop():
    tr = Tracer(enabled=False)
    assert tr.span("x") is NULL_CTX
    tr.instant("x")
    tr.request_begin(1, "r")
    assert len(tr) == 0
    obs = Obs.disabled()
    assert obs.phase("decode") is NULL_CTX
    assert not obs.active
    obs.annotate("degradation", to="no_spec")
    obs.track("pressure", 1.0)
    assert len(obs.tracer) == 0
    assert obs.metrics.snapshot()["histograms"] == {}
    obs.metrics.counter("c").inc()
    assert obs.metrics.counters()["c"] == 1


# ---------------------------------------------------------------------------
# instrumented engine: hot-path contract + request lifecycle
# ---------------------------------------------------------------------------

def test_engine_obs_on_one_device_read_per_step(lut, tmp_path):
    obs = Obs(tracer=Tracer(enabled=True))
    eng = _mk_engine(lut, obs=obs)
    req = Request(tokens=[3, 4, 5], max_new_tokens=6)
    eng.run([req])
    assert eng.device_reads == 6             # one fetch per step, obs on
    met = obs.metrics
    cs = met.counters()
    assert cs["engine.device_reads"] == 6
    assert cs["engine.emitted_tokens"] == 6
    assert cs["req.finish.completed"] == 1
    for fam in ("req.ttft_steps", "req.latency_steps", "req.ttft_s",
                "req.latency_s", "req.tpot_s"):
        h = met.get_histogram(fam)
        assert h is not None and h.count == 1, fam
    assert met.get_histogram("req.ttft_s").min > 0.0
    for ph in ("admit", "prefill_chunk", "decode", "sample", "device_read"):
        h = met.get_histogram(f"engine.phase.{ph}_s")
        assert h is not None and h.count > 0, ph
    doc = obs.tracer.export(str(tmp_path / "eng.json"))
    assert validate_trace(doc) == []
    phs = [e["ph"] for e in doc["traceEvents"]]
    assert phs.count("b") == 1 and phs.count("e") == 1


def test_engine_obs_disabled_same_tokens_and_counters(lut):
    outs = {}
    for tag, obs in (("off", Obs.disabled()), ("on", Obs())):
        req = Request(tokens=[5, 6, 7], max_new_tokens=5)
        eng = _mk_engine(lut, obs=obs)
        eng.run([req])
        outs[tag] = req.out_tokens
        assert eng.device_reads == 5
    assert outs["on"] == outs["off"]
    off = Obs.disabled()
    _mk_engine(lut, obs=off).run([Request(tokens=[5, 6, 7],
                                          max_new_tokens=5)])
    snap = off.metrics.snapshot()
    assert not any(n.startswith("engine.phase.")
                   for n in snap["histograms"])
    assert snap["counters"]["engine.emitted_tokens"]["value"] == 5


def test_chaos_trace_has_spans_and_annotations(lut, tmp_path):
    tracer = Tracer(enabled=True)
    router = ReplicaRouter(
        [_mk_engine(lut, obs=Obs(tracer=tracer), num_pages=8)
         for _ in range(2)])
    FaultInjector(FaultSchedule.canned(replicas=2)).attach(router)
    reqs = [Request(tokens=[2 + i, 3 + i], max_new_tokens=6 + 4 * (i % 2))
            for i in range(6)]
    for r in reqs:
        router.submit(r)
    router.run_until_idle()
    assert all(r.done for r in reqs)
    doc = tracer.export(str(tmp_path / "chaos.json"))
    assert validate_trace(doc) == []
    evs = doc["traceEvents"]
    annot = {e["name"] for e in evs if e.get("ph") == "i"}
    assert any(a.startswith("fault.") for a in annot), annot
    assert "health" in annot
    begins = [e for e in evs if e.get("ph") == "b"]
    ends = [e for e in evs if e.get("ph") == "e"]
    assert {e["id"] for e in begins} == {e["id"] for e in ends}
    assert len(begins) == len(reqs)           # migration keeps ONE span
    assert {e["pid"] for e in evs if e.get("ph") == "X"} == {0, 1}
    assert router.retried_requests > 0
    assert router.obs.metrics.counters()["router.health.to_dead"] == 1


def test_scheduler_preemption_and_cow_fork_annotate(lut):
    obs = Obs(tracer=Tracer(enabled=True))
    eng = _mk_engine(lut, num_pages=5, obs=obs)
    reqs = [Request(tokens=[2, 3, 4, 5, 6, 7], max_new_tokens=20),
            Request(tokens=list(range(2, 26)), max_new_tokens=4)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert eng.scheduler.preemptions > 0
    eng.run([Request(tokens=list(range(2, 18)), max_new_tokens=2)])
    eng.run([Request(tokens=list(range(2, 18)), max_new_tokens=2)])
    names = [ev[1] for ev in obs.tracer._events if ev[0] == "i"]
    assert "preempt" in names and "cow_fork" in names


def test_phases_show_in_a_torch_profiler_trace(lut):
    obs = Obs(torch_annotations=True)
    eng = _mk_engine(lut, obs=obs)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run([Request(tokens=[3, 4], max_new_tokens=3)])
    keys = {e.key for e in prof.key_averages()}
    assert {"admit", "prefill_chunk", "decode", "device_read"} <= keys
