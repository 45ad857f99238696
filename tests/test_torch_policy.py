"""Port parity: scheduler and engine policy (``serve/scheduler.py``:
priorities, the bounded queue, load shedding, deadlines, requeue;
``serve/engine.py``: ``DegradationPolicy`` and the ladder, the JAX
defaults; ``serve/faults.py``: the fault schedules and a standalone
engine's injector) against the JAX package.

Mirrors the host-side and single-engine half of ``tests/test_faults.py``
(the router half is ``tests/test_torch_router.py``), and adds:
``DegradationPolicy.mode_for`` equals the JAX policy's over a hypothesis
grid of policies, pressures and modes; the canned and seeded random
fault schedules equal the JAX package's; a random stream of submits
sheds the same requests in the same order; and the engine runs of
deadlines, shedding and the ladder (a speculative engine under a pool
squeeze included) give the JAX engine's tokens, finish reasons and mode
trajectory.

Tolerances: greedy tokens identical; policy outputs equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import DegradationPolicy as JPolicy  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Fault as JFault  # noqa: E402
from repro.serve import FaultInjector as JFaultInjector  # noqa: E402
from repro.serve import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SlotScheduler as JSlotScheduler  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import (DegradationPolicy, Engine,  # noqa: E402
                               Fault, FaultInjector, FaultSchedule,
                               FinishReason, MODE_NO_SPEC, MODE_NORMAL,
                               MODE_SHRINK_PREFILL, MODE_STOP_ADMIT,
                               Request, SlotScheduler, SpecConfig)
from repro_torch.serve.engine import DEFAULT_DEGRADATION  # noqa: E402

ENGINE_KW = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)


# ---------------------------------------------------------------------------
# host-side: schedule validation, degradation policy, bounded queue
# ---------------------------------------------------------------------------

def test_fault_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(step=1, kind="meteor")
    with pytest.raises(ValueError, match="step must be >= 1"):
        Fault(step=0, kind="crash")
    with pytest.raises(ValueError, match="duration"):
        Fault(step=1, kind="slow", duration=0)
    f = Fault(step=3, kind="slow", duration=2)
    assert [f.active(c) for c in range(1, 7)] == [
        False, False, True, True, False, False]
    crash = Fault(step=3, kind="crash")
    assert [crash.active(c) for c in (2, 3, 99)] == [False, True, True]


def _as_tuples(schedule):
    return [(f.step, f.kind, f.replica, f.duration) for f in schedule.faults]


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_fault_schedules_equal_jax(seed):
    a = FaultSchedule.random(seed, replicas=3, n_faults=8)
    assert a.faults == FaultSchedule.random(seed, replicas=3,
                                            n_faults=8).faults
    assert _as_tuples(a) == _as_tuples(
        JFaultSchedule.random(seed, replicas=3, n_faults=8))
    assert sum(f.kind == "crash" for f in a.faults) <= 1
    assert all(f.replica < 3 for f in a.faults)
    for replicas in (1, 2, 3):
        assert _as_tuples(FaultSchedule.canned(replicas)) == _as_tuples(
            JFaultSchedule.canned(replicas))


def test_degradation_mode_monotone_in_pressure():
    p = DegradationPolicy()
    for current in range(4):
        modes = [p.mode_for(x / 1000.0, current) for x in range(1001)]
        assert all(a <= b for a, b in zip(modes, modes[1:]))
        assert set(modes) <= {0, 1, 2, 3}
    assert p.mode_for(0.79, MODE_NORMAL) == MODE_NORMAL
    assert p.mode_for(0.80, MODE_NORMAL) == MODE_NO_SPEC
    assert p.mode_for(0.90, MODE_NORMAL) == MODE_SHRINK_PREFILL
    assert p.mode_for(0.97, MODE_NORMAL) == MODE_STOP_ADMIT


def test_degradation_hysteresis():
    p = DegradationPolicy()
    assert p.mode_for(0.80, MODE_NO_SPEC) == MODE_NO_SPEC
    assert p.mode_for(0.75, MODE_NO_SPEC) == MODE_NO_SPEC
    assert p.mode_for(0.699, MODE_NO_SPEC) == MODE_NORMAL
    assert p.mode_for(0.88, MODE_STOP_ADMIT) == MODE_STOP_ADMIT
    assert p.mode_for(0.869, MODE_STOP_ADMIT) == MODE_SHRINK_PREFILL
    assert p.mode_for(0.5, MODE_STOP_ADMIT) == MODE_NORMAL
    with pytest.raises(ValueError, match="thresholds"):
        DegradationPolicy(spec_off=0.9, chunk_shrink=0.8)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(0.01, 1.0), min_size=3, max_size=3),
       st.floats(0.0, 0.5), st.floats(0.0, 1.0), st.integers(0, 3))
def test_mode_for_equals_jax(thresholds, hysteresis, pressure, current):
    t = sorted(thresholds)
    kw = dict(spec_off=t[0], chunk_shrink=t[1], admit_stop=t[2],
              hysteresis=hysteresis)
    assert DegradationPolicy(**kw).mode_for(pressure, current) == \
        JPolicy(**kw).mode_for(pressure, current)


def test_engine_defaults_are_the_jax_engines(lut):
    *_, tm, params_t, qc_t = lut
    eng = Engine(tm, params_t, qc_t, **ENGINE_KW)
    assert eng.kv.table.prefix is not None
    assert eng.degradation is DEFAULT_DEGRADATION
    assert eng.scheduler.max_queue is None
    assert dataclasses.asdict(DEFAULT_DEGRADATION) == \
        dataclasses.asdict(JPolicy())
    with pytest.raises(NotImplementedError, match="item 11"):
        Engine(tm, params_t, qc_t, mesh=object(), **ENGINE_KW)


def test_bounded_queue_sheds_lowest_priority_newest_first():
    sched = SlotScheduler(2, max_queue=2)
    reqs = [Request(tokens=[i], priority=pr)
            for i, pr in enumerate([0, 1, 2, 3, 0, 5])]
    victims = [sched.submit(r) for r in reqs]
    assert victims[:2] == [None, None]
    assert [v is reqs[i] for v, i in zip(victims[2:], (0, 1, 4, 2))] == \
        [True] * 4
    assert [r.shed for r in reqs] == [True, True, True, False, True, False]
    assert all(r.done and r.finish_reason is FinishReason.LOAD_SHED
               for r in reqs if r.shed)
    assert sched.shed_count == 4
    assert [r.tokens for r in sched.waiting] == [[5], [3]]


def test_shedding_order_equals_jax_on_a_random_stream():
    rng = np.random.default_rng(5)
    prio = rng.integers(0, 4, 60).tolist()
    pops = rng.random(60) < 0.3
    out = []
    for sched_cls, req_cls in ((SlotScheduler, Request),
                               (JSlotScheduler, JRequest)):
        sched = sched_cls(2, max_queue=5)
        reqs = [req_cls(tokens=[i], priority=p) for i, p in enumerate(prio)]
        shed = []
        for r, pop in zip(reqs, pops):
            v = sched.submit(r)
            shed.append(None if v is None else v.tokens[0])
            if pop and sched.waiting:
                sched.waiting.popleft()         # one admission
        out.append((shed, [r.tokens[0] for r in sched.waiting],
                    sched.shed_count))
    assert out[0] == out[1]


def test_requeue_is_exempt_from_queue_bound():
    sched = SlotScheduler(1, max_queue=1)
    sched.submit(Request(tokens=[1]))
    preempted = Request(tokens=[2])
    sched.requeue(preempted)
    assert len(sched.waiting) == 2
    assert sched.waiting[0] is preempted and preempted.retries == 1
    assert sched.shed_count == 0


# ---------------------------------------------------------------------------
# engine runs against the JAX engine (int8 lut_infer smoke)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lut():
    jm = JModel(jcfg.smoke_config())
    qc_j = JQC(mode="lut_infer", lut_dtype="int8")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(4), JQC(mode="lut_train")), qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, TQC(mode="lut_infer",
                                                 lut_dtype="int8")


def _both(lut, **kw):
    """A JAX engine and a port engine with the same arguments."""
    jm, params_j, qc_j, tm, params_t, qc_t = lut
    kw = dict(ENGINE_KW, **kw)
    return JEngine(jm, params_j, qc_j, **kw), Engine(tm, params_t, qc_t, **kw)


def _outcome(reqs):
    return [(r.finish_reason.name, r.out_tokens, r.finish_step)
            for r in reqs]


def test_deadline_evicts_slot_but_keeps_partial_output(lut):
    outs = []
    for eng, req in zip(_both(lut), (JRequest, Request)):
        slow = req(tokens=[2, 3], max_new_tokens=20)
        dl = req(tokens=[4, 5], max_new_tokens=20, deadline_steps=4)
        eng.submit(slow)
        eng.submit(dl)
        eng.run_until_idle()
        assert dl.done and dl.finish_reason.name == "DEADLINE"
        assert 1 <= len(dl.out_tokens) < 20
        assert slow.done and len(slow.out_tokens) == 20
        assert eng.scheduler.expired_count == 1
        assert eng.kv.live_pages == 0
        outs.append(_outcome([slow, dl]))
    assert outs[0] == outs[1]


def test_deadline_expires_queued_request_without_a_slot(lut):
    outs = []
    for eng, req in zip(_both(lut), (JRequest, Request)):
        hogs = [req(tokens=[i + 2, i + 3], max_new_tokens=12)
                for i in range(2)]
        dl = req(tokens=[9, 9], max_new_tokens=4, deadline_steps=2)
        for r in hogs + [dl]:
            eng.submit(r)
        eng.run_until_idle()
        assert dl.finish_reason.name == "DEADLINE" and dl.out_tokens == []
        assert all(len(r.out_tokens) == 12 for r in hogs)
        outs.append(_outcome(hogs + [dl]))
    assert outs[0] == outs[1]


def test_engine_load_shedding_is_a_result_not_an_exception(lut):
    outs = []
    for eng, req in zip(_both(lut, max_queue=1), (JRequest, Request)):
        reqs = [req(tokens=[i + 2, i + 3], max_new_tokens=3, priority=pr)
                for i, pr in enumerate([0, 1, 2])]
        victims = [eng.submit(r) for r in reqs]
        assert victims[0] is None and victims[1] is reqs[0]
        eng.run_until_idle()
        assert [r.shed for r in reqs] == [True, True, False]
        assert all(r.out_tokens == [] for r in reqs[:2])
        assert eng.scheduler.shed_count == 2
        assert len(reqs[2].out_tokens) == 3
        outs.append(_outcome(reqs))
    assert outs[0] == outs[1]


def _ladder_run(eng, req, fault, inj_cls, sched_cls, spec=False):
    inj = inj_cls(sched_cls([fault(step=3, kind="pool_exhaust",
                                   duration=6)])).attach(eng)
    reqs = [req(tokens=[i + 2, i + 3], max_new_tokens=10)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    modes = []
    while eng.scheduler.has_work:
        eng.step()
        modes.append(eng.mode)
    return reqs, modes, inj


def test_degradation_ladder_under_forced_pool_exhaustion(lut):
    """A pool squeeze drives pressure to 1.0: the engine rides the ladder
    up to the admission stop, keeps every request alive (preempt, not
    truncate), and comes back to normal once pages free up, on the JAX
    engine's trajectory."""
    j_eng, t_eng = _both(lut)
    runs = []
    for eng, req, fault, inj, sch in (
            (j_eng, JRequest, JFault, JFaultInjector, JFaultSchedule),
            (t_eng, Request, Fault, FaultInjector, FaultSchedule)):
        reqs, modes, injector = _ladder_run(eng, req, fault, inj, sch)
        assert max(modes) == MODE_STOP_ADMIT and modes[-1] == MODE_NORMAL
        assert injector.report()["by_kind"]["pool_exhaust"] >= 1
        assert all(r.finish_reason.name == "COMPLETED" and
                   len(r.out_tokens) == 10 for r in reqs)
        assert eng.mode_steps[MODE_STOP_ADMIT] > 0
        runs.append((modes, _outcome(reqs), eng.mode_steps,
                     eng.scheduler.preemptions, injector.report()))
    assert runs[0] == runs[1]


def test_speculative_engine_stops_speculating_under_the_ladder(lut):
    """A speculative engine (ngram, k=3) under the same squeeze: no verify
    call while the mode is 1 or higher, speculation resumes after, and
    the streams equal a roomy non-speculative engine's and the JAX
    speculative engine's."""
    jm, params_j, qc_j, tm, params_t, qc_t = lut
    kw = dict(ENGINE_KW, max_seq=64)
    base = [Request(tokens=[i + 2, i + 3], max_new_tokens=10)
            for i in range(3)]
    Engine(tm, params_t, qc_t, **dict(kw, batch_size=3)).run(base)
    eng = Engine(tm, params_t, qc_t, spec_decode=SpecConfig(
        k=3, drafter="ngram"), **kw)
    verify_modes = []
    orig = eng._verify_call

    def spy(*a):
        verify_modes.append(eng.mode)
        return orig(*a)
    eng._verify_call = spy
    reqs, modes, _ = _ladder_run(eng, Request, Fault, FaultInjector,
                                 FaultSchedule)
    j_eng = JEngine(jm, params_j, qc_j, spec_decode=JSpecConfig(
        k=3, drafter="ngram"), **kw)
    j_reqs, j_modes, _ = _ladder_run(j_eng, JRequest, JFault,
                                     JFaultInjector, JFaultSchedule)
    assert max(modes) == MODE_STOP_ADMIT and modes[-1] == MODE_NORMAL
    assert verify_modes and set(verify_modes) == {MODE_NORMAL}
    assert eng.spec_rounds == len(verify_modes)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base]
    assert _outcome(reqs) == _outcome(j_reqs) and modes == j_modes
    assert eng.kv.live_pages == 0
