"""Port parity: replica routing and chaos (``serve/router.py``:
``ReplicaRouter`` dispatch, prefix affinity, health, drain, the step
watchdog, crash recovery; ``serve/faults.py``: ``FaultInjector`` on a
router) against the JAX package.

Mirrors the router half of ``tests/test_faults.py`` and the routing test
of ``tests/test_prefix_cache.py``. Each run of a fault schedule must
complete every request the router accepted, with the greedy tokens of a
fault-free run; and the canned chaos schedule and a stall window give
the JAX router's outcomes: finish reasons, tokens, retries, replica
health and the injections that fired. ``ReplicaRouter.build`` on one
device shares one params dict; ``from_mesh`` raises (ROADMAP.md queue A
item 11).

Tolerances: greedy tokens identical; outcomes equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Fault as JFault  # noqa: E402
from repro.serve import FaultInjector as JFaultInjector  # noqa: E402
from repro.serve import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.serve import ReplicaRouter as JReplicaRouter  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import (Engine, Fault, FaultInjector,  # noqa: E402
                               FaultSchedule, FinishReason,
                               PagePoolExhausted, ReplicaHealth,
                               ReplicaRouter, Request)

SYS = [(3 * j) % 40 + 2 for j in range(16)]
ENGINE_KW = dict(batch_size=2, max_seq=32, page_size=8, prefill_chunk=4)


@pytest.fixture(scope="module")
def lut():
    jm = JModel(jcfg.smoke_config())
    qc_j = JQC(mode="lut_infer", lut_dtype="int8")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(5), JQC(mode="lut_train")), qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, TQC(mode="lut_infer",
                                                 lut_dtype="int8")


def _mk_router(lut, replicas=2, router_kw=None, **kw):
    *_, tm, params_t, qc_t = lut
    return ReplicaRouter([Engine(tm, params_t, qc_t, **dict(ENGINE_KW, **kw))
                          for _ in range(replicas)], **(router_kw or {}))


def _mk_jrouter(lut, replicas=2, router_kw=None, **kw):
    jm, params_j, qc_j, *_ = lut
    return JReplicaRouter([JEngine(jm, params_j, qc_j,
                                   **dict(ENGINE_KW, **kw))
                           for _ in range(replicas)], **(router_kw or {}))


def test_build_shares_params_and_mesh_is_not_ported(lut):
    *_, tm, params_t, qc_t = lut
    router = ReplicaRouter.build(tm, params_t, qc_t, replicas=2,
                                 **ENGINE_KW)
    assert all(e.params is params_t for e in router.engines)
    assert router.engines[0].kv.data["k"].data_ptr() != \
        router.engines[1].kv.data["k"].data_ptr()
    assert [e.obs.pid for e in router.engines] == [0, 1]
    with pytest.raises(NotImplementedError, match="item 11"):
        ReplicaRouter.from_mesh(tm, params_t, qc_t, mesh=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        ReplicaRouter.build(tm, params_t, qc_t, replicas=2, mesh=object())


def test_router_routes_to_replica_with_longest_prefix(lut):
    router = _mk_router(lut)
    warmup = Request(tokens=SYS + [50], max_new_tokens=2)
    assert router.submit(warmup) is router.engines[0]    # load tie: lowest
    router.run_until_idle()
    router.engines[0].submit(Request(tokens=[9, 9], max_new_tokens=2))
    hot = Request(tokens=SYS + [51], max_new_tokens=2)
    assert router.submit(hot) is router.engines[0]       # affinity wins
    cold = Request(tokens=[30, 31, 32], max_new_tokens=2)
    assert router.submit(cold) is router.engines[1]      # least loaded
    router.run_until_idle()
    assert hot.cached_tokens == 16
    for k in range(router.affinity_load_slack + 1):
        router.engines[0].submit(Request(tokens=[9, 9 + k],
                                         max_new_tokens=2))
    spilled = Request(tokens=SYS + [53], max_new_tokens=2)
    assert router.submit(spilled) is router.engines[1]   # load-bounded
    router.run_until_idle()
    assert spilled.cached_tokens == 0
    assert router.engines[1].kv.match_prefix(SYS + [54]).tokens == 16
    plain = _mk_router(lut, router_kw=dict(prefix_affinity=False))
    plain.engines[0].submit(Request(tokens=[9, 9], max_new_tokens=2))
    assert plain.submit(Request(tokens=SYS + [52], max_new_tokens=2)) \
        is plain.engines[1]


def test_router_submit_falls_back_when_a_replica_refuses(lut):
    router = _mk_router(lut)
    inj = FaultInjector(FaultSchedule(
        [Fault(step=1, kind="submit_error", replica=0,
               duration=5)])).attach(router)
    router.step()
    req = Request(tokens=[2, 3], max_new_tokens=3)
    assert router.submit(req) is router.engines[1]
    router.run_until_idle()
    assert req.finish_reason is FinishReason.COMPLETED
    assert inj.report()["by_kind"]["submit_error"] >= 1


def test_router_submit_raises_only_when_every_replica_refuses(lut):
    router = _mk_router(lut)
    FaultInjector(FaultSchedule(
        [Fault(step=1, kind="submit_error", replica=0, duration=5),
         Fault(step=1, kind="submit_error", replica=1,
               duration=5)])).attach(router)
    router.step()
    with pytest.raises(PagePoolExhausted, match="injected"):
        router.submit(Request(tokens=[2, 3], max_new_tokens=2))


def test_router_queues_cross_replica_and_sheds_only_when_all_full(lut):
    router = _mk_router(lut, max_queue=1)
    reqs = [Request(tokens=[i + 2, i + 3], max_new_tokens=3)
            for i in range(3)]
    assert router.submit(reqs[0]) is router.engines[0]
    assert router.submit(reqs[1]) is router.engines[1]
    router.submit(reqs[2])
    assert reqs[2].finish_reason is FinishReason.LOAD_SHED
    router.run_until_idle()
    assert all(len(r.out_tokens) == 3 for r in reqs[:2])


def test_graceful_drain_and_undrain(lut):
    router = _mk_router(lut)
    first = [Request(tokens=[i + 2, i + 3], max_new_tokens=6)
             for i in range(2)]
    for r in first:
        router.submit(r)
    router.drain(0)
    assert router.health(0) is ReplicaHealth.DRAINING
    late = [Request(tokens=[i + 7, i + 8], max_new_tokens=4)
            for i in range(2)]
    assert all(router.submit(r) is router.engines[1] for r in late)
    router.run_until_idle()
    assert router.drained(0)
    assert all(r.done and r.out_tokens for r in first + late)
    router.undrain(0)
    assert router.health(0) is ReplicaHealth.HEALTHY
    assert router.submit(Request(tokens=[2], max_new_tokens=1)) \
        is router.engines[0]
    router.run_until_idle()


def _fault_free(lut, prompts, new):
    reqs = [Request(tokens=list(p), max_new_tokens=new) for p in prompts]
    _mk_router(lut).run(reqs)
    return reqs


def test_step_error_degrades_then_recovers_token_identical(lut):
    prompts = [[i + 2, i + 3] for i in range(2)]
    want = _fault_free(lut, prompts, 10)
    reqs = [Request(tokens=list(p), max_new_tokens=10) for p in prompts]
    router = _mk_router(lut)
    FaultInjector(FaultSchedule(
        [Fault(step=3, kind="step_error", replica=0)])).attach(router)
    router.run(reqs)
    assert router.status[0].total_failures == 1
    assert router.status[0].health is ReplicaHealth.HEALTHY
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]


def test_crash_recovery_never_sheds_recovered_requests(lut):
    prompts = [[i + 2, i + 3] for i in range(4)]
    want = _fault_free(lut, prompts, 8)
    reqs = [Request(tokens=list(p), max_new_tokens=8) for p in prompts]
    router = _mk_router(lut, max_queue=1)
    FaultInjector(FaultSchedule(
        [Fault(step=4, kind="crash", replica=1)])).attach(router)
    for r in reqs[:2]:
        router.submit(r)
    router.step()
    for r in reqs[2:]:
        router.submit(r)
    router.run_until_idle()
    assert router.status[1].recovered_requests > 0
    assert not any(r.shed for r in reqs)
    for got, w in zip(reqs, want):
        assert got.finish_reason is FinishReason.COMPLETED
        assert got.out_tokens == w.out_tokens


def _outcomes(router, reqs, inj):
    return {"requests": [(r.finish_reason.name, r.out_tokens, r.retries,
                          r.finish_step) for r in reqs],
            "health": [st.health.value for st in router.status],
            "recovered": [st.recovered_requests for st in router.status],
            "death": [st.death_reason is not None for st in router.status],
            "retried": router.retried_requests,
            "fired": inj.report()["events"]}


def _chaos(router, req_cls, inj_cls, schedule, prompts, new):
    reqs = [req_cls(tokens=list(p), max_new_tokens=new) for p in prompts]
    inj = inj_cls(schedule).attach(router)
    for r in reqs:
        router.submit(r)
    router.run_until_idle()
    return reqs, _outcomes(router, reqs, inj)


def test_chaos_canned_schedule_equals_jax_router(lut):
    """The acceptance scenario: a pool squeeze and a one-shot decode
    failure on replica 0, a stall window then a hard crash of replica 1
    mid-decode. Zero lost, greedy tokens equal a fault-free run, and
    every outcome equals the JAX router's under the same schedule."""
    prompts = [[i + 2, i + 3, i + 4] for i in range(6)]
    want = _fault_free(lut, prompts, 12)
    router = _mk_router(lut)
    reqs, got = _chaos(router, Request, FaultInjector,
                       FaultSchedule.canned(2), prompts, 12)
    _, jgot = _chaos(_mk_jrouter(lut), JRequest, JFaultInjector,
                     JFaultSchedule.canned(2), prompts, 12)
    assert got == jgot
    assert all(r.done and not r.shed for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 12 for r in reqs)
    assert router.status[1].health is ReplicaHealth.DEAD
    assert router.status[1].recovered_requests > 0
    assert any(r.retries > 0 for r in reqs)
    kinds = {e[1] for e in got["fired"]}
    assert {"pool_exhaust", "crash", "step_error", "slow"} <= kinds


def test_stall_watchdog_kills_replica_like_jax(lut):
    prompts = [[i + 2, i + 3] for i in range(4)]
    want = _fault_free(lut, prompts, 8)
    kw = dict(router_kw=dict(stall_steps=4, retry_backoff=1))
    sched = [Fault(step=2, kind="slow", replica=0, duration=40)]
    jsched = [JFault(step=2, kind="slow", replica=0, duration=40)]
    router = _mk_router(lut, **kw)
    reqs, got = _chaos(router, Request, FaultInjector, FaultSchedule(sched),
                       prompts, 8)
    _, jgot = _chaos(_mk_jrouter(lut, **kw), JRequest, JFaultInjector,
                     JFaultSchedule(jsched), prompts, 8)
    assert got == jgot
    assert router.status[0].health is ReplicaHealth.DEAD
    assert "stalled" in router.status[0].death_reason
    assert router.retried_requests > 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]
