"""The port's co-design models, search and cycle simulator
(``repro_torch.dse``, ``repro_torch.simulator``) against the JAX
package's: the same plain float arithmetic in the same order, so every
value must be equal exactly, at every grid point."""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.core import similarity as jsim  # noqa: E402
from repro.dse import models as jm, ppa as jppa, search as jsearch  # noqa
from repro.simulator import cycle_sim as jsim_cyc  # noqa: E402
from repro_torch.core import similarity as tsim  # noqa: E402
from repro_torch.dse import models as tm, ppa as tppa  # noqa: E402
from repro_torch.dse import search as tsearch  # noqa: E402
from repro_torch.simulator import cycle_sim as tsim_cyc  # noqa: E402

V_SPACE = (2, 3, 4, 6, 8, 9, 12, 16)
C_SPACE = (8, 16, 32, 64)
METRICS = ("l2", "l1", "chebyshev")
GEMMS = ((512, 768, 768), (1, 2560, 6912), (4096, 768, 3072))


@pytest.mark.parametrize("metric", METRICS)
def test_alpha_sim_equals_jax(metric):
    assert tsim.ALPHA_SIM[metric] == jsim.ALPHA_SIM[metric]
    assert tsim.ALPHA_SIM == jsim.ALPHA_SIM


def _point_pair(**kw):
    return jm.LutDlaPoint(**kw), tm.LutDlaPoint(**kw)


@pytest.mark.parametrize("v,c,metric",
                         list(itertools.product(V_SPACE, C_SPACE, METRICS)))
def test_models_equal_jax_at_grid_point(v, c, metric):
    for extra in ({}, {"n_ccu": 7, "n_imm": 5, "tile_n": 256,
                       "bits_lut": 4, "bits_out": 8}):
        jp, tp = _point_pair(v=v, c=c, metric=metric, **extra)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert tp.equivalent_bits == jp.equivalent_bits
        for m, k, n in GEMMS:
            assert tm.compute_model(m, k, n, tp) == \
                jm.compute_model(m, k, n, jp)
            assert tm.memory_model(m, k, n, tp) == \
                jm.memory_model(m, k, n, jp)
            for beta in (683.0, 64.0):
                assert tm.parallelism_model(m, k, n, tp, beta) == \
                    jm.parallelism_model(m, k, n, jp, beta)
            for order in jm.DataflowOrder:
                assert tm.dataflow_memory(
                    m, k, n, tp, tm.DataflowOrder(order.value)) == \
                    jm.dataflow_memory(m, k, n, jp, order)
            for arch in ("lutdla", "pqa"):
                assert tsim_cyc.simulate_gemm(m, k, n, tp, arch) == \
                    jsim_cyc.simulate_gemm(m, k, n, jp, arch)
            assert tsim_cyc.LutDlaSim(tp, banks=8, bw_gbs=1.0).gemm_cycles(
                m, k, n) == jsim_cyc.LutDlaSim(jp, banks=8,
                                               bw_gbs=1.0).gemm_cycles(m, k, n)
        for m_rows in (64, 256, 512):
            assert tm.imm_resources(v, c, tp.tile_n, m_rows, tp.bits_lut) == \
                jm.imm_resources(v, c, jp.tile_n, m_rows, jp.bits_lut)
            assert tppa.imm_cost(tp, m_rows) == jppa.imm_cost(jp, m_rows)
            assert dataclasses.asdict(tppa.design_ppa(tp, m_rows=m_rows)) == \
                dataclasses.asdict(jppa.design_ppa(jp, m_rows=m_rows))
        for prec in ("bf16", "fp32"):
            assert tppa.dpe_cost(v, metric, prec) == \
                jppa.dpe_cost(v, metric, prec)
            assert tppa.ccu_cost(tp, prec) == jppa.ccu_cost(jp, prec)
        d_t, d_j = tppa.design_ppa(tp), jppa.design_ppa(jp)
        assert (d_t.area_eff, d_t.power_eff) == (d_j.area_eff, d_j.power_eff)


def test_dataflow_orders_constants_and_tables_equal_jax():
    assert [(o.name, o.value) for o in tm.DataflowOrder] == \
        [(o.name, o.value) for o in jm.DataflowOrder]
    consts = [k for k in vars(jppa) if k.isupper() or k.startswith("_A")
              or k.startswith("_P")]
    assert consts
    for k in consts:
        assert getattr(tppa, k) == getattr(jppa, k), k
    assert tppa.PPA_TABLE == jppa.PPA_TABLE


@pytest.mark.parametrize("target", (7, 16, 28, 40))
def test_scale_to_node_equals_jax(target):
    for name, entry in jppa.PPA_TABLE.items():
        assert dataclasses.asdict(tppa.scale_to_node(entry, target)) == \
            dataclasses.asdict(jppa.scale_to_node(entry, target)), name


@pytest.mark.parametrize("kw", [{}, {"v_values": (3, 6, 9, 12),
                                     "c_values": (16, 256),
                                     "mkn": (64, 512, 4096)}],
                         ids=["default", "custom"])
def test_efficiency_curves_equal_jax(kw):
    assert tppa.efficiency_curves(**kw) == jppa.efficiency_curves(**kw)


@pytest.mark.parametrize("name", ["RESNET18_LAYERS", "BERT_BASE_LAYERS"])
def test_simulate_network_equals_jax(name):
    t_layers, j_layers = getattr(tsim_cyc, name), getattr(jsim_cyc, name)
    assert list(t_layers) == list(j_layers)
    for v, c, n_imm, bw in ((4, 16, 4, 25.6), (3, 32, 1, 2.0),
                            (8, 64, 8, 100.0)):
        jp, tp = _point_pair(v=v, c=c, n_imm=n_imm, tile_n=128)
        assert tsim_cyc.simulate_network(t_layers, tp, bw_gbs=bw) == \
            jsim_cyc.simulate_network(j_layers, jp, bw_gbs=bw)
        assert tsim_cyc.PqaSim(tp).gemm_cycles(*t_layers[0]) == \
            jsim_cyc.PqaSim(jp).gemm_cycles(*j_layers[0])


def _proxy(pt):
    base = 1.0 - 0.055 * pt.v + 0.012 * min(pt.c, 48) ** 0.5 * pt.v ** 0.25
    return base - {"l2": 0.0, "l1": 0.01, "chebyshev": 0.02}[pt.metric]


@pytest.mark.parametrize("case", ["default", "tight", "proxy", "large-k"])
def test_co_design_search_equals_jax(case):
    kw = {"default": {}, "tight": {"max_area_mm2": 0.9,
                                   "max_power_mw": 240.0},
          "proxy": {"max_mem_ratio": 8.0, "min_accuracy": 0.9},
          "large-k": {"k": 4096, "n": 4096, "max_area_mm2": 2.0}}[case]
    acc = _proxy if case == "proxy" else None
    t_best, t_stats = tsearch.co_design_search(
        tsearch.SearchConstraints(**kw), accuracy_fn=acc)
    j_best, j_stats = jsearch.co_design_search(
        jsearch.SearchConstraints(**kw), accuracy_fn=acc)
    assert t_stats == j_stats
    assert (t_best is None) == (j_best is None)
    assert j_best is not None            # every case finds a design
    assert dataclasses.asdict(t_best.point) == \
        dataclasses.asdict(j_best.point)
    assert (t_best.omega, t_best.bound, t_best.area_mm2, t_best.power_mw,
            t_best.accuracy, t_best.history) == \
        (j_best.omega, j_best.bound, j_best.area_mm2, j_best.power_mw,
         j_best.accuracy, j_best.history)
