"""Port parity for the launch layer (``repro_torch.launch``): the H100
roofline, the op cost of a program run on meta tensors, the one-rank
cost runner, the dry run's input specs and cells, against the JAX
package's ``repro.launch`` on the CPU.

Covered: ``model_flops_for`` / ``model_bytes_for`` equal to the JAX
functions for every smoke config and step kind; ``RooflineReport``'s
terms, bottleneck and roofline fraction on hand-set numbers at the H100
constants; the specs' param, optimizer, batch and cache trees equal to
``jax.eval_shape`` of the JAX specs leaf for leaf (path, shape, dtype;
the port's block leaves without the stacked layer axis), for every
family (the ssm and hybrid caches, the port's slot state, by bytes
only: the hybrid's slot-dense attention cache has one trash row more a
slot); ``program_cost`` of seven chained matmuls (the FLOPs the JAX
``hlo_cost`` test asserts for its scan); the row-parallel program of the
JAX ``test_hlo_cost_counts_loop_collectives`` through the one-rank
``CostRunner`` and, per rank, through the full ``RankRunner``; the
kernel entry points on meta tensors (record their work under an OpCost,
raise outside one, never run a plain version; B2s and B2a, the head_dim
layout's decode, too); ``run_cell`` on a (2, 2) meta mesh for every
smoke config and shape (vlm and audio ``ok`` since they run under a
model axis); one dense cell's per-device FLOPs
against the JAX ``run_cell`` on four host devices (a subprocess); an
in-place indexed write (a paged decode step's pool writes, and each
kind of write at indices) counted by the values, indices and rows it
moves.

Tolerances: exact for the formulas, the specs, the counts and the
bytes; the roofline terms at 1e-12 relative; the dense cell's FLOPs
within 2% of the JAX count (the port counts the matmuls of its eager
program, the JAX package the dots of the partitioned HLO).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import run_in_devices  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops, ref, work  # noqa: E402
from repro_torch.launch import dryrun, roofline as trl  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.launch.op_cost import OpCost, program_cost  # noqa: E402
from repro_torch.parallel.collectives import CostRunner, RankRunner  # noqa
from repro_torch.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.train.trainer import TrainConfig  # noqa: E402

ARCHS = tconfigs.ARCH_NAMES
KINDS = ("train", "prefill", "decode")
#: the JAX dense cell's per-device FLOPs against the port's
CELL_FLOPS_TOL = 0.02


def _smoke_overrides(arch):
    """Every field of ``arch``'s smoke config: ``run_cell``'s overrides
    that make its cell the smoke model's."""
    smoke = tconfigs.get_smoke_config(arch)
    return {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(smoke) if f.name != "name"}


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_equal_jax(arch):
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    assert ct.active_param_count() == cj.active_param_count()
    for kind in KINDS:
        for b, s in ((4, 16), (128, 32768)):
            assert trl.model_flops_for(ct, kind, b, s) == \
                jrl.model_flops_for(cj, kind, b, s)
            assert trl.model_bytes_for(ct, kind, b, s, 1234.0, 56.0) == \
                jrl.model_bytes_for(cj, kind, b, s, 1234.0, 56.0)


def test_roofline_report_terms_and_bottleneck_at_h100_peaks():
    rep = trl.RooflineReport(
        flops=989e12, core_ops=67e12 * 0.5, bytes_accessed=3.35e12 * 2,
        coll_bytes={"all-reduce": int(25e9 * 18 * 0.25), "count": 3},
        chips=4, model_flops=4 * 989e12 * 0.25, model_bytes=0.0)
    assert rep.t_compute == pytest.approx(1.5, rel=1e-12)
    assert rep.t_memory == pytest.approx(2.0, rel=1e-12)
    assert rep.t_collective == pytest.approx(0.25, rel=1e-12)
    assert rep.bottleneck == "memory"
    assert rep.t_ideal == pytest.approx(0.25, rel=1e-12)
    assert rep.roofline_fraction == pytest.approx(0.25 / 2.0, rel=1e-12)
    d = rep.to_dict()
    assert d["bottleneck"] == "memory" and d["core_ops_per_device"] == \
        67e12 * 0.5
    assert set(jrl.RooflineReport(1.0, 1.0, {}, 1).to_dict()) <= set(d)
    rep.core_ops = 67e12 * 2
    assert rep.bottleneck == "compute"


# ---------------------------------------------------------------- specs
def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    """The port's leaves under the JAX paths: the block list's entries
    stacked (each must have the same shape), ints as JAX int32 scalars."""
    out, blocks = {}, {}
    for path, leaf in tree_flatten_with_path(tree):
        if torch.is_tensor(leaf):
            info = (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
        else:
            info = ((), "int32")
        if "['blocks'][" in path:
            head, rest = path.split("['blocks'][", 1)
            key = head + "['blocks']" + rest.split("]", 1)[1]
            blocks.setdefault(key, []).append(info)
        else:
            out[path] = info
    for key, infos in blocks.items():
        assert len(set(infos)) == 1, key
        out[key] = ((len(infos),) + infos[0][0], infos[0][1])
    return out


def _qcs(kind):
    q = dryrun.quant_config("lut", kind)
    j = JQC(mode=q.mode, v=q.v, c=q.c, metric=q.metric,
            lut_dtype=q.lut_dtype, impl="ref")
    return q, j


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_eval_shape_leaf_for_leaf(arch):
    cj, ct = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jm, tm = JModel(cj), tspecs.meta_model(ct)
    train = jspecs.ShapeCase("train", 16, 4)
    qt, qj = _qcs("train")
    p_j, o_j, b_j, _ = jspecs.train_input_specs(jm, qj, train,
                                                JTrainConfig())
    p_t, o_t, b_t, step = tspecs.train_input_specs(
        tm, qt, tspecs.ShapeCase("train", 16, 4), TrainConfig())
    assert _port_leaves(p_t) == _jax_leaves(p_j)
    assert _port_leaves(o_t) == _jax_leaves(o_j)
    assert _port_leaves(b_t) == _jax_leaves(b_j)
    assert step == 0
    for kind in ("prefill", "decode"):
        qt, qj = _qcs(kind)
        case_j = jspecs.ShapeCase(kind, 32, 4)
        case_t = tspecs.ShapeCase(kind, 32, 4)
        s_j = jspecs.serve_input_specs(jm, qj, case_j)
        s_t = tspecs.serve_input_specs(tm, qt, case_t)
        assert _port_leaves(s_t[0]) == _jax_leaves(s_j[0])    # params
        assert _port_leaves(s_t[1]) == _jax_leaves(s_j[1])    # inputs
        cache_j, cache_t = _jax_leaves(s_j[2]), _port_leaves(s_t[2])
        if ct.family in ("ssm", "hybrid"):
            # the port's slot state: the JAX cache's conv / h leaves (and
            # the hybrid's attention cache, one trash row more a slot),
            # under other paths: compared by bytes
            def nbytes(leaves):
                return sum(int(np.prod(s)) * np.dtype(
                    jnp.dtype(d)).itemsize for s, d in leaves.values())
            trash = 0
            if ct.family == "hybrid":
                n_inv = tm.num_attn_slots
                trash = 2 * n_inv * 4 * ct.num_kv_heads * ct.head_dim * \
                    jnp.dtype(ct.dtype).itemsize
            assert nbytes(cache_t) == nbytes(
                {k: v for k, v in cache_j.items() if "pos" not in k}) + trash
        else:
            assert cache_t == cache_j        # pos: an int, JAX's int32 ()


# ---------------------------------------------------------------- op cost
def test_program_cost_of_chained_matmuls():
    a = torch.empty((64, 32), device="meta")
    ws = torch.empty((7, 32, 32), device="meta")

    def g(x, w):
        for i in range(7):
            x = torch.tanh(x @ w[i])
        return x
    cost = program_cost(g, a, ws)
    assert cost.flops == 7 * 2 * 64 * 32 * 32
    assert tuple(cost.result.shape) == (64, 32) and cost.result.is_meta
    # mm reads x and w and writes its product; tanh reads and writes it
    assert cost.bytes == 7 * 4 * (4 * 64 * 32 + 32 * 32)
    top = cost.top_cost_lines(1, by="flops")[0]
    assert top["op"] == "mm" and top["count"] == 7
    assert top["site"].endswith(".g")


def test_peak_temp_bytes_counts_only_storages_the_call_makes():
    """A view of a tensor made before the call and an in-place op add
    nothing; a product held while the next is made counts twice."""
    big = torch.empty((1000,), device="meta")
    with OpCost() as cost:
        view = big[:10]
        for _ in range(3):
            y = big * 2                     # 4000 B; the last one released
        big.add_(1)
    assert cost.peak_temp_bytes == 8000
    assert cost.live_temp_bytes == 4000 and tuple(view.shape) == (10,)
    del y
    assert cost.live_temp_bytes == 0


def test_indexed_write_counts_the_rows_it_moves():
    """A smoke paged decode step's pool writes (``kv[key][li, tgt, off] =
    rows``, an ``index_put_``) count the values and the two index tensors
    read and the rows written, by hand; never the pool they write into
    (24 KB a layer here, 32 times a step's rows)."""
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    model = tspecs.meta_model(cfg)
    b, pages, ps = 3, 11, 8
    qc = TQC(mode="dense")
    params = model.init(None, qc)
    kv = model.init_paged_cache(32, ps, pages, device="meta")
    table = torch.zeros((b, 4), dtype=torch.int32, device="meta")
    toks = torch.zeros((b, 1), dtype=torch.int32, device="meta")
    positions = torch.zeros((b,), dtype=torch.int32, device="meta")
    with torch.no_grad():
        cost = program_cost(model.decode_paged, params, toks, kv, table,
                            positions, qc)
    lines = [r for r in cost.top_cost_lines(1000)
             if r["op"] == "index_put_"]
    assert len(lines) == 1 and lines[0]["count"] == 2 * cfg.num_layers
    rows = b * cfg.num_kv_heads * cfg.head_dim * 4      # float32 rows
    indices = 2 * b * 8                                 # tgt, off: int64
    assert lines[0]["bytes"] == 2 * cfg.num_layers * (2 * rows + indices)


def _ix(*vals):
    return torch.tensor(vals, dtype=torch.int64)


#: (an in-place indexed write of x (10, 6, 4) float32, its bytes by hand:
#: operands read but x, then the rows written, twice where it adds)
INDEXED_WRITES = {
    "index_copy_": (lambda x: x.index_copy_(0, _ix(1, 7),
                                            torch.ones(2, 6, 4)),
                    16 + 192 + 192),
    "index_add_": (lambda x: x.index_add_(0, _ix(1, 7), torch.ones(2, 6, 4)),
                   16 + 192 + 2 * 192),
    "scatter_": (lambda x: x.scatter_(0, torch.zeros(1, 6, 4,
                                                     dtype=torch.int64),
                                      torch.ones(1, 6, 4)),
                 192 + 96 + 96),
    "scatter_add_": (lambda x: x.scatter_add_(
        0, torch.zeros(1, 6, 4, dtype=torch.int64), torch.ones(1, 6, 4)),
        192 + 96 + 2 * 96),
    "index_fill_": (lambda x: x.index_fill_(1, _ix(0, 2, 5), 3.0),
                    24 + 3 * 10 * 4 * 4),
    "index_put_ accumulate": (lambda x: x.index_put_(
        (_ix(4),), torch.ones(6, 4), accumulate=True), 8 + 96 + 2 * 96),
    "index_put_ past a slice": (lambda x: x.__setitem__(
        (slice(None), _ix(0, 3)), torch.ones(10, 2, 4)),
        16 + 320 + 320),
}


@pytest.mark.parametrize("name", list(INDEXED_WRITES))
def test_indexed_write_kinds_count_what_they_move(name):
    """Each in-place write at indices counts its other operands and the
    rows it writes (read too where it accumulates), not the 960 bytes of
    the tensor it writes into."""
    fn, want = INDEXED_WRITES[name]
    x = torch.zeros(10, 6, 4)
    with OpCost() as cost:
        fn(x)
    assert cost.bytes == want


def _row_parallel(tp, x, ws):
    """The JAX test's scan of 6 sharded layers: x (128, 512) and ws (6,
    512, 512) cut over ``model`` on dims -1 and 1, each layer's product
    all-reduced."""
    c, w = tp.shard(x, -1), tp.shard(ws, 1)
    for i in range(6):
        c = tp.shard(torch.tanh(tp.all_reduce(c @ w[i])), -1)
    return c


@pytest.mark.parametrize("runner", ["cost", "full"])
def test_row_parallel_collectives_one_rank_and_every_rank(runner):
    mesh = make_test_mesh((4,), ("model",), device="cpu")
    x = torch.randn(128, 512, generator=torch.Generator().manual_seed(0))
    ws = torch.randn(6, 512, 512, generator=torch.Generator().manual_seed(1))
    if runner == "cost":
        run = CostRunner(mesh)
        x, ws = x.to("meta"), ws.to("meta")
    else:
        run = RankRunner(mesh=mesh)
    cost = program_cost(run.run, lambda tp: _row_parallel(tp, x, ws))
    ranks = len(run.ranks)
    assert cost.coll_count == 6 * ranks
    assert set(cost.coll) == {"all-reduce"}
    assert len(cost.coll_by_rank) == ranks
    for kinds in cost.coll_by_rank.values():
        assert dict(kinds) == {"all-reduce": 6 * 128 * 512 * 4}
    assert cost.flops == ranks * 6 * 2 * 128 * 128 * 512
    assert run.collectives == 6


def test_cost_runner_records_the_backward_collectives():
    mesh = make_test_mesh((2, 4), device="meta")
    run = CostRunner(mesh)
    x = torch.empty((8, 16), device="meta", requires_grad=True)

    def fwd(tp):
        y = tp.all_gather(x, -1)                 # (8, 64)
        return tp.data.all_reduce(y).sum()
    with OpCost() as cost:
        loss = run.run(fwd)[0]
        loss.backward()
    assert dict(cost.coll) == {"all-gather": 8 * 16 * 4,
                               "all-reduce": 2 * 8 * 64 * 4,
                               "reduce-scatter": 8 * 64 * 4}
    assert cost.coll_count == 4 and tuple(x.grad.shape) == (8, 16)


def _meta_operands():
    m = torch.device("meta")
    x = torch.empty((8, 32, 8), device=m)
    z = torch.empty((32, 16, 8), device=m)
    lut = torch.empty((32, 16, 64), dtype=torch.int8, device=m)
    scale = torch.empty((64,), device=m)
    idx = torch.empty((8, 32), dtype=torch.int32, device=m)
    q = torch.empty((2, 1, 4, 16), device=m)
    pages = torch.empty((9, 4, 2, 16), device=m)
    new = torch.empty((2, 1, 2, 16), device=m)
    phys = torch.empty((2, 4), dtype=torch.int32, device=m)
    pos = torch.empty((2,), dtype=torch.int32, device=m)
    codes = torch.empty((9, 4, 2, 4), dtype=torch.uint8, device=m)
    book = {"zk": torch.empty((4, 16, 4), device=m),
            "zv": torch.empty((4, 16, 4), device=m),
            "sk": torch.empty((2,), device=m),
            "sv": torch.empty((2,), device=m)}
    return x, z, lut, scale, idx, q, pages, new, phys, pos, codes, book


def test_kernel_entry_points_on_meta_record_their_work_or_raise():
    (x, z, lut, scale, idx, q, pages, new, phys, pos, codes,
     book) = _meta_operands()
    calls = {
        "b1": lambda: ops.vq_amm(x, z, lut, scale),
        "b3": lambda: ops.vq_assign(x, z),
        "b4": lambda: ops.lut_matmul(idx, lut, scale),
        "b2": lambda: tfd.flash_decode_paged(q, pages, pages, new, new,
                                             phys, pos),
        "b5": lambda: tfd.flash_decode_paged(q, codes, codes, new, new,
                                             phys, pos, codebook=book),
    }
    works = {"b1": work.vq_amm(x, z, lut, scale),
             "b3": work.vq_assign(x, z),
             "b4": work.lut_gemm(idx, lut, scale),
             "b2": work.flash_decode(q, pages, new, phys),
             "b5": work.flash_decode(q, codes, new, phys, codebook=book)}
    shapes = {"b1": (8, 64), "b3": (8, 32), "b4": (8, 64), "b2": (2, 1, 64),
              "b5": (2, 1, 64)}
    plain = (ref.vq_amm_ref.calls, ref.assign_ref.calls,
             ref.lut_gemm_onehot.calls, tfd.flash_decode_paged_plain.calls,
             tfd.flash_decode_paged_kvq_plain.calls)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="outside an OpCost"):
            call()
        cost = program_cost(call)
        assert tuple(cost.result.shape) == shapes[name]
        assert cost.result.is_meta
        assert dict(cost.kernels) == {name: 1}
        assert (cost.bytes, cost.core_ops) == works[name]
        assert cost.flops == 0
    assert plain == (ref.vq_amm_ref.calls, ref.assign_ref.calls,
                     ref.lut_gemm_onehot.calls,
                     tfd.flash_decode_paged_plain.calls,
                     tfd.flash_decode_paged_kvq_plain.calls)


def test_head_dim_decode_kernels_on_meta_record_their_work():
    """B2s and B2a (the head_dim layout's decode) on meta tensors: under an
    OpCost an empty result of the kernel's shape and its
    ``kernels.work`` entry, nothing of the plain version; outside one a
    raise. On the CPU the plain versions run, recording the same work."""
    (_, _, _, _, _, q, pages, new, phys, pos, _, _) = _meta_operands()
    sc = torch.empty((2, 4, 4 * 4 + 1), device="meta")
    calls = {
        "b2s": (lambda q, pages, new, phys, pos, sc:
                tfd.flash_decode_hd_scores(q, pages, new, phys, pos,
                                           window=3)),
        "b2a": (lambda q, pages, new, phys, pos, sc:
                tfd.flash_decode_hd_attend(sc, pages, new, phys, pos, 0.25,
                                           torch.bfloat16)),
    }
    works = {"b2s": work.flash_decode_hd_scores(q, pages, phys),
             "b2a": work.flash_decode_hd_attend(sc, pages, phys,
                                                torch.bfloat16)}
    shapes = {"b2s": (2, 4, 17), "b2a": (2, 1, 4, 16)}
    plain = (tfd.flash_decode_hd_scores_plain.calls,
             tfd.flash_decode_hd_attend_plain.calls)
    args = (q, pages, new, phys, pos, sc)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="outside an OpCost"):
            call(*args)
        cost = program_cost(call, *args)
        assert tuple(cost.result.shape) == shapes[name]
        assert cost.result.is_meta
        assert dict(cost.kernels) == {name: 1}
        assert (cost.bytes, cost.core_ops) == works[name]
    assert plain == (tfd.flash_decode_hd_scores_plain.calls,
                     tfd.flash_decode_hd_attend_plain.calls)
    g = torch.Generator().manual_seed(1)
    cpu = [torch.randn(t.shape, generator=g) if t.is_floating_point()
           else torch.zeros(t.shape, dtype=t.dtype) for t in args]
    cpu[4] = torch.tensor([5, -1], dtype=torch.int32)
    for name, call in calls.items():
        cost = program_cost(call, *cpu)
        assert (cost.bytes, cost.core_ops) == works[name]
        assert tuple(cost.result.shape) == shapes[name]
    assert (tfd.flash_decode_hd_scores_plain.calls,
            tfd.flash_decode_hd_attend_plain.calls) == (plain[0] + 1,
                                                         plain[1] + 1)


def test_kernel_work_on_the_cpu_equals_meta_and_the_plain_version_runs():
    """A CPU call under an OpCost records the same work as the meta call
    and counts none of the plain version's ops."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 32, 8), generator=g)
    z = torch.randn((32, 16, 8), generator=g)
    lut = torch.randint(-127, 128, (32, 16, 64), dtype=torch.int8,
                        generator=g)
    scale = torch.rand((64,), generator=g)
    cpu = program_cost(ops.vq_amm, x, z, lut, scale)
    meta = program_cost(ops.vq_amm, *(t.to("meta") for t in (x, z, lut,
                                                             scale)))
    assert (cpu.bytes, cpu.core_ops, cpu.flops) == \
        (meta.bytes, meta.core_ops, meta.flops)
    torch.testing.assert_close(cpu.result, ref.vq_amm_ref(x, z, lut, scale))
    rows = work.selected_rows(ref.assign_ref(x, z), 16)
    assert rows <= 32 * 8
    assert work.vq_amm(x, z, lut, scale, rows=rows)[0] <= cpu.bytes


# ---------------------------------------------------------------- cells
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_on_a_small_mesh(arch):
    mesh = make_test_mesh((2, 2), device="meta")
    over = _smoke_overrides(arch)
    family = over["family"]
    for shape in tspecs.SHAPES:
        res = dryrun.run_cell(arch, shape, mesh, verbose=False,
                              cfg_overrides=over)
        runnable, _ = tspecs.cell_is_runnable(tconfigs.get_config(arch),
                                              shape)
        if not runnable:
            assert res["status"] == "skipped"
        else:              # every family, vlm and audio included
            assert res["status"] == "ok", (shape, res)
            rl = res["roofline"]
            assert res["chips"] == 4 and res["mesh"] == "2x2"
            assert rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0
            assert rl["collective_bytes_per_device"] > 0
            assert rl["bottleneck"] in ("compute", "memory", "collective")
            mem = res["memory"]
            assert mem["argument_size_in_bytes"] > 0
            assert mem["temp_size_in_bytes"] > 0
            if tspecs.SHAPES[shape].kind != "train":
                assert sum(res["kernels"].values()) > 0   # B1 a projection
            json.dumps(res)


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(True)
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert {str(d) for d in multi.devices.flat} == {"meta"}
    assert CostRunner(multi).handles[0].data.size == 32


def test_dense_cell_flops_match_the_jax_dry_run():
    """qwen1.5-4b cut to its smoke config, decode_32k, dense, on a (2, 2)
    mesh: the port's rank-0 FLOPs against the JAX package's per-device
    HLO FLOPs (four host devices, a subprocess)."""
    over = _smoke_overrides("qwen1.5-4b")
    out = run_in_devices(f"""
import json
from repro.launch.dryrun import run_cell
from repro.launch.mesh import make_test_mesh
res = run_cell("qwen1.5-4b", "decode_32k", make_test_mesh((2, 2)), "dense",
               verbose=False, cfg_overrides={over!r})
print("CELL", json.dumps(res["roofline"]))
""", n_devices=4, timeout=900)
    want = json.loads(out.split("CELL ", 1)[1])["flops_per_device"]
    res = dryrun.run_cell("qwen1.5-4b", "decode_32k",
                          make_test_mesh((2, 2), device="meta"), "dense",
                          verbose=False, cfg_overrides=over)
    got = res["roofline"]["flops_per_device"]
    assert abs(got - want) <= CELL_FLOPS_TOL * want, (got, want)
