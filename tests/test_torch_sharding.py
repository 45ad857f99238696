"""Port parity for the sharding rules and the mesh (``parallel/sharding.py``,
``launch/mesh.py``) against the JAX package, on the CPU.

Covered: ``param_pspecs`` leaf for leaf for all ten smoke configs at model
axes of 2, 4 and 16, in dense and int8 lut_infer form (the JAX leaf
shapes from ``jax.eval_shape``, so no JAX model is initialised; the
port's block leaves have no layer axis, so their specs are the JAX ones
without its leading entry); the one run-time departure, the Mamba2
``in_proj`` / conv layout (``serving_layout``), checked by which logical
columns each rank holds; ``paged_cache_pspecs`` (fp and quantized),
``cache_pspecs`` and ``batch_pspecs`` equal to the JAX ones (the JAX
functions read only ``mesh.shape``, so they take the port's mesh);
``shard_tree`` -> ``unshard_tree`` bit for bit on params of every dtype
and on pools; ``replica_submeshes``' groups and errors.

Tolerance: specs and round trips exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.core.kv_codebook import KVCodebook  # noqa: E402
from repro_torch.launch.mesh import (Mesh, data_axes,  # noqa: E402
                                     make_test_mesh, replica_submeshes)
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ARCHS = jconfigs.ARCH_NAMES if hasattr(jconfigs, "ARCH_NAMES") else \
    tconfigs.ARCH_NAMES
SIZES = [2, 4, 16]


def _jax_leaves(arch, lut):
    """(keystr, shape) of every JAX param leaf of ``arch``'s smoke model,
    dense or in int8 lut_infer form, from abstract shapes only."""
    jm = JModel(jconfigs.get_smoke_config(arch))
    if lut:
        fn = lambda k: precompute_model(                    # noqa: E731
            jm.init(k, JQC(mode="lut_train")),
            JQC(mode="lut_infer", lut_dtype="int8"))
    else:
        fn = lambda k: jm.init(k, JQC(mode="dense"))        # noqa: E731
    shapes = jax.eval_shape(fn, jax.random.PRNGKey(0))
    return [(jax.tree_util.keystr(p), tuple(l.shape))
            for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _port_path(path):
    """The port's path of a JAX leaf: block leaves gain the layer index."""
    if path.startswith("['blocks']"):
        return "['blocks'][0]" + path[len("['blocks']"):]
    return path


def _spec_leaves(specs):
    """(path, spec) of a port spec tree (a spec is a leaf, not a tuple to
    walk)."""
    out = []

    def walk(t, path):
        if isinstance(t, (tsh.P, tsh.Columns)):
            out.append((path, t))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
    walk(specs, "")
    return out


@pytest.fixture(scope="module", params=["dense", "lut"])
def leaves(request):
    return request.param, {arch: _jax_leaves(arch, request.param == "lut")
                           for arch in ARCHS}


@pytest.mark.parametrize("msize", SIZES)
def test_param_pspecs_equal_jax_leaf_for_leaf(leaves, msize):
    """Every JAX leaf's spec, from the JAX rule on its stacked shape and
    from the port's rule on the port's path and per-layer shape; then the
    port's own ``param_pspecs`` over the port's init, whose every leaf
    must be one of the JAX leaves with the same spec."""
    mode, by_arch = leaves
    qc = TQC(mode="dense") if mode == "dense" else \
        TQC(mode="lut_infer", lut_dtype="int8")
    for arch in ARCHS:
        cfg_j = jconfigs.get_smoke_config(arch)
        cfg_t = tconfigs.get_smoke_config(arch)
        want = {}
        for path, shape in by_arch[arch]:
            spec_j = tuple(jsh._spec_for_leaf(path, shape, cfg_j, "model",
                                              msize))
            blocks = path.startswith("['blocks']")
            port_shape = shape[1:] if blocks else shape
            if blocks:
                assert spec_j[:1] in ((), (None,)), (arch, path, spec_j)
                spec_j = spec_j[1:]
            spec_t = tsh._spec_for_leaf(_port_path(path), port_shape,
                                        cfg_t, "model", msize)
            assert tuple(spec_t) == spec_j, (arch, path, msize)
            want[_port_path(path)] = spec_j
        params = TModel(cfg_t, device="cpu").init(
            torch.Generator().manual_seed(0), qc)
        got = _spec_leaves(tsh.param_pspecs(params, cfg_t,
                                            model_axis_size=msize))
        assert len(got) == len(tree_flatten_with_path(params))
        for path, spec in got:
            key = path if not path.startswith("['blocks']") else \
                "['blocks'][0]" + path.split("]", 2)[2]
            assert key in want, (arch, path)
            assert tuple(spec) == want[key], (arch, path, msize)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
@pytest.mark.parametrize("msize", [2, 4])
def test_mamba_in_proj_layout_is_the_one_departure(arch, msize):
    """``serving_layout`` equals ``param_pspecs`` except at a Mamba2
    block's in_proj (w, lut, lut_scale) and conv_w / conv_b, where rank r
    holds its z, x and dt columns and the whole B and C (the JAX rule
    would give it the contiguous r-th N / msize columns)."""
    cfg = tconfigs.get_smoke_config(arch)
    qc = TQC(mode="lut_infer", lut_dtype="int8")
    params = TModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0), qc)
    rule = dict(_spec_leaves(tsh.param_pspecs(params, cfg,
                                              model_axis_size=msize)))
    layout = dict(_spec_leaves(tsh.serving_layout(params, cfg, msize)))
    differ = sorted(p for p in rule if rule[p] != layout[p])
    names = {p.split("]", 2)[2] for p in differ}
    assert names == {"['in_proj']['lut']", "['in_proj']['lut_scale']",
                     "['conv_w']", "['conv_b']"}, names
    assert len(differ) == 4 * cfg.num_layers
    din, gn, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    n = 2 * din + 2 * gn + h
    mesh = make_test_mesh((1, msize), device="cpu")
    label = torch.arange(n, dtype=torch.float32)
    specs = tsh.serving_layout(params, cfg, msize)
    in_spec = specs["blocks"][0]["in_proj"]["lut_scale"]
    conv_spec = specs["blocks"][0]["conv_b"]
    ranks = tsh.shard_tree(label, in_spec, mesh)
    conv = tsh.shard_tree(torch.arange(din + 2 * gn, dtype=torch.float32),
                          conv_spec, mesh)
    dl, hl = din // msize, h // msize
    for r in range(msize):
        z = list(range(r * dl, (r + 1) * dl))
        want = (z + [din + i for i in z]
                + list(range(2 * din, 2 * din + 2 * gn))
                + list(range(2 * din + 2 * gn + r * hl,
                             2 * din + 2 * gn + (r + 1) * hl)))
        assert ranks[r].long().tolist() == want
        assert conv[r].long().tolist() == z + list(range(din, din + 2 * gn))
    # the JAX rule for the leaf this layout replaces: contiguous columns
    assert tuple(jsh._spec_for_leaf("['blocks']['in_proj']['lut']",
                                    (cfg.num_layers, 1, 1, n), cfg,
                                    "model", msize)) == \
        (None, None, None, "model" if n % msize == 0 else None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (4, 16)])
def test_cache_and_batch_pspecs_equal_jax(arch, shape):
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg_t = tconfigs.get_smoke_config(arch)
    mesh = Mesh(np.full(shape, torch.device("cpu"), dtype=object),
                ("data", "model"))

    def tup(tree):
        if isinstance(tree, dict):
            return {k: tup(v) for k, v in tree.items()}
        return tuple(tree)
    for q in (False, True):
        assert tup(tsh.paged_cache_pspecs(cfg_t, mesh, quantized=q)) == \
            tup(jsh.paged_cache_pspecs(cfg_j, mesh, quantized=q))
    for b in (1, 2, 8):
        assert tup(tsh.cache_pspecs(cfg_t, b, mesh)) == \
            tup(jsh.cache_pspecs(cfg_j, b, mesh))
    for da in (("data",), ("pod", "data")):
        assert tup(tsh.batch_pspecs(cfg_t, da)) == \
            tup(jsh.batch_pspecs(cfg_j, da))
    assert tsh._kv_model_axes(cfg_t, "model", shape[1]) == \
        jsh._kv_model_axes(cfg_j, "model", shape[1])


def _equal_trees(a, b):
    la, lb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y), p


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "zamba2-1.2b",
                                  "dbrx-132b"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_shard_then_unshard_round_trips(arch, shape):
    """Params in bf16 with int8 LUTs (and in dense float32), and the pool
    or slot state, cut by the serving layout and put back: bit for bit;
    each shard lies on its rank's device and is contiguous; a replicated
    leaf is shared, not copied."""
    cfg = tconfigs.get_smoke_config(arch).replace(dtype="bfloat16")
    msize = shape[1]
    mesh = make_test_mesh(shape, device="cpu")
    m = TModel(cfg, device="cpu")
    for qc in (TQC(mode="lut_infer", lut_dtype="int8"), TQC(mode="dense")):
        params = m.init(torch.Generator().manual_seed(1), qc)
        specs = tsh.serving_layout(params, cfg, msize)
        shards = tsh.shard_tree(params, specs, mesh)
        assert len(shards) == mesh.size
        for sh in shards:
            assert all(t.is_contiguous() for t in
                       (x for _, x in tree_flatten_with_path(sh)))
        assert shards[0]["final_norm"] is params["final_norm"]
        _equal_trees(params, tsh.unshard_tree(shards, specs, mesh))
    pool = m.init_paged_cache(16, 8, 3, num_slots=2)
    for _, t in tree_flatten_with_path(pool):
        t.copy_(torch.randn(t.shape, generator=torch.Generator()
                            .manual_seed(2)).to(t.dtype))
    lay = tsh.serving_cache_layout(cfg, mesh)
    _equal_trees(pool, tsh.unshard_tree(tsh.shard_tree(pool, lay, mesh),
                                        lay, mesh))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_meta_leaves_shard_into_zeros_on_each_device(arch):
    """A pool given on the meta device (its shapes alone) is cut into
    zeroed shards on each rank's device: the shapes and dtypes of the
    shards of the real pool."""
    cfg = tconfigs.get_smoke_config(arch)
    m = TModel(cfg, device="cpu")
    mesh = make_test_mesh((1, 2), device="cpu")
    lay = tsh.serving_cache_layout(cfg, mesh)
    got = tsh.shard_tree(m.init_paged_cache(16, 8, 3, num_slots=2,
                                            device="meta"), lay, mesh)
    want = tsh.shard_tree(m.init_paged_cache(16, 8, 3, num_slots=2), lay,
                          mesh)
    for g, w in zip(got, want):
        _equal_trees(w, g)
        assert all(t.device.type == "cpu" and t.is_contiguous()
                   for _, t in tree_flatten_with_path(g))


def test_code_pool_shards_by_kv_head_and_keeps_the_codebook_whole():
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    m = TModel(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(cfg.num_layers, 64, cfg.num_kv_heads, cfg.head_dim,
                       generator=g)
    cb = KVCodebook.fit(rows, rows * 0.5, v=4, c=16, generator=g)
    pool = m.init_paged_cache(16, 8, 3, codebook=cb)
    mesh = make_test_mesh((1, 2), device="cpu")
    lay = tsh.serving_cache_layout(cfg, mesh, quantized=True)
    shards = tsh.shard_tree(pool, lay, mesh)
    for r, sh in enumerate(shards):
        assert sh["k"].shape == pool["k"].shape[:3] + (
            cfg.num_kv_heads // 2, pool["k"].shape[4])
        assert sh["k"].dtype == torch.uint8
        for key, leaf in pool["codebook"].items():
            assert sh["codebook"][key] is leaf
    _equal_trees(pool, tsh.unshard_tree(shards, lay, mesh))


@pytest.mark.parametrize("shape,axes,groups", [
    ((2, 2), ("data", "model"), 2),
    ((1, 4), ("data", "model"), 1),
    ((2, 2, 2), ("pod", "data", "model"), 4),
    ((4, 1), ("data", "model"), 4),
])
def test_replica_submeshes_groups(shape, axes, groups):
    mesh = make_test_mesh(shape, axes, device="cpu")
    subs = replica_submeshes(mesh)
    assert len(subs) == groups
    for s in subs:
        assert s.axis_names == ("data", "model")
        assert tuple(s.shape.values()) == (1, shape[-1])
    flat = [d for s in subs for d in s.devices.flat]
    assert flat == list(mesh.devices.flat)
    assert data_axes(mesh) == tuple(a for a in axes
                                    if a in ("pod", "data"))


def test_replica_submeshes_errors_and_one_device_match_jax():
    """The errors of a mesh without a ``model`` axis or with a
    non-trailing one are the JAX function's (it reads ``axis_names``
    before it builds a mesh); a (1, 1) mesh over the one JAX CPU device
    gives the same one group."""
    for axes in (("data", "pod"), ("model", "data")):
        mesh = make_test_mesh((1, 1), axes, device="cpu")
        with pytest.raises(ValueError) as t_err:
            replica_submeshes(mesh)
        with pytest.raises(ValueError) as j_err:
            jmesh.replica_submeshes(mesh)
        assert str(t_err.value) == str(j_err.value)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    j_subs = jmesh.replica_submeshes(jm)
    t_subs = replica_submeshes(make_test_mesh((1, 1), device="cpu"))
    assert len(j_subs) == len(t_subs) == 1
    assert dict(j_subs[0].shape) == dict(t_subs[0].shape)
    assert jmesh.data_axes(jm) == data_axes(t_subs[0])


def test_mesh_rejects_bad_axes_and_deals_cards_in_rank_order():
    with pytest.raises(ValueError, match="axis names"):
        Mesh([[torch.device("cpu")]], ("data",))
    with pytest.raises(ValueError, match="repeat"):
        Mesh([[torch.device("cpu")]], ("model", "model"))
    mesh = make_test_mesh((2, 2), device="cpu")
    assert mesh.size == 4 and dict(mesh.shape) == {"data": 2, "model": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
