"""Sharding rules: params / batches / caches -> PartitionSpec trees (port
of ``repro.parallel.sharding``), and the cut of full tensors into each
rank's shard.

Strategy (megatron-style TP on the ``model`` axis, DP over ``pod`` x
``data``), the JAX package's rules copied leaf for leaf:

* embeddings shard on the vocab dim; attention q/k/v shard heads
  (column-parallel), the output projection is row-parallel; MLP up/gate
  are column-parallel, down is row-parallel. MoE experts shard the
  *expert* dim (EP). Mamba's fused in_proj is column-parallel, out_proj
  row-parallel.
* LUT-DLA artefacts: codebooks ``z`` follow the *input* (K) dim of their
  projection: replicated for column-parallel projections,
  subspace-sharded for row-parallel ones (assignment is then local to the
  shard, and the LUT accumulate produces partial sums that reduce exactly
  like a dense row-parallel matmul). Precomputed LUTs ``(nc, c, N)``
  shard like the weight they replace: N for column-parallel, nc for
  row-parallel.
* KV caches: batch over the data axes when batch >= their product,
  otherwise the *sequence* dim over ``data``.

The port's params keep one dict per layer (``blocks`` is a list) where
the JAX leaves carry a leading layer axis, so the port's specs of block
leaves are the JAX ones without that axis; the path rules are the same
strings (``tree.py`` writes paths as ``jax.tree_util.keystr`` does).

Where GSPMD reshards, the port cannot: the layer code of a rank sees its
local shard only. One layout therefore departs from the JAX rule, at
run time only (:func:`serving_layout`): a Mamba2 block's fused
``in_proj`` output is z | x | B | C | dt, and an even split of it does
not line up with those segments, while B and C are read by every head.
Each rank's ``in_proj`` columns (and ``conv_w`` / ``conv_b`` / the conv
state's channels) are its own z, x and dt slices plus the whole B and C
(:class:`Columns`). :func:`param_pspecs` itself stays the JAX rule.

:func:`shard_tree` is the counterpart of ``logical_to_sharding`` +
``jax.device_put``: it cuts full tensors into every rank's local shard on
the rank's device; :func:`unshard_tree` puts them back together. The
sharded train step reads the same layout (and :func:`opt_pspecs` for the
optimizer state, :func:`shard_batch` for the batch); where several ranks
hold an entry (:func:`model_shared`) its gradient is a sum over them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map_with_path


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, ``None`` (replicated),
    a mesh axis name, or a tuple of axis names (sharded over their
    product, the first the slowest). Compares equal to a JAX
    ``PartitionSpec`` with the same entries (both are tuples)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Columns:
    """A port-side layout of one dim: rank r of the ``model`` axis holds
    the entries ``ranks[r]`` of dim ``axis`` (a negative index), every
    other dim whole. The Mamba2 ``in_proj`` / conv layout
    (:func:`mamba_columns`)."""

    def __init__(self, axis: int, ranks: Sequence[Sequence[int]],
                 mesh_axis: str = "model"):
        self.axis = axis
        self.ranks = tuple(tuple(int(i) for i in r) for r in ranks)
        self.mesh_axis = mesh_axis

    def __eq__(self, other) -> bool:
        return isinstance(other, Columns) and (
            self.axis, self.ranks, self.mesh_axis) == (
                other.axis, other.ranks, other.mesh_axis)

    def __repr__(self) -> str:
        return f"Columns(axis={self.axis}, {len(self.ranks)} ranks)"


def _spec_for_leaf(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                   model_axis: str, msize: int) -> P:
    """Per-leaf PartitionSpec. `path` is the keystr, `shape` the leaf shape.

    Any dim assigned to the model axis must divide its size; otherwise that
    dim falls back to replicated (e.g. mamba2's vocab 50280 on a 16-way
    axis)."""
    m = model_axis
    ndim = len(shape)

    def lead(base: Tuple, want_ndim: int) -> P:
        """Left-pad `base` with None (expert dims) and drop the model axis
        from any non-divisible dim."""
        pad = want_ndim - len(base)
        axes = [None] * pad + list(base)
        axes = [a if (a is None or shape[i] % msize == 0) else None
                for i, a in enumerate(axes)]
        return P(*axes)

    # ---- embeddings & heads -------------------------------------------
    if "embed" in path and ndim == 2:
        return lead((m, None), ndim)            # vocab-sharded
    if "heads" in path and ndim == 3:           # audio heads (Q, D, V)
        return lead((None, None, m), ndim)
    if "head" in path and ndim == 2:
        return lead((None, m), ndim)
    if "in_proj']" in path and "blocks" not in path and ndim == 2:
        return P()                              # audio stub input proj (tiny)

    # ---- MoE ----------------------------------------------------------
    if "router" in path:
        return lead((None, None), ndim)         # replicated (tiny, hot)
    if "shared_w" in path:
        # shared experts are few (can't shard E over the model axis):
        # tensor-parallel instead: up/gate column-parallel, down row-parallel.
        rowwise = "shared_wd" in path
        if path.endswith("['w']"):              # (..., SE, K, N)
            return lead((None, m, None) if rowwise else (None, None, m), ndim)
        if path.endswith("['z']"):
            return lead((None, m, None, None) if rowwise
                        else (None, None, None, None), ndim)
        if path.endswith("['lut']"):            # (..., SE, nc, c, N)
            return lead((None, m, None, None) if rowwise
                        else (None, None, None, m), ndim)
        if path.endswith("['lut_scale']"):
            return lead((None, None) if rowwise else (None, m), ndim)
    for key in ("wg", "wu", "wd"):
        if f"['{key}']" in path and "moe" in path:
            if path.endswith("['w']"):          # (..., E, K, N)
                return lead((m, None, None), ndim)
            if path.endswith("['z']"):          # (..., E, nc, c, v)
                return lead((m, None, None, None), ndim)
            if path.endswith("['lut']"):        # (..., E, nc, c, N)
                return lead((m, None, None, None), ndim)
            if path.endswith("['lut_scale']"):
                return lead((m, None), ndim)

    # ---- column-parallel projections (shard output dim N) -------------
    col = ("['wq']", "['wk']", "['wv']", "['wg']", "['wu']", "['in_proj']")
    # ---- row-parallel projections (shard input dim K = nc·v) ----------
    row = ("['wo']", "['wd']", "['out_proj']")

    if any(k in path for k in col):
        if path.endswith("['w']"):
            return lead((None, m), ndim)
        if path.endswith("['b']"):
            return lead((m,), ndim)
        if path.endswith("['z']"):
            return lead((None, None, None), ndim)          # replicate
        if path.endswith("['lut']"):
            return lead((None, None, m), ndim)             # N-sharded
        if path.endswith("['lut_scale']"):
            return lead((m,), ndim)
    if any(k in path for k in row):
        if path.endswith("['w']"):
            return lead((m, None), ndim)
        if path.endswith("['b']"):
            return lead((None,), ndim)
        if path.endswith("['z']"):
            return lead((m, None, None), ndim)             # subspace-sharded
        if path.endswith("['lut']"):
            return lead((m, None, None), ndim)             # nc-sharded
        if path.endswith("['lut_scale']"):
            return lead((None,), ndim)

    # ---- mamba channelwise params --------------------------------------
    if "conv_w" in path:
        return lead((None, m), ndim)           # (K, C): channels sharded
    if "conv_b" in path or "gate_norm" in path:
        return lead((m,), ndim)
    if any(k in path for k in ("dt_bias", "A_log", "['D']")):
        return lead((m,), ndim)                # per-head

    # ---- norms & leftovers: replicated ---------------------------------
    return P(*([None] * ndim))


def param_pspecs(params, cfg: ModelConfig, model_axis: str = "model",
                 model_axis_size: int = 16):
    """PartitionSpec tree matching `params` (the JAX rule; block leaves
    have no layer axis)."""
    return tree_map_with_path(
        lambda path, leaf: _spec_for_leaf(path, tuple(leaf.shape), cfg,
                                          model_axis, model_axis_size),
        params)


def opt_pspecs(p_specs, tc):
    """The optimizer state's layout (the JAX dry run's ``_opt_pspecs``):
    AdamW's moments ``m`` / ``v`` and the error-feedback residuals ``ef``
    (with ``tc.compress_grads``) by the params' layout, the step count
    replicated."""
    out = {"adam": {"m": p_specs, "v": p_specs, "count": P()}}
    if tc.compress_grads:
        out["ef"] = p_specs
    return out


def batch_pspecs(cfg: ModelConfig, data_axes: Tuple[str, ...] = ("data",)):
    """PartitionSpecs for a training batch (batch dim over all DP axes)."""
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    if cfg.family == "audio":
        return {"embeds": P(da, None, None), "labels": P(da, None, None)}
    if cfg.family == "vlm":
        return {"patch_embeds": P(da, None, None), "tokens": P(da, None)}
    return {"tokens": P(da, None)}


def shard_batch(batch, cfg: ModelConfig, mesh: Mesh,
                only: Optional[Sequence[int]] = None) -> list:
    """A global training batch cut by :func:`batch_pspecs` over the mesh's
    data axes (every rank of a data group gets its rows; the batch dim
    must divide their product), one dict a rank on the rank's device, in
    the order of ``mesh.devices.flat`` (``only``: the ranks to cut for,
    as :func:`shard_tree` takes them). A mesh without data axes gives
    every rank the whole batch."""
    da = data_axes(mesh)
    specs = (batch_pspecs(cfg, da) if da
             else {k: P() for k in batch})
    return shard_tree({k: batch[k] for k in specs}, specs, mesh, only=only)


def cache_pspecs(cfg: ModelConfig, batch_size: int, mesh: Mesh,
                 data_axes: Tuple[str, ...] = ("data",),
                 model_axis: str = "model"):
    """PartitionSpecs for a dense decode cache (``Model.init_cache``
    layout; the JAX layout's ``layers`` leaves, whose SSM entries the
    port's dense cache does not have).

    If the batch covers the data axes, shard batch; otherwise shard the
    sequence dim over `data` (SP, long-context decode with batch=1).
    """
    dp = 1
    for a in data_axes:
        dp *= mesh.shape[a]
    batch_first = batch_size % dp == 0 and batch_size >= dp
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    m = model_axis
    msize = mesh.shape[m]
    mh, md = _kv_model_axes(cfg, m, msize)

    if batch_first:
        kv = P(None, da, None, mh, md)          # (L, B, T, KVH, D)
    else:
        kv = P(None, None,
               da if len(data_axes) == 1 else "data", mh, md)

    pos = P()
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return {"layers": {"k": kv, "v": kv}, "pos": pos}

    mamba = {
        "conv": P(None, da if batch_first else None, None, m),
        "h": P(None, da if batch_first else None, m, None, None),
    }
    if cfg.family == "ssm":
        return {"layers": mamba, "pos": pos}
    return {"layers": {"mamba": mamba, "attn": {"k": kv, "v": kv}},
            "pos": pos}


def _kv_model_axes(cfg: ModelConfig, model_axis: str, msize: int):
    """Model-axis placement inside a KV cache: prefer kv heads, fall back
    to head_dim (matches the column-parallel wk/wv output sharding), else
    replicate across model."""
    kvh, hd = cfg.num_kv_heads, (cfg.head_dim or 0)
    if kvh and kvh % msize == 0:
        return model_axis, None
    if hd and hd % msize == 0:
        return None, model_axis
    return None, None


def shard_cache(cache, cfg: ModelConfig, batch_size: int, mesh: Mesh,
                only: Optional[Sequence[int]] = None) -> list:
    """A dense cache (``Model.init_cache``: full leaves on any device,
    the meta device giving zeroed shards) cut by :func:`cache_pspecs`
    into each rank's part (``only`` as :func:`shard_tree` takes it): its
    batch rows when the batch covers the data axes, else a slice of the
    sequence over ``data``, whose first global row the part carries as
    ``"seq_rows"`` (what ``Model.prefill`` / ``decode`` read); each
    rank's kv heads, or its head_dim slice where they do not divide the
    model axis."""
    da = data_axes(mesh)
    specs = cache_pspecs(cfg, batch_size, mesh, da)["layers"]
    parts = shard_tree(cache["layers"], specs, mesh, only=only)
    seq = specs["k"][2]                       # (L, B, T, KVH, HD): T's axes
    coords = _coords(mesh)
    out = []
    for i, layers in zip(range(mesh.size) if only is None else only,
                         parts):
        part = dict(cache, layers=layers)
        if seq is not None:
            rows = layers["k"].shape[2]
            part["seq_rows"] = _block(seq, coords[i], mesh)[0] * rows
        out.append(part)
    return out


def paged_cache_pspecs(cfg: ModelConfig, mesh: Mesh,
                       model_axis: str = "model", quantized: bool = False):
    """PartitionSpecs for the PAGED serving cache
    (``Model.init_paged_cache``).

    Attention families store KV as a physical page pool ``(L,
    num_pages+1, page_size, KVH, HD)``, REPLICATED over the data axes:
    data-parallel serving is replica-level (one engine + page table per
    replica group, ``serve.router``), so within one engine only tensor
    parallelism applies, on the kv-head / head-dim axis as in the dense
    cache. SSM / hybrid slot-indexed state shards its channel / head dims
    over ``model`` (replicated on non-divisible dims). The page table,
    positions and tokens are host objects.

    ``quantized``: the pool holds uint8 codes ``(L, P+1, page, KVH, nc)``
    plus the codebook; kv heads still shard over ``model`` when
    divisible, but the last dim is the subspace axis, not head_dim, so the
    head_dim fallback does not apply: the pool is replicated (each rank
    encodes and attends every kv head). The codebook is replicated.
    """
    m = model_axis
    msize = mesh.shape[m]
    mh, md = _kv_model_axes(cfg, m, msize)
    if quantized:
        md = None                           # last dim = subspaces, whole
    kv = P(None, None, None, mh, md)        # (L, P+1, page, KVH, HD|nc)
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        if quantized:
            cbook = {"zk": P(), "zv": P(), "sk": P(), "sv": P()}
            return {"k": kv, "v": kv, "codebook": cbook}
        return {"k": kv, "v": kv}
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    mamba = {
        # (L, slots, K-1, C): channels over model, like the dense cache
        "conv": P(None, None, None,
                  m if conv_dim % msize == 0 else None),
        # (L, slots, H, HP, N): ssm heads over model
        "h": P(None, None,
               m if cfg.ssm_nheads % msize == 0 else None, None, None),
    }
    if cfg.family == "ssm":
        return mamba
    # hybrid: slot-dense shared-attn cache (n_inv, slots, T+1, KVH, HD)
    return {"mamba": mamba, "attn": {"k": kv, "v": kv}}


# ----------------------------------------------------------------------
# the port's run-time layout
# ----------------------------------------------------------------------
def mamba_columns(cfg: ModelConfig, msize: int
                  ) -> Tuple[List[List[int]], List[List[int]]]:
    """Each rank's ``in_proj`` output columns and conv channels: its
    slice of z, x and dt (of the heads it owns) and the whole B and C.
    Returns (in_proj columns, conv channels), one list a rank."""
    din, gn, h = (cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state,
                  cfg.ssm_nheads)
    dl, hl = din // msize, h // msize
    bc = list(range(2 * din, 2 * din + 2 * gn))
    in_cols, conv_cols = [], []
    for r in range(msize):
        z = list(range(r * dl, (r + 1) * dl))
        x = [din + i for i in z]
        dt = list(range(2 * din + 2 * gn + r * hl,
                        2 * din + 2 * gn + (r + 1) * hl))
        in_cols.append(z + x + bc + dt)
        conv_cols.append(z + [din + i for i in range(2 * gn)])
    return in_cols, conv_cols


def check_tensor_parallel(cfg: ModelConfig, msize: int, qc=None) -> None:
    """Raise ``NotImplementedError`` unless the layer code can run
    ``cfg`` over a model axis of ``msize``. Every dim it shards must
    divide, or fall back as the reference's does:

    * kv heads that do not divide take the head_dim layout (each rank
      holds its head_dim slice of the dense cache and of an fp page
      pool, which must divide; a pool of codes is replicated:
      ``models.layers``) everywhere: ``forward`` / ``loss``, the
      dense-cache ``prefill`` / ``decode``, the train step and the paged
      engines;
    * a d_ff that does not divide replicates the MLP (the JAX rule drops
      the axis there), and so do q / k / v / o projections whose width
      does not divide under the head_dim layout.

    The vocab may go either way (sharded or replicated; audio's
    ``heads`` on V); audio's ``in_proj`` is replicated. ``qc``'s
    sub-vector length must also divide each row-parallel shard's input
    width."""
    if msize == 1:
        return
    v = qc.v if qc is not None and qc.is_lut else 1
    need = []
    if cfg.family in ("dense", "moe", "hybrid", "audio", "vlm"):
        hd = cfg.head_dim
        wo = cfg.num_heads * hd
        if cfg.family == "hybrid" or not cfg.num_kv_heads % msize:
            need += [("num_heads", cfg.num_heads),
                     ("num_kv_heads", cfg.num_kv_heads),
                     ("wo subspaces", wo // v)]
        else:                                   # the head_dim layout
            need += [("head_dim", hd)]
            if not wo % msize:
                need += [("wo subspaces", wo // v)]
        if cfg.family == "moe":
            need += [("num_experts", cfg.num_experts)]
            if cfg.num_shared_experts:
                need += [("d_ff", cfg.d_ff), ("wd subspaces", cfg.d_ff // v)]
        elif not cfg.d_ff % msize:              # else the MLP is replicated
            need += [("wd subspaces", cfg.d_ff // v)]
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm_ngroups != 1:
            raise NotImplementedError(
                "tensor-parallel Mamba2 keeps every head's B and C on each "
                f"rank and needs ssm_ngroups == 1 (got {cfg.ssm_ngroups})")
        need += [("ssm_nheads", cfg.ssm_nheads),
                 ("out_proj subspaces", cfg.d_inner // v)]
    bad = [f"{name}={n}" for name, n in need if n % msize]
    if bad:
        raise NotImplementedError(
            f"{cfg.name} over a model axis of {msize}: {', '.join(bad)} "
            "do not divide it; a layout for such dims is not ported: "
            "ROADMAP.md queue A item 11")


def serving_layout(params, cfg: ModelConfig, msize: int,
                   model_axis: str = "model"):
    """The layout a tensor-parallel engine (and the sharded train step)
    places ``params`` by: :func:`param_pspecs`, with a Mamba2 block's
    ``in_proj`` leaves and ``conv_w`` / ``conv_b`` as :class:`Columns`
    (:func:`mamba_columns`)."""
    specs = param_pspecs(params, cfg, model_axis, msize)
    if cfg.family not in ("ssm", "hybrid") or msize == 1:
        return specs
    in_cols, conv_cols = mamba_columns(cfg, msize)

    def fix(path, spec):
        if "['blocks']" not in path:
            return spec
        if "['in_proj']" in path and not path.endswith("['z']"):
            return Columns(-1, in_cols, model_axis)
        if "['conv_w']" in path or "['conv_b']" in path:
            return Columns(-1, conv_cols, model_axis)
        return spec
    return tree_map_with_path(fix, specs, leaf=_is_spec)


def serving_cache_layout(cfg: ModelConfig, mesh: Mesh,
                         model_axis: str = "model",
                         quantized: bool = False):
    """The layout of a tensor-parallel engine's pool or slot state:
    :func:`paged_cache_pspecs`, with the Mamba2 conv state's channels as
    :class:`Columns` (the conv's own layout, :func:`serving_layout`)."""
    specs = paged_cache_pspecs(cfg, mesh, model_axis, quantized)
    msize = mesh.shape[model_axis]
    if cfg.family not in ("ssm", "hybrid") or msize == 1:
        return specs
    _, conv_cols = mamba_columns(cfg, msize)
    mamba = dict(specs if cfg.family == "ssm" else specs["mamba"])
    mamba["conv"] = Columns(-1, conv_cols, model_axis)
    if cfg.family == "ssm":
        return mamba
    return dict(specs, mamba=mamba)


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------
def _is_spec(x) -> bool:
    return isinstance(x, (P, Columns))


def _coords(mesh: Mesh) -> List[dict]:
    """Each device's coordinate along every axis, in the order of
    ``mesh.devices.flat``."""
    return [dict(zip(mesh.axis_names, idx))
            for idx in np.ndindex(mesh.devices.shape)]


def _block(entry, coord: dict, mesh: Mesh) -> Tuple[int, int]:
    """(index, count) of a device's block along one dim sharded over
    ``entry`` (an axis name or a tuple of them, row-major)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx, count = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + coord[a]
        count *= mesh.shape[a]
    return idx, count


def _region(spec, shape, coord: dict, mesh: Mesh):
    """The index a device's shard takes out of a full leaf: a tuple of
    slices for a :class:`P`, (axis, index tensor) for :class:`Columns`."""
    if isinstance(spec, Columns):
        return spec.axis, spec.ranks[coord[spec.mesh_axis]]
    region = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            region.append(slice(None))
            continue
        idx, count = _block(entry, coord, mesh)
        if n % count:
            raise ValueError(f"dim {d} of size {n} does not divide over "
                             f"{entry} ({count})")
        w = n // count
        region.append(slice(idx * w, (idx + 1) * w))
    return tuple(region)


def _take(leaf: torch.Tensor, spec, region) -> torch.Tensor:
    if isinstance(spec, Columns):
        axis, idx = region
        return leaf.index_select(
            axis, torch.tensor(idx, dtype=torch.long, device=leaf.device))
    return leaf[region]


def shard_tree(tree, specs, mesh: Mesh, copy: bool = False,
               only: Optional[Sequence[int]] = None) -> list:
    """Cut every full leaf of ``tree`` into each device's shard by its
    spec (a :class:`P` or :class:`Columns` leaf of ``specs``, a tree of
    the same structure). Returns one local tree a device of ``mesh``, in
    the order of ``mesh.devices.flat``; each shard is contiguous and on
    its device.

    The full leaves may lie on any one device, the host (CPU) included:
    each shard is cut there and copied straight to its device, so no
    device of the mesh receives more than its shards. A leaf on the meta
    device stands for zeros: each shard is allocated zeroed on its
    device (a pool made shard by shard). A replicated leaf is copied to
    a device once and shared by the ranks there; on its own device it is
    the leaf itself, and a contiguous slice there is a view of it.
    ``only``: the flat indices of the devices to cut for (a runner's
    ``ranks``; the one-rank ``CostRunner`` runs rank 0 alone), in that
    order; default every device."""
    coords = _coords(mesh)
    devices = list(mesh.devices.flat)
    placed: dict = {}                     # (leaf, device) -> replicated copy

    def one(i):
        dev = devices[i]

        def cut(path, leaf, spec):
            region = _region(spec, leaf.shape, coords[i], mesh)
            whole = not isinstance(spec, Columns) and all(
                r == slice(None) for r in region)
            part = leaf if whole else _take(leaf, spec, region)
            if leaf.is_meta:
                return torch.zeros(part.shape, dtype=part.dtype, device=dev)
            if copy:
                return part.to(dev, copy=True,
                               memory_format=torch.contiguous_format)
            if not whole:
                return part.contiguous().to(dev)
            key = (id(leaf), str(dev))
            if key not in placed:
                placed[key] = part.to(dev).contiguous()
            return placed[key]
        return tree_map_with_path(cut, tree, specs)
    return [one(i) for i in (range(len(devices)) if only is None
                             else only)]


@dataclasses.dataclass(frozen=True)
class SharedRun:
    """Entries [lo, hi) of dim ``axis`` of a rank's shard, which every
    rank of the model axis holds (:func:`model_shared`)."""
    axis: int
    lo: int
    hi: int


def model_shared(spec, model_axis: str = "model"):
    """Which entries of a rank's shard every rank of its ``model`` axis
    group holds too (so a gradient there is one part of a sum over those
    ranks, and a norm counts it once): ``"all"`` for a leaf the spec does
    not cut over ``model_axis``, None for one it cuts, and for
    :class:`Columns` the :class:`SharedRun` of columns every rank's list
    holds (a Mamba2 ``in_proj``'s B and C: the same positions on every
    rank)."""
    if isinstance(spec, Columns):
        common = set(spec.ranks[0]).intersection(*map(set, spec.ranks[1:]))
        pos = [[i for i, c in enumerate(r) if c in common]
               for r in spec.ranks]
        if not pos[0]:
            return None
        lo, hi = pos[0][0], pos[0][-1] + 1
        if any(p != list(range(lo, hi)) for p in pos) or any(
                [r[i] for i in p] != [spec.ranks[0][i] for i in pos[0]]
                for r, p in zip(spec.ranks, pos)):
            raise ValueError("the columns every rank holds must sit at the "
                             "same positions, in one run, on each rank")
        return SharedRun(spec.axis, lo, hi)
    cut = any(e == model_axis or (isinstance(e, tuple) and model_axis in e)
              for e in spec)
    return None if cut else "all"


def unshard_tree(shards: Sequence, specs, mesh: Mesh,
                 device: Optional[torch.device] = None):
    """The inverse of :func:`shard_tree`: full leaves, on ``device``
    (default the first shard's). Replicated copies are taken from the
    first device that holds each block."""
    coords = _coords(mesh)

    def join(path, spec, *parts):
        dev = device if device is not None else parts[0].device
        if isinstance(spec, Columns):
            idx = [j for r in spec.ranks for j in r]
            shape = list(parts[0].shape)
            shape[spec.axis] = max(idx) + 1
            out = torch.empty(shape, dtype=parts[0].dtype, device=dev)
            for c, part in zip(coords, parts):
                cols = torch.tensor(spec.ranks[c[spec.mesh_axis]],
                                    dtype=torch.long, device=dev)
                out.index_copy_(spec.axis, cols, part.to(dev))
            return out
        shape = list(parts[0].shape)
        for d in range(len(shape)):
            entry = spec[d] if d < len(spec) else None
            if entry is not None:
                shape[d] *= _block(entry, coords[0], mesh)[1]
        out = torch.empty(shape, dtype=parts[0].dtype, device=dev)
        for c, part in zip(coords, parts):
            out[_region(spec, shape, c, mesh)] = part.to(dev)
        return out
    return tree_map_with_path(join, specs, *shards, leaf=_is_spec)
