"""The cost of one rank's program, counted while it runs (the port's
counterpart of ``repro.launch.hlo_cost``).

The JAX package costs the SPMD-partitioned HLO module, one device's
program. The port has no HLO: an eager program's kernels are its aten ops
and its hand-written kernels, so :class:`OpCost`, a ``TorchDispatchMode``,
counts them as they run (on the meta device for the dry run, where
nothing is computed, or on the card):

  * flops: matmul-class FLOPs of every aten op, from
    ``torch.utils.flop_counter``'s registry (mm, bmm, addmm, baddbmm,
    convolutions, attention), as ``hlo_cost`` counts dots;
  * bytes: operand plus result bytes of every op that is not a view, a
    metadata op or a factory, the eager counterpart of ``hlo_cost``'s
    per-instruction bytes at fusion granularity (an in-place op's result
    is its operand, counted once); an in-place write at indices
    (``index_put_``, ``index_copy_``, ``scatter_``, ...) counts what it
    moves: its values and indices read, and the rows it writes (read
    too where it accumulates), never the whole tensor it writes into
    (:func:`_indexed_write_bytes`);
  * kernels: each call of a kernel entry point (B1-B5) records the work
    its function needs (``kernels.work``: bytes, and CUDA-core
    operations in ``core_ops``) and its launch, by kernel, and nothing
    of what implements it (:func:`kernel_call`): the ops a kernel call
    dispatches inside the entry point are not counted, so the same call
    counts the same on the meta device (where it returns an empty
    result), on the CPU (its plain version) and on the card (its kernel);
  * collectives: operand bytes by kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``permute``), one count a call
    (``parallel.collectives`` records them; the one-rank runner,
    ``CostRunner``, also records the backward's transposed collective);
  * memory: the peak bytes of meta storages made during the call and
    still alive (tracked when an op that is not a view returns a tensor
    that is none of its operands, released by a finalizer on the
    storage), the dry run's ``temp_size_in_bytes``.

A rank runner carries the caller's dispatch modes into its rank threads,
so a mode open around a sharded call sees every rank's ops.

API: ``program_cost(fn, *args)`` -> :class:`OpCost` (``.result`` holds
``fn``'s return value); ``cost.top_cost_lines(k, by="bytes")`` lists the
costliest (op, site) pairs, the site being the module and function of the
port that called the op.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import weakref
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

#: Ops that touch no data: metadata queries and aliasing.
_METADATA = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten.sym_size,
             _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset,
             _aten.is_same_size, _aten.set_, _aten.resize_,
             _aten._local_scalar_dense}

#: In-place writes at indices (the result is the first operand, of which
#: only the indexed rows are touched), and whether each accumulates into
#: the rows (reads them too).
_INDEXED_WRITES = {_aten.index_put_: False, _aten._index_put_impl_: False,
                   _aten.index_copy_: False, _aten.index_fill_: False,
                   _aten.scatter_: False, _aten.scatter_add_: True,
                   _aten.scatter_reduce_: True, _aten.index_add_: True,
                   _aten.index_reduce_: True}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "permute")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _indexed_rows(packet, args) -> int:
    """Elements an in-place indexed write touches in its first operand:
    the shape ``self[indices]`` has for ``index_put_`` (a boolean index
    counts all its elements, an upper bound), the index's elements
    (times the other dims for ``index_fill_``) for ``scatter_`` /
    ``index_fill_``, the source's for ``index_copy_`` / ``index_add_``."""
    self_ = args[0]
    if packet in (_aten.index_put_, _aten._index_put_impl_):
        kept, shapes, used = 1, [], 0
        for idx in args[1]:
            if idx is None:
                kept *= self_.shape[used]
                used += 1
            elif idx.dtype == torch.bool:
                shapes.append((idx.numel(),))
                used += idx.dim()
            else:
                shapes.append(tuple(idx.shape))
                used += 1
        n = torch.Size(torch.broadcast_shapes(*shapes)).numel()
        for size in self_.shape[used:]:
            kept *= size
        return n * kept
    if packet in (_aten.index_copy_, _aten.index_add_, _aten.index_reduce_):
        return args[3].numel()
    if packet is _aten.index_fill_:
        dim = args[1] % self_.dim()
        return args[2].numel() * (self_.numel() // max(self_.shape[dim], 1))
    return args[2].numel()                   # scatter_ and its kin


def _indexed_write_bytes(packet, args, kwargs) -> int:
    """Bytes an in-place write at indices moves: every operand but the
    destination (values, indices, a source) read once, and the rows it
    writes (twice where it accumulates: read, then written)."""
    self_ = args[0]
    rows = _indexed_rows(packet, args) * self_.element_size()
    accumulate = _INDEXED_WRITES[packet] or bool(
        kwargs.get("accumulate", len(args) > 3 and packet in (
            _aten.index_put_, _aten._index_put_impl_) and args[3]))
    seen = {id(self_)}
    nbytes = 0
    for t in _tensors((args[1:], kwargs)):
        if id(t) not in seen:
            seen.add(id(t))
            nbytes += _nbytes(t)
    return nbytes + rows * (2 if accumulate else 1)


def _is_factory(packet, inputs) -> bool:
    name = packet.__name__
    return (not inputs or name.endswith("_like") or name.startswith("new_")
            or name == "scalar_tensor")


def _site() -> str:
    """``module.function`` of the innermost frame of the port that led to
    the op (``(autograd)`` for an op of the backward)."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if not mod.startswith(("torch", __name__)):
            return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return "(autograd)"


class OpCost(TorchDispatchMode):
    """The cost of what runs while the mode is open; fields as
    ``hlo_cost.HloCost`` (``flops``, ``bytes``, ``coll`` by kind,
    ``coll_count``) plus ``core_ops`` (the kernels' CUDA-core work),
    ``kernels`` (launches by kernel name), ``coll_by_rank`` (collective
    bytes by the recording rank) and ``peak_temp_bytes``."""

    #: modes entered and not yet exited, on any thread: a kernel call
    #: looks for its mode only while one is open (a check of one int on
    #: the serving path)
    open_count = 0
    _count_lock = threading.Lock()

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.core_ops = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.coll_count = 0
        self.coll_by_rank: Dict[int, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self.kernels: Dict[str, int] = defaultdict(int)
        self.lines: Dict[Tuple[str, str], List[float]] = defaultdict(
            lambda: [0, 0.0, 0.0])
        self.live_temp_bytes = 0
        self.peak_temp_bytes = 0
        self.result = None
        self._storages: set = set()
        self._lock = threading.RLock()    # a finalizer may run under it
        self._tls = threading.local()

    def __enter__(self):
        with OpCost._count_lock:
            OpCost.open_count += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            with OpCost._count_lock:
                OpCost.open_count -= 1

    # ---- what the mode sees ---------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(self._tls, "paused", 0):
            return out
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        nbytes = 0
        if packet in _INDEXED_WRITES:
            nbytes = _indexed_write_bytes(packet, args, kwargs)
        elif not (func.is_view or packet in _METADATA
                  or _is_factory(packet, ins)):
            seen = set()
            for t in ins + outs:          # an in-place result: its operand
                if id(t) not in seen:
                    seen.add(id(t))
                    nbytes += _nbytes(t)
        with self._lock:
            self.flops += flops
            self.bytes += nbytes
            if flops or nbytes:
                line = self.lines[(packet.__name__, _site())]
                line[0] += 1
                line[1] += flops
                line[2] += nbytes
            if not func.is_view:          # a view's storage is its base's
                known = {id(t) for t in ins}
                for t in outs:
                    if t.is_meta and id(t) not in known:
                        self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages.add(key)
        self.live_temp_bytes += n
        self.peak_temp_bytes = max(self.peak_temp_bytes,
                                   self.live_temp_bytes)
        weakref.finalize(st, self._release, key, n)

    def _release(self, key: int, n: int) -> None:
        with self._lock:
            self._storages.discard(key)
            self.live_temp_bytes -= n

    # ---- what the kernels and collectives record ------------------------
    def record_kernel(self, name: str, work: Tuple[float, float]) -> None:
        nbytes, ops = work
        with self._lock:
            self.kernels[name] += 1
            self.bytes += nbytes
            self.core_ops += ops
            line = self.lines[(name, "kernel")]
            line[0] += 1
            line[2] += nbytes

    def record_collective(self, kind: str, nbytes: int,
                          rank: int = 0) -> None:
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        with self._lock:
            self.coll[kind] += nbytes
            self.coll_count += 1
            self.coll_by_rank[rank][kind] += nbytes

    @contextlib.contextmanager
    def paused(self):
        """Count nothing this thread dispatches inside (a kernel call)."""
        self._tls.paused = getattr(self._tls, "paused", 0) + 1
        try:
            yield
        finally:
            self._tls.paused -= 1

    # ---- reading ---------------------------------------------------------
    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def top_cost_lines(self, k: int = 20, by: str = "bytes"):
        """The ``k`` costliest (op or kernel, site) pairs by ``by``
        ("bytes" or "flops"): a list of dicts with ``op``, ``site``,
        ``count``, ``flops``, ``bytes``."""
        col = {"flops": 1, "bytes": 2}[by]
        rows = sorted(self.lines.items(), key=lambda kv: -kv[1][col])[:k]
        return [{"op": op, "site": site, "count": int(v[0]),
                 "flops": v[1], "bytes": v[2]}
                for (op, site), v in rows]


def costs() -> List[OpCost]:
    """The :class:`OpCost` modes open on the calling thread, innermost
    last."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCost)]


def record_collective(kind: str, nbytes: int, rank: int = 0) -> None:
    """Record a collective's operand bytes in every open :class:`OpCost`
    (none open: nothing)."""
    if not OpCost.open_count:
        return
    for c in costs():
        c.record_collective(kind, nbytes, rank)


def kernel_call(name: str, device: torch.device,
                work: Callable[[], Tuple[float, float]]):
    """The frame of a kernel entry point's body (a context manager).
    Under an open :class:`OpCost`, records the kernel's launch and
    ``work()`` (its ``kernels.work`` function) and counts nothing the
    body dispatches; the body then returns an empty result for meta
    tensors. With no OpCost open a meta call raises: a meta tensor has no
    data, and no kernel or plain version runs on one."""
    if not OpCost.open_count and device.type != "meta":
        return contextlib.nullcontext()
    return _kernel_call(name, device, work)


@contextlib.contextmanager
def _kernel_call(name, device, work):
    open_costs = costs()
    if not open_costs:
        if device.type == "meta":
            raise RuntimeError(
                f"kernel {name} called on meta tensors outside an OpCost "
                "(launch.op_cost): there is nothing to compute; a meta "
                "call only records the kernel's work")
        yield
        return
    w = work()
    for c in open_costs:
        c.record_kernel(name, w)
    with contextlib.ExitStack() as stack:
        for c in open_costs:
            stack.enter_context(c.paused())
        yield


def program_cost(fn: Callable, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`OpCost`; the
    cost, with ``fn``'s return value in ``.result``."""
    with OpCost() as cost:
        cost.result = fn(*args, **kwargs)
    return cost


def meta_result(shape, dtype) -> torch.Tensor:
    """The empty meta tensor a kernel entry point returns under an
    OpCost."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")

