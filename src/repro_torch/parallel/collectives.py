"""Collectives and the rank runner of a tensor-parallel engine.

The JAX package drives a whole mesh from one Python process and GSPMD
inserts the collectives. The port keeps the one controller: a
tensor-parallel group is one :class:`RankRunner` of ``size`` ranks, each
holding its local shard on its device. :meth:`RankRunner.run` calls the
model's layer code once a rank, rank 0 on the calling thread and every
other rank on a worker thread of its own (as ``nn.DataParallel``'s
``parallel_apply`` does). The layer code sees only its shard and calls
the rank's :class:`TP` handle (:func:`current`) at the points where
GSPMD inserts a collective in the reference:

  * :meth:`TP.all_reduce` sums every rank's tensor in rank order (0, 1,
    ...), so every rank holds the same bits and a run reproduces;
  * :meth:`TP.all_gather` concatenates them along a dim in rank order;
  * :meth:`TP.all_to_all` gives rank r the r-th slice (along one dim) of
    every rank's tensor, concatenated along another in rank order.

On one device (several ranks sharing a card, or the CPU) a collective is
plain adds or a concatenation; across cards each rank copies the others'
tensors to its own device (a peer copy; PyTorch orders it after the
producer's stream), then adds. Nothing waits for the host: no collective
reads a value back.

The ranks take turns: one rank thread runs at a time, from one
collective to the next, then hands the turn to the next rank (rank 0
after the last), so a collective's parts are all in when its first rank
resumes. Python runs one thread at a time anyway (the GIL); free-running
rank threads handed the GIL back and forth at every torch op, and made a
TP-2 decode step of full-depth qwen1.5-4b on one H100 5.2x the
unsharded step (PERF.md, section 6); turns cost one lock handoff a rank a
collective, and the interleaving is the same on every run. A rank that
raises wakes every other rank, which leaves its collective at once, and
:meth:`RankRunner.run` raises the first rank's error in the caller; a
rank that waits longer than :data:`BARRIER_TIMEOUT` seconds for its turn
raises too. Nothing hangs.

Outside a runner :func:`current` is :data:`SOLO`, a group of one whose
collectives return their input: the single-device code paths are the
sharded ones at size 1.

A runner may also span a whole device mesh (``RankRunner(mesh=)``): a
``(data, model)`` or ``(pod, data, model)`` mesh for the sharded train
step, a ``(stage,)`` mesh for the pipeline. Every rank of the mesh is a
rank of the one runner, in the order of ``mesh.devices.flat``, and takes
its turn in the one ring. Its :class:`TP` handle (:func:`current`) is
the one of its ``model`` axis group (the ranks that differ only in their
``model`` coordinate); :meth:`TP.over` gives the handle of any other
axis group of the same rank (``tp.over("data")``, ``tp.data`` for the
data axes together, ``tp.over("stage")``). Since every rank runs the same
program, every rank reaches the same collective at the same point: each
puts its part in, and each reads the parts of its own group. An axis the
mesh does not have gives a group of one.

Grad mode and inference mode are thread-local: :meth:`RankRunner.run`
carries the caller's into every rank, so a training forward builds one
autograd graph over every rank (a collective hands over the other ranks'
live tensors, so its output is a function of every rank's input) and a
``torch.no_grad()`` caller builds none. A call with grad enabled (and
inference mode off) runs every rank on a thread started for the call,
which counts autograd's sequence numbers from zero. The backward orders
the parts of a gradient by those numbers, and the persistent worker
threads (whose counts go on across calls) made two identical training
steps differ in their last bits. Serving runs under ``no_grad`` or
inference mode and keeps the persistent workers, as threads started at
every decode step made a TP-2 step of qwen1.5-4b 35-66 ms slower on an
H100 (PERF.md, section 6).

This module is the one seam for a multi-process backend: a
``torch.distributed`` (NCCL) group would implement the same :class:`TP`
methods, one process a rank, for serving and training across hosts
(ROADMAP.md queue A item 11).

Counters: ``RankRunner.collectives`` counts collectives (one per call of
all ranks, whatever the axis) and ``RankRunner.bytes`` the bytes they
gathered (the sum of every rank's contribution), for the ``scale`` and
``train_scale`` phases of ``chip_smoke.py``. Under an open
``launch.op_cost.OpCost`` each rank also records its operand's bytes by
kind.

:class:`CostRunner` is the one-rank runner of the dry run (``launch``):
over a mesh it runs only the rank at coordinate 0 of every axis, whose
collectives exchange nothing: each returns an empty tensor of its
result's shape (on the meta device, where the dry run runs) and records
its operand's bytes, and its backward records the transposed collective.
The layouts the port accepts shard evenly, so every rank runs the same
shapes and one rank's program is every rank's: the counterpart of the
SPMD-partitioned module the JAX package costs.

Activation checkpointing (:func:`remat`): a layer's forward keeps none
of the tensors its backward reads (each is replaced by its index); the
first backward node of a layer that reads one recomputes the layer. Under
a runner over several ranks every rank recomputes that layer together,
on rank threads started for the recompute, so its collectives run again
and give what the forward's gave (the same parts, added in rank order);
each rank's recomputed tensors are kept only until its own backward
reads them, so at most one layer's are held for each rank, collective
results included. The gradient still flows through the forward's
collectives (the original graph). Under :class:`CostRunner` the
recompute calls the cost handle's collectives, which record their bytes
again: what the reference's remat costs.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.op_cost import record_collective

#: Seconds a rank waits for its turn before the call raises (a rank stuck
#: for this long is a bug).
BARRIER_TIMEOUT = 600.0


class TP:
    """One rank's handle on one axis group of its runner: ``rank`` (its
    index in the group), ``size``, ``device`` and the collectives."""

    def __init__(self, group: Optional["_Group"], rank: int,
                 device: torch.device, members: Sequence[int] = (0,),
                 me: int = 0):
        self.group = group
        self.rank = rank
        self.device = device
        self.members = tuple(members)     # the group's ranks in the runner
        self.me = me                      # this rank in the runner
        self._views: Dict[Tuple[str, ...], "TP"] = {}

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def world(self) -> int:
        """The number of ranks of the whole runner (1 outside one)."""
        return 1 if self.group is None else self.group.size

    def over(self, *axes: str) -> "TP":
        """The same rank's handle on the group of ``axes`` (the ranks that
        differ only in those mesh coordinates, ranked row-major over
        them); axes the runner's mesh lacks are left out, and with none
        left it is a group of one."""
        if self.group is None:
            return self
        names = tuple(a for a in self.group.axis_names if a in axes)
        return self._views[names]

    @property
    def data(self) -> "TP":
        """The handle on the data axes (``pod`` and ``data``) together."""
        return self.over("pod", "data")

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on this rank's device (itself when it lies there): the
        engine's replicated step inputs."""
        return t if t.device == self.device else t.to(self.device)

    def _exchange(self, t: torch.Tensor, kind: str) -> List[torch.Tensor]:
        record_collective(kind, t.numel() * t.element_size(), self.me)
        g = self.group
        buf = g.slots[g.gen[self.me] % 2]
        g.gen[self.me] += 1
        buf[self.me] = t
        if self.me == 0:
            g.runner.collectives += 1
        g.handoff(self.me)
        if self.me == 0:
            g.runner.bytes += sum(p.numel() * p.element_size()
                                  for p in buf)
        return [self.local(buf[m]) for m in self.members]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order."""
        if self.size == 1:
            return t
        parts = self._exchange(t, "all-reduce")
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        return torch.cat(self._exchange(t, "all-gather"), dim=dim)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """Rank r's part: the r-th even slice along ``split_dim`` of every
        rank's ``t``, concatenated along ``cat_dim`` in rank order (the
        Ulysses re-shard: sequence-sharded <-> head-sharded)."""
        if self.size == 1:
            return t
        parts = self._exchange(t, "all-to-all")
        w = t.shape[split_dim] // self.size
        return torch.cat([p.narrow(split_dim, self.rank * w, w)
                          for p in parts], dim=cat_dim)

    def permute(self, t: torch.Tensor,
                perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: rank ``dst`` receives the ``t`` of rank
        ``src`` for each ``(src, dst)`` of ``perm``; a rank that receives
        nothing gets zeros."""
        if self.size == 1:
            src = [s for s, d in perm if d == 0]
            return t if src else torch.zeros_like(t)
        parts = self._exchange(t, "permute")
        src = [s for s, d in perm if d == self.rank]
        return parts[src[0]] if src else torch.zeros_like(t)

    def shard(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's even slice of a replicated ``t`` along ``dim``."""
        if self.size == 1:
            return t
        w = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * w, w)


#: The handle of code that runs outside a runner: one rank, no group.
SOLO = TP(None, 0, torch.device("cpu"))

_LOCAL = threading.local()


class _Frame:
    """One rank's call of a checkpointed layer: its function and inputs,
    how many tensors its forward saved for the backward, and those tensors
    once recomputed (by index; each dropped as the backward reads it)."""

    def __init__(self, fn: Callable, args: tuple, tp: TP):
        self.fn, self.args, self.tp = fn, args, tp
        self.packed = 0
        self.saved: Optional[Dict[int, torch.Tensor]] = None
        self.layer: Optional["_Layer"] = None

    def pack(self, t: torch.Tensor) -> int:
        self.packed += 1
        return self.packed - 1

    def unpack(self, i: int) -> torch.Tensor:
        if self.saved is None:
            if self.layer is None:
                with _as_rank(self.tp), _cuda_device(self.tp.device):
                    self.recompute()
            else:
                self.layer.recompute()
        t = self.saved.pop(i)
        if not self.saved:
            self.saved = None
        return t

    def recompute(self) -> None:
        """Run the layer again with grad enabled, keeping what it saves
        (detached: the recompute's own graph is dropped)."""
        saved: Dict[int, torch.Tensor] = {}

        def keep(t):
            saved[len(saved)] = t.detach()

        def never(_):
            raise RuntimeError("a recomputed layer's own graph is never "
                               "run backward")
        args = tuple(a.detach().requires_grad_(a.requires_grad)
                     if torch.is_tensor(a) else a for a in self.args)
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(keep, never):
            self.fn(*args)
        if len(saved) != self.packed:
            raise RuntimeError(
                f"a recomputed layer saved {len(saved)} tensors, its "
                f"forward {self.packed}: the layer is not deterministic")
        self.saved = saved


class _Layer:
    """Every rank's :class:`_Frame` of one checkpointed call under a runner
    over several ranks: the first frame the backward reaches recomputes
    them all, each rank on a thread started for the recompute, so that
    their collectives exchange as the forward's did."""

    def __init__(self, runner: "RankRunner"):
        self.runner = runner
        self.frames: List[Optional[_Frame]] = [None] * runner.size
        self.lock = threading.Lock()

    def recompute(self) -> None:
        with self.lock:
            if all(f.saved is not None for f in self.frames):
                return
            with torch.enable_grad():      # a call started for the ranks
                self.runner.run(lambda tp: self.frames[tp.me].recompute())


def remat(fn: Callable, *args):
    """``fn(*args)`` under activation checkpointing (``cfg.remat``): the
    forward keeps none of the tensors its backward reads; the backward
    recomputes them when it first reads one, under a runner over several
    ranks every rank's call of this layer together, its collectives run
    again (:class:`_Layer`)."""
    tp = current()
    frame = _Frame(fn, args, tp)
    g = tp.group
    if g is not None:
        with g.lock:
            k = g.remat_calls[tp.me]
            g.remat_calls[tp.me] += 1
            layer = g.remat.setdefault(k, _Layer(g.runner))
            layer.frames[tp.me] = frame
            if all(f is not None for f in layer.frames):
                del g.remat[k]           # every rank's frame holds it
        frame.layer = layer
    with torch.autograd.graph.saved_tensors_hooks(frame.pack, frame.unpack):
        return fn(*args)


def current() -> TP:
    """The calling thread's rank handle (:data:`SOLO` outside a
    :meth:`RankRunner.run`)."""
    return getattr(_LOCAL, "tp", SOLO)


@contextlib.contextmanager
def _as_rank(tp: TP):
    prev = getattr(_LOCAL, "tp", SOLO)
    _LOCAL.tp = tp
    try:
        yield
    finally:
        _LOCAL.tp = prev


class _Group:
    """The state the ranks of one runner share: the double-buffered
    exchange slots (a rank writes a collective's part into one buffer
    while the others may still read the previous collective's from the
    other; it reuses a buffer only after every rank has taken its turn
    since, so no read races a write) and the turn: one lock a rank, held
    while it is not the rank's turn."""

    def __init__(self, runner: "RankRunner", size: int,
                 axis_names: Tuple[str, ...]):
        self.runner = runner
        self.size = size
        self.axis_names = axis_names
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """A fresh start, at every run: every lock held, and rank 0 runs
        first (its turn needs no wait)."""
        self.gen = [0] * self.size
        self.slots = [[None] * self.size, [None] * self.size]
        self.failed = False
        self.remat: Dict[int, "_Layer"] = {}    # calls not every rank made
        self.remat_calls = [0] * self.size
        self.turns = [threading.Lock() for _ in range(self.size)]
        for lock in self.turns:
            lock.acquire()

    def give(self, rank: int) -> None:
        """Hand the turn on from ``rank`` to the next rank."""
        try:
            self.turns[(rank + 1) % self.size].release()
        except RuntimeError:          # a failed run released it already
            pass

    def wait(self, rank: int) -> None:
        """Wait for ``rank``'s turn; raise when another rank failed."""
        if not self.turns[rank].acquire(timeout=BARRIER_TIMEOUT) \
                or self.failed:
            raise _Aborted()

    def handoff(self, rank: int) -> None:
        self.give(rank)
        self.wait(rank)

    def clear(self) -> None:
        """Drop the exchanged parts (after a run: they may be live
        tensors of an autograd graph)."""
        self.slots = [[None] * self.size, [None] * self.size]

    def abort(self) -> None:
        """Wake every rank: each leaves at its next wait."""
        self.failed = True
        for lock in self.turns:
            try:
                lock.release()
            except RuntimeError:
                pass


class _Aborted(RuntimeError):
    """A rank left its collective: another rank failed, or the group
    waited past :data:`BARRIER_TIMEOUT`."""


def _dispatch_modes():
    """The ``TorchDispatchMode`` stack open on the calling thread (the
    sync guard's recorder, say): the workers enter it too, so a mode sees
    every rank's ops."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return list(_get_current_dispatch_mode_stack())


@contextlib.contextmanager
def _entered(modes):
    if not modes:
        yield
        return
    from torch.utils._python_dispatch import _pop_mode, _push_mode
    for m in modes:
        _push_mode(m)
    try:
        yield
    finally:
        for _ in modes:
            _pop_mode()


def _worker(q: "queue.Queue") -> None:
    while True:
        job = q.get()
        if job is None:
            return
        job()
        del job                 # holds the runner: let it be collected


class RankRunner:
    """The ranks of one tensor-parallel group over ``devices`` (one a
    rank, in rank order; a device may repeat), or of a whole ``mesh``
    (``launch.mesh.Mesh``: its devices in the order of
    ``mesh.devices.flat``, each rank's :func:`current` the handle of its
    ``model`` axis group, the other axes through :meth:`TP.over`).

    ``run(fn)`` calls ``fn(tp)`` once a rank, with the rank's :class:`TP`
    also returned by :func:`current` inside it, and returns the list of
    results in rank order. Rank 0 runs on the calling thread, the others
    on persistent worker threads (daemons, stopped when the runner is
    collected); a call with grad enabled outside inference mode (a
    training forward) runs every rank of a runner of several on a thread
    started for the call. Each rank runs under its own
    device (the current CUDA device) and the calling thread's dispatch
    modes, grad mode, inference mode and number of intra-op threads.
    """

    def __init__(self, devices: Optional[Sequence[torch.device]] = None,
                 mesh=None):
        if mesh is not None:
            devices = list(mesh.devices.flat)
            axis_names = tuple(mesh.axis_names)
            shape = tuple(mesh.devices.shape)
        else:
            axis_names, shape = ("model",), (len(devices),)
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.size = len(self.devices)
        if self.size < 1:
            raise ValueError("a rank runner needs at least one device")
        self.axis_names = axis_names
        self.ranks = list(range(self.size))   # the mesh ranks it runs
        self.collectives = 0
        self.bytes = 0
        self._group = (_Group(self, self.size, axis_names)
                       if self.size > 1 else None)
        self.handles = _handles(self._group, self.devices, axis_names,
                                shape)
        self._queues: List[queue.Queue] = []
        for _ in range(1, self.size):
            q: queue.Queue = queue.Queue()
            threading.Thread(target=_worker, args=(q,), daemon=True).start()
            self._queues.append(q)
        weakref.finalize(self, _stop, list(self._queues))

    def run(self, fn: Callable[[TP], object]) -> list:
        if self.size == 1:
            with _as_rank(self.handles[0]):
                return [fn(self.handles[0])]
        g = self._group
        g.reset()
        results: list = [None] * self.size
        errors: list = [None] * self.size
        done = [threading.Event() for _ in range(1, self.size)]
        modes = _dispatch_modes()
        threads = torch.get_num_threads()
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        fresh = grad and not inference        # a training forward

        def call(r):
            tp = self.handles[r]
            away = bool(r) or fresh           # not on the calling thread
            try:
                if r:
                    g.wait(r)
                if away and torch.get_num_threads() != threads:
                    # the caller's intra-op threads (CPU ranks): a new
                    # thread would start its own pool of every core
                    torch.set_num_threads(threads)
                with _as_rank(tp), _cuda_device(tp.device), _entered(
                        modes if away else ()), _grad_mode(grad, inference):
                    results[r] = fn(tp)
            except BaseException as e:     # noqa: BLE001 -- re-raised below
                errors[r] = e
                g.abort()
            else:
                g.give(r)

        if fresh:
            started = [threading.Thread(target=call, args=(r,),
                                        daemon=True)
                       for r in range(self.size)]
            for th in started:
                th.start()
            for th in started:
                th.join()
        else:
            for r in range(1, self.size):
                self._queues[r - 1].put(
                    lambda r=r: (call(r), done[r - 1].set()))
            call(0)
            for ev in done:
                ev.wait()
        g.clear()
        first = next((e for e in errors
                      if e is not None and not isinstance(e, _Aborted)),
                     None)
        if first is None:
            first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


class _Costed(torch.autograd.Function):
    """A collective of the one-rank runner: an empty result of the given
    shape on the operand's device, its operand's bytes recorded; the
    backward records the transposed collective (``back``) on the
    incoming gradient."""

    @staticmethod
    def forward(ctx, t, tp, kind, back, shape):
        ctx.tp, ctx.back, ctx.in_shape = tp, back, tuple(t.shape)
        tp._record(kind, t)
        return t.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        ctx.tp._record(ctx.back, g)
        return g.new_empty(ctx.in_shape), None, None, None, None


class _CostTP(TP):
    """Rank 0's handle on one axis group of a :class:`CostRunner`: the
    group's ``size``, and collectives that exchange nothing."""

    def __init__(self, runner: "CostRunner", size: int,
                 device: torch.device):
        super().__init__(None, 0, device, tuple(range(size)), 0)
        self.runner = runner

    @property
    def world(self) -> int:
        return self.runner.world

    def over(self, *axes: str) -> TP:
        names = tuple(a for a in self.runner.axis_names if a in axes)
        return self._views[names]

    def _record(self, kind: str, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        record_collective(kind, n, 0)
        self.runner.collectives += 1
        self.runner.bytes += n * self.size

    def _costed(self, t, kind, back, shape):
        return _Costed.apply(t, self, kind, back, tuple(shape))

    def all_reduce(self, t):
        if self.size == 1:
            return t
        return self._costed(t, "all-reduce", "all-reduce", t.shape)

    def all_gather(self, t, dim=-1):
        if self.size == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= self.size
        return self._costed(t, "all-gather", "reduce-scatter", shape)

    def all_to_all(self, t, split_dim, cat_dim):
        if self.size == 1:
            return t
        shape = list(t.shape)
        shape[split_dim] //= self.size
        shape[cat_dim] *= self.size
        return self._costed(t, "all-to-all", "all-to-all", shape)

    def permute(self, t, perm):
        if self.size == 1:
            return TP.permute(self, t, perm)
        return self._costed(t, "permute", "permute", t.shape)


class CostRunner:
    """The one-rank runner of the dry run: over ``mesh`` it runs only the
    rank at coordinate 0 of every axis (``ranks == [0]``), on the mesh's
    first device; its handles' sizes are the mesh's, their collectives
    return empty tensors of the result's shape and record their operand
    bytes in every open ``launch.op_cost.OpCost`` (and ``collectives`` /
    ``bytes`` here: ``bytes`` counts every rank's part, as
    :class:`RankRunner`'s). ``run(fn)`` returns ``[fn(tp)]``. Takes a
    :class:`RankRunner`'s place wherever a runner is passed."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.axis_names)
        shape = tuple(mesh.devices.shape)
        self.world = int(mesh.devices.size)
        self.devices = [_indexed(torch.device(mesh.devices.flat[0]))]
        self.size = 1
        self.ranks = [0]
        self.collectives = 0
        self.bytes = 0
        views: Dict[Tuple[str, ...], TP] = {}
        for mask in itertools.product((False, True),
                                      repeat=len(shape)):
            names = tuple(a for a, keep in zip(self.axis_names, mask)
                          if keep)
            size = 1
            for a, n, keep in zip(self.axis_names, shape, mask):
                size *= n if keep else 1
            views[names] = _CostTP(self, size, self.devices[0])
        for tp in views.values():
            tp._views = views
        model = ("model",) if "model" in self.axis_names else ()
        self.handles = [views[model]]

    def run(self, fn: Callable[[TP], object]) -> list:
        tp = self.handles[0]
        with _as_rank(tp), _cuda_device(tp.device):
            return [fn(tp)]


def _handles(group, devices, axis_names, shape) -> List[TP]:
    """Every rank's handle on its ``model`` axis group, each carrying its
    handles on every other combination of axes (:meth:`TP.over`)."""
    n = len(devices)
    coords = list(itertools.product(*[range(k) for k in shape]))
    subsets = [tuple(a for a, keep in zip(axis_names, mask) if keep)
               for mask in itertools.product((False, True),
                                             repeat=len(axis_names))]
    views: List[Dict[Tuple[str, ...], TP]] = [{} for _ in range(n)]
    for names in subsets:
        groups: Dict[tuple, List[int]] = {}
        for r, c in enumerate(coords):
            key = tuple(c[i] for i, a in enumerate(axis_names)
                        if a not in names)
            groups.setdefault(key, []).append(r)   # row-major over names
        for members in groups.values():
            for idx, r in enumerate(members):
                views[r][names] = TP(group, idx, devices[r], members, r)
    model = ("model",) if "model" in axis_names else ()
    out = []
    for r in range(n):
        for tp in views[r].values():
            tp._views = views[r]
        out.append(views[r][model])
    return out


@contextlib.contextmanager
def _grad_mode(grad: bool, inference: bool):
    if inference:
        with torch.inference_mode():
            yield
    else:
        with torch.set_grad_enabled(grad):
            yield


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so a rank's inputs that lie there
    compare equal to its device (:meth:`TP.local` moves nothing)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _cuda_device(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _stop(queues) -> None:
    for q in queues:
        q.put(None)
