"""Collectives and the rank runner of a tensor-parallel engine.

The JAX package drives a whole mesh from one Python process and GSPMD
inserts the collectives. The port keeps the one controller: a
tensor-parallel group is one :class:`RankRunner` of ``size`` ranks, each
holding its local shard on its device. :meth:`RankRunner.run` calls the
model's layer code once a rank, rank 0 on the calling thread and every
other rank on a worker thread of its own (as ``nn.DataParallel``'s
``parallel_apply`` does). The layer code sees only its shard and calls
the rank's :class:`TP` handle (:func:`current`) at the points where GSPMD
inserts a collective in the reference:

  * :meth:`TP.all_reduce` sums every rank's tensor in rank order (0, 1,
    ...), so every rank holds the same bits and a run reproduces;
  * :meth:`TP.all_gather` concatenates them along a dim in rank order.

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

This module is the one seam for a multi-process backend: a
``torch.distributed`` (NCCL) group would implement the same :class:`TP`
methods, one process a rank, for serving across hosts (ROADMAP.md queue
A item 11).

Counters: ``RankRunner.collectives`` counts collectives (one per call of
all ranks) and ``RankRunner.bytes`` the bytes they gathered (the sum of
every rank's contribution), for the ``scale`` phase of ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from typing import Callable, List, Optional, Sequence

import torch

#: Seconds a rank waits for its turn before the call raises (a rank stuck
#: for this long is a bug).
BARRIER_TIMEOUT = 600.0


class TP:
    """One rank's handle on its tensor-parallel group: ``rank``, ``size``,
    ``device`` and the collectives."""

    def __init__(self, group: Optional["_Group"], rank: int,
                 device: torch.device):
        self.group = group
        self.rank = rank
        self.device = device

    @property
    def size(self) -> int:
        return 1 if self.group is None else self.group.size

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on this rank's device (itself when it lies there): the
        engine's replicated step inputs."""
        return t if t.device == self.device else t.to(self.device)

    def _exchange(self, t: torch.Tensor) -> List[torch.Tensor]:
        g = self.group
        buf = g.slots[g.gen[self.rank] % 2]
        g.gen[self.rank] += 1
        buf[self.rank] = t
        if self.rank == 0:
            g.runner.collectives += 1
        g.handoff(self.rank)
        parts = list(buf)
        if self.rank == 0:
            g.runner.bytes += sum(p.numel() * p.element_size()
                                  for p in parts)
        return [self.local(p) for p in parts]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order."""
        if self.size == 1:
            return t
        parts = self._exchange(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        return torch.cat(self._exchange(t), dim=dim)

    def shard(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's even slice of a replicated ``t`` along ``dim``."""
        if self.size == 1:
            return t
        w = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * w, w)


#: The handle of code that runs outside a runner: one rank, no group.
SOLO = TP(None, 0, torch.device("cpu"))

_LOCAL = threading.local()


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

    def __init__(self, runner: "RankRunner", size: int):
        self.runner = runner
        self.size = size
        self.reset()

    def reset(self) -> None:
        """A fresh start, at every run: every lock held, and rank 0 runs
        first (its turn needs no wait)."""
        self.gen = [0] * self.size
        self.slots = [[None] * self.size, [None] * self.size]
        self.failed = False
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
    rank, in rank order; a device may repeat).

    ``run(fn)`` calls ``fn(tp)`` once a rank, with the rank's :class:`TP`
    also returned by :func:`current` inside it, and returns the list of
    results in rank order. Rank 0 runs on the calling thread, the others
    on persistent worker threads (daemons, stopped when the runner is
    collected). Each rank runs under its own device (the current CUDA
    device), the calling thread's dispatch modes and its number of
    intra-op threads.
    """

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.size = len(self.devices)
        if self.size < 1:
            raise ValueError("a rank runner needs at least one device")
        self.collectives = 0
        self.bytes = 0
        self._group = _Group(self, self.size) if self.size > 1 else None
        self.handles = [TP(self._group, r, d)
                        for r, d in enumerate(self.devices)]
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

        def call(r):
            tp = self.handles[r]
            try:
                if r:
                    g.wait(r)
                    if torch.get_num_threads() != threads:
                        # the caller's intra-op threads (CPU ranks): a
                        # worker would start its own pool of every core
                        torch.set_num_threads(threads)
                with _as_rank(tp), _cuda_device(tp.device), _entered(
                        modes if r else ()):
                    results[r] = fn(tp)
            except BaseException as e:     # noqa: BLE001 -- re-raised below
                errors[r] = e
                g.abort()
            else:
                g.give(r)

        for r in range(1, self.size):
            self._queues[r - 1].put(
                lambda r=r: (call(r), done[r - 1].set()))
        call(0)
        for ev in done:
            ev.wait()
        first = next((e for e in errors
                      if e is not None and not isinstance(e, _Aborted)),
                     None)
        if first is None:
            first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


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
