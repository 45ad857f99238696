"""Paged KV cache for the continuous-batching engine (port of
``repro.serve.kv_cache``, without prefix caching and copy-on-write;
ROADMAP.md queue A lists them).

  * :class:`PageAllocator` — host-side free list over physical page ids;
    raises :class:`PagePoolExhausted` when a request cannot be satisfied.
  * :class:`PageTable` — host-side slot -> page bookkeeping: one row of
    logical -> physical page ids per slot (``-1`` = unallocated), grown as
    a slot's sequence crosses page boundaries and trimmed back when a
    speculative round rejects draft rows.
  * :class:`PagedKVCache` — the device pool (``Model.init_paged_cache``)
    plus a :class:`PageTable`. KV lives in a shared pool of fixed-size
    pages, so memory scales with live tokens, not slots x max_seq. With a
    KV codebook the pages hold uint8 centroid codes instead of fp rows;
    the byte accounting reads the pool arrays, so it follows either.

One extra physical page, the last one, is never handed out: the *trash
page*. Writes of padded prefill positions and of lanes that are not
decoding go there, so the write path needs no masking.

The pool is a pair of torch tensors that the model updates in place
(the JAX engine instead donates the old buffer to each jitted step).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


class PagePoolExhausted(RuntimeError):
    """A page allocation cannot be satisfied (the message carries the
    pool's state)."""


class PageAllocator:
    """Free-list allocator over ``num_pages`` physical page ids.

    ``alloc`` is all-or-nothing. Freeing a page that is not allocated is
    an error (double free), never a silent corruption.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = num_pages
        # pop() from the tail: pages are handed out in ascending id order
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._used = [False] * num_pages

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages; raises without allocating if short."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"requested {n} page(s) but only {self.available} of "
                f"{self.num_pages} are free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._used[p] = True
        return out

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 <= p < self.num_pages) or not self._used[p]:
                raise ValueError(f"double free or invalid page id {p}")
            self._used[p] = False
            self._free.append(p)


class PageTable:
    """Host-side slot -> physical-page mapping.

    Row ``s`` maps slot ``s``'s logical pages (token positions
    ``[i*page_size, (i+1)*page_size)``) to physical page ids; ``-1`` marks
    an unallocated page. The device copy is cached and dropped on every
    change (allocation happens a few times per request, not per token).
    """

    def __init__(self, num_slots: int, max_seq: int, page_size: int,
                 num_pages: Optional[int] = None):
        if max_seq % page_size:
            raise ValueError(
                f"max_seq ({max_seq}) must be a multiple of page_size "
                f"({page_size})")
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = max_seq // page_size
        if num_pages is None:
            num_pages = num_slots * self.pages_per_slot
        self.allocator = PageAllocator(num_pages)
        self.table = np.full((num_slots, self.pages_per_slot), -1, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self._dev: Optional[torch.Tensor] = None

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens."""
        return max(1, math.ceil(n_tokens / self.page_size))

    @property
    def live_pages(self) -> int:
        return self.allocator.in_use

    def occupancy(self) -> str:
        """One-line pool accounting for capacity errors."""
        return (f"pool: {self.live_pages} live, {self.allocator.available} "
                f"free of {self.allocator.num_pages} pages "
                f"({self.page_size} tokens each)")

    def can_fit(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= self.allocator.available

    def check_admissible(self, n_tokens: int) -> None:
        """Raise if a request of ``n_tokens`` could NEVER be served: longer
        than ``max_seq``, or needing more pages than the pool has."""
        if n_tokens > self.max_seq:
            raise PagePoolExhausted(
                f"request of {n_tokens} tokens exceeds max_seq="
                f"{self.max_seq} (pages_per_slot={self.pages_per_slot})")
        if self.pages_for(n_tokens) > self.allocator.num_pages:
            raise PagePoolExhausted(
                f"request of {n_tokens} tokens needs "
                f"{self.pages_for(n_tokens)} pages but the pool only has "
                f"{self.allocator.num_pages} ({self.occupancy()})")

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot ``slot`` to cover positions ``[0, n_tokens)``
        (all-or-nothing; raises :class:`PagePoolExhausted`)."""
        need = self.pages_for(n_tokens)
        if need > self.pages_per_slot:
            raise PagePoolExhausted(
                f"slot {slot}: {n_tokens} tokens exceed max_seq="
                f"{self.max_seq} ({self.occupancy()})")
        have = len(self._slot_pages[slot])
        if need <= have:
            return
        try:
            new = self.allocator.alloc(need - have)
        except PagePoolExhausted as e:
            raise PagePoolExhausted(f"{e} ({self.occupancy()})") from None
        self.table[slot, have:need] = new
        self._slot_pages[slot].extend(new)
        self._dev = None

    def release(self, slot: int) -> None:
        """Evict a slot: its pages return to the pool, its row clears."""
        if self._slot_pages[slot]:
            self.allocator.free(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.table[slot, :] = -1
            self._dev = None

    def trim(self, slot: int, n_tokens: int) -> int:
        """Shrink slot ``slot`` to the pages covering ``n_tokens`` tokens
        (speculative-decoding rollback: rejected draft rows past the
        accepted position may leave whole tail pages unused). Only pages
        wholly above the keep mark are freed. Returns how many."""
        keep = 0 if n_tokens <= 0 else self.pages_for(n_tokens)
        row = self._slot_pages[slot]
        if len(row) <= keep:
            return 0
        dropped = row[keep:]
        del row[keep:]
        self.allocator.free(dropped)
        self.table[slot, keep:] = -1
        self._dev = None
        return len(dropped)

    def device(self, device) -> torch.Tensor:
        """(num_slots, pages_per_slot) int32 copy on ``device`` (cached)."""
        if self._dev is None:
            self._dev = torch.from_numpy(self.table.copy()).to(device)
        return self._dev


class PagedKVCache:
    """The device pool + page table of one engine.

    ``data`` is ``{"k": (L, P+1, page, KVH, HD), "v": ...}``, or with a
    ``codebook`` uint8 codes ``(L, P+1, page, KVH, nc)`` plus the
    codebook under ``CODEBOOK_KEY``; the final page is the trash page.
    """

    def __init__(self, model, num_slots: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 codebook=None):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.device = model.device
        self.table = PageTable(num_slots, max_seq, page_size, num_pages)
        self.data = model.init_paged_cache(
            max_seq, page_size, self.table.allocator.num_pages,
            codebook=codebook)

    @property
    def bytes_per_token(self) -> int:
        """Device bytes ONE cached token occupies across k+v and all
        layers, read from the pool arrays (fp rows or uint8 codes)."""
        total = 0
        for key in ("k", "v"):
            t = self.data[key]                  # (L, P+1, page, KVH, W)
            l, _, _, kvh, w = t.shape
            total += l * kvh * w * t.element_size()
        return total

    @property
    def page_bytes(self) -> int:
        """Bytes one physical page pins across k+v and all layers."""
        return self.bytes_per_token * self.page_size

    @property
    def pool_bytes(self) -> int:
        """Allocatable pool capacity in bytes (the trash page excluded:
        it is never handed out)."""
        return self.page_bytes * self.table.allocator.num_pages

    def trim(self, slot: int, n_tokens: int) -> int:
        """Speculative rollback: free the slot's tail pages past
        ``n_tokens`` (:meth:`PageTable.trim`)."""
        return self.table.trim(slot, n_tokens)

    def table_device(self) -> torch.Tensor:
        return self.table.device(self.device)

