"""Paged KV cache for the continuous-batching engine, with automatic
prefix caching and copy-on-write (port of ``repro.serve.kv_cache``).

  * :class:`PageAllocator`: host-side ref-counted free list over physical
    page ids; raises :class:`PagePoolExhausted` when a request cannot be
    satisfied.
  * :class:`PageTable`: host-side slot -> page bookkeeping: one row of
    logical -> physical page ids per slot (``-1`` = unallocated), grown
    as a slot's sequence crosses page boundaries and trimmed back when a
    speculative round rejects draft rows.
  * :class:`PagedKVCache`: the device pool (``Model.init_paged_cache``)
    plus a :class:`PageTable`. KV lives in a shared pool of fixed-size
    pages, so memory scales with live tokens, not slots x max_seq. With a
    KV codebook the pages hold uint8 centroid codes instead of fp rows;
    the byte accounting reads the pool tensors, so it follows either.

One extra physical page, the last one, is never handed out: the *trash
page*. Writes of padded prefill positions and of lanes that are not
decoding go there, so the write path needs no masking.

Prefix caching rides on top: pages carry reference counts, every *fully
written* prompt page is indexed by a chained content hash of the token
ids it covers (a hash trie at page granularity), and a newly admitted
request whose prompt shares a page-aligned prefix maps the matching
pages into its row read-shared instead of recomputing their KV.
Unreferenced but indexed pages park in an LRU (:class:`PrefixCache`) and
are reclaimed lazily: eviction drops a reference, it does not free. The
keys are built from Python ints only, so a lookup reads nothing from
the card.

The pool is a pair of torch tensors that the model updates in place
(the JAX engine instead donates the old buffer to each jitted step); a
copy-on-write fork copies one page in place too.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class PagePoolExhausted(RuntimeError):
    """A page allocation cannot be satisfied (the message carries the
    pool's state)."""


class PageAllocator:
    """Ref-counted free list over ``num_pages`` physical page ids.

    ``alloc`` is all-or-nothing and hands out pages with refcount 1. A
    page mapped into several rows holds one reference per row. ``free``
    drops one reference and returns the page to the free list when the
    last one goes; dropping a reference a page does not hold is an error
    (double free), never a silent corruption.

    A page can also be *parked* with refcount 0: the prefix cache keeps
    unreferenced but indexed pages off the free list (their KV stays
    valid for later hits) and hands them back with :meth:`restore` when
    reclaimed, or re-activates them with :meth:`revive` on a hit.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = num_pages
        # pop() from the tail: pages are handed out in ascending id order
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def _check(self, p: int) -> None:
        if not (0 <= p < self.num_pages):
            raise ValueError(f"invalid page id {p}")

    def refcount(self, p: int) -> int:
        self._check(p)
        return self._ref[p]

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages (refcount 1 each); raises without
        allocating if short."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"requested {n} page(s) but only {self.available} of "
                f"{self.num_pages} are free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def incref(self, p: int) -> int:
        """Add a reference to a live page (refcount must be >= 1)."""
        self._check(p)
        if self._ref[p] <= 0:
            raise ValueError(
                f"incref on page {p} with refcount {self._ref[p]} "
                f"(revive() is the path for parked cached pages)")
        self._ref[p] += 1
        return self._ref[p]

    def decref(self, p: int) -> int:
        """Drop one reference; returns the new count. Does not free: the
        caller chooses between the free list and the prefix LRU at zero.
        A refcount-0 page raises (double free)."""
        self._check(p)
        if self._ref[p] <= 0:
            raise ValueError(
                f"double free: page {p} has refcount {self._ref[p]}")
        self._ref[p] -= 1
        return self._ref[p]

    def free(self, pages: List[int]) -> None:
        """Decref each page; a page whose last reference drops returns to
        the free list (exactly once: a second free raises)."""
        for p in pages:
            if self.decref(p) == 0:
                self._free.append(p)

    def revive(self, p: int) -> None:
        """Re-activate a parked refcount-0 page (prefix-cache hit); the
        page is not on the free list, it gains its first reference."""
        self._check(p)
        if self._ref[p] != 0:
            raise ValueError(
                f"revive on page {p} with refcount {self._ref[p]}")
        self._ref[p] = 1

    def restore(self, p: int) -> None:
        """Return a parked refcount-0 page to the free list (the prefix
        cache reclaimed it; its cached content is dropped)."""
        self._check(p)
        if self._ref[p] != 0:
            raise ValueError(
                f"restore on page {p} with refcount {self._ref[p]}")
        self._free.append(p)


def _chunk_keys(tokens, page_size: int,
                salt: int = 0) -> List[Tuple[int, tuple]]:
    """Chained content keys of ``tokens`` at page granularity.

    Key ``i`` is ``(hash(key_{i-1}), chunk_i_token_tuple)`` and covers
    tokens ``[0, (i+1)*page_size)``: the chain makes a page stand for its
    whole prefix (KV at position p depends on every token <= p). A lookup
    compares the page's own tokens exactly; ancestry rides on the chained
    64-bit parent hash. Only full pages are keyed.

    ``salt`` seeds the chain. A code pool stores codebook indices, which
    are comparable only under the codebook that produced them: seeding
    with the codebook's fingerprint puts pages written under different
    codebooks (or a code pool against an fp pool) in disjoint key spaces.
    Python's hash of a tuple of ints is fixed (no per-process seed), so
    the keys equal the JAX package's for the same tokens and salt.
    """
    out: List[Tuple[int, tuple]] = []
    h = salt
    for i in range(len(tokens) // page_size):
        key = (h, tuple(int(t) for t in
                        tokens[i * page_size:(i + 1) * page_size]))
        out.append(key)
        h = hash(key)
    return out


@dataclasses.dataclass
class PrefixMatch:
    """Reuse plan for one prompt against the prefix index.

    ``pages`` are mapped read-shared into the new slot's row; ``tokens``
    prompt tokens skip prefill. ``cow_page`` is set when indexed pages
    cover the whole prompt: the last prompt token must still run prefill
    (its logits seed decode), and its KV write would land inside the last
    shared page, so that page is forked (copy-on-write) instead.
    """
    tokens: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)
    cow_page: Optional[int] = None

    @property
    def reused_pages(self) -> int:
        return len(self.pages)


class PrefixCache:
    """Content-keyed index over full KV pages + LRU of unreferenced pages.

    ``(parent_hash, chunk_tokens) -> page`` lookups drive prefix matching
    (exact tuple comparison; see :func:`_chunk_keys`); the LRU keeps pages
    whose refcount dropped to zero off the free list so their content can
    still be shared, and gives up the oldest when the allocator runs dry.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._page_of: Dict[Tuple[int, tuple], int] = {}   # key -> page id
        self._key_of: Dict[int, Tuple[int, tuple]] = {}    # page id -> key
        self._lru: "OrderedDict[int, None]" = OrderedDict()

    def lookup(self, key: Tuple[int, tuple]) -> Optional[int]:
        return self._page_of.get(key)

    def is_registered(self, page: int) -> bool:
        return page in self._key_of

    def register(self, key: Tuple[int, tuple], page: int) -> None:
        if key in self._page_of or page in self._key_of:
            raise ValueError(f"page {page} / key already registered")
        self._page_of[key] = page
        self._key_of[page] = key

    def unregister(self, page: int) -> None:
        """Drop a page's index entry (and its LRU place, if parked)."""
        key = self._key_of.pop(page, None)
        if key is not None:
            self._page_of.pop(key, None)
        self._lru.pop(page, None)

    def park(self, page: int) -> None:
        """An indexed page lost its last reference: keep it (LRU)."""
        self._lru[page] = None
        self._lru.move_to_end(page)

    def unpark(self, page: int) -> None:
        """An indexed parked page regained a reference."""
        self._lru.pop(page, None)

    def pop_lru(self) -> int:
        """Reclaim the least recently parked page (drops its index)."""
        page = next(iter(self._lru))
        self.unregister(page)
        return page

    @property
    def reclaimable(self) -> int:
        """Parked pages the allocator may reclaim under pressure."""
        return len(self._lru)


class PageTable:
    """Host-side slot -> physical-page mapping.

    Row ``s`` maps slot ``s``'s logical pages (token positions
    ``[i*page_size, (i+1)*page_size)``) to physical page ids; ``-1`` marks
    an unallocated page. The device copy is cached and dropped on every
    change to a row (a few times per request, not per token).
    """

    def __init__(self, num_slots: int, max_seq: int, page_size: int,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = True, content_salt: int = 0):
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
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(page_size) if prefix_cache else None)
        self.table = np.full((num_slots, self.pages_per_slot), -1, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        # seed of the content-hash chain (see _chunk_keys): pages written
        # under different pool encodings must never alias
        self.content_salt = content_salt
        # bytes per physical page across k+v and all layers, set by
        # PagedKVCache from the pool tensors; 0 = unknown (a bare table)
        self.page_bytes = 0
        # per-slot registration cursor (full pages hashed, chain hash), so
        # register_prefix resumes mid-prompt instead of rehashing
        self._reg_state: List[Tuple[int, int]] = [
            (0, content_salt)] * num_slots
        self._dev: Optional[torch.Tensor] = None

    # -- capacity queries ---------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens."""
        return max(1, math.ceil(n_tokens / self.page_size))

    @property
    def available_pages(self) -> int:
        """Free pages plus parked cached pages (reclaimable on demand)."""
        extra = self.prefix.reclaimable if self.prefix is not None else 0
        return self.allocator.available + extra

    @property
    def pressure(self) -> float:
        """Pool pressure in ``[0, 1]``: the fraction of physical pages
        that could NOT go to a new allocation now (live slot-referenced
        pages; parked prefix pages are reclaimable and count as
        capacity). 1.0 = no sequence can grow without preempting. The
        engine's degradation ladder steps on this signal."""
        return 1.0 - self.available_pages / self.allocator.num_pages

    def occupancy(self) -> str:
        """One-line pool accounting for capacity errors and preemption
        logs: live, cached-parked and free pages, with their bytes when
        :attr:`page_bytes` is known (a code pool's pages are 4-16x
        smaller than fp pages)."""
        pages = (f"pool: {self.live_pages} live, "
                 f"{self.prefix.reclaimable if self.prefix else 0} "
                 f"cached-parked, {self.allocator.available} free of "
                 f"{self.allocator.num_pages} pages "
                 f"({self.page_size} tokens each)")
        if not self.page_bytes:
            return pages
        mib = self.page_bytes / (1 << 20)
        return (f"{pages}; {self.live_pages * mib:.2f} MiB live of "
                f"{self.allocator.num_pages * mib:.2f} MiB "
                f"({self.page_bytes} B/page)")

    def can_fit(self, n_tokens: int,
                match: Optional[PrefixMatch] = None) -> bool:
        """Whether ``n_tokens`` tokens' pages could be allocated now.

        With a ``match`` only the UNSHARED pages count against capacity
        (matched pages are mapped by reference), but matched pages that
        are parked stop being reclaimable once adopted, so they come off
        the available side."""
        need = self.pages_for(n_tokens)
        avail = self.available_pages
        if match is not None and self.prefix is not None:
            need -= match.reused_pages
            parked = self.prefix._lru
            cand = match.pages + (
                [match.cow_page] if match.cow_page is not None else [])
            avail -= sum(1 for p in cand if p in parked)
        return need <= avail

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

    # -- changes ------------------------------------------------------------
    def _alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh pages, reclaiming parked cached pages
        (oldest first) when the free list runs short."""
        if self.prefix is not None:
            while (self.allocator.available < n
                   and self.prefix.reclaimable):
                self.allocator.restore(self.prefix.pop_lru())
        try:
            return self.allocator.alloc(n)
        except PagePoolExhausted as e:
            raise PagePoolExhausted(f"{e} ({self.occupancy()})") from None

    def _retain(self, page: int) -> None:
        """Take a reference on a cached page: a parked page is revived out
        of the LRU, a live page increfed."""
        if self.allocator.refcount(page) == 0:
            self.prefix.unpark(page)
            self.allocator.revive(page)
        else:
            self.allocator.incref(page)

    def _release_page(self, page: int) -> None:
        """Drop one reference; an unreferenced page parks in the prefix
        LRU when indexed (its content stays shareable) and returns to the
        free list otherwise."""
        if self.allocator.decref(page) == 0:
            if self.prefix is not None and self.prefix.is_registered(page):
                self.prefix.park(page)
            else:
                self.allocator.restore(page)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot ``slot`` to cover positions ``[0, n_tokens)``
        (all-or-nothing; raises :class:`PagePoolExhausted`, and the caller
        decides whether to wait or preempt)."""
        need = self.pages_for(n_tokens)
        if need > self.pages_per_slot:
            raise PagePoolExhausted(
                f"slot {slot}: {n_tokens} tokens exceed max_seq="
                f"{self.max_seq} ({self.occupancy()})")
        have = len(self._slot_pages[slot])
        if need <= have:
            return
        new = self._alloc(need - have)
        self.table[slot, have:need] = new
        self._slot_pages[slot].extend(new)
        self._dev = None

    def release(self, slot: int) -> None:
        """Evict a slot: drop its references, clear its row. Pages another
        slot still references stay live; unreferenced indexed pages park
        for later hits; the rest return to the pool."""
        if self._slot_pages[slot]:
            for p in self._slot_pages[slot]:
                self._release_page(p)
            self._slot_pages[slot] = []
            self.table[slot, :] = -1
            self._dev = None
        self._reg_state[slot] = (0, self.content_salt)

    def trim(self, slot: int, n_tokens: int) -> int:
        """Shrink slot ``slot`` to the pages covering ``n_tokens`` tokens
        (speculative rollback: rejected draft rows past the accepted
        position may leave whole tail pages unused). Only pages wholly
        above the keep mark go, each through :meth:`_release_page`: a
        page another slot references only loses this slot's reference,
        and an indexed page parks. (A draft tail page is in practice a
        fresh refcount-1 page: shared prefix pages lie below
        ``slot.pos``, and prefill never rolls back.) Returns how many
        pages left the row."""
        keep = 0 if n_tokens <= 0 else self.pages_for(n_tokens)
        row = self._slot_pages[slot]
        if len(row) <= keep:
            return 0
        dropped = row[keep:]
        del row[keep:]
        for p in dropped:
            self._release_page(p)
        self.table[slot, keep:] = -1
        self._dev = None
        return len(dropped)

    # -- prefix caching -----------------------------------------------------
    def match_prefix(self, tokens) -> PrefixMatch:
        """Plan (read-only) the longest page-aligned prefix reuse of a
        prompt: consecutive indexed pages from position 0. The last prompt
        token always runs prefill, so a full-prompt match turns its last
        page into a copy-on-write fork (see :class:`PrefixMatch`)."""
        m = PrefixMatch()
        if self.prefix is None or len(tokens) <= 1:
            return m
        for key in _chunk_keys(tokens, self.page_size, self.content_salt):
            page = self.prefix.lookup(key)
            if page is None:
                break
            m.pages.append(page)
        m.tokens = len(m.pages) * self.page_size
        if m.pages and m.tokens >= len(tokens):
            m.cow_page = m.pages.pop()
            m.tokens = len(tokens) - 1
        return m

    def adopt_prefix(self, slot: int,
                     match: PrefixMatch) -> Optional[Tuple[int, int]]:
        """Map a :class:`PrefixMatch` into an empty slot row.

        Matched pages gain a reference (revived out of the LRU when
        parked) and enter the row read-shared. A ``cow_page`` is forked: a
        fresh page takes its place and ``(src, dst)`` comes back for the
        caller to copy the donor's KV on the device; the donor keeps its
        index entry. Raises :class:`PagePoolExhausted` (after rolling the
        row back) if the fork cannot be allocated."""
        if not match.pages and match.cow_page is None:
            return None
        if self._slot_pages[slot]:
            raise ValueError(f"adopt_prefix on non-empty slot {slot}")
        row = self._slot_pages[slot]
        for p in match.pages:
            self._retain(p)
            self.table[slot, len(row)] = p
            row.append(p)
        pair = None
        if match.cow_page is not None:
            src = match.cow_page
            self._retain(src)        # pin: _alloc's reclaim must not take it
            try:
                dst = self._alloc(1)[0]
            except PagePoolExhausted:
                self._release_page(src)
                self.release(slot)   # roll back the shared mappings
                raise
            self.table[slot, len(row)] = dst
            row.append(dst)
            self._release_page(src)  # unpin (back to the LRU if unshared)
            pair = (src, dst)
        self._dev = None
        return pair

    def register_prefix(self, slot: int, tokens, n_covered: int) -> None:
        """Index the slot's fully written prompt pages by content key.

        ``n_covered`` tokens of ``tokens`` have their KV written (prefill
        progress); every full page below that mark becomes shareable.
        First writer wins: keys already indexed (this slot's own shared
        pages too) are skipped. Incremental: the per-slot cursor resumes
        the hash chain where the previous chunk left it, so a prompt is
        hashed once."""
        if self.prefix is None:
            return
        ps = self.page_size
        n_full = min(n_covered, len(tokens)) // ps
        done, h = self._reg_state[slot]
        if n_full <= done:
            return
        row = self._slot_pages[slot]
        for i in range(done, n_full):
            key = (h, tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            h = hash(key)
            if self.prefix.lookup(key) is None \
                    and not self.prefix.is_registered(row[i]):
                self.prefix.register(key, row[i])
        self._reg_state[slot] = (n_full, h)

    # -- device view --------------------------------------------------------
    def device(self, device) -> torch.Tensor:
        """(num_slots, pages_per_slot) int32 copy on ``device`` (cached)."""
        if self._dev is None:
            self._dev = torch.from_numpy(self.table.copy()).to(device)
        return self._dev

    @property
    def live_pages(self) -> int:
        """Pages referenced by at least one slot. Parked cached pages
        (refcount 0, held only by the prefix LRU) are free capacity and
        are not counted."""
        parked = self.prefix.reclaimable if self.prefix is not None else 0
        return self.allocator.in_use - parked

    @property
    def cached_pages(self) -> int:
        """Pages the prefix cache indexes (live + parked)."""
        return len(self.prefix._key_of) if self.prefix is not None else 0


class PagedKVCache:
    """The device pool + page table of one engine.

    ``data`` is ``{"k": (L, P+1, page, KVH, HD), "v": ...}``, or with a
    ``codebook`` uint8 codes ``(L, P+1, page, KVH, nc)`` plus the
    codebook under ``CODEBOOK_KEY``; the final page is the trash page.
    A code pool salts the prefix keys with the codebook's fingerprint
    (computed once here, so no lookup reads the card).
    """

    def __init__(self, model, num_slots: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 codebook=None, prefix_cache: bool = True):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.device = model.device
        self.codebook = codebook
        salt = codebook.fingerprint() if codebook is not None else 0
        self.table = PageTable(num_slots, max_seq, page_size, num_pages,
                               prefix_cache=prefix_cache, content_salt=salt)
        self.data = model.init_paged_cache(
            max_seq, page_size, self.table.allocator.num_pages,
            codebook=codebook)
        self.cow_forks = 0
        # set by the Engine: forks annotate the owning replica's trace
        # track; None outside an engine
        self.obs = None
        self.table.page_bytes = self.page_bytes

    # -- byte accounting ----------------------------------------------------
    @property
    def bytes_per_token(self) -> int:
        """Device bytes ONE cached token occupies across k+v and all
        layers, read from the pool tensors (fp rows or uint8 codes)."""
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

    @property
    def live_bytes(self) -> int:
        """Bytes pinned by slot-referenced pages now."""
        return self.page_bytes * self.table.live_pages

    @property
    def pressure(self) -> float:
        """Pool pressure in ``[0, 1]`` (:attr:`PageTable.pressure`)."""
        return self.table.pressure

    @property
    def live_pages(self) -> int:
        return self.table.live_pages

    def pages_for(self, n: int) -> int:
        return self.table.pages_for(n)

    def occupancy(self) -> str:
        return self.table.occupancy()

    def can_fit(self, n_tokens: int,
                match: Optional[PrefixMatch] = None) -> bool:
        return self.table.can_fit(n_tokens, match)

    def check_admissible(self, n_tokens: int) -> None:
        self.table.check_admissible(n_tokens)

    def ensure(self, slot: int, n_tokens: int) -> None:
        self.table.ensure(slot, n_tokens)

    def release(self, slot: int) -> None:
        self.table.release(slot)

    def trim(self, slot: int, n_tokens: int) -> int:
        """Speculative rollback: drop the slot's tail pages past
        ``n_tokens`` (:meth:`PageTable.trim`)."""
        return self.table.trim(slot, n_tokens)

    # -- prefix caching -----------------------------------------------------
    def match_prefix(self, tokens) -> PrefixMatch:
        """Longest reusable page-aligned prefix of ``tokens`` (a read-only
        probe; also the router's affinity metric)."""
        return self.table.match_prefix(tokens)

    def adopt_prefix(self, slot: int, match: PrefixMatch) -> int:
        """Map a match into ``slot`` and copy the forked page on the
        device when the plan forks one. Returns the tokens covered."""
        if not match.pages and match.cow_page is None:
            return 0
        pair = self.table.adopt_prefix(slot, match)
        if pair is not None:
            self._copy_page(*pair)
            self.cow_forks += 1
            if self.obs is not None:
                self.obs.annotate("cow_fork", slot=slot, src=pair[0],
                                  dst=pair[1])
        return match.tokens

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page's K/V rows in place (the fork). Only the
        page leaves ``k`` and ``v``: a code pool's codebook has no page
        axis."""
        for key in ("k", "v"):
            pool = self.data[key]
            pool[:, dst].copy_(pool[:, src])

    def register_prefix(self, slot: int, tokens, n_covered: int) -> None:
        self.table.register_prefix(slot, tokens, n_covered)

    def table_device(self) -> torch.Tensor:
        return self.table.device(self.device)
