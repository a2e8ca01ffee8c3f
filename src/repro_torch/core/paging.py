"""Block-paged KV allocation (vLLM-style) for the batched serving engine.

A copy of ``repro.core.paging`` (the port imports nothing of the JAX
package); ``SwapPool`` counts torch tensors as well as numpy arrays.

The dense layout pins every scheduler slot to a ``max_seq`` ring, so pool
memory is ``B x max_seq`` regardless of how long each stream actually is.
The paged layout instead carves KV storage into fixed-size *pages* of
``page_size`` tokens shared by all slots:

  * each slot owns a **block table** row mapping logical page index
    (``position // page_size``) to a physical page id, ``-1`` = unallocated;
  * a host-side **free list** hands out physical pages on demand
    (alloc-on-write: admission takes the prompt's pages — written either by
    a monolithic prefill scatter or chunk-by-chunk under chunked prefill —
    and each decode tick takes a page only when a row crosses a page
    boundary);
  * pages are **refcounted**: a radix-style :class:`PrefixIndex` keyed by
    page-aligned token chunks lets streams whose prompts share a token
    prefix map the *same* physical pages (``share_page``), and the first
    divergent write to a page with refcount > 1 is answered with a
    **copy-on-write** (``cow_page``: allocate a private page, device-copy
    the contents, repoint the slot's block-table entry);
  * retiring a slot decrements refcounts and returns only the pages that
    actually dropped to zero; the engine invalidates their ``pos`` markers
    on device, so a reallocated page can never leak stale K/V into another
    stream's attention.  Pages still held by the prefix cache keep their
    contents and serve future prefix hits until ``evict_prefix`` reclaims
    them under pressure.

Physical page 0 is reserved as the **trash page**: rows without a mapping
(inactive slots, masked cloud rows) have their writes redirected there with
``pos = -1``, so a masked step needs no merge of old and new caches.

A pool of ``columns`` > 1 is split over a data axis of that many columns
(``serving/mesh_exec.py``): column c owns the slots of its block
(``num_slots / columns`` contiguous slots) and the pages of its block
(ids ``c * n + 1 .. (c + 1) * n`` for ``n = num_pages / columns``), and a
slot takes pages from its own column's free list only, so the device
pool of a column holds only its ``n`` pages (local ids ``1 .. n``, its
own trash page 0; ``column_block``).  Counts scoped to one slot's column
(``free_in``, ``available_in``, ``evict_prefix(column=)``) are what
admission asks; with one column they are the pool's totals, and the pool
is the single device's page for page.

Admission is **optimistic**: the pool no longer keeps a worst-case
reservation ledger — a stream is admitted when its *prompt* pages (plus a
configurable ``watermark`` of held-back headroom pages) fit the free list,
and a decode-time ``alloc`` may therefore fail with ``OutOfPages``.  The
scheduler resolves that by **preempting** a victim stream chosen by
``select_victim`` (youngest-first / fewest-pages / LRU-arrival), freeing
its pages, and resuming it later by re-prefill or swap-in (see
``SwapPool`` and docs/kv_paging.md §Preemption).  Schedulers that want
the old never-preempt guarantee (``CollmConfig.preemption = "off"``)
re-derive the conservative worst-case admission check from
``owned_pages`` — the ledger just no longer lives in the allocator.

This module is pure host-side bookkeeping (numpy block table + Python free
list); the device-side paged cache layout lives in
``repro_torch.models.attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TRASH_PAGE = 0

PREEMPT_POLICIES = ("youngest", "fewest-pages", "lru")


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


def column_block(num_pages: int, columns: int,
                 column: int) -> Tuple[int, int]:
    """(first id, pages) of ``column``'s block of a pool of ``num_pages``
    split over ``columns``: global id g is local id ``g - first + 1`` on
    the column's device pool, whose page 0 is its own trash page."""
    n = num_pages // columns
    return column * n + 1, n


class OutOfPages(RuntimeError):
    """``alloc`` found an empty free list — the caller must preempt a
    victim (or fail) before retrying."""


@dataclasses.dataclass
class PagePoolStats:
    allocs: int = 0
    frees: int = 0
    high_water: int = 0          # max pages simultaneously in use
    cow_copies: int = 0          # copy-on-write page splits
    prefix_hit_tokens: int = 0   # prompt tokens served from shared pages
    prefix_evictions: int = 0    # prefix-cache entries reclaimed


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """Result of ``PagePool.match_prefix``.

    ``pages`` are the physical pages backing the matched *full* page-aligned
    chunks (``hit_tokens == len(pages) * page_size`` unless a terminal also
    matched); ``terminal`` is ``(tail_page_or_None, first_token)`` when the
    ENTIRE prompt — including a partial tail — is cached, in which case
    ``hit_tokens`` covers the whole prompt and the cached greedy first token
    can be emitted without any prefill compute."""
    pages: Tuple[int, ...]
    hit_tokens: int
    terminal: Any = None         # Optional[(Optional[int], int)]


class _PrefixNode:
    """One page-aligned token chunk in the radix prefix trie."""
    __slots__ = ("children", "page", "last_used", "terminals")

    def __init__(self, page: int = -1):
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.page = page
        self.last_used = 0
        self.terminals: Dict[Tuple[int, ...], "_Terminal"] = {}


class _Terminal:
    """Cached completion of a whole prompt: the (possibly partial) tail
    page plus the greedy first token the prefill produced."""
    __slots__ = ("page", "token", "last_used")

    def __init__(self, page, token: int, clock: int):
        self.page = page             # Optional[int]: None for aligned tails
        self.token = token
        self.last_used = clock


class PagePool:
    """Free-list page allocator + per-slot block tables.

    ``num_pages`` counts usable pages (the trash page is extra and never
    allocated).  ``max_logical`` bounds the logical context of one slot:
    ``block_table`` is ``(num_slots, max_logical)`` int32.  ``watermark``
    pages are held back from admission (``can_admit``) so in-flight
    streams keep some alloc-on-write headroom before the scheduler has to
    preempt; it never blocks ``alloc`` itself.  The attribute is a live
    control knob: only ``__init__`` validates it, and the engine's
    adaptive loop (``serving/adaptive.py``, docs/fleet_sim.md) raises and
    decays it between scheduler ticks in response to observed
    ``OutOfPages``/preemption pressure — mutate it freely between
    ``can_admit`` calls, never mid-allocation.

    With ``prefix_cache=True`` the pool additionally keeps a radix trie of
    page-aligned prompt token chunks (``match_prefix`` / ``insert_prefix``)
    so several slots can map the same physical page (``share_page``); every
    mapping holds a reference, the trie itself holds one more, and pages
    are only returned to the free list when the last reference drops.
    """

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_logical: int, watermark: int = 0,
                 prefix_cache: bool = False, columns: int = 1):
        if num_pages < 1:
            raise ValueError("PagePool needs at least one usable page")
        if not 0 <= watermark < num_pages:
            raise ValueError(
                f"watermark must be in [0, num_pages): {watermark}")
        if columns < 1 or num_pages % columns or num_slots % columns:
            raise ValueError(
                f"a pool split over {columns} columns needs pages "
                f"({num_pages}) and slots ({num_slots}) that they divide")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_logical = max_logical
        self.watermark = watermark
        self.columns = columns
        self._col_pages = num_pages // columns
        self._col_slots = num_slots // columns
        # physical ids 1..num_pages, column c's block c*n+1..(c+1)*n, each
        # column's free list popping its lowest id first; 0 is the trash
        n = self._col_pages
        self._frees: List[List[int]] = [list(range((c + 1) * n, c * n, -1))
                                        for c in range(columns)]
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self.block_table = np.full((num_slots, max_logical), -1, np.int32)
        self.stats = PagePoolStats()
        self._ref: Dict[int, int] = {}         # page -> reference count
        self.prefix_cache = prefix_cache
        self._root = _PrefixNode()             # radix trie over token chunks
        self._cached: set = set()              # pages held by the trie
        self._unfilled: set = set()            # trie pages awaiting compute
        self._clock = 0                        # LRU clock for trie entries

    # -- columns -----------------------------------------------------------
    def column_of_slot(self, slot: int) -> int:
        return slot // self._col_slots

    def column_of_page(self, page: int) -> int:
        return (page - 1) // self._col_pages

    def foreign_pages(self, slot: int, pages: Sequence[int]) -> int:
        """How many of ``pages`` lie outside ``slot``'s column."""
        col = self.column_of_slot(slot)
        return sum(1 for p in pages if self.column_of_page(p) != col)

    @property
    def _free(self) -> List[int]:
        """The free list (the columns' lists one after the other), as the
        JAX package's pool holds it."""
        return [p for free in self._frees for p in free]

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._frees)

    def free_in(self, slot: int) -> int:
        """Free pages of ``slot``'s column."""
        return len(self._frees[self.column_of_slot(slot)])

    def reclaimable_in(self, slot: int) -> int:
        col = self.column_of_slot(slot)
        return sum(1 for p in self._cached if self._ref.get(p, 0) == 1
                   and self.column_of_page(p) == col)

    def available_in(self, slot: int) -> int:
        """``available_pages`` of ``slot``'s column (the watermark held
        back in each column)."""
        if self.columns == 1:
            return self.available_pages
        return self.free_in(slot) + self.reclaimable_in(slot) \
            - self.watermark

    @property
    def reclaimable_pages(self) -> int:
        """Pages held only by the prefix cache — ``evict_prefix`` can
        return them to the free list without touching any live stream."""
        return sum(1 for p in self._cached if self._ref.get(p, 0) == 1)

    @property
    def available_pages(self) -> int:
        """Pages admission may take right now: the free list plus what the
        prefix cache could give back on demand, minus the watermark held
        back as decode headroom."""
        return self.free_pages + self.reclaimable_pages - self.watermark

    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def owned_pages(self, slot: int) -> int:
        """Physical pages currently mapped by one slot (shared included)."""
        return len(self._owned[slot])

    def shared_pages(self, slot: int) -> int:
        """How many of the slot's pages other holders also reference —
        preempting the slot frees ``owned - shared`` pages, which is what
        victim selection should weigh."""
        return sum(1 for p in self._owned[slot] if self._ref.get(p, 0) > 1)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def is_shared(self, page: int) -> bool:
        """True when a write to ``page`` would be visible to another holder
        (another slot or the prefix cache) — the copy-on-write trigger."""
        return self._ref.get(page, 0) > 1

    def can_admit(self, tokens: int, hit_pages: int = 0) -> bool:
        """Optimistic admission: do ``tokens`` worth of pages fit the free
        list right now (watermark respected)?  Callers decide what
        ``tokens`` means — the prompt for optimistic admission, the full
        ``prompt + max_new`` worst case for conservative admission.
        ``hit_pages`` discounts pages a prospective prompt would map from
        the prefix cache instead of allocating (``match_prefix``), so a
        prompt that mostly hits the cache is not over-reserved against."""
        need = pages_needed(tokens, self.page_size) - hit_pages
        return max(0, need) <= self.available_pages

    # -- slot lifecycle ----------------------------------------------------
    def alloc(self, slot: int, logical: int) -> int:
        """Map ``block_table[slot, logical]`` to a fresh physical page.

        Raises ``OutOfPages`` when the free list is empty — under
        optimistic admission this is an expected event the scheduler
        answers with preemption, not a bookkeeping bug."""
        if self.block_table[slot, logical] != -1:
            return int(self.block_table[slot, logical])
        if logical >= self.max_logical:
            raise ValueError(
                f"slot {slot}: logical page {logical} beyond max_logical "
                f"{self.max_logical}")
        free = self._frees[self.column_of_slot(slot)]
        if not free:
            raise OutOfPages(
                f"slot {slot}: no free pages for logical page {logical} "
                f"({self.pages_in_use()}/{self.num_pages} in use)")
        page = free.pop()
        self._owned[slot].append(page)
        self.block_table[slot, logical] = page
        self._ref[page] = 1
        self.stats.allocs += 1
        self.stats.high_water = max(self.stats.high_water,
                                    self.pages_in_use())
        return page

    def share_page(self, slot: int, logical: int, page: int) -> None:
        """Map an already-populated physical page (a prefix-cache hit) into
        ``block_table[slot, logical]``, taking one more reference instead
        of allocating."""
        if self.block_table[slot, logical] != -1:
            raise ValueError(
                f"slot {slot}: logical page {logical} already mapped")
        if self._ref.get(page, 0) < 1:
            raise ValueError(f"page {page} is not live, cannot share")
        self._owned[slot].append(page)
        self.block_table[slot, logical] = page
        self._ref[page] += 1

    def cow_page(self, slot: int, logical: int) -> Tuple[int, int]:
        """Copy-on-write split: the slot is about to write into a shared
        page.  Allocates a private page, repoints the slot's block-table
        entry, and returns ``(src, dst)`` — the caller must device-copy the
        page contents (int8 pages copy their scale rows alongside) before
        the write lands.  Raises ``OutOfPages`` like ``alloc``."""
        src = int(self.block_table[slot, logical])
        if src < 0:
            raise ValueError(f"slot {slot}: logical page {logical} unmapped")
        if not self.is_shared(src):
            raise ValueError(f"page {src} is private, no copy needed")
        free = self._frees[self.column_of_slot(slot)]
        if not free:
            raise OutOfPages(
                f"slot {slot}: no free pages for CoW of logical page "
                f"{logical} ({self.pages_in_use()}/{self.num_pages} in use)")
        dst = free.pop()
        self._ref[src] -= 1
        self._ref[dst] = 1
        owned = self._owned[slot]
        owned[owned.index(src)] = dst
        self.block_table[slot, logical] = dst
        self.stats.allocs += 1
        self.stats.cow_copies += 1
        self.stats.high_water = max(self.stats.high_water,
                                    self.pages_in_use())
        return src, dst

    def free_slot(self, slot: int) -> List[int]:
        """Release a retired (or preempted) slot's pages: every mapping
        drops one reference, and only pages whose count hit zero go back to
        the free list.  Returns exactly those ids — the engine must
        invalidate their ``pos`` markers on device, and must NOT touch
        pages still referenced by other slots or the prefix cache (their
        contents are live)."""
        freed: List[int] = []
        for page in self._owned[slot]:
            self._ref[page] -= 1
            if self._ref[page] == 0:
                del self._ref[page]
                freed.append(page)
        for page in freed:
            self._frees[self.column_of_page(page)].append(page)
        self.stats.frees += len(freed)
        self._owned[slot] = []
        self.block_table[slot, :] = -1
        return freed

    # -- prefix cache (radix trie over page-aligned token chunks) ----------
    def _chunks(self, tokens: Sequence[int]):
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n_full)]

    def match_prefix(self, tokens: Sequence[int]) -> PrefixHit:
        """Walk the trie along the prompt's page-aligned chunks.  Returns
        the shared pages covering the longest cached prefix; when the whole
        prompt (full chunks + exact tail) is cached, ``terminal`` carries
        the tail page and the memoized greedy first token."""
        self._clock += 1
        node, pages = self._root, []
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                return PrefixHit(tuple(pages), len(pages) * self.page_size)
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        tail = tuple(int(t) for t in tokens[len(pages) * self.page_size:])
        term = node.terminals.get(tail)
        if term is None:
            return PrefixHit(tuple(pages), len(pages) * self.page_size)
        term.last_used = self._clock
        return PrefixHit(tuple(pages), len(tokens),
                         (term.page, term.token))

    def insert_prefix(self, slot: int, tokens: Sequence[int]) -> List[int]:
        """Register the slot's full-chunk prompt pages in the trie.  New
        chunks take the slot's own pages with one cache reference and are
        *unfilled* until the owning stream's prefill writes them
        (``mark_filled``) — a concurrent sharer must stall its suffix
        compute until then.  Returns the newly registered pages."""
        self._clock += 1
        node, added = self._root, []
        for i, key in enumerate(self._chunks(tokens)):
            child = node.children.get(key)
            if child is None:
                page = int(self.block_table[slot, i])
                if page < 0:
                    break                      # beyond the slot's mapping
                child = _PrefixNode(page)
                node.children[key] = child
                self._ref[page] += 1
                self._cached.add(page)
                self._unfilled.add(page)
                added.append(page)
            child.last_used = self._clock
            node = child
        return added

    def insert_terminal(self, slot: int, tokens: Sequence[int],
                        first_token: int) -> None:
        """Cache a completed prompt end-to-end: the partial tail page (if
        any) plus the greedy first token, so an identical future prompt
        skips prefill entirely."""
        self._clock += 1
        node = self._root
        chunks = self._chunks(tokens)
        for key in chunks:
            node = node.children.get(key)
            if node is None:
                return                         # prefix chunks were evicted
        tail = tuple(int(t) for t in tokens[len(chunks) * self.page_size:])
        if tail in node.terminals:
            return
        page = None
        if tail:
            page = int(self.block_table[slot, len(chunks)])
            if page < 0:
                return
            self._ref[page] += 1
            self._cached.add(page)
        node.terminals[tail] = _Terminal(page, int(first_token), self._clock)

    def mark_filled(self, page: int) -> None:
        """The owning stream's prefill chunk for this trie page landed on
        device — sharers may now compute past it."""
        self._unfilled.discard(page)

    def pages_filled(self, pages: Sequence[int]) -> bool:
        return not any(p in self._unfilled for p in pages)

    def _evictable(self):
        """Yield ``(last_used, kind_order, remover, page)`` for every trie
        leaf whose page no live stream maps (terminal entries, then chunk
        nodes with no children or terminals)."""
        out = []

        def walk(node: _PrefixNode):
            for tail, term in node.terminals.items():
                if term.page is None or self._ref.get(term.page, 0) == 1:
                    out.append((term.last_used, 0,
                                (node.terminals, tail), term.page))
            for key, child in node.children.items():
                walk(child)
                if not child.children and not child.terminals \
                        and self._ref.get(child.page, 0) == 1:
                    out.append((child.last_used, 1,
                                (node.children, key), child.page))

        walk(self._root)
        return out

    def evict_prefix(self, need: int,
                     column: Optional[int] = None) -> List[int]:
        """Reclaim least-recently-used prefix-cache entries until ``need``
        pages came back to the free list (or nothing evictable remains).
        Returns the freed ids — the engine must invalidate their ``pos``
        markers on device before they are reallocated.  ``column``: only
        entries whose page lies in that column (or that hold no page)."""
        freed: List[int] = []
        while len(freed) < need:
            cands = self._evictable()
            if column is not None and self.columns > 1:
                cands = [c for c in cands if c[3] is None
                         or self.column_of_page(c[3]) == column]
            if not cands:
                break
            progress = False
            for _, _, (container, key), page in sorted(
                    cands, key=lambda e: (e[0], e[1])):
                del container[key]
                self.stats.prefix_evictions += 1
                progress = True
                if page is not None:
                    self._cached.discard(page)
                    self._unfilled.discard(page)
                    self._ref[page] -= 1
                    if self._ref[page] == 0:
                        del self._ref[page]
                        self._frees[self.column_of_page(page)].append(page)
                        self.stats.frees += 1
                        freed.append(page)
                        if len(freed) >= need:
                            break
            if not progress:
                break
        return freed


# ---------------------------------------------------------------------------
# victim selection (preemption policy)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VictimCandidate:
    """One preemptible stream as the policy sees it."""
    slot: int
    admit_seq: int               # monotonically increasing admission order
    owned_pages: int
    shared_pages: int = 0        # of those, pages with refcount > 1

    @property
    def reclaimable(self) -> int:
        """Pages preempting this stream would actually free — shared pages
        stay live in their other holders, so they don't count."""
        return self.owned_pages - self.shared_pages


def select_victim(cands: Sequence[VictimCandidate], policy: str) -> int:
    """Pick the slot to preempt.  Candidates must have at least one
    *reclaimable* page: a slot whose pages are all shared (refcount > 1)
    is skipped outright — preempting it frees nothing, the pages stay
    live in the prefix cache or in their co-holders.

      * ``youngest``      — most recently admitted first (vLLM default:
                            the oldest streams are closest to finishing);
      * ``fewest-pages``  — smallest reclaim benefit first (cheapest
                            checkpoint/restore; shared pages down-rank a
                            candidate because they don't come back);
      * ``lru``           — least-recently-*arrived* (oldest admission)
                            first: long-running hogs yield to fresh work.

    Ties break on admission order (youngest), then slot index, so victim
    choice is deterministic."""
    if policy not in PREEMPT_POLICIES:
        raise ValueError(f"unknown preemption policy {policy!r} "
                         f"(choose from {PREEMPT_POLICIES})")
    cands = [c for c in cands if c.reclaimable > 0]
    if not cands:
        raise OutOfPages("no preemptible stream owns any reclaimable pages")
    if policy == "youngest":
        key = lambda c: (-c.admit_seq, c.slot)  # noqa: E731
    elif policy == "fewest-pages":
        key = lambda c: (c.reclaimable, -c.admit_seq, c.slot)  # noqa: E731
    else:  # lru
        key = lambda c: (c.admit_seq, c.slot)  # noqa: E731
    return min(cands, key=key).slot


# ---------------------------------------------------------------------------
# host-side swap store
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SwapPoolStats:
    swapped_out: int = 0
    swapped_in: int = 0
    bytes_out: int = 0
    bytes_in: int = 0

    @property
    def held(self) -> int:
        return self.swapped_out - self.swapped_in


class SwapPool:
    """Host-side page store for ``CollmConfig.preemption = "swap"``.

    A preempted stream's device pages are copied here (CPU tensors, host
    RAM) and restored bit for bit into freshly allocated physical pages at
    resume — no recompute, at the cost of host traffic.  Snapshots are
    opaque trees of tensors (and numpy arrays) keyed by a caller-chosen
    id."""

    def __init__(self):
        self._store: Dict[Any, Any] = {}
        self.stats = SwapPoolStats()

    @staticmethod
    def _nbytes(snapshot: Any) -> int:
        total = 0
        stack = [snapshot]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            elif isinstance(node, torch.Tensor):
                total += node.numel() * node.element_size()
            elif isinstance(node, np.ndarray):
                total += node.nbytes
        return total

    def put(self, key: Any, snapshot: Any) -> None:
        if key in self._store:
            raise KeyError(f"swap key {key!r} already held")
        self._store[key] = snapshot
        self.stats.swapped_out += 1
        self.stats.bytes_out += self._nbytes(snapshot)

    def take(self, key: Any) -> Any:
        snapshot = self._store.pop(key)
        self.stats.swapped_in += 1
        self.stats.bytes_in += self._nbytes(snapshot)
        return snapshot

    def __contains__(self, key: Any) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)
