"""Block-paged KV allocation (vLLM-style) for the batched serving engine.

A copy of the allocator half of ``repro.core.paging`` (the port imports
nothing of the JAX package).  The dense layout pins every scheduler slot to
a ``max_seq`` ring, so pool memory is ``B x max_seq`` regardless of how long
each stream actually is.  The paged layout instead carves KV storage into
fixed-size *pages* of ``page_size`` tokens shared by all slots:

  * each slot owns a **block table** row mapping logical page index
    (``position // page_size``) to a physical page id, ``-1`` = unallocated;
  * a host-side **free list** hands out physical pages on demand
    (alloc-on-write: admission takes the prompt's pages, and each decode
    tick takes a page only when a row crosses a page boundary);
  * retiring a slot returns its pages; the engine invalidates their ``pos``
    markers on device, so a reallocated page can never leak stale K/V into
    another stream's attention.

Physical page 0 is reserved as the **trash page**: rows without a mapping
(inactive slots, masked cloud rows) have their writes redirected there with
``pos = -1``.

Admission is **optimistic** under preemption: a stream is admitted when its
*prompt* pages (plus a ``watermark`` of held-back headroom pages) fit the
free list, so a decode-time ``alloc`` may fail with ``OutOfPages``.  The
scheduler then **preempts** a victim stream chosen by ``select_victim``
(youngest-first / fewest-pages / LRU-arrival), frees its pages and resumes
it later by re-prefill or swap-in (``SwapPool``, host memory).

The radix prefix index (``prefix_cache=True``: shared pages, copy-on-write,
LRU eviction) serves prefix sharing (ROADMAP A.5); it is not ported yet,
and the pool raises for ``prefix_cache=True``.

This module is pure host-side bookkeeping (numpy block table + Python free
list); the device-side paged cache layout lives in
``repro_torch.models.attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

PREEMPT_POLICIES = ("youngest", "fewest-pages", "lru")


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


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


class PagePool:
    """Free-list page allocator + per-slot block tables.

    ``num_pages`` counts usable pages (the trash page is extra and never
    allocated).  ``max_logical`` bounds the logical context of one slot:
    ``block_table`` is ``(num_slots, max_logical)`` int32.  ``watermark``
    pages are held back from admission (``can_admit``) but never from
    ``alloc`` itself."""

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_logical: int, watermark: int = 0,
                 prefix_cache: bool = False):
        if prefix_cache:
            raise NotImplementedError(
                "the radix prefix cache (prefix sharing) is not ported yet "
                "(ROADMAP A.5)")
        if num_pages < 1:
            raise ValueError("PagePool needs at least one usable page")
        if not 0 <= watermark < num_pages:
            raise ValueError(
                f"watermark must be in [0, num_pages): {watermark}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_logical = max_logical
        self.watermark = watermark
        # physical ids 1..num_pages; 0 is the trash page
        self._free: List[int] = list(range(num_pages, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self.block_table = np.full((num_slots, max_logical), -1, np.int32)
        self.stats = PagePoolStats()

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages admission may take right now: the free list minus the
        watermark held back as decode headroom."""
        return self.free_pages - self.watermark

    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def owned_pages(self, slot: int) -> int:
        """Physical pages currently mapped by one slot."""
        return len(self._owned[slot])

    def can_admit(self, tokens: int, hit_pages: int = 0) -> bool:
        """Do ``tokens`` worth of pages fit the free list right now
        (watermark respected)?"""
        need = pages_needed(tokens, self.page_size) - hit_pages
        return max(0, need) <= self.available_pages

    # -- slot lifecycle ----------------------------------------------------
    def alloc(self, slot: int, logical: int) -> int:
        """Map ``block_table[slot, logical]`` to a fresh physical page.
        Raises ``OutOfPages`` when the free list is empty."""
        if self.block_table[slot, logical] != -1:
            return int(self.block_table[slot, logical])
        if logical >= self.max_logical:
            raise ValueError(
                f"slot {slot}: logical page {logical} beyond max_logical "
                f"{self.max_logical}")
        if not self._free:
            raise OutOfPages(
                f"slot {slot}: no free pages for logical page {logical} "
                f"({self.pages_in_use()}/{self.num_pages} in use)")
        page = self._free.pop()
        self._owned[slot].append(page)
        self.block_table[slot, logical] = page
        self.stats.allocs += 1
        self.stats.high_water = max(self.stats.high_water,
                                    self.pages_in_use())
        return page

    def free_slot(self, slot: int) -> List[int]:
        """Release a retired slot's pages.  Returns their ids — the engine
        must invalidate their ``pos`` markers on device."""
        freed = list(self._owned[slot])
        self._free.extend(freed)
        self.stats.frees += len(freed)
        self._owned[slot] = []
        self.block_table[slot, :] = -1
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
    *reclaimable* page: preempting a slot that frees nothing is skipped.

      * ``youngest``      — most recently admitted first (the oldest
                            streams are closest to finishing);
      * ``fewest-pages``  — smallest reclaim benefit first (cheapest
                            checkpoint/restore);
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
