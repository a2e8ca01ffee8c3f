"""Cross-engine cloud batching, and the pooled-cache helpers of the batched
engine.

Port of ``repro.serving.cloud_batcher`` without the mesh (ROADMAP A.11):

  * the admission scatters of a prefilled row into the pooled (dense or
    paged) caches, the page invalidation of retired streams, and the
    backfill upload ring;
  * ``CloudBatcher``: one cloud partition serving N edge clients (each its
    own single-slot ``BatchScheduler``) out of a pooled, batch-major cloud
    KV cache, one pool row per client stream.  Requests queue at submit
    time (their uploads are popped from the ContentManager then) and are
    computed lazily: the first reply an engine drains calls ``flush``,
    which serves every queued request in waves of at most one row per
    cloud slot, each wave ONE masked cloud step.

  * the page-tree helpers of swap preemption: a slot's physical pages
    gathered out of every paged cache node into host memory, and written
    back into freshly allocated pages (int8 pages carry their scale leaves
    along).

Chunked admission and prefix sharing (ROADMAP A.5) are not ported yet;
their methods raise.

Caches are ``{segment index: [per-layer cache, ...]}`` with the batch at
axis 0 of every dense leaf, and are written in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.content_manager import ContentManager
from repro_torch.core.paging import PagePool, pages_needed
from repro_torch.models.attention import (paged_reset_pages,
                                          paged_scatter_prefill)

Pytree = Any


def _bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two length bucket >= n: prompts are right-padded to
    it, so pooled row caches have one size per scheduler."""
    b = floor
    while b < n:
        b *= 2
    return b


def _pad_pages(phys: np.ndarray) -> np.ndarray:
    """Pad a physical-page id list to its power-of-two bucket by repeating
    the last id (duplicate writes of identical data are no-ops).  The JAX
    package pads to bound its compile count; the port pads the same way so
    that a swap snapshot, and the swap pool's byte counts, equal JAX's."""
    n = len(phys)
    padded = np.empty((_bucket(n, floor=1),), np.int32)
    padded[:n] = phys
    padded[n:] = phys[n - 1]
    return padded


def _put_row(f: torch.Tensor, r: torch.Tensor, j: int) -> torch.Tensor:
    """Copy one cache row (batch axis 0, size 1) into row j of a pooled
    leaf, in place."""
    f[j] = r[0].to(f.dtype)
    return f


def _scatter_row(full: Pytree, row: Pytree, j: int) -> Pytree:
    """Insert a single-row cache tree into a batched pool at row j."""
    if isinstance(full, torch.Tensor):
        return _put_row(full, row, j)
    if isinstance(full, dict):
        return {k: _scatter_row(full[k], row[k], j) for k in full}
    return [_scatter_row(f, r, j) for f, r in zip(full, row)]


def _scatter_row_paged(full: Pytree, row: Pytree, j: int,
                       pages: np.ndarray) -> Pytree:
    """Paged admission scatter: self-attention K/V of the prefilled row is
    written into its allocated physical pages (``pages``: one id per
    logical prompt page, -1 entries redirect to the trash page); any other
    cache leaf is a dense per-row scatter at row j exactly like the dense
    layout."""
    if isinstance(full, dict):
        if "kp" in full:
            return paged_scatter_prefill(full, row, pages)
        return {k: _scatter_row_paged(full[k], row[k], j, pages)
                for k in full}
    if isinstance(full, list):
        return [_scatter_row_paged(f, r, j, pages)
                for f, r in zip(full, row)]
    return _put_row(full, row, j)


def _reset_pages_tree(caches: Pytree, pages) -> Pytree:
    """Invalidate freed physical pages across every paged cache node, so a
    page returned to the free list never leaks a retired stream's K/V."""
    if isinstance(caches, dict):
        if "kp" in caches:
            return paged_reset_pages(caches, pages)
        return {k: _reset_pages_tree(v, pages) for k, v in caches.items()}
    if isinstance(caches, list):
        return [_reset_pages_tree(c, pages) for c in caches]
    return caches


def build_upload_ring(entries, batch: int):
    """Assemble the dense upload ring for ``CoLLM.ring_cloud_steps`` from
    per-row packet lists.

    ``entries``: [(row, [(pos, StatePacket), ...]), ...] — one entry per
    pool row, packets in consumption order.  Returns ``(ring, ring_pos,
    valid)`` tensors on the packets' device.  The ring is as deep as the
    longest list: the JAX package pads the depth to a power of two to
    bound its compile count, which eager PyTorch has no need of (a padded
    step would run the whole cloud partition on no row)."""
    depth = max((len(p) for _, p in entries), default=1)
    first = next(p for _, pkts in entries for _, p in pkts)
    dev = next(iter(first.hidden.values())).device
    slots, rows, positions, flat = [], [], [], []
    for row, pkts in entries:
        for i, (p, pkt) in enumerate(pkts):
            slots.append(i)
            rows.append(row)
            positions.append(p)
            flat.append(pkt.hidden)
    idx = (torch.as_tensor(slots, device=dev),
           torch.as_tensor(rows, device=dev))
    ring = {}
    for k, v in first.hidden.items():
        ring[k] = torch.zeros((depth, batch) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=dev)
        ring[k][idx] = torch.cat([h[k] for h in flat])
    ring_pos = torch.zeros((depth, batch), dtype=torch.int32, device=dev)
    ring_pos[idx] = torch.as_tensor(positions, dtype=torch.int32,
                                    device=dev)
    valid = torch.zeros((depth, batch), dtype=torch.bool, device=dev)
    valid[idx] = True
    return ring, ring_pos, valid


def _gather_pages_tree(caches: Pytree, phys) -> Pytree:
    """Swap-out: slice the given physical pages out of every paged cache
    node, same tree shape."""
    if isinstance(caches, dict):
        if "kp" in caches:
            ids = torch.as_tensor(phys, dtype=torch.long,
                                  device=caches["kp"].device)
            return {k: v.index_select(0, ids) for k, v in caches.items()}
        return {k: _gather_pages_tree(v, phys) for k, v in caches.items()}
    if isinstance(caches, list):
        return [_gather_pages_tree(c, phys) for c in caches]
    return None


def _write_pages_tree(caches: Pytree, phys, data: Pytree) -> Pytree:
    """Swap-in: write snapshotted page contents (on the cache's device)
    into freshly allocated physical pages, in place.  Duplicate ids in
    ``phys`` carry identical data (``_pad_pages``), so overlapping writes
    are benign."""
    if isinstance(caches, dict):
        if "kp" in caches:
            ids = torch.as_tensor(phys, dtype=torch.long,
                                  device=caches["kp"].device)
            for k, v in caches.items():
                v.index_copy_(0, ids, data[k].to(v.dtype))
            return caches
        return {k: _write_pages_tree(v, phys, data[k])
                for k, v in caches.items()}
    if isinstance(caches, list):
        return [_write_pages_tree(c, phys, d) for c, d in zip(caches, data)]
    return caches


def _map_tensors(tree: Pytree, fn) -> Pytree:
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def snapshot_to_device(snap: Pytree, device) -> Pytree:
    """A host snapshot's tensors on ``device``: non-blocking copies, then
    one synchronisation, after which the host snapshot may be dropped."""
    out = _map_tensors(snap, lambda t: t.to(device, non_blocking=True))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out


def gather_slot_pages(pool: PagePool, slot: int, caches: Pytree):
    """Swap-out core: copy one slot's physical pages out of a paged cache
    tree into host memory.  Returns ``(logical, host_tree)`` — the slot's
    logical page indices and the page contents as CPU tensors (None when
    the slot owns nothing)."""
    tbl_row = pool.block_table[slot]
    logical = np.nonzero(tbl_row >= 0)[0].astype(np.int32)
    if not len(logical):
        return logical, None
    padded = _pad_pages(tbl_row[logical].astype(np.int32))
    return logical, _map_tensors(_gather_pages_tree(caches, padded),
                                 lambda t: t.to("cpu"))


def rebind_slot_pages(pool: PagePool, slot: int,
                      logical: np.ndarray) -> np.ndarray:
    """Swap-in core: re-allocate a snapshot's logical pages for ``slot``
    (pages are row-agnostic — the block table re-binds them to whatever
    physical ids are free) and return the padded id vector to write the
    snapshot into."""
    for lp in logical:
        pool.alloc(slot, int(lp))
    return _pad_pages(pool.block_table[slot][logical].astype(np.int32))


def all_paged(caches: Pytree) -> bool:
    """True when every cache leaf lives under a paged ("kp") node — the
    precondition for swap preemption (a page-only snapshot would silently
    lose a dense leaf)."""
    def go(c: Pytree) -> bool:
        if isinstance(c, dict):
            if "kp" in c:
                return True
            return bool(c) and all(go(v) for v in c.values())
        if isinstance(c, list):
            return bool(c) and all(go(v) for v in c)
        return False
    return all(go(c) for c in caches.values())


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Entry:
    """One queued cloud request awaiting a batched step."""
    device_id: str
    slot: int                   # cloud pool row
    pos: int
    packets: list               # [(pos, StatePacket), ...]; len > 1 means
                                # backfill ring and/or k-token draft
    group: dict                 # reply payload shared with the channel


@dataclasses.dataclass
class BatcherStats:
    requests: int = 0
    steps: int = 0              # masked batched cloud calls executed
    rows: int = 0               # summed rows served by those calls
    max_rows: int = 0           # peak rows in any single wave (occupancy)
    cancelled: int = 0
    prefills: int = 0
    prefill_chunks: int = 0     # chunked-admission cloud prefill calls
    prefix_hit_tokens: int = 0  # prompt tokens served from shared pages
    restores: int = 0           # preempted-stream cloud-KV replays
    swaps: int = 0              # cloud rows swapped out to host
    # host seconds spent in batched wave compute.  Prefill time is NOT
    # included: the admitting engine times admit() and charges it to the
    # admitting stream's GenStats, so summing the two never double-counts.
    cloud_time: float = 0.0

    @property
    def mean_batch(self) -> float:
        return self.rows / self.steps if self.steps else 0.0

    def as_row(self) -> Dict[str, float]:
        return {"requests": self.requests, "steps": self.steps,
                "mean_batch": round(self.mean_batch, 2),
                "max_batch": self.max_rows,
                "cancelled": self.cancelled, "prefills": self.prefills,
                "prefill_chunks": self.prefill_chunks,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "restores": self.restores, "swaps": self.swaps,
                "cloud_time_s": round(self.cloud_time, 4)}


def _unported(name: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"CloudBatcher.{name} is not ported yet (ROADMAP {item})")
    method.__name__ = name
    return method


class CloudBatcher:
    """One cloud partition serving N client streams out of a pooled,
    batch-major KV cache: the compute half of the shared cloud service
    point (``transport.CloudServicePoint`` is its timing half).

    ``collm`` is a ``CoLLM``, ``cm`` the ``ContentManager`` the engines
    upload into (it also maps each client to its pool row).  The pool is
    dense rings or, with ``CollmConfig.kv_layout="paged"``, a page pool of
    its own; its rows are not preemptible, so admission is the
    conservative worst case.  A preempted engine releases its stream's row
    (``release``, then ``admit`` and ``restore`` on resume) or swaps its
    pages to host memory (``swap_out`` / ``swap_in``)."""

    def __init__(self, collm, cm: ContentManager, num_slots: int,
                 max_seq: int, *, max_batch: Optional[int] = None,
                 max_ctx: Optional[int] = None,
                 num_pages: Optional[int] = None):
        self.collm = collm
        self.cm = cm
        self.B = num_slots
        self.max_seq = max_seq
        self.max_batch = max_batch or num_slots
        cm.init_cloud_slots(num_slots)

        self.layout = collm.ccfg.kv_layout
        self.pool: Optional[PagePool] = None
        self._tbl_device: Optional[torch.Tensor] = None
        if self.layout == "paged":
            ps = collm.ccfg.page_size
            self.max_ctx = max_ctx or max_seq
            n_pages = num_pages or num_slots * pages_needed(self.max_ctx, ps)
            self.pool = PagePool(n_pages, ps, num_slots,
                                 pages_needed(self.max_ctx, ps))
            row_seq = _bucket(self.max_ctx)
            self.caches = collm.init_cloud_cache_paged(
                num_slots, self.pool.num_pages, ps)
        else:
            self.max_ctx = max_seq
            row_seq = max_seq
            self.caches = collm.init_cloud_cache(num_slots, max_seq)
        self._row_seq = row_seq
        self._row0 = collm.init_cloud_cache(1, row_seq)

        self._pending: List[_Entry] = []
        self._budget: Dict[str, int] = {}   # device_id -> prompt+max_new
        self.stats = BatcherStats()

    # -- capacity / lifecycle ----------------------------------------------
    def _outstanding_pages(self) -> int:
        """Worst-case pages still owed to admitted streams: each active
        client's token budget minus the pages it already owns."""
        out = 0
        for dev, budget in self._budget.items():
            slot = self.cm.cloud_slot(dev)
            if slot is None:
                continue
            out += max(0, pages_needed(budget, self.pool.page_size)
                       - self.pool.owned_pages(slot))
        return out

    def can_admit(self, budget_tokens: int) -> bool:
        """One more stream of ``prompt + max_new`` tokens, right now?  (The
        JAX package's ``hit_pages`` discount comes with prefix sharing,
        ROADMAP A.5.)"""
        if self.cm.cloud_slots_free() <= 0:
            return False
        if self.pool is not None:
            need = pages_needed(budget_tokens, self.pool.page_size)
            if need > self.pool.num_pages:
                raise ValueError(
                    f"stream of {budget_tokens} tokens needs more pages "
                    f"than the cloud pool has ({self.pool.num_pages})")
            return need <= self.pool.free_pages - self._outstanding_pages()
        return True

    def _alloc(self, slot: int, lp: int) -> None:
        self.pool.alloc(slot, lp)
        self._tbl_device = None

    def _alloc_for(self, slot: int, packets) -> None:
        """Map the pages that ``packets``' positions write (paged pool)."""
        if self.pool is None:
            return
        for p, _ in packets:
            lp = p // self.pool.page_size
            if self.pool.block_table[slot, lp] == -1:
                self._alloc(slot, lp)

    def admit(self, device_id: str, h1_seq: torch.Tensor, true_len: int,
              budget_tokens: int) -> torch.Tensor:
        """Prefill the cloud partition over the uploaded (padded) prompt
        hidden sequence into the client's pool row; returns the logits
        (1, 1, V) at the true last position (the cloud answer for the first
        token), still on the device."""
        slot = self.cm.assign_cloud_slot(device_id)
        self._budget[device_id] = budget_tokens
        logits, row = self.collm.cloud_prefill_padded(h1_seq, true_len,
                                                      self._row0)
        if self.pool is None:
            self.caches = _scatter_row(self.caches, row, slot)
        else:
            ps = self.pool.page_size
            n_prompt = pages_needed(true_len, ps)
            for lp in range(n_prompt):
                self._alloc(slot, lp)
            pages = np.full((pages_needed(h1_seq.shape[1], ps),), -1,
                            np.int32)
            pages[:n_prompt] = self.pool.block_table[slot, :n_prompt]
            self.caches = _scatter_row_paged(self.caches, row, slot, pages)
        self.stats.prefills += 1
        return logits

    prefix_hit = _unported("prefix_hit", "A.5")
    admit_begin = _unported("admit_begin", "A.5")
    admit_chunk = _unported("admit_chunk", "A.5")
    pages_filled = _unported("pages_filled", "A.5")

    def release(self, device_id: str) -> None:
        """Stream finished (or was preempted): cancel its queued requests,
        free its pages (invalidated on the device), return its pool row."""
        self.cancel(device_id, 0)
        self._budget.pop(device_id, None)
        slot = self.cm.release_cloud_slot(device_id)
        if slot is None or self.pool is None:
            return
        freed = self.pool.free_slot(slot)
        self._tbl_device = None
        if freed:
            _reset_pages_tree(self.caches, freed)

    # -- request path -------------------------------------------------------
    def submit(self, device_id: str, pos: int, *, backfill: bool = False):
        """Queue one single-token cloud request; returns ``(group, row,
        packets)``: the engine hands ``(group, row)`` to its channel as the
        reply payload.  The uploaded packet(s) are popped from the
        ContentManager NOW (submit order = per-client pos order), so a
        later flush computes exactly what a per-engine call would have."""
        slot = self.cm.cloud_slot(device_id)
        if slot is None:
            raise KeyError(f"{device_id} has no cloud slot (admit first)")
        if backfill:
            packets = self.cm.take_uploads_upto(device_id, pos)
        else:
            packets = [(pos, self.cm.take_upload(device_id, pos))]
        self._alloc_for(slot, packets)
        group = {"logits": None, "np": None, "flush": self.flush}
        self._pending.append(_Entry(device_id=device_id, slot=slot, pos=pos,
                                    packets=packets, group=group))
        self.stats.requests += 1
        return group, slot, packets

    def submit_draft(self, device_id: str, draft, *, backfill: bool = False):
        """Queue one k-token draft verification request (the engine's
        ``_flush_drafts``).  ``draft``: [(pos, StatePacket), ...] — the
        draft positions' packets in order, popped by the engine at draft
        time.  Backfill additionally drains the client's not-yet-consumed
        older uploads here, so the merged ring rebuilds the exact cloud KV.
        Returns ``(group, row, packets)`` like ``submit``; ``packets`` is
        the merged consumption-order list the engine indexes the reply's
        per-position logits (the group's ``all``) with."""
        slot = self.cm.cloud_slot(device_id)
        if slot is None:
            raise KeyError(f"{device_id} has no cloud slot (admit first)")
        packets = list(draft)
        if backfill:
            # older positions all precede the draft (the engine flushes on
            # a confident tick, so drafts stay position-contiguous)
            packets = self.cm.take_uploads_upto(device_id,
                                                packets[-1][0]) + packets
        self._alloc_for(slot, packets)
        group = {"logits": None, "all": None, "np": None, "np_all": None,
                 "flush": self.flush}
        self._pending.append(_Entry(device_id=device_id, slot=slot,
                                    pos=packets[-1][0], packets=packets,
                                    group=group))
        self.stats.requests += 1
        return group, slot, packets

    def cancel(self, device_id: str, min_pos: int) -> int:
        """Drop queued (not yet computed) requests of one client at
        positions >= ``min_pos`` — a speculative rewind discarded them, or
        the stream retired.  Their replies late-drop in the engine;
        computing them after an ``invalidate`` would resurrect stale KV."""
        keep = [e for e in self._pending
                if e.device_id != device_id or e.pos < min_pos]
        dropped = len(self._pending) - len(keep)
        self._pending = keep
        self.stats.cancelled += dropped
        return dropped

    def invalidate(self, device_id: str, cut_pos: int) -> None:
        """Speculative rewind: invalidate the client's cloud KV at
        positions >= ``cut_pos`` (``CoLLM.invalidate_rows_after``)."""
        slot = self.cm.cloud_slot(device_id)
        if slot is None:
            return
        cut = np.full((self.B,), np.iinfo(np.int32).max, np.int32)
        cut[slot] = cut_pos
        self.caches = self.collm.invalidate_rows_after(
            self.caches, cut, self._block_tbl())

    # -- preemption lifecycle ----------------------------------------------
    def restore(self, device_id: str, packets) -> None:
        """Resume (recompute mode): replay a checkpointed stream's consumed
        cloud uploads — positions below the resume point — through the
        cloud partition, rebuilding its row's KV exactly as it was
        (release-semantics gaps included).  The caller ``admit``s the
        prompt first."""
        slot = self.cm.cloud_slot(device_id)
        if slot is None:
            raise KeyError(f"{device_id} has no cloud slot (admit first)")
        if not packets:
            return
        self._alloc_for(slot, packets)
        t0 = time.perf_counter()
        ring, ring_pos, valid = build_upload_ring([(slot, packets)], self.B)
        _, self.caches = self.collm.ring_cloud_steps(
            ring, ring_pos, valid, self.caches, self._block_tbl())
        self.stats.restores += 1
        self.stats.cloud_time += time.perf_counter() - t0

    def swap_out(self, device_id: str):
        """Preempt (swap mode): snapshot the stream's cloud-KV pages to
        host memory, then release its row, pages and budget.  Returns the
        snapshot for ``swap_in``.

        Flushes the queue first: a queued entry has consumed its uploads
        without writing their KV yet, and ``release``'s cancel would drop
        the only copy of them (flushing early changes wave grouping, never
        values)."""
        slot = self.cm.cloud_slot(device_id)
        if slot is None or self.pool is None:
            self.release(device_id)
            return None
        if self._pending:
            self.flush()
        logical, pages = gather_slot_pages(self.pool, slot, self.caches)
        if pages is not None:
            self.stats.swaps += 1
        snap = {"logical": logical, "pages": pages,
                "budget": self._budget.get(device_id)}
        self.release(device_id)
        return snap

    def swap_in(self, device_id: str, snap) -> None:
        """Resume (swap mode): re-acquire a cloud row (possibly another one
        — the block table re-binds the pages) and write the snapshot back
        into freshly allocated pages."""
        self.cm.assign_cloud_slot(device_id)
        if snap is None:
            return
        if snap["budget"] is not None:
            self._budget[device_id] = snap["budget"]
        if snap["pages"] is None:
            return
        slot = self.cm.cloud_slot(device_id)
        padded = rebind_slot_pages(self.pool, slot, snap["logical"])
        _write_pages_tree(self.caches, padded, snapshot_to_device(
            snap["pages"], self.collm.model.device))
        self._tbl_device = None

    def flush(self) -> None:
        """Drain the queue in waves: each wave serves at most one request
        per cloud slot (and at most ``max_batch`` rows) with ONE masked
        batched cloud step; every entry's reply group gets the wave's
        still-on-device logits."""
        while self._pending:
            wave, rest, seen = [], [], set()
            for e in self._pending:
                if e.slot in seen or len(wave) >= self.max_batch:
                    rest.append(e)
                else:
                    seen.add(e.slot)
                    wave.append(e)
            self._pending = rest
            self._compute(wave)

    # -- internals ----------------------------------------------------------
    def _block_tbl(self) -> Optional[torch.Tensor]:
        if self.pool is None:
            return None
        if self._tbl_device is None:
            self._tbl_device = torch.tensor(self.pool.block_table,
                                            device=self.collm.model.device)
        return self._tbl_device

    def _compute(self, wave: List[_Entry]) -> None:
        """One masked cloud step over a wave.  The (B, ...) input is built
        on the device by index copies of the entries' packets (the JAX
        package builds it on the host); positions are host integers."""
        t0 = time.perf_counter()
        dev = self.collm.model.device
        if any(len(e.packets) > 1 for e in wave):
            # a backfill ring or a k-token draft in the wave: the ring
            # pass serves all of it
            ring, ring_pos, valid = build_upload_ring(
                [(e.slot, e.packets) for e in wave], self.B)
            logits, all_logits, self.caches = \
                self.collm.ring_cloud_steps_all(ring, ring_pos, valid,
                                                self.caches,
                                                self._block_tbl())
            for e in wave:
                # every ring entry's logits: what a k-token draft reply
                # reconciles against; a single-token reply reads "logits"
                e.group["all"] = all_logits
        else:
            first = wave[0].packets[0][1].hidden
            rows = torch.as_tensor([e.slot for e in wave], device=dev)
            dense = {}
            for k, v in first.items():
                dense[k] = torch.zeros((self.B,) + tuple(v.shape[1:]),
                                       dtype=v.dtype, device=dev)
                dense[k][rows] = torch.cat([e.packets[0][1].hidden[k]
                                            for e in wave])
            pos = np.zeros((self.B,), np.int32)
            mask = np.zeros((self.B,), bool)
            for e in wave:
                pos[e.slot] = e.packets[0][0]
                mask[e.slot] = True
            logits, self.caches = self.collm.cloud_step(
                dense, self.caches, torch.as_tensor(pos, device=dev),
                block_tbl=self._block_tbl(),
                write_mask=torch.as_tensor(mask, device=dev))
        for e in wave:
            e.group["logits"] = logits
        self.stats.steps += 1
        self.stats.rows += len(wave)
        self.stats.max_rows = max(self.stats.max_rows, len(wave))
        self.stats.cloud_time += time.perf_counter() - t0

    def kv_cache_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size()
                   for layers in self.caches.values() for c in layers
                   for leaf in c["self"].values())
