"""Cloud-side content manager (paper §4.2); a copy of
``repro.core.content_manager`` (pure Python).

Host-level component that coordinates per-client state on the cloud tier:

  * uploaded hidden-state packets (parallel upload lands here *before* the
    matching inference request arrives — paper fig 3 step 4); the batched
    scheduler uses the ``*_batch`` variants so one tick touches every
    below-θ client with per-client accounting intact;
  * per-client KV / recurrent caches for the cloud LLM partition on the
    sequential path (``get_cache``/``put_cache``).  The batched
    ``BatchScheduler`` does NOT park caches here: it owns pooled
    device caches (one row — or one set of KV pages under
    ``kv_layout="paged"`` — per slot) and only uses the upload and
    end-of-sequence APIs;
  * release of consumed hidden states and end-of-sequence cleanup
    (paper fig 3 step 6).

It deliberately mirrors the paper's dual-API split: ``upload`` is the data
receive API, ``take_upload``/``take_uploads_upto`` back the inference API.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.core.transport import StatePacket

Pytree = Any


@dataclasses.dataclass
class ClientState:
    device_id: str
    pending_uploads: Dict[int, StatePacket] = dataclasses.field(default_factory=dict)
    cache: Optional[Pytree] = None          # cloud-partition KV / ssm states
    cloud_slot: Optional[int] = None        # row in the CloudBatcher's pool
    last_active: float = 0.0
    uploads_received: int = 0
    uploads_consumed: int = 0
    uploads_released: int = 0
    bytes_received: int = 0
    requests_served: int = 0
    prefix_reused_tokens: int = 0   # prompt tokens deduped against another
                                    # client's cached upload (never re-sent)


class ContentManager:
    """Multi-client cloud state store."""

    def __init__(self, max_pending_per_client: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self._clients: Dict[str, ClientState] = {}
        self._max_pending = max_pending_per_client
        self._clock = clock

    # -- data-receive API ---------------------------------------------------
    def upload(self, device_id: str, pos: int, packet: StatePacket) -> None:
        c = self._client(device_id)
        c.pending_uploads[pos] = packet
        c.uploads_received += 1
        c.bytes_received += packet.nbytes()
        c.last_active = self._clock()
        # continuously release stale hidden states (paper §4.2): any upload
        # older than the window can no longer be requested.
        while len(c.pending_uploads) > self._max_pending:
            oldest = min(c.pending_uploads)
            del c.pending_uploads[oldest]
            c.uploads_released += 1

    # -- inference API ------------------------------------------------------
    def take_upload(self, device_id: str, pos: int) -> StatePacket:
        c = self._client(device_id)
        if pos not in c.pending_uploads:
            raise KeyError(
                f"client {device_id}: no uploaded state for position {pos} "
                f"(have {sorted(c.pending_uploads)})")
        pkt = c.pending_uploads.pop(pos)
        # token inference for pos invalidates earlier speculative uploads
        for stale in [p for p in c.pending_uploads if p < pos]:
            del c.pending_uploads[stale]
            c.uploads_released += 1
        c.uploads_consumed += 1
        c.requests_served += 1
        c.last_active = self._clock()
        return pkt

    def take_upload_keep(self, device_id: str, pos: int) -> StatePacket:
        """Pop exactly ``pos`` WITHOUT invalidating earlier pendings.

        Multi-token drafting holds each draft position's packet at the
        edge of the engine (so the window eviction in ``upload`` cannot
        release a position still awaiting verification) while the
        *backfill* ring of not-yet-consumed earlier uploads must survive
        untouched until the draft's single verification request drains
        them together.  ``take_upload`` would release those earlier
        entries; this variant takes only ``pos``."""
        c = self._client(device_id)
        if pos not in c.pending_uploads:
            raise KeyError(
                f"client {device_id}: no uploaded state for position {pos} "
                f"(have {sorted(c.pending_uploads)})")
        pkt = c.pending_uploads.pop(pos)
        c.uploads_consumed += 1
        c.last_active = self._clock()
        return pkt

    def take_uploads_upto(self, device_id: str, pos: int):
        """Backfill mode: pop ALL pending uploads with position <= pos, in
        order (beyond-paper exact-KV mode; see DESIGN.md)."""
        c = self._client(device_id)
        out = []
        for p in sorted(k for k in c.pending_uploads if k <= pos):
            out.append((p, c.pending_uploads.pop(p)))
            c.uploads_consumed += 1
        c.requests_served += 1
        c.last_active = self._clock()
        return out

    # -- batched APIs (continuous-batching scheduler) -----------------------
    # One scheduler tick touches every below-θ slot at once; these keep the
    # per-client accounting identical to the sequential API while letting the
    # engine build a single dense cloud call out of the returned packets.
    def upload_batch(self, items) -> None:
        """items: iterable of (device_id, pos, StatePacket)."""
        for device_id, pos, packet in items:
            self.upload(device_id, pos, packet)

    def take_upload_batch(self, items):
        """items: iterable of (device_id, pos) -> [StatePacket, ...] in order.
        Per-entry semantics match ``take_upload`` (stale invalidation)."""
        return [self.take_upload(d, p) for d, p in items]

    def take_uploads_upto_batch(self, items):
        """Backfill variant: items (device_id, pos) -> list of per-client
        [(pos, StatePacket), ...] pending rings, oldest first."""
        return [self.take_uploads_upto(d, p) for d, p in items]

    def has_upload(self, device_id: str, pos: int) -> bool:
        c = self._clients.get(device_id)
        return bool(c and pos in c.pending_uploads)

    # -- prefix dedup ledger -------------------------------------------------
    def note_prefix_reuse(self, device_id: str, tokens: int) -> None:
        """Record that ``tokens`` prompt tokens of this client were served
        from another client's cached cloud prefix (shared KV pages) and
        therefore never crossed the wire.  Pure accounting — the dedup
        decision itself lives in the engine/batcher admission path — but it
        keeps the §4.2 content-management story auditable: received bytes +
        reused tokens together cover every prompt position."""
        c = self._client(device_id)
        c.prefix_reused_tokens += tokens
        c.last_active = self._clock()

    def prefix_reused_tokens(self, device_id: Optional[str] = None) -> int:
        if device_id is not None:
            c = self._clients.get(device_id)
            return 0 if c is None else c.prefix_reused_tokens
        return sum(c.prefix_reused_tokens for c in self._clients.values())

    # -- preemption checkpoint support ---------------------------------------
    # A preempted stream's pending uploads move into its host-side
    # checkpoint and come back verbatim at resume.  Neither direction is a
    # wire event (the packets crossed the wire when first uploaded), so
    # these bypass the received/consumed/released counters on purpose —
    # the stats of a preempted run stay comparable to an un-preempted one.
    def pending_positions(self, device_id: str):
        c = self._clients.get(device_id)
        return sorted(c.pending_uploads) if c else []

    def take_all_uploads(self, device_id: str):
        """Checkpoint: pop every pending upload, oldest first."""
        c = self._clients.get(device_id)
        if c is None:
            return []
        out = [(p, c.pending_uploads.pop(p))
               for p in sorted(c.pending_uploads)]
        return out

    def drop_uploads_after(self, device_id: str, pos: int) -> int:
        """Speculative rewind: release the pending uploads at positions
        after ``pos``.  They were computed from discarded tokens, and left
        in the window they would crowd out (release) the uploads the
        re-decoded stream makes below them.  Returns how many went."""
        c = self._client(device_id)
        stale = [p for p in c.pending_uploads if p > pos]
        for p in stale:
            del c.pending_uploads[p]
        c.uploads_released += len(stale)
        return len(stale)

    def restore_uploads(self, device_id: str, items) -> None:
        """Resume: re-insert a checkpoint's pending uploads."""
        c = self._client(device_id)
        for pos, packet in items:
            c.pending_uploads[pos] = packet

    # -- per-client cloud cache ----------------------------------------------
    def get_cache(self, device_id: str) -> Optional[Pytree]:
        return self._client(device_id).cache

    def put_cache(self, device_id: str, cache: Pytree) -> None:
        c = self._client(device_id)
        c.cache = cache
        c.last_active = self._clock()

    # -- cloud slot pool (CloudBatcher) --------------------------------------
    # The batcher serves every client out of ONE pooled, batch-major cloud
    # cache; the manager owns the device_id -> pool-row mapping so the
    # per-client state (uploads, slot, lifecycle) lives in one place.
    def init_cloud_slots(self, num_slots: int) -> None:
        self._cloud_free_slots = list(range(num_slots - 1, -1, -1))

    def assign_cloud_slot(self, device_id: str) -> int:
        c = self._client(device_id)
        if c.cloud_slot is not None:
            return c.cloud_slot
        if not getattr(self, "_cloud_free_slots", None):
            raise RuntimeError(
                f"cloud slot pool exhausted assigning {device_id} "
                "(release a finished client first)")
        c.cloud_slot = self._cloud_free_slots.pop()
        return c.cloud_slot

    def cloud_slot(self, device_id: str) -> Optional[int]:
        c = self._clients.get(device_id)
        return None if c is None else c.cloud_slot

    def release_cloud_slot(self, device_id: str) -> Optional[int]:
        c = self._clients.get(device_id)
        if c is None or c.cloud_slot is None:
            return None
        slot, c.cloud_slot = c.cloud_slot, None
        self._cloud_free_slots.append(slot)
        return slot

    def cloud_slots_free(self) -> int:
        return len(getattr(self, "_cloud_free_slots", ()))

    # -- lifecycle ------------------------------------------------------------
    def end_of_sequence(self, device_id: str) -> None:
        """Paper step 6: clear KV caches + hidden states on completion."""
        c = self._clients.get(device_id)
        if c is None:
            return
        c.uploads_released += len(c.pending_uploads)
        c.pending_uploads.clear()
        c.cache = None

    def drop_client(self, device_id: str) -> None:
        self._clients.pop(device_id, None)

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {
            d: {"uploads_received": c.uploads_received,
                "uploads_consumed": c.uploads_consumed,
                "uploads_released": c.uploads_released,
                "bytes_received": c.bytes_received,
                "requests_served": c.requests_served,
                "prefix_reused_tokens": c.prefix_reused_tokens,
                "pending": len(c.pending_uploads)}
            for d, c in self._clients.items()
        }

    def clients(self):
        return list(self._clients)

    def _client(self, device_id: str) -> ClientState:
        if device_id not in self._clients:
            self._clients[device_id] = ClientState(device_id=device_id,
                                                   last_active=self._clock())
        return self._clients[device_id]
