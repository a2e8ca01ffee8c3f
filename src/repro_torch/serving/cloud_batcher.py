"""Pooled-cache helpers of the batched engine.

Port of the helper half of ``repro.serving.cloud_batcher``: the admission
scatters of a prefilled row into the pooled (dense or paged) caches, the
page invalidation of retired streams, and the backfill upload ring.  The
``CloudBatcher`` itself (one pooled cloud cache shared by several engines)
is not ported yet (ROADMAP A.5).

Caches are ``{segment index: [per-layer cache, ...]}`` with the batch at
axis 0 of every dense leaf, and are written in place.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

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
