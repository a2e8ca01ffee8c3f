"""Plain PyTorch versions of GQA flash-decode attention over a ring KV cache
and over a block-paged KV pool (mirrors of
``repro.kernels.decode_attn.ref``)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_ids: torch.Tensor, cur_pos,
                    window: int = 0) -> torch.Tensor:
    """q: (B,H,d); k/v: (B,S,KV,d); pos_ids: (B,S) (-1 = empty slot);
    cur_pos: scalar or per-row (B,) int.  Returns (B,H,d) in q's dtype; a
    row with no valid key gives 0."""
    b, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cur = torch.as_tensor(cur_pos, dtype=torch.int32,
                          device=q.device).broadcast_to((b,))[:, None]
    qg = q.reshape(b, kvh, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k.float()) / math.sqrt(d)
    valid = (pos_ids >= 0) & (pos_ids <= cur)
    if window:
        valid &= (cur - pos_ids) < window
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attn_paged_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                          pos_pages: torch.Tensor, block_tbl: torch.Tensor,
                          cur_pos, window: int = 0, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q: (B,H,d); kp/vp: (P,page,KV,d) physical pages; pos_pages: (P,page)
    (-1 = empty slot); block_tbl: (B,n_lp) physical page ids (-1 =
    unallocated); cur_pos: scalar or per-row (B,) int.  Returns (B,H,d).

    Gathers the logical K/V view through the block table (unmapped pages
    read page 0, masked via pos = -1), dequantizes int8 pages with the
    (P,page,KV) float32 ``k_scale``/``v_scale`` when given, then attends
    exactly like the ring version."""
    b = q.shape[0]
    ps, kvh, d = kp.shape[1:]
    n_lp = block_tbl.shape[1]
    mapped = block_tbl >= 0
    phys = torch.where(mapped, block_tbl, 0).long()
    k, v = kp[phys], vp[phys]
    if k_scale is not None:
        k = k.float() * k_scale[phys][..., None]
        v = v.float() * v_scale[phys][..., None]
    k = k.reshape(b, n_lp * ps, kvh, d)
    v = v.reshape(b, n_lp * ps, kvh, d)
    pos = torch.where(mapped[:, :, None], pos_pages[phys],
                      -1).reshape(b, n_lp * ps)
    return decode_attn_ref(q, k, v, pos, cur_pos, window=window)
