"""Plain PyTorch version of GQA flash-decode attention over a ring KV cache
(a mirror of ``repro.kernels.decode_attn.ref.decode_attn_ref``)."""
from __future__ import annotations

import math

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
