"""Plain PyTorch versions of the int8 quantizer's entries: the per-row
transport quantizer (a mirror of ``repro.kernels.quantize.ref``) and the
two int8 K/V page writes of the paged cache, the torch sequences that
``models/attention.py`` ran before the writes became kernels (mirrors of
``decode_attention_paged``'s and ``paged_scatter_prefill``'s int8 branches
in ``repro.models.attention``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Cache = Dict[str, torch.Tensor]


def quantize_int8_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) -> (q int8 (N,d), scale f32 (N,1)).  ``torch.round``
    rounds half to even, as ``jnp.round`` does.  Both divisions are true
    divisions by tensors: PyTorch turns a division by a Python scalar into
    a multiplication by its reciprocal on CUDA, which moves the scale by
    one ulp from the kernel's and the JAX package's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_rows(x: torch.Tensor, quantize=quantize_int8_ref
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., KV, d) -> (q int8 (..., KV, d), scale f32 (..., KV)): one
    absmax scale per (..., kv head) row, through ``quantize`` (the plain
    quantizer, or the wire kernel's wrapper)."""
    shape = x.shape
    q, s = quantize(x.reshape(-1, shape[-1]).contiguous())
    return q.reshape(shape), s.reshape(shape[:-1])


def page_slots(pos: torch.Tensor, block_tbl: torch.Tensor,
               write_mask: Optional[torch.Tensor], ps: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each row's decode-step K/V goes: (dest page, slot, ok).  Row b
    writes page ``block_tbl[b, pos // ps]`` at slot ``pos % ps``; a row
    whose entry is unmapped (< 0) or whose ``write_mask`` is False is not
    ``ok`` and goes to the trash page 0."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    # out-of-range logical pages clamp to the last, as a JAX gather does
    lp = (pos // ps).long().clamp(max=block_tbl.shape[1] - 1)
    page = block_tbl[rows, lp]
    ok = page >= 0
    if write_mask is not None:
        ok &= write_mask
    dest = torch.where(ok, page, 0).long()
    slot = (pos % ps).long()
    return dest, slot, ok


def quantize_kv_write_ref(cache: Cache, knew: torch.Tensor,
                          vnew: torch.Tensor, pos: torch.Tensor,
                          block_tbl: torch.Tensor,
                          write_mask: Optional[torch.Tensor] = None, *,
                          quantize=quantize_int8_ref) -> Cache:
    """One decode step's K/V rows knew/vnew (B, KV, d) into the int8 page
    pool ``cache`` (kp/vp (P, ps, KV, d) int8, ks/vs (P, ps, KV) f32, pos
    (P, ps) int32), in place, at ``page_slots``; the trash page gets marker
    -1.  ``quantize`` codes the rows (the kernel-free default, or the
    transport kernel to replay the sequence the write kernel replaced)."""
    dest, slot, ok = page_slots(pos, block_tbl, write_mask,
                                cache["kp"].shape[1])
    cache["pos"].index_put_((dest, slot), torch.where(ok, pos, -1))
    qkv, skv = quantize_rows(torch.stack([knew, vnew]), quantize)
    cache["kp"].index_put_((dest, slot), qkv[0])
    cache["vp"].index_put_((dest, slot), qkv[1])
    cache["ks"].index_put_((dest, slot), skv[0])
    cache["vs"].index_put_((dest, slot), skv[1])
    return cache


def page_tiles(x: torch.Tensor, n_lp: int, ps: int, fill) -> torch.Tensor:
    """A single-row ring leaf (1, L, ...) as ``n_lp`` page tiles (n_lp, ps,
    ...): trimmed to ``n_lp * ps`` entries, or padded with ``fill``."""
    x = x[0][:n_lp * ps]                           # drop batch axis, trim ring
    pad = n_lp * ps - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
    return x.reshape((n_lp, ps) + x.shape[1:])


def quantize_kv_scatter_ref(cache: Cache, row: Cache, pages: torch.Tensor, *,
                            quantize=quantize_int8_ref) -> Cache:
    """A single-row dense prefill cache ``row`` ({"k"/"v": (1, L, KV, d),
    "pos": (1, L)}) into the int8 page pool ``cache``, in place: token t
    of the row to page ``pages[t // ps]`` (entries < 0: the trash page) at
    slot ``t % ps``; entries past the ring take code 0, scale 0.0 and
    marker -1."""
    ps = cache["kp"].shape[1]
    dest = torch.where(pages >= 0, pages, 0).long()
    n_lp = dest.shape[0]
    cache["pos"][dest] = page_tiles(row["pos"], n_lp, ps, -1).to(torch.int32)
    # rows are quantized one by one: only the paged part is needed
    qk, sk = quantize_rows(row["k"][:, :n_lp * ps], quantize)
    qv, sv = quantize_rows(row["v"][:, :n_lp * ps], quantize)
    cache["kp"][dest] = page_tiles(qk, n_lp, ps, 0)
    cache["vp"][dest] = page_tiles(qv, n_lp, ps, 0)
    cache["ks"][dest] = page_tiles(sk, n_lp, ps, 0.0)
    cache["vs"][dest] = page_tiles(sv, n_lp, ps, 0.0)
    return cache
