"""Multi-head attention: GQA, optional bias, RoPE, sliding-window masks,
the direct full-sequence path (training / prefill) and single-token decode
over a dense ring KV cache or a block-paged KV pool (float or int8 pages).

Port of ``repro.models.attention``.  Decode attention goes through the
``decode_attn`` / ``decode_attn_paged`` kernels
(``repro_torch.kernels.decode_attn``) instead of einsums, and each int8
page write (a decode step's K/V, a prefilled row's scatter) through one
launch of a ``quantize`` kernel (``quantize_kv_write`` /
``quantize_kv_scatter``).  Caches are updated IN PLACE
(``index_copy_`` / ``index_put_``) where the JAX package returns new
arrays: the cache passed in is the cache returned.  So a row excluded by a
decode ``write_mask`` is never written (dense: its old entry is written
back; paged: the write goes to the trash page with ``pos = -1``), where
the JAX package computes every row and merges the old rows back.  The
chunked and banded long-sequence paths (ROADMAP A.8) and the
chunked-prefill paged path (``chunk_attention_paged``, ROADMAP A.5) are not
ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_paged
from repro_torch.kernels.quantize.ops import (quantize_int8,
                                              quantize_kv_scatter,
                                              quantize_kv_write)
from repro_torch.kernels.quantize.ref import (page_slots, page_tiles,
                                              quantize_rows)
from repro_torch.models.common import apply_rope, dense_init_

Cache = Dict[str, torch.Tensor]

_DIRECT_LIMIT = 1 << 22   # Sq*Sk above this -> chunked path (not ported)


class Attention(nn.Module):
    """Projection weights of one attention layer, applied as ``x @ W``
    (the JAX package's layout, so weights carry across unchanged)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.empty(h * hd, **kw))
            self.bk = nn.Parameter(torch.empty(kv * hd, **kw))
            self.bv = nn.Parameter(torch.empty(kv * hd, **kw))


@torch.no_grad()
def init_attention(p: Attention, gen: torch.Generator) -> None:
    """The JAX package's distributions: N(0,1)/sqrt(d_in) weights, zero
    biases."""
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init_(w, gen)
    for name in ("bq", "bk", "bv"):
        if hasattr(p, name):
            getattr(p, name).zero_()


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 kv_src: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p.wq.to(x.dtype)
    k = kv_src @ p.wk.to(x.dtype)
    v = kv_src @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(*q.shape[:2], h, hd)
    k = k.reshape(*k.shape[:2], kv, hd)
    v = v.reshape(*v.shape[:2], kv, hd)
    return q, k, v


# ---------------------------------------------------------------------------
# Masked softmax attention core
# ---------------------------------------------------------------------------
def _mask_logits(logits: torch.Tensor, qpos: torch.Tensor,
                 kpos: torch.Tensor, causal: bool, window: int,
                 prefix_len: int) -> torch.Tensor:
    """logits: (..., Sq, Sk); qpos: (Sq,), kpos: (Sk,)."""
    ok = torch.ones(logits.shape[-2:], dtype=torch.bool, device=logits.device)
    if causal:
        allowed = kpos[None, :] <= qpos[:, None]
        if prefix_len:
            allowed = allowed | (kpos[None, :] < prefix_len)
        ok &= allowed
    if window:
        ok &= (qpos[:, None] - kpos[None, :]) < window
    return logits.masked_fill(~ok, float("-inf"))


def _direct_attention(q, k, v, qpos, kpos, *, causal, window, prefix_len,
                      scale) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D) -> (B,Sq,H,D)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    logits = _mask_logits(logits, qpos, kpos, causal, window, prefix_len)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)          # fully-masked rows
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                    window: int = 0, kv_len: Optional[int] = None,
                    device=None, dtype=torch.float32) -> Cache:
    s = kv_len if kv_len is not None else (min(max_seq, window) if window
                                           else max_seq)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, s, kvh, hd), device=device, dtype=dtype),
        "v": torch.zeros((batch, s, kvh, hd), device=device, dtype=dtype),
        "pos": torch.full((batch, s), -1, device=device, dtype=torch.int32),
    }


def _cache_write(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> Cache:
    """Write S new kv entries at ring slots ``positions % size``, in place
    (only the last ``size`` entries survive when S exceeds the ring)."""
    size = cache["k"].shape[1]
    s = k.shape[1]
    if s > size:
        k, v, positions = k[:, s - size:], v[:, s - size:], positions[s - size:]
    idx = (positions % size).long()
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, idx, positions.to(torch.int32)[None, :]
                             .expand(k.shape[0], -1))
    return cache


# ---------------------------------------------------------------------------
# Paged caches (block tables; see repro_torch.core.paging)
# ---------------------------------------------------------------------------
def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of K/V entries: one absmax scale per
    ``(..., kv_head)`` row over ``head_dim`` — the transport quantizer's
    scaling, through the ``quantize`` kernel on the card.

    x: (..., KV, d) -> (q int8 (..., KV, d), scale float32 (..., KV))."""
    return quantize_rows(x, quantize_int8)


def init_paged_attn_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                          *, device=None, dtype=torch.float32,
                          kv_dtype: str = "float32") -> Cache:
    """Page-pool KV storage for ONE layer.  Physical page 0 is the trash
    page (writes of unmapped rows land there); ``pos = -1`` marks an empty
    page slot, so a freshly (re)allocated page is invisible to attention
    until it is written.  ``kv_dtype="int8"`` stores int8 pages with
    per-row absmax scales ``ks``/``vs`` (P+1, page_size, KV) float32;
    ``"float32"`` keeps the pages in the model's dtype."""
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    p = num_pages + 1                              # + trash page
    kw = dict(device=device)
    if kv_dtype == "int8":
        return {
            "kp": torch.zeros((p, page_size, kvh, hd), dtype=torch.int8, **kw),
            "vp": torch.zeros((p, page_size, kvh, hd), dtype=torch.int8, **kw),
            "ks": torch.zeros((p, page_size, kvh), dtype=torch.float32, **kw),
            "vs": torch.zeros((p, page_size, kvh), dtype=torch.float32, **kw),
            "pos": torch.full((p, page_size), -1, dtype=torch.int32, **kw),
        }
    if kv_dtype != "float32":
        raise ValueError(f"kv_dtype must be 'float32' or 'int8', "
                         f"got {kv_dtype!r}")
    return {
        "kp": torch.zeros((p, page_size, kvh, hd), dtype=dtype, **kw),
        "vp": torch.zeros((p, page_size, kvh, hd), dtype=dtype, **kw),
        "pos": torch.full((p, page_size), -1, dtype=torch.int32, **kw),
    }


def _page_ids(pages, device) -> torch.Tensor:
    """Physical page ids as a long tensor; entries < 0 -> the trash page."""
    pages = torch.as_tensor(pages, device=device)
    return torch.where(pages >= 0, pages, 0).long()


def paged_scatter_prefill(cache: Cache, row: Cache, pages) -> Cache:
    """Scatter a single-row dense prefill cache into physical pages, in
    place.

    ``row``: dense cache {"k": (1, L, KV, d), ...} as produced by prefill
    on one stream (ring wide enough that slot ``s`` holds position ``s``).
    ``pages``: (ceil(L / page_size),) physical page ids; entries ``< 0``
    redirect to the trash page (right-pad positions beyond the pages the
    allocator actually granted — their ``pos`` is already -1).  int8
    pages take K, V, scales and markers in one ``quantize_kv_scatter``
    launch."""
    dev = cache["kp"].device
    if "ks" in cache:                              # int8 pages + scales
        return quantize_kv_scatter(
            cache, row, torch.as_tensor(pages, dtype=torch.int32, device=dev))
    ps = cache["kp"].shape[1]
    dest = _page_ids(pages, dev)
    n_lp = dest.shape[0]
    cache["pos"][dest] = page_tiles(row["pos"], n_lp, ps, -1).to(torch.int32)
    cache["kp"][dest] = page_tiles(row["k"], n_lp, ps, 0).to(
        cache["kp"].dtype)
    cache["vp"][dest] = page_tiles(row["v"], n_lp, ps, 0).to(
        cache["vp"].dtype)
    return cache


def paged_reset_pages(cache: Cache, pages) -> Cache:
    """Invalidate the given physical pages (``pos = -1``) in place, so a
    page freed from a retired stream never leaks stale K/V once
    reallocated.  Entries ``< 0`` redirect to the trash page (already
    invalid)."""
    cache["pos"][_page_ids(pages, cache["pos"].device)] = -1
    return cache


def paged_gather(cache: Cache, block_tbl: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize the logical (B, max_logical*page_size) K/V view of a
    paged cache through the block table (unmapped pages read the trash page
    and are masked via ``pos = -1``)."""
    b, n_lp = block_tbl.shape
    ps = cache["kp"].shape[1]
    phys = torch.where(block_tbl >= 0, block_tbl, 0).long()
    k, v = cache["kp"][phys], cache["vp"][phys]
    if "ks" in cache:                              # dequantize int8 pages
        k = k.float() * cache["ks"][phys][..., None]
        v = v.float() * cache["vs"][phys][..., None]
    k = k.reshape(b, n_lp * ps, *k.shape[3:])
    v = v.reshape(b, n_lp * ps, *v.shape[3:])
    kpos = torch.where(block_tbl[:, :, None] >= 0, cache["pos"][phys],
                       -1).reshape(b, n_lp * ps)
    return k, v, kpos


# ---------------------------------------------------------------------------
# Public forwards
# ---------------------------------------------------------------------------
def attention_forward(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True, window: int = 0,
                      prefix_len: int = 0, use_rope: bool = True,
                      cache: Optional[Cache] = None
                      ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence self-attention (training / prefill).  Returns
    (output, the cache written in place, or None)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, x)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    if (window and s > window) or s * s > _DIRECT_LIMIT:
        raise NotImplementedError(
            "banded / chunked long-sequence attention is not ported yet "
            "(ROADMAP A.8); the direct path covers S*S <= 2**22 without a "
            "window shorter than S")
    out = _direct_attention(q, k, v, positions, positions, causal=causal,
                            window=window, prefix_len=prefix_len, scale=scale)
    if cache is not None:
        cache = _cache_write(cache, k, v, positions)
    y = out.reshape(b, s, -1) @ p.wo.to(x.dtype)
    return y, cache


def _project_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    pos: torch.Tensor, use_rope: bool):
    """q (B,1,H,d), k/v (B,1,KV,d) of one new token per row, rotated to
    its per-row position."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    q = x @ p.wq.to(x.dtype)
    knew = x @ p.wk.to(x.dtype)
    vnew = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        knew = knew + p.bk.to(x.dtype)
        vnew = vnew + p.bv.to(x.dtype)
    q = q.reshape(b, 1, h, hd)
    knew = knew.reshape(b, 1, kvh, hd)
    vnew = vnew.reshape(b, 1, kvh, hd)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        knew = apply_rope(knew, pos[:, None], cfg.rope_theta)
    return q, knew, vnew


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: Cache, pos: torch.Tensor, *, window: int = 0,
                     use_rope: bool = True,
                     write_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """Single-token decode.  x: (B,1,d); pos: (B,) int32 per-row positions
    (continuous batching: every row decodes at its own offset).  Writes the
    new K/V into the ring in place, then attends through the
    ``decode_attn`` kernel (its plain version on the CPU).  A row whose
    ``write_mask`` (B,) bool is False keeps its ring bit for bit (its old
    entry is written back); its output is meaningless."""
    b = x.shape[0]
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    q, knew, vnew = _project_decode(p, cfg, x, pos, use_rope)
    size = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (pos % size).long()
    knew = knew[:, 0].to(cache["k"].dtype)
    vnew = vnew[:, 0].to(cache["v"].dtype)
    pnew = pos
    if write_mask is not None:
        keep = ~write_mask
        knew = torch.where(keep[:, None, None], cache["k"][rows, slot], knew)
        vnew = torch.where(keep[:, None, None], cache["v"][rows, slot], vnew)
        pnew = torch.where(keep, cache["pos"][rows, slot], pos)
    cache["k"].index_put_((rows, slot), knew)
    cache["v"].index_put_((rows, slot), vnew)
    cache["pos"].index_put_((rows, slot), pnew)
    out = decode_attn(q.reshape(b, h, hd).contiguous(), cache["k"],
                      cache["v"], cache["pos"], pos, window=window)
    y = out.reshape(b, 1, h * hd) @ p.wo.to(x.dtype)
    return y, cache


def decode_attention_paged(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           cache: Cache, pos: torch.Tensor,
                           block_tbl: torch.Tensor, *, window: int = 0,
                           use_rope: bool = True,
                           write_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Cache]:
    """Single-token decode over a block-paged KV cache.

    x: (B,1,d); pos: (B,) int32 per-row positions; block_tbl: (B,
    max_logical) int32 physical page ids (-1 = unallocated).  Each row
    writes its new K/V in place at page ``block_tbl[b, pos // page_size]``,
    slot ``pos % page_size`` (int8 pools quantize and write K, V, scales
    and markers in one ``quantize_kv_write`` launch); rows without a
    mapping there — inactive slots, or rows excluded by ``write_mask``
    (masked cloud step) — are redirected to the trash page with
    ``pos = -1``.  Attention then runs through the ``decode_attn_paged``
    kernel over the table."""
    b = x.shape[0]
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    q, knew, vnew = _project_decode(p, cfg, x, pos, use_rope)
    if "ks" in cache:                              # quantize on write
        quantize_kv_write(cache, knew[:, 0], vnew[:, 0], pos, block_tbl,
                          write_mask)
    else:
        dest, slot, ok = page_slots(pos, block_tbl, write_mask,
                                    cache["kp"].shape[1])
        cache["pos"].index_put_((dest, slot), torch.where(ok, pos, -1))
        cache["kp"].index_put_((dest, slot), knew[:, 0].to(cache["kp"].dtype))
        cache["vp"].index_put_((dest, slot), vnew[:, 0].to(cache["vp"].dtype))
    out = decode_attn_paged(q.reshape(b, h, hd).contiguous(), cache["kp"],
                            cache["vp"], cache["pos"], block_tbl, pos,
                            k_scale=cache.get("ks"), v_scale=cache.get("vs"),
                            window=window)
    y = out.reshape(b, 1, h * hd) @ p.wo.to(x.dtype)
    return y, cache
