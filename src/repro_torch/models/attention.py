"""Multi-head attention: GQA, optional bias, RoPE, sliding-window and
prefix-LM masks, cross-attention over an encoder's output, the
full-sequence paths of training and prefill (direct, chunked flash-style
for long sequences, banded for sliding windows), single-token decode over
a dense ring KV cache or a block-paged KV pool (float or int8 pages), the
page-sized chunk decode of chunked prefill over the paged pool (its
tokens as rows of the paged kernels), and cross decode over a cache of
the encoder's keys (``build_cross_cache``), read through the ring kernel.

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
chunked and banded prefill paths are XLA in the JAX package and stay
torch operations here; a pass of either batches whole query chunks up to
``_TILE_ELEMS`` float32 logits (every query sees the same keys in the
same order as in the JAX package's scans).  A right-padded prefill
(``valid_len``) keeps its real tokens in a ring narrower than the padded
sequence, where the JAX package keeps the pads (ROADMAP §C).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_paged
from repro_torch.kernels.quantize.ops import (quantize_int8,
                                              quantize_kv_scatter,
                                              quantize_kv_write)
from repro_torch.kernels.quantize.ref import (page_slots, page_tiles,
                                              quantize_rows)
from repro_torch.launch.sharding import Axis, reduce_model
from repro_torch.models.common import apply_rope, dense_init_

Cache = Dict[str, torch.Tensor]

_DIRECT_LIMIT = 1 << 22   # Sq*Sk above this -> chunked path
_Q_CHUNK = 512
_KV_CHUNK = 1024
_TILE_ELEMS = 1 << 27     # float32 logits of one chunked / banded pass


class HeadSplit(NamedTuple):
    """A rank's share of one attention layer under a model axis.
    ``heads`` query heads from ``h0`` and ``kv_heads`` KV heads from
    ``k0`` are the rank's (what its cache keeps); ``kv_split`` says that
    ``wk`` / ``wv`` are split too, else they are whole (the KV heads do
    not divide the axis, as the JAX package's head-aligned rule has it)
    and the rank keeps its KV heads of the projection.  ``axis`` is the
    axis to sum ``wo``'s partial products over, or None when nothing is
    split (the heads do not divide the axis: every rank computes the
    whole layer)."""
    heads: int
    kv_heads: int
    h0: int = 0
    k0: int = 0
    kv_split: bool = False
    axis: Optional[Axis] = None


def head_split(cfg: ModelConfig, axis: Optional[Axis] = None) -> HeadSplit:
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if axis is None or axis.size == 1 or h % axis.size:
        return HeadSplit(h, kv)
    hl = h // axis.size
    h0 = axis.index * hl
    g = h // kv
    if hl % g and g % hl:
        raise ValueError(f"{cfg.name}: {hl} query heads a rank over groups "
                         f"of {g} give no whole GQA group a rank")
    k0, k1 = h0 // g, (h0 + hl - 1) // g + 1
    return HeadSplit(hl, k1 - k0, h0, k0, kv % axis.size == 0, axis)


class Attention(nn.Module):
    """Projection weights of one attention layer, applied as ``x @ W``
    (the JAX package's layout, so weights carry across unchanged).  Under
    a model ``axis`` they are the rank's share (``head_split``): ``wq``
    its heads' columns, ``wo`` their rows, ``wk`` / ``wv`` their KV
    heads' columns or whole; the biases stay whole (1-D leaves are
    replicated) and are sliced where they are added."""

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        self.split = head_split(cfg, axis)
        hl = self.split.heads
        kvw = self.split.kv_heads if self.split.kv_split else kv
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, hl * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kvw * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kvw * hd, **kw))
        self.wo = nn.Parameter(torch.empty(hl * hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.empty(h * hd, **kw))
            self.bk = nn.Parameter(torch.empty(kv * hd, **kw))
            self.bv = nn.Parameter(torch.empty(kv * hd, **kw))


def _q_bias(p: Attention, hd: int, dtype) -> torch.Tensor:
    s = p.split
    return p.bq[s.h0 * hd:(s.h0 + s.heads) * hd].to(dtype)


def _kv_bias(p: Attention, w: torch.Tensor, hd: int, dtype) -> torch.Tensor:
    s = p.split
    if s.kv_split:
        return w[s.k0 * hd:(s.k0 + s.kv_heads) * hd].to(dtype)
    return w.to(dtype)


def _keep_kv(p: Attention, k: torch.Tensor) -> torch.Tensor:
    """(..., KV, d) projected KV heads -> the rank's (..., kv_heads, d)."""
    s = p.split
    if s.kv_split or k.shape[-2] == s.kv_heads:
        return k
    return k[..., s.k0:s.k0 + s.kv_heads, :].contiguous()


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """The output projection of the rank's heads, summed over the model
    group (its partial products add up to the whole layer's)."""
    return reduce_model(o @ p.wo.to(o.dtype), p.split.axis)


@torch.no_grad()
def init_attention(p: Attention, gen: torch.Generator) -> None:
    """The JAX package's distributions: N(0,1)/sqrt(d_in) weights, zero
    biases."""
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init_(w, gen)
    for name in ("bq", "bk", "bv"):
        if hasattr(p, name):
            getattr(p, name).zero_()


def _project_kv(p: Attention, cfg: ModelConfig, src: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k, v (B, S, kv_heads, d) of the rank's KV heads from ``src``."""
    hd = cfg.resolved_head_dim
    k = src @ p.wk.to(src.dtype)
    v = src @ p.wv.to(src.dtype)
    if cfg.qkv_bias:
        k = k + _kv_bias(p, p.bk, hd, src.dtype)
        v = v + _kv_bias(p, p.bv, hd, src.dtype)
    return (_keep_kv(p, k.reshape(*k.shape[:2], -1, hd)),
            _keep_kv(p, v.reshape(*v.shape[:2], -1, hd)))


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 kv_src: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    if cfg.qkv_bias:
        q = q + _q_bias(p, hd, x.dtype)
    k, v = _project_kv(p, cfg, kv_src)
    return q.reshape(*q.shape[:2], -1, hd), k, v


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


def _hidden_blocks(qpos: torch.Tensor, kpos: torch.Tensor, q_rows: int,
                   kv_chunk: int, *, causal: bool, window: int,
                   prefix_len: int) -> list:
    """``hidden[i][j]``: the mask hides kv chunk ``j`` from every query of
    pass ``i`` (``q_rows`` queries a pass), read once on the host."""
    qp = qpos.reshape(-1, q_rows)
    kp = kpos.reshape(-1, kv_chunk)
    qlo, qhi, klo, khi = (t.tolist() for t in (qp.amin(1), qp.amax(1),
                                               kp.amin(1), kp.amax(1)))
    return [[(causal and k0 > q1 and not (prefix_len and k0 < prefix_len))
             or (window and q0 - k1 >= window)
             for k0, k1 in zip(klo, khi)] for q0, q1 in zip(qlo, qhi)]


def _chunked_attention(q, k, v, qpos, kpos, *, causal, window, prefix_len,
                       scale, q_chunk=_Q_CHUNK, kv_chunk=_KV_CHUNK,
                       tile=_TILE_ELEMS) -> torch.Tensor:
    """Two-level online-softmax scan; memory O(rows * kv_chunk) a step.

    The JAX package scans the q chunks and, inside each, the kv chunks in
    order.  Here one pass takes as many whole q chunks as ``tile`` float32
    logits allow and runs the kv scan for all of them at once, so each
    query still sees the kv chunks in the same order.  A kv chunk that
    the mask hides from every query of the pass is skipped: its update
    would leave (acc, m, l) as they are (its weights are 0 and the
    correction is exp(0) = 1, or 0 while nothing was seen).  Products in
    float32 (JAX's ``preferred_element_type``); the probabilities round to
    v's dtype before the value product, as in JAX."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q_chunk = math.gcd(sq, q_chunk)
    kv_chunk = math.gcd(sk, kv_chunk)
    rows = min(sq, max(1, tile // (b * h * q_chunk * kv_chunk)) * q_chunk)
    while sq % rows:                                # whole passes
        rows -= q_chunk
    hidden = _hidden_blocks(qpos, kpos, rows, kv_chunk, causal=causal,
                            window=window, prefix_len=prefix_len)
    qg = q.reshape(b, sq, kvh, g, d)
    out = torch.empty((b, sq, kvh, g, d), dtype=q.dtype, device=q.device)
    for i, r0 in enumerate(range(0, sq, rows)):
        qblk = qg[:, r0:r0 + rows].float()
        qp = qpos[r0:r0 + rows]
        acc = torch.zeros((b, kvh, g, rows, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kvh, g, rows), float("-inf"), device=q.device)
        l = torch.zeros((b, kvh, g, rows), device=q.device)
        for j in range(sk // kv_chunk):
            if hidden[i][j]:
                continue
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            logits = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                                  k[:, ks].float()) * scale
            logits = _mask_logits(logits, qp, kpos[ks], causal, window,
                                  prefix_len)
            m_new = torch.maximum(m, logits.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            # exp(-inf) is already the 0 JAX selects for masked; in place
            # unless autograd records (amax saved the logits)
            if logits.requires_grad:
                p = (logits - m_safe[..., None]).exp()
            else:
                p = logits.sub_(m_safe[..., None]).exp_()
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v[:, ks].float())
            l = l * corr + p.sum(-1)
            m = m_new
        acc = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, r0:r0 + rows] = acc.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(b, sq, h, d)


def _banded_attention(q, k, v, qpos, kpos, *, window, scale,
                      q_chunk=_Q_CHUNK, tile=_TILE_ELEMS) -> torch.Tensor:
    """Sliding-window causal attention with exact O(S*window) cost: each
    query chunk attends only to the kv band [chunk_start - window,
    chunk_end) (left-padded with never-valid keys), with a plain softmax
    over the band, as the JAX package's scan does.  One pass takes as
    many chunks as ``tile`` float32 logits allow; their bands are
    overlapping views of the padded keys (``unfold``)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q_chunk = math.gcd(sq, q_chunk)
    nq = sq // q_chunk
    band = window + q_chunk
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, band, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, band, 0))
    kpos_p = torch.nn.functional.pad(kpos, (band, 0), value=-10 ** 9)
    # window w starts at padded key w * q_chunk; chunk i's band is w = i + 1
    kb_all = kp.unfold(1, band, q_chunk)              # (b, nq+1, kvh, d, band)
    vb_all = vp.unfold(1, band, q_chunk)
    kpb_all = kpos_p.unfold(0, band, q_chunk)         # (nq+1, band)
    qg = q.reshape(b, nq, q_chunk, kvh, g, d)
    qpos_c = qpos.reshape(nq, q_chunk)
    per = max(1, tile // (b * h * q_chunk * band))
    out = torch.empty((b, nq, q_chunk, kvh, g, d), dtype=q.dtype,
                      device=q.device)
    for c0 in range(0, nq, per):
        c1 = min(nq, c0 + per)
        qp, kpb = qpos_c[c0:c1], kpb_all[c0 + 1:c1 + 1]
        logits = torch.einsum("bnqkgd,bnkds->bnkgqs", qg[:, c0:c1].float(),
                              kb_all[:, c0 + 1:c1 + 1].float()) * scale
        ok = ((kpb[:, None, :] <= qp[:, :, None])
              & (qp[:, :, None] - kpb[:, None, :] < window))
        logits.masked_fill_(~ok[None, :, None, None], float("-inf"))
        w = torch.softmax(logits, dim=-1)
        w = torch.where(torch.isnan(w), 0.0, w)
        out[:, c0:c1] = torch.einsum(
            "bnkgqs,bnkds->bnqkgd", w.to(v.dtype).float(),
            vb_all[:, c0 + 1:c1 + 1].float()).to(q.dtype)
    return out.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                    window: int = 0, kv_len: Optional[int] = None,
                    device=None, dtype=torch.float32,
                    kv_heads: Optional[int] = None) -> Cache:
    """A dense ring of ``kv_heads`` KV heads (the configuration's, or a
    rank's share under a model axis)."""
    s = kv_len if kv_len is not None else (min(max_seq, window) if window
                                           else max_seq)
    kvh, hd = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, s, kvh, hd), device=device, dtype=dtype),
        "v": torch.zeros((batch, s, kvh, hd), device=device, dtype=dtype),
        "pos": torch.full((batch, s), -1, device=device, dtype=torch.int32),
    }


def _cache_write(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor,
                 valid_len: Optional[int] = None) -> Cache:
    """Write S new kv entries at ring slots ``positions % size``, in place
    (only the last ``size`` entries survive when S exceeds the ring).
    ``valid_len``: entries from ``valid_len`` on are right padding; when
    the ring cannot hold all S, it keeps the last ``size`` REAL entries
    (the JAX package keeps the last ``size`` entries, pads included, so a
    windowed ring loses the prompt's tail: ROADMAP §C)."""
    size = cache["k"].shape[1]
    s = k.shape[1]
    if s > size:
        end = s if valid_len is None else min(s, valid_len)
        start = max(0, end - size)
        k, v, positions = k[:, start:end], v[:, start:end], positions[start:end]
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
                          kv_dtype: str = "float32",
                          kv_heads: Optional[int] = None) -> Cache:
    """Page-pool KV storage for ONE layer.  Physical page 0 is the trash
    page (writes of unmapped rows land there); ``pos = -1`` marks an empty
    page slot, so a freshly (re)allocated page is invisible to attention
    until it is written.  ``kv_dtype="int8"`` stores int8 pages with
    per-row absmax scales ``ks``/``vs`` (P+1, page_size, KV) float32;
    ``"float32"`` keeps the pages in the model's dtype; ``kv_heads`` as
    ``init_attn_cache``."""
    kvh, hd = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
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
                      enc_out: Optional[torch.Tensor] = None,
                      causal: bool = True, window: int = 0,
                      prefix_len: int = 0, use_rope: bool = True,
                      cache: Optional[Cache] = None,
                      valid_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence attention (training / prefill), dispatched as in the
    JAX package: banded when a window is shorter than S, direct while
    Sq*Sk <= ``_DIRECT_LIMIT``, chunked beyond.  ``enc_out`` (B, Se, d)
    makes it cross-attention: keys and values from the encoder's output at
    positions 0..Se-1, no mask, no rotation (``cache`` is then unused; the
    cross cache is ``build_cross_cache``'s).  ``prefix_len``: the first
    positions every query sees (the prefix-LM mask of a vision prefix).
    ``valid_len``: the real length of a right-padded prefill (see
    ``_cache_write``).  Returns (output, the cache written in place, or
    None)."""
    b, s, _ = x.shape
    cross = enc_out is not None
    kv_src = enc_out if cross else x
    sk = kv_src.shape[1]
    q, k, v = _project_qkv(p, cfg, x, kv_src)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    kpos = torch.arange(sk, device=x.device) if cross else positions
    if use_rope and not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    if cross:
        out = (_direct_attention if s * sk <= _DIRECT_LIMIT else
               _chunked_attention)(q, k, v, positions, kpos, causal=False,
                                   window=0, prefix_len=0, scale=scale)
    elif window and s > window:
        out = _banded_attention(q, k, v, positions, positions,
                                window=window, scale=scale)
    else:
        out = (_direct_attention if s * s <= _DIRECT_LIMIT else
               _chunked_attention)(q, k, v, positions, positions,
                                   causal=causal, window=window,
                                   prefix_len=prefix_len, scale=scale)
    if cache is not None and not cross:
        cache = _cache_write(cache, k, v, positions, valid_len)
    return _out(p, out.reshape(b, s, -1)), cache


def _project_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    pos: torch.Tensor, use_rope: bool):
    """q (B,1,H,d), k/v (B,1,KV,d) of one new token per row, rotated to
    its per-row position."""
    q, knew, vnew = _project_qkv(p, cfg, x, x)
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
    hd, h = cfg.resolved_head_dim, p.split.heads
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
    return _out(p, out.reshape(b, 1, h * hd)), cache


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
    hd, h = cfg.resolved_head_dim, p.split.heads
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
    return _out(p, out.reshape(b, 1, h * hd)), cache


def chunk_rows(pos: torch.Tensor, block_tbl: torch.Tensor,
               write_mask: Optional[torch.Tensor], c: int
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """A (B, C) chunk's tokens as the B*C rows of one decode-step page
    write: per-row positions ``pos[b] + i`` (B*C,) int32, the stream's
    block-table row repeated for each of its tokens (B*C, n_lp), and the
    (B,C) or (B,) write mask flattened to (B*C,), all contiguous (the
    operands ``quantize_kv_write`` takes)."""
    b = pos.shape[0]
    pos_bc = pos[:, None] + torch.arange(c, dtype=torch.int32,
                                         device=pos.device)
    rows_mask = None
    if write_mask is not None:
        wm = write_mask if write_mask.dim() == 2 else write_mask[:, None]
        rows_mask = wm.expand(b, c).reshape(-1).contiguous()
    return (pos_bc.reshape(-1).contiguous(),
            block_tbl.repeat_interleave(c, dim=0).contiguous(), rows_mask)


def chunk_attention_paged(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                          cache: Cache, pos: torch.Tensor,
                          block_tbl: torch.Tensor, *, window: int = 0,
                          use_rope: bool = True,
                          write_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Cache]:
    """Multi-token chunk decode over a block-paged KV cache: the compute
    path of chunked prefill (``decode_attention_paged`` generalized from
    one token to a page-sized chunk).

    x: (B,C,d); pos: (B,) int32 FIRST position of each row's chunk (token
    ``i`` sits at ``pos + i``); block_tbl: (B, max_logical) int32.  Each
    token writes its K/V in place at page ``block_tbl[b, (pos+i) // ps]``,
    slot ``(pos+i) % ps``; tokens without a mapping or excluded by
    ``write_mask`` ((B,C) per token, or (B,) per row) go to the trash page
    with ``pos = -1`` (a right-padded final chunk keeps its pads invisible
    so).  An int8 pool takes the chunk's B*C tokens as the rows of ONE
    ``quantize_kv_write`` launch (each row carries its stream's table
    row); float pages take the decode path's index writes.  Writes land
    before the attention, so the chunk's tokens attend to each other
    through the pages under the causal ``kpos <= qpos`` mask.  The
    attention is ONE ``decode_attn_paged`` launch over the same B*C rows:
    token ``i`` is a query row at ``cur = pos + i`` over its stream's
    table, which is that causal mask (the JAX package's float32 einsums
    over the gathered pages, plain XLA there, compute the same
    function)."""
    b, c, _ = x.shape
    hd, h, kvh = cfg.resolved_head_dim, p.split.heads, p.split.kv_heads
    ps = cache["kp"].shape[1]
    rows_pos, rows_tbl, rows_mask = chunk_rows(pos, block_tbl, write_mask,
                                               c)
    pos_bc = rows_pos.view(b, c)
    q, knew, vnew = _project_qkv(p, cfg, x, x)
    if use_rope:
        q = apply_rope(q, pos_bc, cfg.rope_theta)
        knew = apply_rope(knew, pos_bc, cfg.rope_theta)
    k_rows = knew.reshape(b * c, kvh, hd).contiguous()
    v_rows = vnew.reshape(b * c, kvh, hd).contiguous()
    if "ks" in cache:                              # quantize on write
        quantize_kv_write(cache, k_rows, v_rows, rows_pos, rows_tbl,
                          rows_mask)
    else:
        dest, slot, ok = page_slots(rows_pos, rows_tbl, rows_mask, ps)
        cache["pos"].index_put_((dest, slot),
                                torch.where(ok, rows_pos, -1))
        cache["kp"].index_put_((dest, slot), k_rows.to(cache["kp"].dtype))
        cache["vp"].index_put_((dest, slot), v_rows.to(cache["vp"].dtype))

    out = decode_attn_paged(q.reshape(b * c, h, hd).contiguous(),
                            cache["kp"], cache["vp"], cache["pos"], rows_tbl,
                            rows_pos, k_scale=cache.get("ks"),
                            v_scale=cache.get("vs"), window=window)
    return _out(p, out.reshape(b, c, h * hd)), cache


def build_cross_cache(p: Attention, cfg: ModelConfig, enc_out: torch.Tensor,
                      cache: Cache) -> Cache:
    """The encoder's keys and values for cross decode, written in place
    into ``cache`` (a dense per-row entry of Se keys, in its dtype): k/v
    (B, Se, KV, d) projected from ``enc_out`` (B, Se, d) with their
    biases, and ``pos`` = 0..Se-1 in every row."""
    b, sk, _ = enc_out.shape
    k, v = _project_kv(p, cfg, enc_out)
    pos = torch.arange(sk, dtype=torch.int32, device=enc_out.device
                       ).expand(b, sk)
    if cache["k"].shape != k.shape:
        raise ValueError(f"cross cache holds {tuple(cache['k'].shape)} keys, "
                         f"the encoder gave {tuple(k.shape)}: frames must "
                         f"have the configuration's encoder_seq")
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    cache["pos"].copy_(pos)
    return cache


def cross_decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           cache: Cache, cur: torch.Tensor) -> torch.Tensor:
    """Single-token cross-attention (x: (B,1,d)) over a cross cache of Se
    encoder keys, through the ring ``decode_attn`` kernel (its plain
    version on the CPU).  ``cur`` (B,) int32 is Se - 1 in every row with
    no window, so every key (pos 0..Se-1) is valid, as the JAX package's
    ``valid = kpos >= 0``; the cache is read, never written, so a masked
    row leaves it as it is."""
    b = x.shape[0]
    hd, h = cfg.resolved_head_dim, p.split.heads
    q = x @ p.wq.to(x.dtype)
    if cfg.qkv_bias:
        q = q + _q_bias(p, hd, x.dtype)
    out = decode_attn(q.reshape(b, h, hd).contiguous(), cache["k"],
                      cache["v"], cache["pos"], cur)
    return _out(p, out.reshape(b, 1, h * hd))
