"""Multi-head attention: GQA, optional bias, RoPE, sliding-window masks,
the direct full-sequence path (training / prefill) and single-token decode
over a dense ring KV cache.

Port of ``repro.models.attention``.  Decode attention goes through the
``decode_attn`` kernel (``repro_torch.kernels.decode_attn``) instead of
einsums.  KV rings are updated IN PLACE (``index_copy_`` / ``index_put_``)
where the JAX package returns new arrays: the cache passed in is the cache
returned.  The chunked and banded long-sequence paths are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn.ops import decode_attn
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
            "(ROADMAP A.2); the direct path covers S*S <= 2**22 without a "
            "window shorter than S")
    out = _direct_attention(q, k, v, positions, positions, causal=causal,
                            window=window, prefix_len=prefix_len, scale=scale)
    if cache is not None:
        cache = _cache_write(cache, k, v, positions)
    y = out.reshape(b, s, -1) @ p.wo.to(x.dtype)
    return y, cache


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: Cache, pos: torch.Tensor, *, window: int = 0,
                     use_rope: bool = True) -> Tuple[torch.Tensor, Cache]:
    """Single-token decode.  x: (B,1,d); pos: (B,) int32 per-row positions
    (continuous batching: every row decodes at its own offset).  Writes the
    new K/V into the ring in place, then attends through the
    ``decode_attn`` kernel (its plain version on the CPU)."""
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
    size = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (pos % size).long()
    cache["k"].index_put_((rows, slot), knew[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((rows, slot), vnew[:, 0].to(cache["v"].dtype))
    cache["pos"].index_put_((rows, slot), pos)
    out = decode_attn(q.reshape(b, h, hd).contiguous(), cache["k"],
                      cache["v"], cache["pos"], pos, window=window)
    y = out.reshape(b, 1, h * hd) @ p.wo.to(x.dtype)
    return y, cache
