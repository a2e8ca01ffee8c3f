"""Per-layer decoder blocks (port of the DENSE path of
``repro.models.blocks``).

    DecoderBlock(cfg)                              -> parameters of ONE layer
    block_forward(block, cfg, x, ctx, cache)       -> (x, cache)
    block_decode(block, cfg, x, cache, ctx)        -> (x, cache)
    init_block_cache(cfg, batch, max_seq, window)  -> cache for ONE layer
    init_block_cache_paged(cfg, num_pages, page_size) -> paged cache, ditto

Caches are updated in place (see ``repro_torch.models.attention``).  Other
block kinds (MoE, mamba2, xLSTM, shared attention, cross-attention) and
layer norms are not ported yet (ROADMAP A.9) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models.attention import (Attention, attention_forward,
                                          decode_attention,
                                          decode_attention_paged,
                                          init_attention, init_attn_cache,
                                          init_paged_attn_cache)
from repro_torch.models.common import dense_init_, rms_norm

Cache = Dict[str, Any]


@dataclasses.dataclass
class BlockCtx:
    positions: Optional[torch.Tensor] = None   # (S,) absolute positions
    window: int = 0                            # sliding window for this layer
    causal: bool = True
    pos: Optional[torch.Tensor] = None         # decode positions (B,) int32
    block_tbl: Optional[torch.Tensor] = None   # (B, max_logical) paged table
    write_mask: Optional[torch.Tensor] = None  # (B,) rows allowed to write KV


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        if cfg.mlp_kind == "gelu":
            self.w1 = nn.Parameter(torch.empty(d, f, **kw))
            self.b1 = nn.Parameter(torch.empty(f, **kw))
            self.w2 = nn.Parameter(torch.empty(f, d, **kw))
            self.b2 = nn.Parameter(torch.empty(d, **kw))
        else:
            self.w_gate = nn.Parameter(torch.empty(d, f, **kw))
            self.w_up = nn.Parameter(torch.empty(d, f, **kw))
            self.w_down = nn.Parameter(torch.empty(f, d, **kw))


class DecoderBlock(nn.Module):
    """Attention + MLP with pre-norms; parameter names follow the JAX
    package's pytree (``attn.wq``, ``mlp.w_gate``, ``ln1_scale``, ...)."""

    def __init__(self, cfg: ModelConfig, kind: str = DENSE, *, device,
                 dtype):
        super().__init__()
        if kind != DENSE:
            raise NotImplementedError(f"block kind {kind!r} is not ported "
                                      f"yet (ROADMAP A.9)")
        kw = dict(device=device, dtype=dtype)
        self.attn = Attention(cfg, **kw)
        self.mlp = MLP(cfg, **kw)
        self.ln1_scale = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.ln2_scale = nn.Parameter(torch.empty(cfg.d_model, **kw))


@torch.no_grad()
def init_block(block: DecoderBlock, cfg: ModelConfig,
               gen: torch.Generator) -> None:
    """Fill one block with the JAX package's distributions."""
    init_attention(block.attn, gen)
    for name, w in block.mlp.named_parameters():
        if name.startswith("b"):
            w.zero_()
        else:
            dense_init_(w, gen)
    block.ln1_scale.zero_()           # rms gains are (1 + scale)
    block.ln2_scale.zero_()


def _norm(x: torch.Tensor, block: DecoderBlock, cfg: ModelConfig,
          key: str) -> torch.Tensor:
    return rms_norm(x, getattr(block, key + "_scale"), cfg.norm_eps)


def _mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p.w1.to(x.dtype) + p.b1.to(x.dtype), approximate="tanh")
        return h @ p.w2.to(x.dtype) + p.b2.to(x.dtype)
    g = F.silu(x @ p.w_gate.to(x.dtype))
    u = x @ p.w_up.to(x.dtype)
    return (g * u) @ p.w_down.to(x.dtype)


def init_block_cache(cfg: ModelConfig, batch: int, max_seq: int, window: int,
                     *, device=None, dtype=torch.float32) -> Cache:
    return {"self": init_attn_cache(cfg, batch, max_seq, window=window,
                                    device=device, dtype=dtype)}


def init_block_cache_paged(cfg: ModelConfig, num_pages: int, page_size: int,
                           *, device=None, dtype=torch.float32,
                           kv_dtype: str = "float32") -> Cache:
    """Paged variant: self-attention K/V lives in the shared page pool (no
    batch axis — rows address it through their block table).
    ``kv_dtype="int8"`` stores the pages quantized with per-row scales."""
    return {"self": init_paged_attn_cache(cfg, num_pages, page_size,
                                          device=device, dtype=dtype,
                                          kv_dtype=kv_dtype)}


def block_forward(block: DecoderBlock, cfg: ModelConfig, x: torch.Tensor,
                  ctx: BlockCtx, cache: Optional[Cache] = None
                  ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence forward; fills ``cache`` in place when given."""
    h = _norm(x, block, cfg, "ln1")
    att, _ = attention_forward(
        block.attn, cfg, h, positions=ctx.positions, causal=ctx.causal,
        window=ctx.window, use_rope=cfg.use_rope,
        cache=cache["self"] if cache is not None else None)
    x = x + att
    h2 = _norm(x, block, cfg, "ln2")
    return x + _mlp(block.mlp, cfg, h2), cache


def block_decode(block: DecoderBlock, cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, ctx: BlockCtx) -> Tuple[torch.Tensor, Cache]:
    """Single-token decode (x: (B,1,d)); updates ``cache`` in place.  A
    paged cache (it holds ``kp``) decodes through the block table in
    ``ctx``; ``ctx.write_mask`` keeps the masked-out rows' KV as it was."""
    h = _norm(x, block, cfg, "ln1")
    if "kp" in cache["self"]:
        att, _ = decode_attention_paged(
            block.attn, cfg, h, cache["self"], ctx.pos, ctx.block_tbl,
            window=ctx.window, use_rope=cfg.use_rope,
            write_mask=ctx.write_mask)
    else:
        att, _ = decode_attention(block.attn, cfg, h, cache["self"], ctx.pos,
                                  window=ctx.window, use_rope=cfg.use_rope,
                                  write_mask=ctx.write_mask)
    x = x + att
    h2 = _norm(x, block, cfg, "ln2")
    return x + _mlp(block.mlp, cfg, h2), cache
