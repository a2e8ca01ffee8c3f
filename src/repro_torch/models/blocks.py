"""Per-layer blocks (port of ``repro.models.blocks``).

    make_block(cfg, kind)                          -> parameters of ONE layer
    init_block(block, cfg, gen)                    -> the JAX distributions
    block_forward(block, cfg, x, ctx, cache)       -> (x, aux, cache)
    block_decode(block, cfg, x, cache, ctx)        -> (x, cache)
    init_block_cache(cfg, batch, max_seq, window, kind=) -> cache of ONE layer
    init_block_cache_paged(cfg, num_pages, page_size, kind=, batch=) -> ditto

A ``DecoderBlock`` is attention and then an MLP (kinds ``dense`` and
``shared_attn``, Zamba2's shared block) or a routed-expert FFN (kind
``moe``: ``moe_forward_local`` in the full-sequence forward,
``moe_forward_decode`` in decode steps and prefill chunks, as the JAX
package runs them).  Its norms are rms norms (``ln1_scale``,
``ln2_scale``) or, with ``norm_type="layernorm"``, layer norms with a
bias each.  A decoder block of an encoder-decoder model also owns a
``cross`` attention (with its norm ``lnx``) between the two: over the
encoder's output in the full-sequence forward, where it fills the
cache's dense per-row ``cross`` entry of ``encoder_seq`` keys
(``build_cross_cache``), and over that entry in decode, through the ring
kernel; the entry stays dense per row in the paged layout too, and
nothing but a prefill writes it.  The recurrent kinds are ``MLSTMBlock`` and
``SLSTMBlock`` (``repro_torch.models.xlstm``) and ``Mamba2Block``
(``repro_torch.models.mamba2``): their caches are dense per row, batch
axis first, in the dense and the paged layout alike (a recurrent state
has nothing to page).  Caches are updated in place (see
``repro_torch.models.attention``); a decode ``write_mask`` keeps the
masked-out rows' KV and recurrent state as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import (DENSE, MAMBA2, MLSTM, MOE, SHARED_ATTN,
                                      SLSTM, ModelConfig)
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm
from repro_torch.models.attention import (Attention, attention_forward,
                                          build_cross_cache,
                                          chunk_attention_paged,
                                          cross_decode_attention,
                                          decode_attention,
                                          decode_attention_paged,
                                          init_attention, init_attn_cache,
                                          init_paged_attn_cache)
from repro_torch.launch.sharding import Axis, reduce_model
from repro_torch.models.cache_tree import commit
from repro_torch.models.common import dense_init_, layer_norm, rms_norm
from repro_torch.models.moe import (MoE, init_moe, moe_forward_decode,
                                    moe_forward_local)

Cache = Dict[str, Any]


@dataclasses.dataclass
class BlockCtx:
    positions: Optional[torch.Tensor] = None   # (S,) absolute positions
    enc_out: Optional[torch.Tensor] = None     # encoder output (enc-dec only)
    prefix_len: int = 0                        # prefix-LM boundary (VLM)
    window: int = 0                            # sliding window for this layer
    causal: bool = True
    pos: Optional[torch.Tensor] = None         # decode positions (B,) int32
    block_tbl: Optional[torch.Tensor] = None   # (B, max_logical) paged table
    # rows (B,) or chunk tokens (B,C) allowed to write KV
    write_mask: Optional[torch.Tensor] = None
    valid_len: Optional[int] = None            # real length of a padded prefill
    # cross decode: (B,) int32 encoder_seq - 1, every encoder key valid
    cross_pos: Optional[torch.Tensor] = None


ATTN_KINDS = (DENSE, SHARED_ATTN, MOE)


class MLP(nn.Module):
    """The gated-SiLU or GeLU FFN.  Under a model ``axis`` whose size
    divides d_ff it is the rank's d_ff slice: ``w_gate`` / ``w_up`` /
    ``w1`` its columns, ``w_down`` / ``w2`` its rows (column- then
    row-parallel), its products summed over the model group; the 1-D
    biases stay whole.  Otherwise it is whole on every rank."""

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.axis = axis if axis is not None and axis.size > 1 and \
            f % axis.size == 0 else None
        if self.axis is not None:
            f //= self.axis.size
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
    """Attention (+ cross-attention) + MLP (or routed experts) with
    pre-norms; parameter names follow the JAX package's pytree
    (``attn.wq``, ``cross.bq``, ``mlp.w_gate``, ``moe.router``,
    ``ln1_scale``, ``lnx_bias``, ...).  ``with_cross`` defaults to the
    configuration's: a decoder block of an encoder-decoder model (the JAX
    package's ``init_block``); encoder blocks pass False."""

    def __init__(self, cfg: ModelConfig, kind: str = DENSE, *, device,
                 dtype, with_cross: Optional[bool] = None,
                 axis: Optional[Axis] = None):
        super().__init__()
        if kind not in ATTN_KINDS:
            raise ValueError(f"{kind!r} is not an attention block kind")
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.attn = Attention(cfg, axis=axis, **kw)
        if kind == MOE:
            self.moe = MoE(cfg, axis=axis, **kw)
        else:
            self.mlp = MLP(cfg, axis=axis, **kw)
        norms = ["ln1", "ln2"]
        if kind != MOE and (cfg.is_encdec if with_cross is None
                            else with_cross):
            self.cross = Attention(cfg, **kw)
            norms.append("lnx")
        parts = ("_scale", "_bias") if cfg.norm_type == "layernorm" else (
            "_scale",)
        for name in norms:
            for part in parts:
                setattr(self, name + part,
                        nn.Parameter(torch.empty(cfg.d_model, **kw)))


class _Recurrent(NamedTuple):
    """A recurrent block kind's module, init, cache and two passes."""
    module: Any
    init: Any
    cache: Any
    forward: Any
    decode: Any


_RECURRENT = {
    MLSTM: _Recurrent(xlstm.MLSTMBlock, xlstm.init_mlstm_block,
                      xlstm.init_mlstm_cache, xlstm.mlstm_forward,
                      xlstm.mlstm_decode),
    SLSTM: _Recurrent(xlstm.SLSTMBlock, xlstm.init_slstm_block,
                      xlstm.init_slstm_cache, xlstm.slstm_forward,
                      xlstm.slstm_decode),
    MAMBA2: _Recurrent(m2.Mamba2Block, m2.init_mamba2_block,
                       m2.init_mamba2_cache, m2.mamba2_forward,
                       m2.mamba2_decode)}


def make_block(cfg: ModelConfig, kind: str, *, device, dtype,
               axis: Optional[Axis] = None) -> nn.Module:
    """The parameters of one layer of ``kind`` (a rank's share under a
    model ``axis``; attention kinds only)."""
    if kind in _RECURRENT:
        return _RECURRENT[kind].module(cfg, device=device, dtype=dtype)
    return DecoderBlock(cfg, kind, device=device, dtype=dtype, axis=axis)


@torch.no_grad()
def init_block(block: nn.Module, cfg: ModelConfig,
               gen: torch.Generator) -> None:
    """Fill one block with the JAX package's distributions."""
    if block.kind in _RECURRENT:
        _RECURRENT[block.kind].init(block, gen)
        return
    init_attention(block.attn, gen)
    if block.kind == MOE:
        init_moe(block.moe, gen)
    else:
        for name, w in block.mlp.named_parameters():
            if name.startswith("b"):
                w.zero_()
            else:
                dense_init_(w, gen)
    if hasattr(block, "cross"):
        init_attention(block.cross, gen)
    for name, w in block.named_parameters(recurse=False):
        # layer-norm gains are 1, rms gains (1 + scale); biases 0
        if name.endswith("_scale") and cfg.norm_type == "layernorm":
            w.fill_(1.0)
        else:
            w.zero_()


def _norm(x: torch.Tensor, block: DecoderBlock, cfg: ModelConfig,
          key: str) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, getattr(block, key + "_scale"),
                          getattr(block, key + "_bias"), cfg.norm_eps)
    return rms_norm(x, getattr(block, key + "_scale"), cfg.norm_eps)


def _mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "gelu":
        b1 = p.b1
        if p.axis is not None:
            b1 = b1[slice(*p.axis.block(b1.shape[0]))]
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p.w1.to(x.dtype) + b1.to(x.dtype), approximate="tanh")
        return reduce_model(h @ p.w2.to(x.dtype), p.axis) + p.b2.to(x.dtype)
    g = F.silu(x @ p.w_gate.to(x.dtype))
    u = x @ p.w_up.to(x.dtype)
    return reduce_model((g * u) @ p.w_down.to(x.dtype), p.axis)


def _cross_cache(cfg: ModelConfig, kind: str, batch: int, device,
                 dtype, kv_heads: Optional[int]) -> Cache:
    """The dense per-row cross entry of an encoder-decoder's decoder
    block ({} otherwise): ``encoder_seq`` keys, filled by a prefill."""
    if not cfg.is_encdec or kind == MOE:
        return {}
    return {"cross": init_attn_cache(cfg, batch, cfg.encoder_seq,
                                     kv_len=cfg.encoder_seq, device=device,
                                     dtype=dtype, kv_heads=kv_heads)}


def init_block_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     window: int, *, kind: str = DENSE, device=None,
                     dtype=torch.float32,
                     kv_heads: Optional[int] = None) -> Cache:
    """One layer's dense cache; ``kv_heads``: the KV heads a rank keeps
    under a model axis (default the configuration's)."""
    if kind in _RECURRENT:
        return _RECURRENT[kind].cache(cfg, batch, device=device, dtype=dtype)
    return {"self": init_attn_cache(cfg, batch, max_seq, window=window,
                                    device=device, dtype=dtype,
                                    kv_heads=kv_heads),
            **_cross_cache(cfg, kind, batch, device, dtype, kv_heads)}


def init_block_cache_paged(cfg: ModelConfig, num_pages: int, page_size: int,
                           *, kind: str = DENSE, batch: int = 0, device=None,
                           dtype=torch.float32,
                           kv_dtype: str = "float32",
                           kv_heads: Optional[int] = None) -> Cache:
    """Paged variant: self-attention K/V lives in the shared page pool (no
    batch axis — rows address it through their block table);
    ``kv_dtype="int8"`` stores the pages quantized with per-row scales.
    Recurrent state and the cross entry stay dense per row (``batch``
    rows)."""
    if kind in _RECURRENT:
        return _RECURRENT[kind].cache(cfg, batch, device=device, dtype=dtype)
    return {"self": init_paged_attn_cache(cfg, num_pages, page_size,
                                          device=device, dtype=dtype,
                                          kv_dtype=kv_dtype,
                                          kv_heads=kv_heads),
            **_cross_cache(cfg, kind, batch, device, dtype, kv_heads)}


def block_forward(block: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                  ctx: BlockCtx, cache: Optional[Cache] = None
                  ) -> Tuple[torch.Tensor, Union[torch.Tensor, float],
                             Optional[Cache]]:
    """Full-sequence forward (training and prefill); fills ``cache`` in
    place when given.  Returns (x, the block's auxiliary loss: the MoE
    load-balance loss, a float32 scalar tensor, or 0.0 for any other
    block, cache).  A recurrent block starts from the state ``cache``
    holds (as the JAX package's ``state=cache``; its conv starts from
    zeros) and leaves the state after ``x`` there, so ``x`` must be the
    exact prompt: a pad would advance the state."""
    aux = 0.0
    if block.kind in _RECURRENT:
        x, new = _RECURRENT[block.kind].forward(block, cfg, x, state=cache)
        if cache is not None:
            commit(cache, new)
        return x, aux, cache
    h = _norm(x, block, cfg, "ln1")
    att, _ = attention_forward(
        block.attn, cfg, h, positions=ctx.positions, causal=ctx.causal,
        window=ctx.window, prefix_len=ctx.prefix_len, use_rope=cfg.use_rope,
        cache=cache["self"] if cache is not None else None,
        valid_len=ctx.valid_len)
    x = x + att
    if hasattr(block, "cross") and ctx.enc_out is not None:
        hx = _norm(x, block, cfg, "lnx")
        catt, _ = attention_forward(block.cross, cfg, hx,
                                    positions=ctx.positions,
                                    enc_out=ctx.enc_out, causal=False,
                                    use_rope=False)
        x = x + catt
        if cache is not None and "cross" in cache:
            build_cross_cache(block.cross, cfg, ctx.enc_out, cache["cross"])
    h2 = _norm(x, block, cfg, "ln2")
    if block.kind == MOE:
        y, aux = moe_forward_local(block.moe, cfg, h2)
    else:
        y = _mlp(block.mlp, cfg, h2)
    return x + y, aux, cache


def block_decode(block: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, ctx: BlockCtx) -> Tuple[torch.Tensor, Cache]:
    """Single-token decode (x: (B,1,d)); updates ``cache`` in place.  A
    paged cache (it holds ``kp``) decodes through the block table in
    ``ctx``, and also takes a multi-token chunk (x: (B,C,d), ``ctx.pos``
    the chunk's first position, ``ctx.write_mask`` optionally (B,C)): the
    chunked-prefill path.  ``ctx.write_mask`` keeps the masked-out rows'
    (or tokens') KV, and a recurrent block's masked-out rows' state, as
    they were (the JAX package's per-row cache merge)."""
    if block.kind in _RECURRENT:
        return _RECURRENT[block.kind].decode(block, cfg, x, cache,
                                             ctx.write_mask)
    h = _norm(x, block, cfg, "ln1")
    if "kp" in cache["self"] and x.shape[1] > 1:
        att, _ = chunk_attention_paged(
            block.attn, cfg, h, cache["self"], ctx.pos, ctx.block_tbl,
            window=ctx.window, use_rope=cfg.use_rope,
            write_mask=ctx.write_mask)
    elif "kp" in cache["self"]:
        att, _ = decode_attention_paged(
            block.attn, cfg, h, cache["self"], ctx.pos, ctx.block_tbl,
            window=ctx.window, use_rope=cfg.use_rope,
            write_mask=ctx.write_mask)
    else:
        att, _ = decode_attention(block.attn, cfg, h, cache["self"], ctx.pos,
                                  window=ctx.window, use_rope=cfg.use_rope,
                                  write_mask=ctx.write_mask)
    x = x + att
    if hasattr(block, "cross") and "cross" in cache:
        hx = _norm(x, block, cfg, "lnx")
        x = x + cross_decode_attention(block.cross, cfg, hx, cache["cross"],
                                       ctx.cross_pos)
    h2 = _norm(x, block, cfg, "ln2")
    if block.kind == MOE:
        return x + moe_forward_decode(block.moe, cfg, h2), cache
    return x + _mlp(block.mlp, cfg, h2), cache
