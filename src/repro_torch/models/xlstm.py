"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, through the
chunked GLA core) and sLSTM (scalar memory, a strict time loop); port of
``repro.models.xlstm``.

Pre-norm residual blocks.  The mLSTM block is pre-up-projection (factor
``expand``) with a causal depthwise conv feeding q/k; the sLSTM block
mixes each head's previous output through its own (hd x hd) recurrent
matrices, then runs a gated FFN.  Parameter names follow the JAX
package's pytree.  The recurrent state is float32 in a model of any
dtype; the conv state is in the model's dtype.  Caches are written in
place (``cache_tree.commit``): a decode row whose write mask is False
keeps its state bit for bit.

Under a model ``axis`` (a rank of the cloud mesh) each block is the rank's
share of its heads (``sharding.head_share``; whole on every rank when the
heads do not divide the axis).  mLSTM: the columns of ``wq`` / ``wk`` /
``wv``, both gate columns of its heads in ``w_if`` / ``b_if``, their rows
of ``head_norm``, the ``z`` half of ``w_up`` and the rows of ``w_down``,
whose partial products the model group sums.  The ``xi`` half of
``w_up`` and the conv stay whole on every rank: ``xi`` feeds every head's
q, k, v and gates through (di, di) products, so a rank computes it whole
(``(d + W) * di`` parameters a rank beside its share) instead of
gathering it.  sLSTM: the columns of ``wz wi wf wo``, ``rz ri rf ro`` on
their head axis, ``b_*`` and ``head_norm``; the block has no output
projection, so its heads' outputs are gathered (``gather_heads``) once a
call, after the time loop, and its FFN is whole on every rank
(``f_ff = int(4d/3)`` divides no model axis of 2 or 4).  The states keep
the rank's heads.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import (Axis, gather_heads, head_share,
                                         reduce_model)
from repro_torch.models import gla
from repro_torch.models.cache_tree import commit
from repro_torch.models.common import dense_init_, rms_norm
from repro_torch.tracing import span

Cache = Dict[str, object]


# ---------------------------------------------------------------------------
# shared with mamba2: causal depthwise conv1d
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); w: (W,D) depthwise causal conv, in float32."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The conv state after a prompt: its last ``width - 1`` inputs, left
    padded with zeros when the prompt is shorter."""
    tail = x[:, -(width - 1):]
    return F.pad(tail, (0, 0, width - 1 - tail.shape[1], 0))


def conv_decode_step(x1: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1: (B,1,D); conv_state: (B,W-1,D) past inputs -> (y1, state)."""
    window = torch.cat([conv_state, x1.to(conv_state.dtype)], 1)  # (B,W,D)
    y = (window.float() * w.float()).sum(1, keepdim=True).to(x1.dtype)
    return y, window[:, 1:]


def per_head_rmsnorm(y: torch.Tensor, scale: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """y: (B,H,S,D) normed per head with a per-head ``(1 + scale)`` gain
    (H,D), in float32."""
    yf = y.float()
    var = yf.square().mean(-1, keepdim=True)
    out = yf * torch.rsqrt(var + eps) * (1.0 + scale.float())[None, :, None]
    return out.to(y.dtype)


# ===========================================================================
# mLSTM block
# ===========================================================================
def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    expand = cfg.ssm.expand if cfg.ssm else 2
    di = cfg.d_model * expand
    h = cfg.ssm.num_ssm_heads or cfg.n_heads
    return di, h, di // h


def _span(lo: int, hi: int) -> list:
    return list(range(lo, hi))


def _whole_state_leaf(block: nn.Module, name: str,
                      t: torch.Tensor) -> torch.Tensor:
    """The single-device model's state leaf ``name`` from the rank's
    ``t`` (batch first, heads second): its heads gathered over the model
    group; an mLSTM's conv tail (of the whole ``xi``) is whole already."""
    if block.axis is None or name == "conv":
        return t
    return gather_heads(t, block.axis,
                        slice(block.h0, block.h0 + block.heads),
                        block.heads * block.axis.size, dim=1)


class MLSTMBlock(nn.Module):
    """``heads`` heads from ``h0`` (all of them without a model axis);
    ``shares``: the parameters the rank keeps at positions that are not
    one block of one dimension (``Model`` reads them)."""
    kind = "mlstm"
    whole_state_leaf = _whole_state_leaf

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        d = cfg.d_model
        di, h, hd = mlstm_dims(cfg)
        self.h0, hl, self.axis = head_share(h, axis)
        self.heads, self.hd = hl, hd
        dl = hl * hd
        conv_w = cfg.ssm.conv_width if cfg.ssm else 4
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.Parameter(torch.empty(d, **kw))
        self.w_up = nn.Parameter(torch.empty(d, di + dl, **kw))
        self.conv = nn.Parameter(torch.empty(conv_w, di, **kw))
        self.wq = nn.Parameter(torch.empty(di, dl, **kw))
        self.wk = nn.Parameter(torch.empty(di, dl, **kw))
        self.wv = nn.Parameter(torch.empty(di, dl, **kw))
        self.w_if = nn.Parameter(torch.empty(di, 2 * hl, **kw))
        self.b_if = nn.Parameter(torch.empty(2 * hl, **kw))
        self.head_norm = nn.Parameter(torch.empty(hl, hd, **kw))
        self.w_down = nn.Parameter(torch.empty(dl, d, **kw))
        self.shares = {}
        if self.axis is not None:
            g0, g1 = self.h0, self.h0 + hl
            gates = _span(g0, g1) + _span(h + g0, h + g1)
            self.shares = {"w_up": (1, _span(0, di) + _span(di + g0 * hd,
                                                            di + g1 * hd)),
                           "w_if": (1, gates), "b_if": (0, gates)}



@torch.no_grad()
def init_mlstm_block(p: MLSTMBlock, gen: torch.Generator) -> None:
    """The JAX package's distributions (``init_mlstm_block``)."""
    for w in (p.w_up, p.wq, p.wk, p.wv, p.w_if, p.w_down):
        dense_init_(w, gen)
    p.conv.copy_(torch.randn(p.conv.shape, generator=gen,
                             device=p.conv.device) * 0.1)
    h = p.b_if.shape[0] // 2
    p.b_if.zero_()
    p.b_if[h:] = 3.0
    p.norm.zero_()
    p.head_norm.zero_()


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device, dtype,
                     axis: Optional[Axis] = None) -> Cache:
    di, h, hd = mlstm_dims(cfg)
    hl = head_share(h, axis)[1]
    conv_w = cfg.ssm.conv_width if cfg.ssm else 4
    return {"gla": gla.init_gla_state(batch, hl, hd, hd, device=device),
            "conv": torch.zeros((batch, conv_w - 1, di), device=device,
                                dtype=dtype)}


def _mlstm_qkv_gates(p: MLSTMBlock, cfg: ModelConfig, xi: torch.Tensor,
                     xc: torch.Tensor):
    h, hd = p.heads, p.hd
    b, s, _ = xi.shape

    def heads(t):
        return t.reshape(b, s, h, hd).transpose(1, 2)

    q = heads(xc @ p.wq.to(xi.dtype))
    k = heads(xc @ p.wk.to(xi.dtype)) / math.sqrt(hd)
    v = heads(xi @ p.wv.to(xi.dtype))
    gates = (xi @ p.w_if.to(xi.dtype) + p.b_if.to(xi.dtype)).float()
    i_pre, f_pre = gates.chunk(2, -1)
    lf = F.logsigmoid(f_pre).transpose(1, 2)                  # (B,H,S)
    li = i_pre.transpose(1, 2)
    return q, k, v, lf, li


def mlstm_forward(p: MLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence mLSTM block, x: (B,S,d), from ``state``'s GLA state
    (zero when None).  Returns (out, the state after x)."""
    di = mlstm_dims(cfg)[0]
    b, s, _ = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    xi, z = (xn @ p.w_up.to(x.dtype)).split([di, p.heads * p.hd], -1)
    xc = F.silu(causal_conv1d(xi, p.conv))
    q, k, v, lf, li = _mlstm_qkv_gates(p, cfg, xi, xc)
    chunk = cfg.ssm.chunk_size if cfg.ssm else 256
    y, gnew = gla.chunked_gla(q, k, v, lf, li, normalize=True, chunk=chunk,
                              state=state["gla"] if state else None)
    y = per_head_rmsnorm(y, p.head_norm, cfg.norm_eps)
    y = y.transpose(1, 2).reshape(b, s, -1) * F.silu(z)
    out = x + reduce_model(y @ p.w_down.to(x.dtype), p.axis)
    return out, {"gla": gnew, "conv": conv_tail(xi, p.conv.shape[0])}


def mlstm_decode(p: MLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, write_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """x: (B,1,d); ``cache`` updated in place (rows outside
    ``write_mask`` kept)."""
    di = mlstm_dims(cfg)[0]
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    xi, z = (xn @ p.w_up.to(x.dtype)).split([di, p.heads * p.hd], -1)
    yc, conv_state = conv_decode_step(xi, cache["conv"], p.conv)
    q, k, v, lf, li = _mlstm_qkv_gates(p, cfg, xi, F.silu(yc))
    y1, gnew = gla.gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   lf[:, :, 0], li[:, :, 0], cache["gla"],
                                   normalize=True)
    y = per_head_rmsnorm(y1[:, :, None], p.head_norm, cfg.norm_eps)
    y = y.transpose(1, 2).reshape(x.shape[0], 1, -1).to(x.dtype) * F.silu(z)
    out = x + reduce_model(y @ p.w_down.to(x.dtype), p.axis)
    commit(cache, {"gla": gnew, "conv": conv_state}, write_mask)
    return out, cache


# ===========================================================================
# sLSTM block
# ===========================================================================
def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    h = cfg.ssm.num_ssm_heads or cfg.n_heads
    return h, cfg.d_model // h


_SLSTM_GATES = ("z", "i", "f", "o")


class SLSTMBlock(nn.Module):
    """``heads`` heads from ``h0`` (all of them without a model axis)."""
    kind = "slstm"
    whole_state_leaf = _whole_state_leaf

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        d = cfg.d_model
        h, hd = slstm_dims(cfg)
        self.h0, hl, self.axis = head_share(h, axis)
        self.heads, self.hd = hl, hd
        f_ff = int(d * 4 / 3)
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.Parameter(torch.empty(d, **kw))
        for g in _SLSTM_GATES:
            setattr(self, "w" + g,
                    nn.Parameter(torch.empty(d, hl * hd, **kw)))
            setattr(self, "r" + g, nn.Parameter(torch.empty(hl, hd, hd,
                                                            **kw)))
            setattr(self, "b_" + g, nn.Parameter(torch.empty(hl * hd, **kw)))
        self.head_norm = nn.Parameter(torch.empty(hl, hd, **kw))
        self.norm2 = nn.Parameter(torch.empty(d, **kw))

        self.ffn_up = nn.Parameter(torch.empty(d, 2 * f_ff, **kw))
        self.ffn_down = nn.Parameter(torch.empty(f_ff, d, **kw))


@torch.no_grad()
def init_slstm_block(p: SLSTMBlock, gen: torch.Generator) -> None:
    """The JAX package's distributions (``init_slstm_block``): recurrent
    matrices N(0, 1) / sqrt(hd), the forget bias 3."""
    for g in _SLSTM_GATES:
        dense_init_(getattr(p, "w" + g), gen)
        r = getattr(p, "r" + g)
        r.copy_(torch.randn(r.shape, generator=gen, device=r.device)
                / math.sqrt(r.shape[-1]))
        getattr(p, "b_" + g).fill_(3.0 if g == "f" else 0.0)
    for w in (p.ffn_up, p.ffn_down):
        dense_init_(w, gen)
    for w in (p.norm, p.head_norm, p.norm2):
        w.zero_()


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device,
                     dtype=None, axis: Optional[Axis] = None) -> Cache:
    h, hd = slstm_dims(cfg)
    h = head_share(h, axis)[1]
    return {k: torch.zeros((batch, h, hd), device=device)
            for k in ("c", "n", "m", "h")}


def _slstm_inputs(p: SLSTMBlock, xn: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every step's input projections at once, in float32 as the JAX
    package computes them (``xf @ w.astype(f32) + b``): {gate: (B,S,d)}."""
    xf = xn.float()
    return {g: xf @ getattr(p, "w" + g).float()
            + getattr(p, "b_" + g).float() for g in _SLSTM_GATES}


def _slstm_cell(rec: Dict[str, torch.Tensor], pre: Dict[str, torch.Tensor],
                state: Cache, h: int, hd: int) -> Tuple[torch.Tensor, Cache]:
    """One step: ``pre`` {gate: (B,d)} input projections, ``rec`` {gate:
    (H,hd,hd)} float32 recurrent matrices -> (h_out (B,H,hd), state)."""
    c, n, m, hprev = state["c"], state["n"], state["m"], state["h"]
    b = hprev.shape[0]

    def lin(g):
        return pre[g].reshape(b, h, hd) + (hprev[:, :, None] @ rec[g])[:, :, 0]

    z = torch.tanh(lin("z"))
    i_pre = lin("i")
    o = torch.sigmoid(lin("o"))
    lf = F.logsigmoid(lin("f"))
    m_new = torch.maximum(lf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(lf + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_out = o * (c_new / n_new.clamp_min(1e-6))
    return h_out, {"c": c_new, "n": n_new, "m": m_new, "h": h_out}


def _slstm_ffn(p: SLSTMBlock, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    xn2 = rms_norm(x, p.norm2, cfg.norm_eps)
    u, g = (xn2 @ p.ffn_up.to(x.dtype)).chunk(2, -1)
    return x + (F.silu(g) * u) @ p.ffn_down.to(x.dtype)


def _slstm_out(p: SLSTMBlock, hs: torch.Tensor, d: int) -> torch.Tensor:
    """(B, heads, S, hd) normed head outputs -> (B, S, d): the rank's
    heads' columns, gathered over the model group."""
    b, _, s, _ = hs.shape
    y = hs.transpose(1, 2).reshape(b, s, -1)
    hd = p.hd
    return gather_heads(y, p.axis, slice(p.h0 * hd, (p.h0 + p.heads) * hd),
                        d)


def slstm_forward(p: SLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence sLSTM block (a time loop over S), from ``state``
    (zero when None).  Returns (out, the state after x)."""
    h, hd = p.heads, p.hd
    b, s, d = x.shape
    with span("slstm", x.device):
        xn = rms_norm(x, p.norm, cfg.norm_eps)
        st = state or init_slstm_cache(cfg, b, device=x.device, axis=p.axis)
        pre = _slstm_inputs(p, xn)
        rec = {g: getattr(p, "r" + g).float() for g in _SLSTM_GATES}
        if is_fake(x):
            # tensors without storage (the dry run): one cell over all S
            # steps as rows, the loop's products and shapes without it
            rows = {k: v.repeat_interleave(s, 0) for k, v in st.items()}
            h_out, rows = _slstm_cell(
                rec, {g: v.reshape(b * s, -1) for g, v in pre.items()},
                rows, h, hd)
            st = {k: v.reshape(b, s, h, hd)[:, -1] for k, v in rows.items()}
            hs = h_out.reshape(b, s, h, hd).transpose(1, 2)
        else:
            hs = []
            for t in range(s):
                h_out, st = _slstm_cell(rec,
                                        {g: v[:, t] for g, v in pre.items()},
                                        st, h, hd)
                hs.append(h_out)
            hs = torch.stack(hs, 2)
        hs = per_head_rmsnorm(hs, p.head_norm, cfg.norm_eps)
        x = x + _slstm_out(p, hs, d).to(x.dtype)
        return _slstm_ffn(p, cfg, x), st


def slstm_decode(p: SLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, write_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    b, _, d = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    pre = {g: v[:, 0] for g, v in _slstm_inputs(p, xn).items()}
    rec = {g: getattr(p, "r" + g).float() for g in _SLSTM_GATES}
    h_out, new = _slstm_cell(rec, pre, cache, p.heads, p.hd)
    hs = per_head_rmsnorm(h_out[:, :, None], p.head_norm, cfg.norm_eps)
    x = x + _slstm_out(p, hs, d).to(x.dtype)
    commit(cache, new, write_mask)
    return _slstm_ffn(p, cfg, x), cache
