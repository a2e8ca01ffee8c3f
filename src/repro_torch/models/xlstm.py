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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
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


class MLSTMBlock(nn.Module):
    kind = "mlstm"

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        di, h, hd = mlstm_dims(cfg)
        conv_w = cfg.ssm.conv_width if cfg.ssm else 4
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.Parameter(torch.empty(d, **kw))
        self.w_up = nn.Parameter(torch.empty(d, 2 * di, **kw))
        self.conv = nn.Parameter(torch.empty(conv_w, di, **kw))
        self.wq = nn.Parameter(torch.empty(di, di, **kw))
        self.wk = nn.Parameter(torch.empty(di, di, **kw))
        self.wv = nn.Parameter(torch.empty(di, di, **kw))
        self.w_if = nn.Parameter(torch.empty(di, 2 * h, **kw))
        self.b_if = nn.Parameter(torch.empty(2 * h, **kw))
        self.head_norm = nn.Parameter(torch.empty(h, hd, **kw))
        self.w_down = nn.Parameter(torch.empty(di, d, **kw))


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


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device,
                     dtype) -> Cache:
    di, h, hd = mlstm_dims(cfg)
    conv_w = cfg.ssm.conv_width if cfg.ssm else 4
    return {"gla": gla.init_gla_state(batch, h, hd, hd, device=device),
            "conv": torch.zeros((batch, conv_w - 1, di), device=device,
                                dtype=dtype)}


def _mlstm_qkv_gates(p: MLSTMBlock, cfg: ModelConfig, xi: torch.Tensor,
                     xc: torch.Tensor):
    di, h, hd = mlstm_dims(cfg)
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
    di, h, hd = mlstm_dims(cfg)
    b, s, _ = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    xi, z = (xn @ p.w_up.to(x.dtype)).chunk(2, -1)
    xc = F.silu(causal_conv1d(xi, p.conv))
    q, k, v, lf, li = _mlstm_qkv_gates(p, cfg, xi, xc)
    chunk = cfg.ssm.chunk_size if cfg.ssm else 256
    y, gnew = gla.chunked_gla(q, k, v, lf, li, normalize=True, chunk=chunk,
                              state=state["gla"] if state else None)
    y = per_head_rmsnorm(y, p.head_norm, cfg.norm_eps)
    y = y.transpose(1, 2).reshape(b, s, di) * F.silu(z)
    out = x + y @ p.w_down.to(x.dtype)
    return out, {"gla": gnew, "conv": conv_tail(xi, p.conv.shape[0])}


def mlstm_decode(p: MLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, write_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """x: (B,1,d); ``cache`` updated in place (rows outside
    ``write_mask`` kept)."""
    di, h, hd = mlstm_dims(cfg)
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    xi, z = (xn @ p.w_up.to(x.dtype)).chunk(2, -1)
    yc, conv_state = conv_decode_step(xi, cache["conv"], p.conv)
    q, k, v, lf, li = _mlstm_qkv_gates(p, cfg, xi, F.silu(yc))
    y1, gnew = gla.gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   lf[:, :, 0], li[:, :, 0], cache["gla"],
                                   normalize=True)
    y = per_head_rmsnorm(y1[:, :, None], p.head_norm, cfg.norm_eps)
    y = y.transpose(1, 2).reshape(x.shape[0], 1, di).to(x.dtype) * F.silu(z)
    out = x + y @ p.w_down.to(x.dtype)
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
    kind = "slstm"

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        h, hd = slstm_dims(cfg)
        f_ff = int(d * 4 / 3)
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.Parameter(torch.empty(d, **kw))
        for g in _SLSTM_GATES:
            setattr(self, "w" + g, nn.Parameter(torch.empty(d, d, **kw)))
            setattr(self, "r" + g, nn.Parameter(torch.empty(h, hd, hd, **kw)))
            setattr(self, "b_" + g, nn.Parameter(torch.empty(d, **kw)))
        self.head_norm = nn.Parameter(torch.empty(h, hd, **kw))
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
                     dtype=None) -> Cache:
    h, hd = slstm_dims(cfg)
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


def slstm_forward(p: SLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence sLSTM block (a time loop over S), from ``state``
    (zero when None).  Returns (out, the state after x)."""
    h, hd = slstm_dims(cfg)
    b, s, d = x.shape
    with span("slstm", x.device):
        xn = rms_norm(x, p.norm, cfg.norm_eps)
        st = state or init_slstm_cache(cfg, b, device=x.device)
        pre = _slstm_inputs(p, xn)
        rec = {g: getattr(p, "r" + g).float() for g in _SLSTM_GATES}
        hs = []
        for t in range(s):
            h_out, st = _slstm_cell(rec,
                                    {g: v[:, t] for g, v in pre.items()},
                                    st, h, hd)
            hs.append(h_out)
        hs = per_head_rmsnorm(torch.stack(hs, 2), p.head_norm, cfg.norm_eps)
        x = x + hs.transpose(1, 2).reshape(b, s, d).to(x.dtype)
        return _slstm_ffn(p, cfg, x), st


def slstm_decode(p: SLSTMBlock, cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, write_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    h, hd = slstm_dims(cfg)
    b, _, d = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    pre = {g: v[:, 0] for g, v in _slstm_inputs(p, xn).items()}
    rec = {g: getattr(p, "r" + g).float() for g in _SLSTM_GATES}
    h_out, new = _slstm_cell(rec, pre, cache, h, hd)
    hs = per_head_rmsnorm(h_out[:, :, None], p.head_norm, cfg.norm_eps)
    x = x + hs[:, :, 0].reshape(b, 1, d).to(x.dtype)
    commit(cache, new, write_mask)
    return _slstm_ffn(p, cfg, x), cache
