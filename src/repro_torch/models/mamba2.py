"""Mamba2 (SSD) block built on the chunked GLA core; port of
``repro.models.mamba2``.

Per head the SSD recurrence

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * (B_t x_t^T)
    y_t = C_t^T h_t + D * x_t

is gated linear attention with lf = dt*a (a < 0), li = log(dt), k = B,
q = C, v = x.  One group (B and C shared by every head), as Zamba2-1.2B.
``a_log``, ``dt_bias`` and ``d_skip`` are float32 parameters in a model of
any dtype, as in the JAX package.

Under a model ``axis`` (a rank of the cloud mesh) a block is the rank's
share of its heads (``sharding.head_share``; whole on every rank when the
heads do not divide the axis): the ``z``, ``x`` and ``dt`` columns of
``w_in`` (which packs ``[z | x | B | C | dt]``), the ``x`` channels of
``conv`` / ``conv_bias``, ``a_log``, ``dt_bias``, ``d_skip``, its slice of
``gate_norm`` and the rows of ``w_out``, whose partial products the model
group sums.  B and C, which every head reads, and their conv channels stay
whole on every rank.  ``gate_norm`` is an rms norm over the whole inner
width: the ranks sum their partial sums of squares (``sum_squares``)
before its scale is applied.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import (Axis, gather_heads, head_share,
                                         reduce_model, sum_squares)
from repro_torch.models import gla
from repro_torch.models.cache_tree import commit
from repro_torch.models.common import dense_init_, rms_norm
from repro_torch.models.xlstm import (Cache, causal_conv1d, conv_decode_step,
                                      conv_tail)


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, state size N, heads, head dim)."""
    ssm = cfg.ssm
    di = cfg.d_model * ssm.expand
    n = ssm.state_size
    headdim = 64 if di % 64 == 0 else di // max(ssm.num_ssm_heads, 1)
    return di, n, di // headdim, headdim


class Mamba2Block(nn.Module):
    """``heads`` heads of ``head_dim`` from ``h0`` (all of them without a
    model axis): an inner width ``di`` = heads * head_dim; ``shares``: the
    parameters the rank keeps at positions that are not one block of one
    dimension (``Model`` reads them)."""
    kind = "mamba2"

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        d = cfg.d_model
        di_all, n, h_all, hp = mamba2_dims(cfg)
        self.h0, h, self.axis = head_share(h_all, axis)
        self.heads, self.head_dim, self.di = h, hp, h * hp
        di = self.di
        conv_dim = di + 2 * n
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.norm = nn.Parameter(torch.empty(d, **kw))
        # in-projection -> [z (di), x (di), B (n), C (n), dt (h)]
        self.w_in = nn.Parameter(torch.empty(d, 2 * di + 2 * n + h, **kw))
        self.conv = nn.Parameter(torch.empty(cfg.ssm.conv_width, conv_dim,
                                             **kw))
        self.conv_bias = nn.Parameter(torch.empty(conv_dim, **kw))
        self.a_log = nn.Parameter(torch.empty(h, **f32))
        self.dt_bias = nn.Parameter(torch.empty(h, **f32))
        self.d_skip = nn.Parameter(torch.empty(h, **f32))
        self.gate_norm = nn.Parameter(torch.empty(di, **kw))
        self.w_out = nn.Parameter(torch.empty(di, d, **kw))
        self.shares = {}
        if self.axis is not None:
            c0, c1 = self.h0 * hp, self.h0 * hp + di
            bc = list(range(di_all, di_all + 2 * n))
            xbc = list(range(c0, c1)) + bc
            dt0 = 2 * di_all + 2 * n + self.h0
            self.shares = {
                "w_in": (1, list(range(c0, c1))
                         + [di_all + i for i in xbc]
                         + list(range(dt0, dt0 + h))),
                "conv": (1, xbc), "conv_bias": (0, xbc)}

    def whole_state_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The single-device model's state leaf ``name`` from the rank's
        ``t`` (batch first): the GLA state's heads, or the conv tail's
        ``x`` channels beside the whole B and C, gathered over the model
        group."""
        if self.axis is None:
            return t
        m, c0 = self.axis.size, self.h0 * self.head_dim
        if name == "conv":
            x = gather_heads(t[..., :self.di], self.axis,
                             slice(c0, c0 + self.di), self.di * m)
            return torch.cat([x, t[..., self.di:]], -1)
        return gather_heads(t, self.axis, slice(self.h0, self.h0 + self.heads),
                            self.heads * m, dim=1)


@torch.no_grad()
def init_mamba2_block(p: Mamba2Block, gen: torch.Generator) -> None:
    """The JAX package's values (``init_mamba2_block``)."""
    dense_init_(p.w_in, gen)
    dense_init_(p.w_out, gen)
    p.conv.copy_(torch.randn(p.conv.shape, generator=gen,
                             device=p.conv.device) * 0.1)
    h = p.a_log.shape[0]
    p.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
    p.dt_bias.fill_(-2.0)
    p.d_skip.fill_(1.0)
    for w in (p.norm, p.conv_bias, p.gate_norm):
        w.zero_()


def init_mamba2_cache(cfg: ModelConfig, batch: int, *, device, dtype,
                      axis: Optional[Axis] = None) -> Cache:
    di, n, h, hp = mamba2_dims(cfg)
    h = head_share(h, axis)[1]
    di = h * hp
    return {"gla": gla.init_gla_state(batch, h, n, hp, device=device),
            "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, di + 2 * n),
                                device=device, dtype=dtype)}


def _split_proj(p: Mamba2Block, cfg: ModelConfig, proj: torch.Tensor):
    di, n = p.di, cfg.ssm.state_size
    return proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]


def _gate_norm(p: Mamba2Block, cfg: ModelConfig, y: torch.Tensor
               ) -> torch.Tensor:
    """``rms_norm`` of the gated (B,S,di) output over the whole inner
    width; a rank's share sums the ranks' sums of squares first."""
    if p.axis is None:
        return rms_norm(y, p.gate_norm, cfg.norm_eps)
    var = sum_squares(y, p.axis) / (p.di * p.axis.size)
    out = y.float() * torch.rsqrt(var + cfg.norm_eps)
    return (out * (1.0 + p.gate_norm.float())).to(y.dtype)


def _ssd_inputs(p: Mamba2Block, cfg: ModelConfig, xbc: torch.Tensor,
                dt_pre: torch.Tensor):
    """xbc: (B,S,di+2n) after the conv -> q, k, v, lf, li for the GLA."""
    di, n, h, hp = p.di, cfg.ssm.state_size, p.heads, p.head_dim
    b, s, _ = xbc.shape
    v = xbc[..., :di].reshape(b, s, h, hp).transpose(1, 2)
    k = xbc[:, None, :, di:di + n].expand(b, h, s, n)
    q = xbc[:, None, :, di + n:].expand(b, h, s, n)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus would return x itself
    # above 20, which differs by under exp(-20) there: past float32's ulp
    pre = dt_pre.float() + p.dt_bias
    dt = torch.logaddexp(pre, torch.zeros_like(pre)).transpose(1, 2)
    lf = dt * -torch.exp(p.a_log)[None, :, None]
    li = torch.log(dt.clamp_min(1e-9))
    return q, k, v, lf, li


def mamba2_forward(p: Mamba2Block, cfg: ModelConfig, x: torch.Tensor,
                   state: Optional[Cache] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence Mamba2 block, x: (B,S,d), from ``state``'s GLA state
    (zero when None).  Returns (out, the state after x)."""
    di = p.di
    b, s, _ = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    z, xbc_raw, dt_pre = _split_proj(p, cfg, xn @ p.w_in.to(x.dtype))
    xbc = F.silu(causal_conv1d(xbc_raw, p.conv) + p.conv_bias.to(x.dtype))
    q, k, v, lf, li = _ssd_inputs(p, cfg, xbc, dt_pre)
    y, gnew = gla.chunked_gla(q, k, v, lf, li, normalize=False,
                              chunk=cfg.ssm.chunk_size,
                              state=state["gla"] if state else None)
    y = y + p.d_skip[None, :, None, None] * v.float()
    y = y.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    y = _gate_norm(p, cfg, y * F.silu(z))
    out = x + reduce_model(y @ p.w_out.to(x.dtype), p.axis)
    return out, {"gla": gnew, "conv": conv_tail(xbc_raw, p.conv.shape[0])}


def mamba2_decode(p: Mamba2Block, cfg: ModelConfig, x: torch.Tensor,
                  cache: Cache, write_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Cache]:
    """x: (B,1,d); ``cache`` updated in place (rows outside
    ``write_mask`` kept)."""
    di = p.di
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    z, xbc, dt_pre = _split_proj(p, cfg, xn @ p.w_in.to(x.dtype))
    yc, conv_state = conv_decode_step(xbc, cache["conv"], p.conv)
    xbc = F.silu(yc + p.conv_bias.to(x.dtype))
    q, k, v, lf, li = _ssd_inputs(p, cfg, xbc, dt_pre)
    y1, gnew = gla.gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   lf[:, :, 0], li[:, :, 0], cache["gla"],
                                   normalize=False)
    y1 = y1 + p.d_skip[None, :, None] * v[:, :, 0].float()
    y = y1.reshape(x.shape[0], 1, di).to(x.dtype)
    y = _gate_norm(p, cfg, y * F.silu(z))
    out = x + reduce_model(y @ p.w_out.to(x.dtype), p.axis)
    commit(cache, {"gla": gnew, "conv": conv_state}, write_mask)
    return out, cache
