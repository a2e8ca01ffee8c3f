"""Shared low-level layers: norms, rotary embeddings, initializers.

Numerics follow ``repro.models.common``: norms compute in float32 and cast
back to the input's dtype; rotary embeddings rotate split halves (not
interleaved pairs); sinusoidal positions are Whisper's sin | cos halves;
initializers draw from an explicit ``torch.Generator`` with the JAX
package's distributions.
"""
from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with a ``(1 + scale)`` gain, in float32."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with a ``scale`` gain and a ``bias``, in float32 (the
    biased variance, as ``jnp.var``)."""
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    angles = angles[..., None, :]                             # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq, d_model: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings, float32.  ``seq`` is an int
    (returns (seq, d)) or a position tensor of any shape (returns
    (*seq.shape, d)): a decode step's per-row (B,) offsets, or their
    (B, S) positions."""
    half = d_model // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    if isinstance(seq, int):
        pos = torch.arange(seq, dtype=torch.float32, device=device)
    else:
        pos = torch.as_tensor(seq, device=device).float()
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=pos.device))
    scaled = pos[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


# ---------------------------------------------------------------------------
# Initializers (in place, from an explicit generator)
# ---------------------------------------------------------------------------
@torch.no_grad()
def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """N(0, 1) / sqrt(d_in) for a ``(d_in, d_out)`` weight applied as
    ``x @ w``; drawn in float32, then cast to ``w``'s dtype."""
    draw = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                       device=w.device)
    return w.copy_(draw.div_(math.sqrt(w.shape[0])))


@torch.no_grad()
def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """N(0, 0.02) for a ``(vocab, d)`` embedding or read-out weight."""
    draw = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                       device=w.device)
    return w.copy_(draw.mul_(0.02))
