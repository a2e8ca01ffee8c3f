"""Plain PyTorch version of the fused early-exit confidence head (a mirror
of ``repro.kernels.exit_head.ref.exit_head_ref``), for one exit and for
several exits of one edge tick."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.quantize.ref import quantize_int8_ref


def exit_head_ref(hidden: torch.Tensor, weight: torch.Tensor,
                  norm_scale: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hidden: (B, d); weight: (V, d); norm_scale: (d,).

    Returns (confidence (B,) f32, token (B,) int32, logsumexp (B,) f32) of
    the exit head: rms-norm -> unembed -> max-softmax-prob + argmax, all in
    float32."""
    h = hidden.float()
    var = h.square().mean(dim=-1, keepdim=True)
    hn = h * torch.rsqrt(var + eps) * (1.0 + norm_scale.float())
    logits = hn @ weight.float().T                       # (B, V)
    lse = torch.logsumexp(logits, dim=-1)
    mx = logits.amax(dim=-1)
    conf = torch.exp(mx - lse)
    tok = logits.argmax(dim=-1).to(torch.int32)
    return conf, tok, lse


def exit_heads_ref(hiddens: torch.Tensor, weight: torch.Tensor,
                   norm_scales: torch.Tensor, eps: float = 1e-5,
                   quant_exit: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """hiddens: (E, B, d); norm_scales: (E, d).  ``exit_head_ref`` over
    each exit, stacked to (conf, tok, lse) of shape (E, B), plus the int8
    packet (q (B, d), scale (B, 1)) of exit ``quant_exit``'s raw rows
    (``quantize_int8_ref``) when it is given."""
    per = [exit_head_ref(h, weight, ns, eps)
           for h, ns in zip(hiddens, norm_scales)]
    out = tuple(torch.stack(x) for x in zip(*per))
    if quant_exit is None:
        return out
    return out + quantize_int8_ref(hiddens[quant_exit])
