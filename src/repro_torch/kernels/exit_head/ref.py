"""Plain PyTorch version of the fused early-exit confidence head (a mirror
of ``repro.kernels.exit_head.ref.exit_head_ref``)."""
from __future__ import annotations

from typing import Tuple

import torch


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
