"""Plain PyTorch version of the fused exit-head + wire-quantize kernel (a
mirror of ``repro.kernels.exit_quant.ref``): the exit-head confidence pass
followed by the int8 quantizer over the SAME raw hidden."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.exit_head.ref import exit_head_ref
from repro_torch.kernels.quantize.ref import quantize_int8_ref


def exit_quant_ref(hidden: torch.Tensor, weight: torch.Tensor,
                   norm_scale: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, ...]:
    """hidden: (B, d); weight: (V, d); norm_scale: (d,).

    Returns (confidence (B,), token (B,), logsumexp (B,), q int8 (B, d),
    scale f32 (B, 1)) — the exit decision plus the int8 wire packet of the
    raw (pre-norm) hidden."""
    conf, tok, lse = exit_head_ref(hidden, weight, norm_scale, eps)
    q, scale = quantize_int8_ref(hidden)
    return conf, tok, lse, q, scale
