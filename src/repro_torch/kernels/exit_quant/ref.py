"""Plain PyTorch version of the fused exit-head + wire-quantize kernel (a
mirror of ``repro.kernels.exit_quant.ref``): the exit-head confidence pass
followed by the int8 quantizer over the SAME raw hidden."""
from __future__ import annotations

import torch

from repro_torch.kernels.exit_head.ref import ExitPacket, exit_head_ref
from repro_torch.kernels.quantize.ref import quantize_int8_ref


def exit_quant_ref(hidden: torch.Tensor, weight: torch.Tensor,
                   norm_scale: torch.Tensor, eps: float = 1e-5
                   ) -> ExitPacket:
    """hidden: (B, d); weight: (V, d); norm_scale: (d,) -> ``ExitPacket``:
    the exit decision of shape (B,) plus the int8 wire packet of the raw
    (pre-norm) hidden, q int8 (B, d) and scale f32 (B, 1)."""
    conf, tok, lse, mx = exit_head_ref(hidden, weight, norm_scale, eps)
    q, scale = quantize_int8_ref(hidden)
    return ExitPacket(conf, tok, lse, q, scale, mx)
