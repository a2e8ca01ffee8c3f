"""Plain PyTorch version of the per-row int8 transport quantizer (a mirror
of ``repro.kernels.quantize.ref``)."""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) -> (q int8 (N,d), scale f32 (N,1)).  ``torch.round``
    rounds half to even, as ``jnp.round`` does.  Both divisions are true
    divisions by tensors: PyTorch turns a division by a Python scalar into
    a multiplication by its reciprocal on CUDA, which moves the scale by
    one ulp from the kernel's and the JAX package's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
