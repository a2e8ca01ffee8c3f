"""Plain PyTorch version of the fused early-exit confidence head (a mirror
of ``repro.kernels.exit_head.ref.exit_head_ref``), for one exit and for
several exits of one edge tick."""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels.quantize.ref import quantize_int8_ref


class ExitHeads(NamedTuple):
    """An exit head's outputs for each row: confidence (max softmax
    probability) f32, token (argmax) int32, logsumexp f32 and the raw max
    logit f32 (what ``sharding.merge_exits`` compares across vocabulary
    slices)."""
    conf: torch.Tensor
    tok: torch.Tensor
    lse: torch.Tensor
    mx: torch.Tensor


class ExitPacket(NamedTuple):
    """``ExitHeads`` with the int8 wire packet of one exit's raw rows,
    ``q`` int8 (B, d) and ``scale`` f32 (B, 1), in the Pallas kernel's
    order (conf, tok, lse, q, scale) with the max logit last."""
    conf: torch.Tensor
    tok: torch.Tensor
    lse: torch.Tensor
    q: torch.Tensor
    scale: torch.Tensor
    mx: torch.Tensor

    @property
    def head(self) -> ExitHeads:
        return ExitHeads(self.conf, self.tok, self.lse, self.mx)


def exit_head_ref(hidden: torch.Tensor, weight: torch.Tensor,
                  norm_scale: torch.Tensor, eps: float = 1e-5) -> ExitHeads:
    """hidden: (B, d); weight: (V, d); norm_scale: (d,) -> ``ExitHeads``
    of shape (B,) of the exit head: rms-norm -> unembed ->
    max-softmax-prob + argmax, all in float32."""
    h = hidden.float()
    var = h.square().mean(dim=-1, keepdim=True)
    hn = h * torch.rsqrt(var + eps) * (1.0 + norm_scale.float())
    logits = hn @ weight.float().T                       # (B, V)
    lse = torch.logsumexp(logits, dim=-1)
    mx = logits.amax(dim=-1)
    conf = torch.exp(mx - lse)
    tok = logits.argmax(dim=-1).to(torch.int32)
    return ExitHeads(conf, tok, lse, mx)


def exit_heads_ref(hiddens: torch.Tensor, weight: torch.Tensor,
                   norm_scales: torch.Tensor, eps: float = 1e-5,
                   quant_exit: Optional[int] = None
                   ) -> Union[ExitHeads, ExitPacket]:
    """hiddens: (E, B, d); norm_scales: (E, d).  ``exit_head_ref`` over
    each exit, stacked to ``ExitHeads`` of shape (E, B); with
    ``quant_exit``, an ``ExitPacket`` holding the int8 packet of that
    exit's raw rows (``quantize_int8_ref``) too: ``exit_heads``' outputs."""
    per = [exit_head_ref(h, weight, ns, eps)
           for h, ns in zip(hiddens, norm_scales)]
    heads = ExitHeads(*(torch.stack(x) for x in zip(*per)))
    if quant_exit is None:
        return heads
    return ExitPacket(heads.conf, heads.tok, heads.lse,
                      *quantize_int8_ref(hiddens[quant_exit]), heads.mx)
