"""Multi-exit training loss, EE-LLM style (port of ``repro.training.loss``).

    total = CE(final) + sum_i exit_weight * CE(exit_i) + MoE aux loss

Every exit is weighted alike (EE-LLM's constant weighting).
``fused_unembed_ce`` is the training path: it unembeds one sequence chunk
at a time under activation checkpointing, so the (B, S, V) float32 logits
of the three read-out heads never exist at once, forward or backward.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import rms_norm


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """sum over (B, S) of mask * (logsumexp - the label's logit), in
    float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return ((lse - ll) * mask).sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V); labels (B, S) int; mask (B, S) float -> the mean
    negative log-likelihood over the masked positions."""
    return _nll_sum(logits, labels, mask) / mask.sum().clamp_min(1.0)


def _chunk_nll(h, norm_scale, weight, labels, mask, eps):
    hn = rms_norm(h, norm_scale, eps)
    return _nll_sum(hn @ weight.to(hn.dtype).T, labels, mask)


def fused_unembed_ce(hidden: torch.Tensor, norm_scale: torch.Tensor,
                     weight: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, *, eps: float = 1e-5,
                     chunk: int = 512) -> torch.Tensor:
    """CE of ``rms_norm(hidden) @ weight.T`` without the full logits.

    hidden (B, S, d); weight (V, d); labels and mask (B, S).  The
    sequence goes in chunks of gcd(S, chunk) tokens, in order, each
    chunk's logits recomputed in the backward pass."""
    s = hidden.shape[1]
    chunk = math.gcd(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for t0 in range(0, s, chunk):
        part = (hidden[:, t0:t0 + chunk], norm_scale, weight,
                labels[:, t0:t0 + chunk], mask[:, t0:t0 + chunk], eps)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *part, use_reentrant=False)
        else:
            total = total + _chunk_nll(*part)
    return total / mask.sum().clamp_min(1.0)


def _with_exits(main: torch.Tensor, exit_losses: Dict[int, torch.Tensor],
                aux: torch.Tensor, exit_weight: float
                ) -> Dict[str, torch.Tensor]:
    total = main
    for l in sorted(exit_losses):
        total = total + exit_weight * exit_losses[l]
    total = total + aux
    return {"loss": total, "main_loss": main, "aux_loss": aux,
            **{f"exit{l}_loss": v for l, v in exit_losses.items()}}


def multi_exit_loss_fused(model, hiddens: Dict[str, Any],
                          labels: torch.Tensor, mask: torch.Tensor, *,
                          exit_weight: float = 0.3
                          ) -> Dict[str, torch.Tensor]:
    """The multi-exit loss from ``Model.forward_train_hiddens``' output,
    through ``fused_unembed_ce``.  A vision prefix's positions are
    trimmed first (the labels cover the text); a layer-norm model
    (whisper) takes the plain final head, its exits the fused rms
    read-outs.  Returns {"loss", "main_loss", "aux_loss",
    "exit<l>_loss"...}."""
    cfg = model.cfg
    w = model.unembed_weight()
    prefix = hiddens.get("prefix_len", 0) or 0

    def trim(x):
        return x[:, prefix:] if prefix else x

    if cfg.norm_type == "layernorm":
        main = cross_entropy(model.logits(trim(hiddens["final"])), labels,
                             mask)
    else:
        main = fused_unembed_ce(trim(hiddens["final"]), model.final_norm, w,
                                labels, mask, eps=cfg.norm_eps)
    exit_losses = {
        l: fused_unembed_ce(trim(h), model.exit_norms[str(l)], w, labels,
                            mask, eps=cfg.norm_eps)
        for l, h in sorted(hiddens["exits"].items())}
    return _with_exits(main, exit_losses, hiddens["aux_loss"], exit_weight)


def multi_exit_loss(outputs: Dict[str, Any], labels: torch.Tensor,
                    mask: torch.Tensor, *, exit_weight: float = 0.3
                    ) -> Dict[str, torch.Tensor]:
    """The multi-exit loss from ``Model.forward_train``'s logits.  For a
    vision prefix the logits cover [prefix + text] and the labels the
    text tail."""
    prefix = outputs.get("prefix_len", 0) or 0

    def trim(x):
        return x[:, prefix:] if prefix else x

    main = cross_entropy(trim(outputs["logits"]), labels, mask)
    exit_losses = {l: cross_entropy(trim(xl), labels, mask)
                   for l, xl in sorted(outputs["exit_logits"].items())}
    aux = outputs.get("aux_loss")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=main.device)
    return _with_exits(main, exit_losses, aux, exit_weight)
