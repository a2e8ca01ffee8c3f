"""Early-exit confidence logic (paper §4.1, Algorithm 1 lines 7-21).

Confidence = probability of the most likely token at an exit head's softmax
(paper Table 1).  A token exits at the FIRST exit whose confidence >= theta;
otherwise the cloud completes inference.

Port of ``repro.core.exits``.  ``evaluate_exit`` takes the exit's hidden
state and head weights and goes through the ``exit_head`` kernel, which
never writes the (B, V) logits: its decisions carry ``logits=None``, and
greedy decoding needs only the token and the confidence.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.exit_head.ops import exit_head


class ExitDecision(NamedTuple):
    token: torch.Tensor                    # (B,) int32 argmax token
    confidence: torch.Tensor               # (B,) f32 max softmax probability
    logits: Optional[torch.Tensor] = None  # (B, V), only for sampling


def evaluate_exit(hidden: torch.Tensor, weight: torch.Tensor,
                  norm_scale: torch.Tensor, eps: float) -> ExitDecision:
    """hidden: (B, d) (or (B, 1, d)) at an exit; weight: (V, d) unembedding;
    norm_scale: (d,) the exit's read-out norm -> ExitDecision."""
    h = hidden.reshape(hidden.shape[0], hidden.shape[-1]).contiguous()
    conf, tok, _ = exit_head(h, weight, norm_scale, eps=eps)
    return ExitDecision(token=tok, confidence=conf)


def select_exit_logits(decisions: Dict[int, ExitDecision], theta: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row logits of the first confident exit (sampling-capable variant
    of ``first_confident_exit``); needs decisions that carry logits.

    Returns (logits (B,V), exited (B,), exit_idx (B,)).  Rows that exit
    nowhere get the LAST exit's logits — callers overwrite those rows with
    cloud logits via the ``exited`` mask before sampling."""
    layers = sorted(decisions)
    if any(decisions[l].logits is None for l in layers):
        raise ValueError("select_exit_logits needs decisions with logits "
                         "(the exit_head kernel returns none)")
    _, exited, exit_idx = first_confident_exit(decisions, theta)
    stack = torch.stack([decisions[l].logits for l in layers])   # (E, B, V)
    row = exit_idx.clamp(0, len(layers) - 1).long()
    sel = stack[row, torch.arange(row.shape[0], device=row.device)]
    return sel, exited, exit_idx


def first_confident_exit(decisions: Dict[int, ExitDecision], theta: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine per-exit decisions (ordered by layer).

    Returns (token, exited_mask, exit_index) where exit_index is the index of
    the chosen exit (len(decisions) == needs cloud)."""
    layers = sorted(decisions)
    first = decisions[layers[0]].token
    b, dev = first.shape[0], first.device
    token = torch.zeros((b,), dtype=torch.int32, device=dev)
    exited = torch.zeros((b,), dtype=torch.bool, device=dev)
    exit_idx = torch.full((b,), len(layers), dtype=torch.int32, device=dev)
    for i, l in enumerate(layers):
        d = decisions[l]
        take = (~exited) & (d.confidence >= theta)
        token = torch.where(take, d.token, token)
        exit_idx = torch.where(take, i, exit_idx)
        exited = exited | take
    return token, exited, exit_idx
