"""Early-exit confidence logic (paper §4.1, Algorithm 1 lines 7-21).

Confidence = probability of the most likely token at an exit head's softmax
(paper Table 1).  A token exits at the FIRST exit whose confidence >= theta;
otherwise the cloud completes inference.

Port of ``repro.core.exits``.  ``evaluate_exit`` takes the exit's hidden
state and head weights and goes through the ``exit_head`` kernel, which
never writes the (B, V) logits: its decisions carry ``logits=None``, and
greedy decoding needs only the token and the confidence.
``evaluate_exits`` does the same for every exit of a tick in one
``exit_heads`` launch, which reads the unembedding once for all of them.
Under a model axis that splits the vocabulary (the cloud mesh), each
rank's launch covers its slice of the unembedding, and the ranks' (conf,
token, lse) are merged into the whole vocabulary's
(``sharding.merge_exits``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.exit_head.ops import exit_head, exit_heads
from repro_torch.launch.sharding import Axis, merge_exits


class ExitDecision(NamedTuple):
    token: torch.Tensor                    # (B,) int32 argmax token
    confidence: torch.Tensor               # (B,) f32 max softmax probability
    logits: Optional[torch.Tensor] = None  # (B, V), only for sampling


def evaluate_exit(hidden: torch.Tensor, weight: torch.Tensor,
                  norm_scale: torch.Tensor, eps: float,
                  axis: Optional[Axis] = None) -> ExitDecision:
    """hidden: (B, d) (or (B, 1, d)) at an exit; weight: (V, d) unembedding
    (a rank's (V / M, d) slice under the vocabulary's ``axis``);
    norm_scale: (d,) the exit's read-out norm -> ExitDecision."""
    h = hidden.reshape(hidden.shape[0], hidden.shape[-1]).contiguous()
    conf, tok, lse = exit_head(h, weight, norm_scale, eps=eps)
    conf, tok, _ = merge_exits(conf, tok, lse, axis, weight.shape[0])
    return ExitDecision(token=tok, confidence=conf)


def evaluate_exits(hiddens: Sequence[torch.Tensor], weight: torch.Tensor,
                   norm_scales: torch.Tensor, eps: float,
                   quant_exit: Optional[int] = None,
                   axis: Optional[Axis] = None
                   ) -> Tuple[List[ExitDecision], Optional[tuple]]:
    """The E exits of one tick in one ``exit_heads`` launch: ``hiddens``
    E hiddens of (B, d) (or (B, 1, d)), ``norm_scales`` (E, d) ->
    (one ExitDecision an exit, in order; the int8 packet (q (B, d),
    scale (B, 1)) of exit ``quant_exit``'s raw rows, or None).  ``axis``
    as ``evaluate_exit``; the packet comes from the whole hidden row, the
    same on every rank."""
    h = torch.stack([x.reshape(x.shape[0], x.shape[-1]) for x in hiddens])
    out = exit_heads(h, weight, norm_scales, eps, quant_exit)
    conf, tok, _ = merge_exits(out[0], out[1], out[2], axis, weight.shape[0])
    decisions = [ExitDecision(token=t, confidence=c)
                 for c, t in zip(conf, tok)]
    return decisions, (None if quant_exit is None else out[3:])


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
