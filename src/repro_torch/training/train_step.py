"""The train step: multi-exit LM loss + AdamW (port of
``repro.training.train_step``).

The model's parameters and the optimizer's state are updated in place.
A step's work is two spans (``repro_torch.tracing``): ``gradients`` (the
forward and backward passes of every microbatch) and ``optimizer``
(AdamW).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.tracing import span
from repro_torch.training.loss import multi_exit_loss, multi_exit_loss_fused
from repro_torch.training.optim import AdamWConfig, adamw_update

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def make_train_step(model, opt_cfg: AdamWConfig, exit_weight: float = 0.3,
                    microbatches: int = 1
                    ) -> Callable[[torch.optim.AdamW, Batch],
                                  Tuple[torch.optim.AdamW, Metrics]]:
    """Returns ``train_step(opt, batch) -> (opt, metrics)``, ``opt`` from
    ``init_adamw(model)``.

    batch: {"tokens": (B, S), "labels": (B, S), "mask": (B, S)} on the
    model's device, with "frames" or "patches" where the model takes them.
    The loss is the fused chunked unembedding + CE (no (B, S, V) logits).
    ``microbatches`` > 1 accumulates the gradient over that many slices
    of the batch, averaged, in order (the JAX package's scan): activation
    memory 1/M for M passes.  metrics: the losses (the mean over the
    slices; "loss" their accumulated mean), "grad_norm" and "lr", 0-d
    tensors."""

    def losses_of(batch: Batch) -> Metrics:
        hiddens = model.forward_train_hiddens(batch)
        return multi_exit_loss_fused(model, hiddens, batch["labels"],
                                     batch["mask"], exit_weight=exit_weight)

    def train_step(opt: torch.optim.AdamW, batch: Batch
                   ) -> Tuple[torch.optim.AdamW, Metrics]:
        model.zero_grad(set_to_none=True)
        dev = batch["tokens"].device
        with torch.enable_grad(), span("gradients", dev):
            if microbatches <= 1:
                losses = losses_of(batch)
                losses["loss"].backward()
                metrics = {k: v.detach() for k, v in losses.items()}
            else:
                b = batch["tokens"].shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"{microbatches} microbatches")
                n = b // microbatches
                parts = []
                for i in range(microbatches):
                    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    losses = losses_of(mb)
                    (losses["loss"] / microbatches).backward()
                    parts.append({k: v.detach() for k, v in losses.items()})
                metrics = {k: torch.stack([p[k] for p in parts]).mean()
                           for k in parts[0]}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=metrics["loss"].device)
                for p in parts:
                    loss = loss + p["loss"] / microbatches
                metrics["loss"] = loss
        with span("optimizer", dev):
            info = adamw_update(opt_cfg, opt)
        return opt, {**metrics, **info}

    return train_step


def make_eval_step(model, exit_weight: float = 0.3
                   ) -> Callable[[Batch], Metrics]:
    """Returns ``eval_step(batch) -> losses``: ``Model.forward_train``'s
    logits through ``multi_exit_loss``, without gradients."""

    @torch.no_grad()
    def eval_step(batch: Batch) -> Metrics:
        out = model.forward_train(batch)
        return multi_exit_loss(out, batch["labels"], batch["mask"],
                               exit_weight=exit_weight)

    return eval_step
