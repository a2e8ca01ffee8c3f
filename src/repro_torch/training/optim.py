"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup cosine schedule (port of ``repro.training.optim``).

The optimizer is torch's fused AdamW: one update in place of each
parameter and its two moments, with no temporary copy of the model (at
ee-llm-7b's full width one copy is 15.6 GB in float32).  Its update is
the JAX package's, p (1 - lr wd) - lr m^ / (sqrt(v^) + eps).  It keeps
the moments (``exp_avg``, ``exp_avg_sq``) in each parameter's dtype, so
``init_adamw`` takes float32 parameters, as the JAX package trains.

Weight decay applies to a parameter of two or more dimensions: a matrix
(or a stack of per-expert or per-head matrices) of one layer.  The JAX
package decides on the stacked pytree leaf, whose leading layer axis
makes every per-layer norm gain and bias (and Mamba2's ``a_log``,
``dt_bias``, ``d_skip``) two-dimensional, so it decays those too; the
port decides on each layer's own parameter (ROADMAP, faults of the JAX
package).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_adamw(model: nn.Module) -> torch.optim.AdamW:
    """Fused AdamW over ``model``'s float32 parameters in two groups, the
    ones that decay (rank >= 2) and the others; ``adamw_update`` sets the
    hyperparameters and steps it."""
    params = list(model.parameters())
    other = sorted({str(p.dtype) for p in params} - {"torch.float32"})
    if other:
        raise ValueError(f"AdamW keeps its moments in the parameters' "
                         f"dtype: train in float32, not {other}")
    groups = [{"params": [p for p in params if (p.dim() >= 2) == decay],
               "decay": decay} for decay in (True, False)]
    return torch.optim.AdamW([g for g in groups if g["params"]], fused=True)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``: linear warmup over
    ``warmup_steps``, then a cosine to ``min_lr_ratio * lr`` at
    ``total_steps`` (float32 arithmetic, as the JAX package's)."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return float(cfg.lr * warm * frac)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32 (0-d, on the
    tensors' device)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def adamw_update(cfg: AdamWConfig, opt: torch.optim.AdamW
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step of ``opt`` (``init_adamw``) from its parameters'
    ``.grad`` (a missing gradient counts as zero), clipped in place to
    ``clip_norm`` by their global norm; the parameters and the moments
    change in place; each group's ``step_count`` is the steps taken.
    Returns {"grad_norm", "lr"}."""
    params = [p for g in opt.param_groups for p in g["params"]]
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        torch._foreach_mul_(grads, torch.clamp(
            cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0))
    step = opt.param_groups[0].get("step_count", 0) + 1
    lr = schedule(cfg, step)
    for g in opt.param_groups:
        g.update(lr=lr, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
                 weight_decay=cfg.weight_decay if g["decay"] else 0.0,
                 step_count=step)
    opt.step()
    return {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
