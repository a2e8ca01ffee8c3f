"""Token samplers.

Port of ``repro.serving.sampler``.  ``greedy`` / ``temperature_sample`` are
the primitives; ``sample`` is the dispatch the batch scheduler calls (one
call samples every row of the batch at once).  The JAX package draws from a
``jax.random`` key; here an explicit ``torch.Generator`` on the logits'
device carries the state, so a scheduler seeded the same way gives the same
stream.  The draw is the Gumbel-max form of a categorical sample, as
``jax.random.categorical`` makes it; the two packages' draws differ token
for token and agree in distribution.
"""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def temperature_sample(gen: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0, top_k: int = 0
                       ) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) drawn from softmax(logits / T), keeping
    only the ``top_k`` largest logits of a row when ``top_k`` > 0."""
    lf = logits.float() / max(temperature, 1e-6)
    if top_k:
        cutoff = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = lf.masked_fill(lf < cutoff, -torch.inf)
    u = torch.rand(lf.shape, generator=gen, device=lf.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (lf - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, *, method: str = "greedy",
           gen: Optional[torch.Generator] = None, temperature: float = 1.0,
           top_k: int = 0) -> torch.Tensor:
    """Batched sampling dispatch: logits (B, V) -> tokens (B,)."""
    if method == "greedy":
        return greedy(logits)
    if method == "temperature":
        if gen is None:
            raise ValueError("temperature sampling requires a generator")
        return temperature_sample(gen, logits, temperature, top_k)
    raise ValueError(f"unknown sampler {method!r}")
