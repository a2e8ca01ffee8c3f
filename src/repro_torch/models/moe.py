"""Mixture-of-experts FFN with top-k routing (port of ``repro.models.moe``).

Every token's router picks its ``top_k`` experts by softmax probability
(the router is float32 in any model dtype, and its logits are computed in
float32); the picks' probabilities, renormalized, weight the experts'
gated-SiLU outputs.  Two forms, as in the JAX package:

* ``moe_forward_local`` (full-sequence forward, prefill): each expert
  takes at most ``C = max(ceil(S * top_k / E * capacity_factor), top_k)``
  of a row's (token, slot) pairs, in the row's (token, slot) order; the
  pairs past that are dropped (they add 0).  Also returns the Switch-style
  load-balance auxiliary loss.
* ``moe_forward_decode`` (decode steps and prefill chunks): routing
  without a capacity.

The JAX package computes the capacity form on per-expert buffers and the
decode form by gathering each (token, slot)'s expert weights, a (T, K, d,
f) copy (805 MB a layer for olmoe-1b-7b at 8 slots).  Here both group the
(token, slot) pairs by expert and run each chosen expert's FFN once over
its pairs with ``torch.matmul``, so an expert's weights are read once a
call, and no weights are copied; the pairs' outputs are then weighted and
summed over the slots in the JAX package's order.  The same code runs on
the CPU and on the card (one host synchronisation a call, for the pair
counts).

Under a model axis (the cloud mesh) each rank holds the d_ff slice of
every expert (``w_gate`` / ``w_up`` columns, ``w_down`` rows, the JAX
package's rules) and the router whole: the routing, and so each
expert's capacity over all tokens, is the same on every rank, and each
rank runs its d_ff slice of every chosen expert; the experts' outputs
are summed over the model group before the slots are weighted, where
the JAX package's ``_moe_forward_shardmap`` ``psum``s them.  The
auxiliary loss comes from the replicated routing.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import Axis, reduce_model
from repro_torch.models.common import dense_init_


class MoE(nn.Module):
    """Router (d, E) in float32, experts ``w_gate`` / ``w_up`` (E, d, f)
    and ``w_down`` (E, f, d) in the model's dtype; names follow the JAX
    package's pytree (``moe.router``, ``moe.w_gate``, ...).  Under a
    model ``axis`` whose size divides expert_d_ff, f is the rank's
    slice."""

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
        self.axis = axis if axis is not None and axis.size > 1 and \
            f % axis.size == 0 else None
        if self.axis is not None:
            f //= self.axis.size
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, e, device=device,
                                               dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **kw))


@torch.no_grad()
def init_moe(p: MoE, gen: torch.Generator) -> None:
    """The JAX package's distributions: the router N(0, 1) / sqrt(d), the
    gate and up projections N(0, 1) / sqrt(d), the down projection
    N(0, 1) / sqrt(f), drawn in float32 (one expert at a time)."""
    dense_init_(p.router, gen)
    for w in (p.w_gate, p.w_up, p.w_down):
        for we in w:
            dense_init_(we, gen)


def _route(p: MoE, xf: torch.Tensor, k: int):
    """xf (T, d) -> (probs (T, E) f32, top_p (T, K) f32 renormalized,
    top_e (T, K) int64), the picks in descending probability, ties to the
    lower expert (``jax.lax.top_k``'s order)."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _experts(p: MoE, xf: torch.Tensor, experts: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """xf (T, d); experts (T, K) int64, the expert of each (token, slot)
    pair or -1 for a dropped pair; weights (T, K) in xf's dtype ->
    sum over k of weights * FFN_expert(x) (T, d), a dropped pair adding 0.
    Each expert with pairs runs its FFN once over all of them."""
    t, k = experts.shape
    e = p.w_gate.shape[0]
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)          # dropped pairs first
    # pairs an expert (dropped first), read by the host once: index_add_
    # where torch.bincount on CUDA would read the maximum first; on
    # tensors without storage (the dry run) nothing can be read, and the
    # pairs count as spread evenly over the experts, none dropped
    if is_fake(flat):
        counts = [0] + [t * k // e + (ex < t * k % e) for ex in range(e)]
    else:
        counts = flat.new_zeros(e + 1).index_add_(
            0, flat + 1, torch.ones_like(flat)).tolist()
    y = xf.new_zeros((t * k, xf.shape[-1]))
    start = counts[0]
    for ex in range(e):
        n = counts[ex + 1]
        if not n:
            continue
        pairs = order[start:start + n]
        start += n
        xe = xf[pairs // k]
        h = (F.silu(xe @ p.w_gate[ex].to(xf.dtype))
             * (xe @ p.w_up[ex].to(xf.dtype)))
        y.index_copy_(0, pairs, h @ p.w_down[ex].to(xf.dtype))
    y = reduce_model(y, p.axis)         # the ranks' d_ff slices summed
    return (y.view(t, k, -1) * weights[..., None]).sum(1)


def moe_forward_local(p: MoE, cfg: ModelConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss f32 scalar), with each
    expert's capacity from S as passed (a right-padded prompt routes its
    pads too, as the JAX package's padded admission does)."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = max(int(math.ceil(s * k / e * moe.capacity_factor)), k)
    xf = x.reshape(b * s, d)
    probs, top_p, top_e = _route(p, xf, k)
    # each (token, slot) pair's place in its expert's buffer, per row
    flat_e = top_e.reshape(b, s * k)
    onehot = (flat_e[..., None] == torch.arange(e, device=x.device)).long()
    place = (onehot.cumsum(1) - onehot).gather(2, flat_e[..., None])[..., 0]
    kept = torch.where(place < cap, flat_e, -1).reshape(b * s, k)
    out = _experts(p, xf, kept, top_p.to(x.dtype))
    # Switch-style load-balance loss over every pair, dropped or not
    me = probs.mean(0)
    ce = onehot.sum((0, 1)).float() / (b * s * k)
    aux = e * torch.sum(me * ce) * moe.router_aux_coef
    return out.reshape(b, s, d), aux


def moe_forward_decode(p: MoE, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): decode steps (S = 1) and prefill chunks,
    every (token, slot) pair computed (no capacity)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    _, top_p, top_e = _route(p, xf, cfg.moe.top_k)
    return _experts(p, xf, top_e, top_p.to(x.dtype)).reshape(b, s, d)
