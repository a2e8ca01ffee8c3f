"""Gated linear attention core: the recurrence engine shared by the xLSTM
mLSTM block and the Mamba2 (SSD) block (port of ``repro.models.gla``).

State recurrence (per batch row and head):

    S_t = exp(lf_t) * S_{t-1} + exp(li_t) * k_t v_t^T        (Dk x Dv matrix)
    n_t = exp(lf_t) * n_{t-1} + exp(li_t) * k_t              (mLSTM normalizer)
    y_t = q_t S_t            [/ max(|q_t n_t|, exp(-m_t)) when normalize]

Three forms of the same function:
  * ``recurrent_gla``   — a loop over time (the oracle; the decode rule);
  * ``chunked_gla``     — chunk-parallel: one step a chunk of ``chunk``
                          tokens with dense (L x L) intra-chunk weights;
  * ``gla_decode_step`` — the one-token state update of serving.

The mLSTM exponential input gate is unbounded, so the xLSTM stabiliser
``m_t = max(lf_t + m_{t-1}, li_t)`` is carried through every form when
``normalize=True`` (the normalizer cancels the scale).  Mamba2 gates are
bounded (lf <= 0, li = log dt): the unstabilised path.  The state is
float32 in a model of any dtype.

The JAX package chunks with ``gcd(S, chunk)``, so a prompt of prime length
runs chunks of one token (a time loop of S steps).  Here every chunk is
``chunk`` tokens long but the last, which takes what is left: the same
function, with at most ``ceil(S / chunk)`` steps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

State = Dict[str, torch.Tensor]

_NEG = -1e30        # masked-out (future) intra-chunk log-weight


def init_gla_state(batch: int, heads: int, dk: int, dv: int, *,
                   device=None) -> State:
    return {"S": torch.zeros((batch, heads, dk, dv), device=device),
            "n": torch.zeros((batch, heads, dk), device=device),
            "m": torch.zeros((batch, heads), device=device)}


def _finalize(y_raw: torch.Tensor, n_dot: torch.Tensor, m_row: torch.Tensor,
              normalize: bool) -> torch.Tensor:
    if normalize:
        denom = torch.maximum(n_dot.abs(), torch.exp(-m_row))
        return y_raw / denom[..., None]
    return y_raw


def _gates(lf: torch.Tensor, li: torch.Tensor, m: torch.Tensor,
           normalize: bool):
    """(new stabiliser, forget scale, input scale) of one step."""
    if normalize:
        m_new = torch.maximum(lf + m, li)
        return m_new, torch.exp(lf + m - m_new), torch.exp(li - m_new)
    return m, torch.exp(lf), torch.exp(li)


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lf: torch.Tensor, li: torch.Tensor, state: State, *,
                    normalize: bool) -> Tuple[torch.Tensor, State]:
    """One-token update.  q, k: (B,H,Dk); v: (B,H,Dv); lf, li: (B,H).
    Returns (y (B,H,Dv) float32, new state); ``state`` is not modified."""
    S, n, m = state["S"].float(), state["n"].float(), state["m"].float()
    q, k, v = q.float(), k.float(), v.float()
    m_new, fscale, iscale = _gates(lf.float(), li.float(), m, normalize)
    S = (fscale[..., None, None] * S
         + iscale[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = fscale[..., None] * n + iscale[..., None] * k
    y_raw = (q[..., None, :] @ S)[..., 0, :]
    n_dot = (q * n).sum(-1)
    return _finalize(y_raw, n_dot, m_new, normalize), {"S": S, "n": n,
                                                       "m": m_new}


def recurrent_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lf: torch.Tensor, li: torch.Tensor, *, normalize: bool,
                  state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    """Oracle time loop.  q, k: (B,H,S,Dk); v: (B,H,S,Dv); lf, li:
    (B,H,S).  Returns (y (B,H,S,Dv) in q's dtype, final state)."""
    b, h, s, dk = q.shape
    st = state or init_gla_state(b, h, dk, v.shape[-1], device=q.device)
    ys = []
    for t in range(s):
        y, st = gla_decode_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                lf[:, :, t], li[:, :, t], st,
                                normalize=normalize)
        ys.append(y)
    return torch.stack(ys, 2).to(q.dtype), st


def _chunk_step(S, n, m_prev, qb, kb, vb, lfb, lib, normalize: bool):
    """One chunk of L tokens (all float32): (y (B,H,L,Dv), S, n, m)."""
    length = qb.shape[2]
    bcum = lfb.cumsum(-1)                         # inclusive: b_t
    b_last = bcum[..., -1]
    # intra log-weights D[t, s] = b_t - b_s + li_s (s <= t)
    dmat = bcum[..., :, None] - bcum[..., None, :] + lib[..., None, :]
    tri = torch.ones((length, length), dtype=torch.bool,
                     device=qb.device).tril()
    dmat = dmat.masked_fill(~tri, _NEG)
    w_inter = bcum + m_prev[..., None]            # (B,H,L)
    if normalize:
        m_row = torch.maximum(w_inter, dmat.amax(-1))
    else:
        m_row = torch.zeros_like(w_inter)
    wmat = (qb @ kb.transpose(-1, -2)) * torch.exp(dmat - m_row[..., None])
    e_inter = torch.exp(w_inter - m_row)
    y_raw = wmat @ vb + e_inter[..., None] * (qb @ S)
    n_dot = wmat.sum(-1) + e_inter * (qb @ n[..., None])[..., 0]
    y = _finalize(y_raw, n_dot, m_row, normalize)
    # end-of-chunk state update
    g = b_last[..., None] - bcum + lib            # (B,H,L)
    if normalize:
        m_new = torch.maximum(b_last + m_prev, g.amax(-1))
    else:
        m_new = m_prev
    carry = torch.exp(b_last + m_prev - m_new)
    kg = kb * torch.exp(g - m_new[..., None])[..., None]
    S = carry[..., None, None] * S + kg.transpose(-1, -2) @ vb
    n = carry[..., None] * n + kg.sum(-2)
    return y, S, n, m_new


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lf: torch.Tensor, li: torch.Tensor, *, normalize: bool,
                chunk: int = 256, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, State]:
    """Chunk-parallel form; equals ``recurrent_gla`` up to rounding.
    Shapes as ``recurrent_gla``; the last chunk may be shorter."""
    b, h, s, dk = q.shape
    st = state or init_gla_state(b, h, dk, v.shape[-1], device=q.device)
    S, n, m = st["S"].float(), st["n"].float(), st["m"].float()
    qf, kf, vf, lff, lif = (a.float() for a in (q, k, v, lf, li))
    ys = []
    for t0 in range(0, s, chunk):
        t1 = min(t0 + chunk, s)
        y, S, n, m = _chunk_step(S, n, m, qf[:, :, t0:t1], kf[:, :, t0:t1],
                                 vf[:, :, t0:t1], lff[:, :, t0:t1],
                                 lif[:, :, t0:t1], normalize)
        ys.append(y)
    return torch.cat(ys, 2).to(q.dtype), {"S": S, "n": n, "m": m}
