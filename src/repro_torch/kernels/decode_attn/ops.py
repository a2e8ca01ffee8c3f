"""Public wrapper of the GQA flash-decode attention kernel
(``csrc/decode_attn.cu``).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  ``launches``
counts kernel launches."""
from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

HEAD_DIMS = (32, 64, 128, 256)
GROUPS = (1, 2, 4, 8)
_ARGTYPES = [c_int, c_int] + [c_void_p] * 6 + [c_int] * 6 + [c_void_p]


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos_ids: torch.Tensor, cur_pos: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """q: (B,H,d) one new token per row; k/v: (B,S,KV,d) ring cache;
    pos_ids: (B,S) int32 (-1 = empty); cur_pos: (B,) int32 per-row current
    position -> (B,H,d) in q's dtype.  Any S; d in ``HEAD_DIMS`` and H/KV
    in ``GROUPS`` on CUDA."""
    if q.device.type == "cpu":
        return decode_attn_ref(q, k, v, pos_ids, cur_pos, window=window)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev, fl = q.device, tuple(_build.DTYPE_CODES)
    _build.require("decode_attn", "q", q, device=dev, shape=(b, h, d),
                   dtypes=fl)
    for name, t in (("k", k), ("v", v)):
        _build.require("decode_attn", name, t, device=dev,
                       shape=(b, s, kvh, d), dtypes=(q.dtype,))
    _build.require("decode_attn", "pos_ids", pos_ids, device=dev,
                   shape=(b, s), dtypes=(torch.int32,))
    _build.require("decode_attn", "cur_pos", cur_pos, device=dev,
                   shape=(b,), dtypes=(torch.int32,))
    if d not in HEAD_DIMS or h % kvh or h // kvh not in GROUPS:
        raise ValueError(f"decode_attn: head_dim {d} / group {h}/{kvh} not "
                         f"supported (head_dim in {HEAD_DIMS}, H/KV in "
                         f"{GROUPS})")
    out = torch.empty_like(q)
    fn = _build.function("decode_attn", "decode_attn_launch", _ARGTYPES)
    _build.check("decode_attn", fn(
        dev.index, _build.DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k),
        _build.ptr(v), _build.ptr(pos_ids), _build.ptr(cur_pos),
        _build.ptr(out), b, h, kvh, s, d, int(window), _build.stream(q)))
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
