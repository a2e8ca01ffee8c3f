"""Public wrappers of the GQA flash-decode attention kernels: the ring
cache (``csrc/decode_attn.cu``) and the block-paged pool with float or int8
pages (``csrc/decode_attn_paged.cu``).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  Each wrapper's
``launches`` counts its kernel launches (the paged kernel's int8 variant
counts on ``decode_attn_paged_int8``)."""
from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import (decode_attn_paged_ref,
                                                 decode_attn_ref)

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


PAGED_HEAD_DIMS = (64, 128)
_PAGED_CODES = {**_build.DTYPE_CODES, torch.float16: 2}
_PAGED_ARGTYPES = [c_int] * 3 + [c_void_p] * 9 + [c_int] * 7 + [c_void_p]


def decode_attn_paged(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      pos_pages: torch.Tensor, block_tbl: torch.Tensor,
                      cur_pos: torch.Tensor, *,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      window: int = 0) -> torch.Tensor:
    """q: (B,H,d) one new token per row; kp/vp: (P,ps,KV,d) page pool in
    q's dtype; pos_pages: (P,ps) int32 (-1 = empty); block_tbl: (B,n_lp)
    int32 physical page ids (-1 = unallocated); cur_pos: (B,) int32 ->
    (B,H,d) in q's dtype.  int8 pools pass their (P,ps,KV) float32
    ``k_scale``/``v_scale`` and go through ``decode_attn_paged_int8``.
    On CUDA: q in float32/bfloat16/float16, d in ``PAGED_HEAD_DIMS``, H/KV
    in ``GROUPS``."""
    if k_scale is not None or v_scale is not None:
        return decode_attn_paged_int8(q, kp, vp, k_scale, v_scale, pos_pages,
                                      block_tbl, cur_pos, window=window)
    if q.device.type == "cpu":
        return decode_attn_paged_ref(q, kp, vp, pos_pages, block_tbl,
                                     cur_pos, window=window)
    out = _paged_launch(q, kp, vp, None, None, pos_pages, block_tbl, cur_pos,
                        window)
    decode_attn_paged.launches += 1
    return out


def decode_attn_paged_int8(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, pos_pages: torch.Tensor,
                           block_tbl: torch.Tensor, cur_pos: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """``decode_attn_paged`` over int8 pages: kp/vp (P,ps,KV,d) int8 with
    per-(slot, kv head) float32 scales k_scale/v_scale (P,ps,KV),
    dequantized inside the kernel after the page load."""
    if q.device.type == "cpu":
        return decode_attn_paged_ref(q, kp, vp, pos_pages, block_tbl,
                                     cur_pos, window=window, k_scale=k_scale,
                                     v_scale=v_scale)
    out = _paged_launch(q, kp, vp, k_scale, v_scale, pos_pages, block_tbl,
                        cur_pos, window)
    decode_attn_paged_int8.launches += 1
    return out


def _paged_launch(q, kp, vp, k_scale, v_scale, pos_pages, block_tbl,
                  cur_pos, window: int) -> torch.Tensor:
    op = "decode_attn_paged"
    b, h, d = q.shape
    n_pages, ps, kvh = kp.shape[:3]
    n_lp = block_tbl.shape[1]
    dev = q.device
    quantized = k_scale is not None
    _build.require(op, "q", q, device=dev, shape=(b, h, d),
                   dtypes=tuple(_PAGED_CODES))
    for name, t in (("kp", kp), ("vp", vp)):
        _build.require(op, name, t, device=dev, shape=(n_pages, ps, kvh, d),
                       dtypes=(torch.int8,) if quantized else (q.dtype,))
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _build.require(op, name, t, device=dev,
                           shape=(n_pages, ps, kvh), dtypes=(torch.float32,))
    _build.require(op, "pos_pages", pos_pages, device=dev,
                   shape=(n_pages, ps), dtypes=(torch.int32,))
    _build.require(op, "block_tbl", block_tbl, device=dev, shape=(b, n_lp),
                   dtypes=(torch.int32,))
    _build.require(op, "cur_pos", cur_pos, device=dev, shape=(b,),
                   dtypes=(torch.int32,))
    if d not in PAGED_HEAD_DIMS or h % kvh or h // kvh not in GROUPS:
        raise ValueError(f"{op}: head_dim {d} / group {h}/{kvh} not "
                         f"supported (head_dim in {PAGED_HEAD_DIMS}, H/KV "
                         f"in {GROUPS})")
    out = torch.empty_like(q)
    null = c_void_p(None)
    fn = _build.function("decode_attn_paged", "decode_attn_paged_launch",
                         _PAGED_ARGTYPES)
    _build.check("decode_attn_paged", fn(
        dev.index, _PAGED_CODES[q.dtype], int(quantized), _build.ptr(q),
        _build.ptr(kp), _build.ptr(vp),
        _build.ptr(k_scale) if quantized else null,
        _build.ptr(v_scale) if quantized else null, _build.ptr(pos_pages),
        _build.ptr(block_tbl), _build.ptr(cur_pos), _build.ptr(out), b, h,
        kvh, ps, n_lp, d, int(window), _build.stream(q)))
    return out


decode_attn_paged.launches = 0
decode_attn_paged_int8.launches = 0
