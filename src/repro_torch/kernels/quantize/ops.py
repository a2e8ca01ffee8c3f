"""Public wrappers of the int8 quantizer kernels (``csrc/quantize.cu``): the
transport quantizer of the wire packet, and the two int8 K/V page writes
of the paged cache (a decode step's rows, a prefilled row's scatter).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  Each call that
reaches the card is one CUDA launch, counted on its wrapper's
``launches``."""
from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ref import (Cache, quantize_int8_ref,
                                              quantize_kv_scatter_ref,
                                              quantize_kv_write_ref)

MAX_ROW = 32768                 # elements of a wire row, at most, on CUDA
KV_HEAD_DIMS = (32, 64, 128, 256)
_ARGTYPES = [c_int, c_int] + [c_void_p] * 3 + [c_int, c_int, c_void_p]
_WRITE_ARGTYPES = [c_int, c_int] + [c_void_p] * 10 + [c_int] * 5 + [c_void_p]
_SCATTER_ARGTYPES = [c_int, c_int] + [c_void_p] * 9 + [c_int] * 5 + [c_void_p]


def quantize_int8(x: torch.Tensor):
    """(N,d) f32/bf16 -> (int8 payload (N,d), f32 per-row scale (N,1)).
    On CUDA d is at most ``MAX_ROW``."""
    if x.device.type == "cpu":
        return quantize_int8_ref(x)
    n, d = x.shape
    _build.require("quantize", "x", x, device=x.device, shape=(n, d),
                   dtypes=tuple(_build.DTYPE_CODES))
    if d > MAX_ROW:
        raise ValueError(f"quantize: rows of {d} elements; the kernel keeps "
                         f"a row in registers, at most {MAX_ROW}")
    q = torch.empty((n, d), device=x.device, dtype=torch.int8)
    scale = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    fn = _build.function("quantize", "quantize_launch", _ARGTYPES)
    _build.check("quantize", fn(
        x.device.index, _build.DTYPE_CODES[x.dtype], _build.ptr(x),
        _build.ptr(q), _build.ptr(scale), n, d, _build.stream(x)))
    quantize_int8.launches += 1
    return q, scale


quantize_int8.launches = 0


def _require_pool(op: str, cache: Cache, kvh: int, d: int,
                  device: torch.device) -> None:
    n_pages, ps = cache["pos"].shape
    _build.require(op, "pos", cache["pos"], device=device,
                   shape=(n_pages, ps), dtypes=(torch.int32,), align=4)
    for name in ("kp", "vp"):
        _build.require(op, name, cache[name], device=device,
                       shape=(n_pages, ps, kvh, d), dtypes=(torch.int8,))
    for name in ("ks", "vs"):
        _build.require(op, name, cache[name], device=device,
                       shape=(n_pages, ps, kvh), dtypes=(torch.float32,),
                       align=4)
    if d not in KV_HEAD_DIMS:
        raise ValueError(f"{op}: head_dim {d} is not one of {KV_HEAD_DIMS}")


def _pool_ptrs(cache: Cache) -> list:
    return [_build.ptr(cache[n]) for n in ("kp", "vp", "ks", "vs", "pos")]


def quantize_kv_write(cache: Cache, knew: torch.Tensor, vnew: torch.Tensor,
                      pos: torch.Tensor, block_tbl: torch.Tensor,
                      write_mask: Optional[torch.Tensor] = None) -> Cache:
    """One decode step's K/V rows into an int8 page pool, in place, in one
    launch: knew/vnew (B, KV, d) f32/bf16; pos (B,) int32; block_tbl (B,
    n_lp) int32; write_mask (B,) bool or None; ``cache`` with kp/vp (P, ps,
    KV, d) int8, ks/vs (P, ps, KV) f32 and pos (P, ps) int32.  Row b goes
    to page ``block_tbl[b, pos // ps]`` (the last entry past the table) at
    slot ``pos % ps`` with marker ``pos``, or, unmapped or masked, to the
    trash page 0 with marker -1 (``ref.quantize_kv_write_ref``).  On CUDA d
    is one of ``KV_HEAD_DIMS``."""
    if knew.device.type == "cpu":
        return quantize_kv_write_ref(cache, knew, vnew, pos, block_tbl,
                                     write_mask)
    op = "quantize_kv_write"
    b, kvh, d = knew.shape
    dev = knew.device
    _build.require(op, "knew", knew, device=dev, shape=(b, kvh, d),
                   dtypes=tuple(_build.DTYPE_CODES))
    _build.require(op, "vnew", vnew, device=dev, shape=(b, kvh, d),
                   dtypes=(knew.dtype,))
    _build.require(op, "pos", pos, device=dev, shape=(b,),
                   dtypes=(torch.int32,), align=4)
    n_lp = block_tbl.shape[-1]
    _build.require(op, "block_tbl", block_tbl, device=dev, shape=(b, n_lp),
                   dtypes=(torch.int32,), align=4)
    if write_mask is not None:
        _build.require(op, "write_mask", write_mask, device=dev, shape=(b,),
                       dtypes=(torch.bool,), align=1)
    _require_pool(op, cache, kvh, d, dev)
    ps = cache["pos"].shape[1]
    fn = _build.function("quantize", "quantize_kv_write_launch",
                         _WRITE_ARGTYPES)
    mask = None if write_mask is None else _build.ptr(write_mask)
    _build.check("quantize", fn(
        dev.index, _build.DTYPE_CODES[knew.dtype], _build.ptr(knew),
        _build.ptr(vnew), _build.ptr(pos), _build.ptr(block_tbl), mask,
        *_pool_ptrs(cache), b, kvh, d, n_lp, ps, _build.stream(knew)))
    quantize_kv_write.launches += 1
    return cache


quantize_kv_write.launches = 0


def quantize_kv_scatter(cache: Cache, row: Cache,
                        pages: torch.Tensor) -> Cache:
    """A single-row dense prefill cache into an int8 page pool, in place, in
    one launch (K, V, scales and markers): ``row`` {"k"/"v": (1, L, KV, d)
    f32/bf16, "pos": (1, L) int32}; ``pages`` (n_lp,) int32 physical ids.
    Token t < n_lp * ps goes to page ``pages[t // ps]`` (entries < 0: the
    trash page) at slot ``t % ps``; tokens at or past L take code 0, scale
    0.0 and marker -1 (``ref.quantize_kv_scatter_ref``).  On CUDA d is one
    of ``KV_HEAD_DIMS``."""
    if row["k"].device.type == "cpu":
        return quantize_kv_scatter_ref(cache, row, pages)
    op = "quantize_kv_scatter"
    _, length, kvh, d = row["k"].shape
    dev = row["k"].device
    k, v, row_pos = row["k"][0], row["v"][0], row["pos"][0]
    _build.require(op, "row k", k, device=dev, shape=(length, kvh, d),
                   dtypes=tuple(_build.DTYPE_CODES))
    _build.require(op, "row v", v, device=dev, shape=(length, kvh, d),
                   dtypes=(k.dtype,))
    _build.require(op, "row pos", row_pos, device=dev, shape=(length,),
                   dtypes=(torch.int32,), align=4)
    n_lp = pages.shape[0]
    _build.require(op, "pages", pages, device=dev, shape=(n_lp,),
                   dtypes=(torch.int32,), align=4)
    _require_pool(op, cache, kvh, d, dev)
    ps = cache["pos"].shape[1]
    fn = _build.function("quantize", "quantize_kv_scatter_launch",
                         _SCATTER_ARGTYPES)
    _build.check("quantize", fn(
        dev.index, _build.DTYPE_CODES[k.dtype], _build.ptr(k), _build.ptr(v),
        _build.ptr(row_pos), _build.ptr(pages), *_pool_ptrs(cache), length,
        n_lp * ps, kvh, d, ps, _build.stream(k)))
    quantize_kv_scatter.launches += 1
    return cache


quantize_kv_scatter.launches = 0
