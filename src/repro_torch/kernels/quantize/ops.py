"""Public wrapper of the int8 transport quantizer kernel
(``csrc/quantize.cu``).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  ``launches``
counts kernel launches."""
from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ref import quantize_int8_ref

_ARGTYPES = [c_int, c_int] + [c_void_p] * 3 + [c_int, c_int, c_void_p]


def quantize_int8(x: torch.Tensor):
    """(N,d) f32/bf16 -> (int8 payload (N,d), f32 per-row scale (N,1))."""
    if x.device.type == "cpu":
        return quantize_int8_ref(x)
    n, d = x.shape
    _build.require("quantize", "x", x, device=x.device, shape=(n, d),
                   dtypes=tuple(_build.DTYPE_CODES))
    q = torch.empty((n, d), device=x.device, dtype=torch.int8)
    scale = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    fn = _build.function("quantize", "quantize_launch", _ARGTYPES)
    _build.check("quantize", fn(
        x.device.index, _build.DTYPE_CODES[x.dtype], _build.ptr(x),
        _build.ptr(q), _build.ptr(scale), n, d, _build.stream(x)))
    quantize_int8.launches += 1
    return q, scale


quantize_int8.launches = 0
