"""Public wrapper of the fused exit-head + int8 quantize kernel
(``csrc/exit_quant.cu``).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  ``launches``
counts kernel launches."""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exit_head.ops import exit_operands
from repro_torch.kernels.exit_quant.ref import exit_quant_ref

_ARGTYPES = ([c_int, c_int] + [c_void_p] * 3 + [c_float, c_int, c_int, c_int]
             + [c_void_p] * 9)


def exit_quant(hidden: torch.Tensor, weight: torch.Tensor,
               norm_scale: torch.Tensor, *, eps: float = 1e-5):
    """(B,d) hidden + (V,d) unembedding + (d,) exit-norm scale ->
    (confidence, token, logsumexp, q int8 (B,d), scale f32 (B,1)) in one
    launch: the exit decision and the int8 wire packet of the raw hidden."""
    if hidden.device.type == "cpu":
        return exit_quant_ref(hidden, weight, norm_scale, eps)
    scratch, outs = exit_operands("exit_quant", hidden, weight, norm_scale)
    b, d = hidden.shape
    q = torch.empty((b, d), device=hidden.device, dtype=torch.int8)
    scale = torch.empty((b, 1), device=hidden.device, dtype=torch.float32)
    fn = _build.function("exit_quant", "exit_quant_launch", _ARGTYPES)
    _build.check("exit_quant", fn(
        hidden.device.index, _build.DTYPE_CODES[hidden.dtype],
        _build.ptr(hidden), _build.ptr(weight), _build.ptr(norm_scale),
        float(eps), b, weight.shape[0], d,
        *map(_build.ptr, scratch), *map(_build.ptr, outs),
        _build.ptr(q), _build.ptr(scale), _build.stream(hidden)))
    exit_quant.launches += 1
    return (*outs, q, scale)


exit_quant.launches = 0
