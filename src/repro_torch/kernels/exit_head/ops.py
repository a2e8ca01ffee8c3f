"""Public wrapper of the fused early-exit confidence head kernel
(``csrc/exit_head.cu``).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  ``launches``
counts kernel launches."""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exit_head.ref import exit_head_ref

_ARGTYPES = ([c_int, c_int] + [c_void_p] * 3 + [c_float, c_int, c_int, c_int]
             + [c_void_p] * 7)


def exit_operands(op: str, hidden: torch.Tensor, weight: torch.Tensor,
                  norm_scale: torch.Tensor):
    """Validate the exit head's operands and allocate its outputs and
    per-(row, V tile) scratch.  Shared with ``exit_quant``."""
    b, d = hidden.shape
    v = weight.shape[0]
    dev = hidden.device
    _build.require(op, "hidden", hidden, device=dev, shape=(b, d),
                   dtypes=tuple(_build.DTYPE_CODES))
    _build.require(op, "weight", weight, device=dev, shape=(v, d),
                   dtypes=(hidden.dtype,))
    _build.require(op, "norm_scale", norm_scale, device=dev, shape=(d,),
                   dtypes=(hidden.dtype,))
    if d % 8:
        raise ValueError(f"{op}: d_model {d} must be a multiple of 8")
    tiles = _build.function(op, "exit_tiles", [c_int])(v)
    f32 = dict(device=dev, dtype=torch.float32)
    scratch = (torch.empty((b, tiles), **f32), torch.empty((b, tiles), **f32),
               torch.empty((b, tiles), device=dev, dtype=torch.int32))
    outs = (torch.empty((b,), **f32),
            torch.empty((b,), device=dev, dtype=torch.int32),
            torch.empty((b,), **f32))
    return scratch, outs


def exit_head(hidden: torch.Tensor, weight: torch.Tensor,
              norm_scale: torch.Tensor, *, eps: float = 1e-5):
    """(B,d) hidden + (V,d) unembedding + (d,) exit-norm scale ->
    (confidence (B,) f32, token (B,) int32, logsumexp (B,) f32)."""
    if hidden.device.type == "cpu":
        return exit_head_ref(hidden, weight, norm_scale, eps)
    scratch, outs = exit_operands("exit_head", hidden, weight, norm_scale)
    b, d = hidden.shape
    fn = _build.function("exit_head", "exit_head_launch", _ARGTYPES)
    _build.check("exit_head", fn(
        hidden.device.index, _build.DTYPE_CODES[hidden.dtype],
        _build.ptr(hidden), _build.ptr(weight), _build.ptr(norm_scale),
        float(eps), b, weight.shape[0], d,
        *map(_build.ptr, scratch), *map(_build.ptr, outs),
        _build.stream(hidden)))
    exit_head.launches += 1
    return outs


exit_head.launches = 0
