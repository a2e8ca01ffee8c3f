"""Public wrapper of the fused exit-head + int8 quantize kernel
(``csrc/exit_quant.cu``).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  ``launches``
counts kernel launches."""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exit_head.ops import (MAX_ROWS, WS_BLOCKS,
                                               exit_operands, workspace)
from repro_torch.kernels.exit_quant.ref import exit_quant_ref

_ARGTYPES = ([c_int, c_int] + [c_void_p] * 3 + [c_float] + [c_int] * 3
             + [c_void_p] * 3 + [c_int] + [c_void_p] * 4)


def exit_quant(hidden: torch.Tensor, weight: torch.Tensor,
               norm_scale: torch.Tensor, *, eps: float = 1e-5):
    """(B,d) hidden + (V,d) unembedding + (d,) exit-norm scale ->
    (confidence, token, logsumexp, q int8 (B,d), scale f32 (B,1)): the
    exit decision and the int8 wire packet of the raw hidden, in one
    launch per ``exit_head.ops.MAX_ROWS`` rows."""
    if hidden.device.type == "cpu":
        return exit_quant_ref(hidden, weight, norm_scale, eps)
    ns = norm_scale.reshape(1, -1)
    b, d = hidden.shape
    blocks = [slice(b0, b0 + MAX_ROWS) for b0 in range(0, max(b, 1),
                                                       MAX_ROWS)]
    for rows in blocks:
        exit_operands("exit_quant", hidden[rows], weight, ns, 1)
    q = torch.empty((b, d), device=hidden.device, dtype=torch.int8)
    scale = torch.empty((b, 1), device=hidden.device, dtype=torch.float32)
    out = torch.empty((3, b), device=hidden.device, dtype=torch.int32)
    outs = (out[0].view(torch.float32), out[1], out[2].view(torch.float32))
    fn = _build.function("exit_quant", "exit_quant_launch", _ARGTYPES)
    for rows in blocks:
        h = hidden[rows]
        _build.check("exit_quant", fn(
            hidden.device.index, _build.DTYPE_CODES[hidden.dtype],
            _build.ptr(h), _build.ptr(weight), _build.ptr(ns), float(eps),
            h.shape[0], weight.shape[0], d, _build.ptr(q[rows]),
            _build.ptr(scale[rows]), _build.ptr(workspace(hidden.device)),
            WS_BLOCKS, *(_build.ptr(o[rows]) for o in outs),
            _build.stream(hidden)))
        exit_quant.launches += 1
    return (*outs, q, scale)


exit_quant.launches = 0
