"""Public wrappers of the fused early-exit confidence head kernel
(``csrc/exit_head.cu``): ``exit_head`` for one exit and ``exit_heads`` for
the E exits of an edge tick in one launch, which reads the unembedding
once for all E * B rows (and, with ``quant_exit``, also writes the int8
wire packet of one exit's raw rows, ``exit_quant``'s body).

A CUDA tensor goes through the hand-written kernel (or the wrapper raises);
a CPU tensor goes through the plain version in ``ref.py``.  ``launches``
on each wrapper counts its kernel launches."""
from __future__ import annotations

from ctypes import POINTER, c_float, c_int, c_void_p
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.exit_head.ref import (ExitHeads, ExitPacket,
                                               exit_head_ref, exit_heads_ref)

MAX_ROWS = 16           # rows (exits x slots) of one launch
WS_BLOCKS = 1024        # partial slots of the workspace: blocks a launch
_PARTIALS = 3 * MAX_ROWS  # floats a block slot: (max, sum-exp, argmax) a row
_ARGTYPES = ([c_int, c_int] + [c_void_p] * 3 + [c_float] + [c_int] * 5
             + [c_void_p] * 3 + [c_int] + [c_void_p] * 4 + [c_int] * 2
             + [c_void_p, POINTER(c_int)])

_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def workspace(dev: torch.device) -> torch.Tensor:
    """The kernel's partials and completion counter for PyTorch's current
    stream on ``dev``: zeroed once, and left with the counter at 0 by
    every launch, so launches in stream order share it without a memset."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = torch.zeros((_PARTIALS * WS_BLOCKS + 4,), device=dev,
                         dtype=torch.float32)
        _workspaces[key] = ws
    return ws


def exit_operands(op: str, hidden: torch.Tensor, weight: torch.Tensor,
                  norm_scales: torch.Tensor, e: int):
    """Validate the operands of one launch over ``e`` exits: hidden
    (e * B, d), weight (V, d), norm_scales (e, d) of one dtype, d a
    multiple of 8, e * B <= MAX_ROWS.  Shared with ``exit_quant``."""
    r, d = hidden.shape
    v = weight.shape[0]
    dev = hidden.device
    _build.require(op, "hidden", hidden, device=dev, shape=(r, d),
                   dtypes=tuple(_build.DTYPE_CODES))
    _build.require(op, "weight", weight, device=dev, shape=(v, d),
                   dtypes=(hidden.dtype,))
    _build.require(op, "norm_scale", norm_scales, device=dev, shape=(e, d),
                   dtypes=(hidden.dtype,))
    if d % 8:
        raise ValueError(f"{op}: d_model {d} must be a multiple of 8")
    if not 1 <= r <= MAX_ROWS or r % e:
        raise ValueError(f"{op}: {r} rows over {e} exits; a launch takes "
                         f"1 to {MAX_ROWS} rows, B of each exit")


def launch(op: str, hidden: torch.Tensor, weight: torch.Tensor,
           norm_scales: torch.Tensor, e: int, eps: float,
           quant_exit: int = -1, q: Optional[torch.Tensor] = None,
           scale: Optional[torch.Tensor] = None, *, stages: int = 0,
           per_sm: int = 0, grid: Optional[c_int] = None):
    """One launch of the C entry ``exit_heads_launch`` of library ``op``
    over ``e`` exits of hidden (e * B, d); returns (conf, tok, lse, mx),
    each (e * B,), mx each row's raw max logit.  ``stages`` / ``per_sm``
    set the ring depth and the blocks a SM (0: the defaults); ``grid``
    receives the blocks launched."""
    exit_operands(op, hidden, weight, norm_scales, e)
    r, d = hidden.shape
    out = torch.empty((4, r), device=hidden.device, dtype=torch.int32)
    outs = (out[0].view(torch.float32), out[1], out[2].view(torch.float32),
            out[3].view(torch.float32))
    null = c_void_p(None)
    fn = _build.function(op, "exit_heads_launch", _ARGTYPES)
    _build.check(op, fn(
        hidden.device.index, _build.DTYPE_CODES[hidden.dtype],
        _build.ptr(hidden), _build.ptr(weight), _build.ptr(norm_scales),
        float(eps), e, r // e, weight.shape[0], d, quant_exit,
        null if q is None else _build.ptr(q),
        null if scale is None else _build.ptr(scale),
        _build.ptr(workspace(hidden.device)), WS_BLOCKS,
        *map(_build.ptr, outs), stages, per_sm, _build.stream(hidden), grid))
    return outs


def exit_head(hidden: torch.Tensor, weight: torch.Tensor,
              norm_scale: torch.Tensor, *, eps: float = 1e-5) -> ExitHeads:
    """(B,d) hidden + (V,d) unembedding + (d,) exit-norm scale ->
    ``ExitHeads`` of shape (B,).  More than ``MAX_ROWS`` rows take one
    launch per ``MAX_ROWS``."""
    if hidden.device.type == "cpu":
        return exit_head_ref(hidden, weight, norm_scale, eps)
    ns = norm_scale.reshape(1, -1)
    parts = []
    for b0 in range(0, hidden.shape[0], MAX_ROWS):
        parts.append(launch("exit_head", hidden[b0:b0 + MAX_ROWS], weight,
                            ns, 1, eps))
        exit_head.launches += 1
    if len(parts) == 1:
        return ExitHeads(*parts[0])
    return ExitHeads(*(torch.cat(p) for p in zip(*parts)))


exit_head.launches = 0


def exit_heads(hiddens: torch.Tensor, weight: torch.Tensor,
               norm_scales: torch.Tensor, eps: float = 1e-5,
               quant_exit: Optional[int] = None
               ) -> Union[ExitHeads, ExitPacket]:
    """The exit heads of E exits over B slots in one launch: hiddens
    (E, B, d), weight (V, d), norm_scales (E, d) -> ``ExitHeads`` of shape
    (E, B); with ``quant_exit``, an ``ExitPacket`` that also holds the
    int8 packet of that exit's raw rows, q int8 (B, d) and scale f32
    (B, 1).  E * B above ``MAX_ROWS`` takes one launch per slice of
    slots."""
    e, b, d = hiddens.shape
    if quant_exit is not None and not 0 <= quant_exit < e:
        raise ValueError(f"exit_heads: quant_exit {quant_exit} is not one "
                         f"of the {e} exits")
    if hiddens.device.type == "cpu":
        return exit_heads_ref(hiddens, weight, norm_scales, eps, quant_exit)
    qe = -1 if quant_exit is None else quant_exit
    q = scale = None
    if qe >= 0:
        q = torch.empty((b, d), device=hiddens.device, dtype=torch.int8)
        scale = torch.empty((b, 1), device=hiddens.device,
                            dtype=torch.float32)
    per = max(1, MAX_ROWS // e)
    parts = []
    for b0 in range(0, b, per):
        h = hiddens[:, b0:b0 + per]
        nb = h.shape[1]
        parts.append(launch(
            "exit_head", h.reshape(e * nb, d).contiguous(), weight,
            norm_scales, e, eps, qe,
            None if q is None else q[b0:b0 + nb],
            None if scale is None else scale[b0:b0 + nb]))
        exit_heads.launches += 1
    conf, tok, lse, mx = (
        torch.cat([p[i].reshape(e, -1) for p in parts], dim=1)
        if len(parts) > 1 else parts[0][i].reshape(e, b) for i in range(4))
    if q is None:
        return ExitHeads(conf, tok, lse, mx)
    return ExitPacket(conf, tok, lse, q, scale, mx)


exit_heads.launches = 0
