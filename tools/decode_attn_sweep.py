#!/usr/bin/env python3
"""Sweep the split plan of the port's two decode-attention kernels on one
NVIDIA GPU.

    python3 tools/decode_attn_sweep.py

Calls the C entries of ``csrc/decode_attn.cu`` and ``decode_attn_paged.cu``
directly with a range of splits per row (``per`` keys, or logical pages, a
split), on the inputs and with the timing of ``chip_smoke.py`` phase 2
(ee-llm-7b heads, bf16 q, cold L2, CUDA events), and prints one line per
shape: the device time in microseconds at each ``per``, the one that
``ops.split_plan`` picks marked with ``*``.  It also times a 64-key ring
at B=1 in one and in two splits, the floor of one launch.  Needs a CUDA
card and ``nvcc``; it checks each output against the plain version first.
"""
from __future__ import annotations

import sys
from ctypes import c_void_p
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn import ops  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_paged_ref, decode_attn_ref)

P = _build.ptr


def ring(per, q, k, v, pos, cur):
    b, h, d = q.shape
    s, kv = k.shape[1:3]
    out = torch.empty_like(q)
    fn = _build.function("decode_attn", "decode_attn_launch", ops._ARGTYPES)
    _build.check("decode_attn", fn(
        q.device.index, _build.DTYPE_CODES[q.dtype], P(q), P(k), P(v), P(pos),
        P(cur), P(out), b, h, kv, s, d, 0, -(-s // per), per,
        _build.stream(q)))
    return out


def paged(per, q, kp, vp, pos, tbl, cur, k_scale=None, v_scale=None):
    b, h, d = q.shape
    ps, kv = kp.shape[1:3]
    n_lp = tbl.shape[1]
    out = torch.empty_like(q)
    null = c_void_p(None)
    fn = _build.function("decode_attn_paged", "decode_attn_paged_launch",
                         ops._PAGED_ARGTYPES)
    _build.check("decode_attn_paged", fn(
        q.device.index, ops._PAGED_CODES[q.dtype], int(k_scale is not None),
        P(q), P(kp), P(vp), null if k_scale is None else P(k_scale),
        null if v_scale is None else P(v_scale), P(pos), P(tbl), P(cur),
        P(out), b, h, kv, ps, n_lp, d, 0, -(-n_lp // per), per,
        _build.stream(q)))
    return out


def sweep(label, fn, ref, calls, pers, chosen, kw=None):
    kw = kw or {}
    n = len(calls)
    line = []
    for per in pers:
        err = cs.max_err(fn(per, *calls[0], **kw), ref(*calls[0], **kw))
        cs.check(err <= 2e-2, f"{label} per={per}: max|err| {err}")
        ms = cs.device_ms(lambda i: fn(per, *calls[i % n], **kw))
        line.append(f"per={per}{'*' if per == chosen else ''}:"
                    f"{ms * 1e3:.2f}")
    print(f"sweep {label} (us):", *line, flush=True)


@torch.no_grad()
def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_attn_sweep: no CUDA card")
    cs.CFG = get_config("ee-llm-7b")
    print(cs.nvidia_smi(), flush=True)
    _build.build(["decode_attn", "decode_attn_paged"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    kv, s = cs.CFG.n_kv_heads, cs.MAX_SEQ
    for b, n_sets, pers in ((1, 12, (552, 192, 112, 80, 69)),
                            (8, 4, (552, 288, 192))):
        sets = [cs.attn_inputs(b, s, torch.bfloat16, dev, gen)
                for _ in range(n_sets)]
        for st in sets:
            st[4].fill_(s - 1)
        _, per = ops.split_plan(s, b * kv, align=ops.RING_ALIGN,
                                min_per=ops.RING_MIN_KEYS)
        sweep(f"ring B={b}", ring, decode_attn_ref, sets, pers, per)
    small = [cs.attn_inputs(1, 64, torch.bfloat16, dev, gen)
             for _ in range(12)]
    sweep("ring B=1 S=64", ring, decode_attn_ref, small, (64, 32), 64)
    n_lp = -(-cs.FILLS[1] // cs.PAGE_SIZE)
    for b, n_sets, pers in ((8, 4, (35, 18, 9, 5)),
                            (1, 12, (35, 18, 9, 7, 5))):
        kp, vp, sets = cs.paged_inputs(torch.bfloat16, dev, gen,
                                       sets=n_sets, b=b)
        _, per = ops.split_plan(n_lp, b * kv, min_per=ops.PAGED_MIN_PAGES)
        for int8 in (False, True):
            pool = cs.paged_pool(kp, vp, torch.bfloat16, int8)
            kw = ({k: pool[k] for k in ("k_scale", "v_scale")} if int8
                  else {})
            calls = [(q, pool["kp"], pool["vp"], pos, tbl, cur)
                     for q, pos, tbl, cur in sets]
            sweep(f"paged{' int8' if int8 else ''} B={b}", paged,
                  decode_attn_paged_ref, calls, pers, per, kw)


if __name__ == "__main__":
    main()
