#!/usr/bin/env python3
"""Check and time the port's exit-head kernel on one NVIDIA GPU over its
ring depth and blocks a SM.

    python3 tools/exit_head_sweep.py [--check-only]

Calls the C entry ``exit_heads_launch`` of ``csrc/exit_head.cu`` directly,
at ee-llm-7b's (V = 32000, d = 4096) and gemma3-12b's (V = 262144,
d = 3840) unembeddings in bf16, for R = 1, 2, 8 and 16 rows (one exit
at B = 1, two exits at B = 1, of 4 and of 8 slots; bf16 above 8 rows runs
on the tensor cores), with a ring of 1 to 3
stages and 1 or 2 blocks a SM.  Each configuration is first held to the
plain version (confidence within 1e-5, logsumexp within 1e-4, equal
tokens, with a tie across two blocks' ranges on row 0); then its device
time is taken as ``chip_smoke.py`` phase 2 takes it (CUDA events over 50
back-to-back calls behind a sleep), and printed beside the blocks launched
and the bound (the bytes of W and the rows over 3.35 TB/s).  R = 16
against R = 1 at one depth shows what the products cost beside the bytes;
the depths show what keeps the loads in flight.  ``--check-only`` stops
after the checks (a first run of a new build); ``--rows`` and ``--model``
narrow the grid.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from ctypes import byref, c_int
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.exit_head import ops  # noqa: E402
from repro_torch.kernels.exit_head.ref import exit_heads_ref  # noqa: E402

SHAPES = (("ee-llm-7b", 32000, 4096), ("gemma3-12b", 262144, 3840))
ROWS = ((1, 1), (2, 1), (2, 4), (2, 8))   # (E, B)
CONFIGS = ((3, 1), (2, 1), (1, 1), (1, 2))  # (stages, blocks a SM)


def inputs(e, b, v, d, dtype, dev, gen):
    h = torch.randn((e, b, d), generator=gen, device=dev) * 3
    w = torch.randn((v, d), generator=gen, device=dev) * 0.02
    ns = torch.randn((e, d), generator=gen, device=dev) * 0.1
    tie = (100, v * 5 // 8)              # in two different blocks' ranges
    hn0 = h[0, 0] * (1 + ns[0])
    j = int(hn0.abs().argmax())
    w[list(tie)] = 0.0
    w[list(tie), j] = 4.0 * torch.sign(hn0[j])
    return h.to(dtype), w.to(dtype), ns.to(dtype), tie


def run(h, w, ns, stages, per_sm, grid=None):
    e, b, d = h.shape
    return ops.launch("exit_head", h.reshape(e * b, d), w, ns, e, 1e-5,
                      stages=stages, per_sm=per_sm, grid=grid)


@torch.no_grad()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--rows", type=int, nargs="*", default=None,
                    help="only these R (rows: exits x slots)")
    ap.add_argument("--model", choices=[n for n, _, _ in SHAPES],
                    default=None, help="only this model's (V, d)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exit_head_sweep: no CUDA card")
    print(cs.nvidia_smi(), flush=True)
    for line in _build.build(["exit_head", "exit_quant"])["exit_head"] \
            .splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas", line.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    for name, v, d in SHAPES:
        if args.model not in (None, name):
            continue
        for dtype in ((torch.bfloat16, torch.float32) if args.check_only
                      else (torch.bfloat16,)):
            for e, b in ROWS:
                if args.rows and e * b not in args.rows:
                    continue
                h, w, ns, tie = inputs(e, b, v, d, dtype, dev, gen)
                want = [x.reshape(-1) for x in exit_heads_ref(h, w, ns)]
                line = []
                for stages, per_sm in CONFIGS:
                    grid = c_int(0)
                    got = run(h, w, ns, stages, per_sm, byref(grid))
                    torch.cuda.synchronize()
                    ec = cs.max_err(got[0], want[0])
                    el = cs.max_err(got[2], want[2])
                    cs.check(ec <= 1e-5 and el <= 1e-4
                             and torch.equal(got[1], want[1])
                             and int(got[1][0]) == tie[0],
                             f"{name} {dtype} R={e * b} S={stages} "
                             f"per_sm={per_sm}: conf err {ec}, lse err "
                             f"{el}, tokens {got[1][:4].tolist()} against "
                             f"{want[1][:4].tolist()}")
                    if args.check_only:
                        line.append(f"S={stages}/{per_sm}:ok({grid.value})")
                        continue
                    ms = cs.device_ms(lambda i: run(h, w, ns, stages, per_sm))
                    line.append(f"S={stages}/{per_sm}x{grid.value}:"
                                f"{ms * 1e3:.2f}")
                nbytes = (w.numel() + (e * b + e) * d) * w.element_size()
                bnd = nbytes / cs.HBM_BYTES_PER_S * 1e6
                print(f"sweep {name} {str(dtype)[6:]} R={e * b} (us, bound "
                      f"{bnd:.2f}):", *line, flush=True)
                del h, w, ns
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
