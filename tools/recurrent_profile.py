#!/usr/bin/env python3
"""Where a decode step of the recurrent and hybrid decoders spends its time
on the card.

    python3 tools/recurrent_profile.py

For xlstm-350m and zamba2-1.2b (full width, bfloat16, random weights from
``chip_smoke``'s seed): one collaborative decode step of 8 slots (the
edge step and the cloud step of every row) over dense caches whose rings
hold 1024 valid keys, timed without the profiler (host wall, and the span
between its first and last device events) and then under
``torch.profiler``: the device time of its kernels and their busy share
of the unprofiled wall, that time split into the recurrent layers,
Zamba2's shared attention block and the exits, and the costliest
kernels.  This is ``chip_smoke.py --profile``'s phase 11 window alone;
the kernels are built first.  Fails without a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@torch.no_grad()
def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("recurrent_profile: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {chip_smoke.nvidia_smi()}")
    chip_smoke.build_kernels()
    for arch in (chip_smoke.XLSTM, chip_smoke.ZAMBA2):
        model = chip_smoke.build_full(arch, dev)
        chip_smoke.profile_decode_split(model)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
