#!/usr/bin/env python3
"""Do gemma3-12b's paged, int8-paged and chunked streams agree with its
dense ones once bfloat16 rounding is out of the way?

    PYTHONPATH=src python3 tools/gemma_f32_agreement.py [--slots 2]
        [--lens 640 1536] [--max-new 32]

Builds gemma3-12b at full width (48 layers, d_model 3840, a 1024-token
window in 40 layers, V = 262144) in float32 (about 49 GB of weights,
random, seed 0) on the card and serves the same prompts through
``ServingSystem.generate`` at the split θ of a θ = 1 run (collm, float16
wire, 128-token pages) on dense KV, paged float32 KV, paged int8 KV and
paged KV with chunked prefill; then frees it and does the same in
bfloat16 (about 24 GB).  Prints, for each dtype, how many streams equal
the dense run's (and chunked against monolithic paged), their LCS-F1,
exits and cloud requests.  Where float32 agrees and bfloat16 does not,
the bfloat16 gap is rounding of random weights; a float32 gap is a fault.
Fails without a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PAGE = 128


def lcs_f1(a, b) -> float:
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), np.int32)
    for i in range(n):
        for j in range(m):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if a[i] == b[j]
                                else max(dp[i, j + 1], dp[i + 1, j]))
    return 2.0 * dp[n, m] / max(n + m, 1)


def agreement(a, b) -> str:
    same = sum(x == y for x, y in zip(a, b))
    f1 = np.mean([lcs_f1(x, y) for x, y in zip(a, b)])
    return f"{same}/{len(a)} streams equal, LCS-F1 {f1:.4f}"


def run_dtype(dtype, prompts, slots, max_new, dev) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.core.collm import CollmConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingSystem
    t0 = time.perf_counter()
    model = build_model(get_config("gemma3-12b"), device=dev, dtype=dtype,
                        seed=0)
    torch.cuda.synchronize()
    print(f"gemma3-12b in {dtype}: "
          f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f}"
          f" GB, initialised in {time.perf_counter() - t0:.1f} s")
    full = ServingSystem(model, CollmConfig(theta=1.0)).generate(
        prompts, max_new, num_slots=slots)
    c = sorted(l1 for l1, _ in full["stats"].confidences)
    theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
    runs = {}
    for name, kw in (("dense", dict(kv_layout="dense")),
                     ("paged", dict(kv_layout="paged")),
                     ("paged-int8", dict(kv_layout="paged", kv_dtype="int8")),
                     ("chunked", dict(kv_layout="paged",
                                      chunked_prefill=True))):
        t0 = time.perf_counter()
        r = ServingSystem(model, CollmConfig(
            theta=theta, wire_format="float16", page_size=PAGE, **kw)
        ).generate(prompts, max_new, num_slots=slots)
        torch.cuda.synchronize()
        st = r["stats"]
        print(f"  {str(dtype)[6:]} {name:10s} theta={theta:.6g} "
              f"wall={time.perf_counter() - t0:.2f}s exits={st.exits_l1}/"
              f"{st.exits_l2} cloud_requests={st.cloud_requests}")
        runs[name] = r["tokens"]
    for name in ("paged", "paged-int8"):
        print(f"  {str(dtype)[6:]} {name} vs dense: "
              f"{agreement(runs[name], runs['dense'])}")
    print(f"  {str(dtype)[6:]} chunked vs monolithic paged: "
          f"{agreement(runs['chunked'], runs['paged'])}")
    del model
    torch.cuda.empty_cache()
    return runs


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--lens", type=int, nargs="+", default=[640, 1536])
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemma_f32_agreement: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__}")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 262144, n) for n in args.lens]
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        run_dtype(dtype, prompts, args.slots, args.max_new, dev)


if __name__ == "__main__":
    main()
