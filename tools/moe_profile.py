#!/usr/bin/env python3
"""Where a MoE decode step spends its time on the card.

    PYTHONPATH=src python3 tools/moe_profile.py [--arch olmoe-1b-7b ...]

For each model (full width, bfloat16, random weights, seed 0): one MoE
layer's decode form (``moe_forward_decode``) on B = 1 and 8 rows of
random hidden states, 20 calls under ``torch.profiler``: the experts the
rows touch and their weight bytes (over 3.35 TB/s: the layer's bound),
the device time a call (the kernels' sum), the host wall a call (ending
in a synchronisation), device operations and synchronisations a call;
then the same times the model's layers, a decode step's MoE share.  Then
``torch.profiler`` over the 8-slot batched engine (8 prompts of 128
tokens, 8 new tokens, dense KV, collm at θ = 0.5): wall, the card's busy
share, the costliest kernels and host operators.  Fails without a CUDA
card.
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

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM


def profiled(fn, calls: int):
    """(host wall ms a call, device ms a call, device ops a call, key
    averages) of ``calls`` calls of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    events = prof.key_averages()
    dev = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in dev) / calls / 1e3
    ops = sum(e.count for e in dev) / calls
    return wall, busy, ops, events


def layer_report(model, b: int, calls: int = 20) -> None:
    from repro_torch.models.moe import _route, moe_forward_decode
    cfg = model.cfg
    layer = model.layers[0].moe
    gen = torch.Generator(device=model.device).manual_seed(b)
    x = torch.randn((b, 1, cfg.d_model), generator=gen,
                    device=model.device).to(torch.bfloat16)
    _, _, top_e = _route(layer, x.reshape(b, -1), cfg.moe.top_k)
    touched = int(torch.unique(top_e).numel())
    per_expert = 3 * cfg.d_model * cfg.moe.expert_d_ff * 2
    nbytes = touched * per_expert
    wall, busy, ops, events = profiled(
        lambda: moe_forward_decode(layer, cfg, x), calls)
    syncs = sum(e.count for e in events
                if e.key in ("aten::item", "aten::_local_scalar_dense"))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{cfg.name} MoE layer B={b}: {touched} of {cfg.moe.num_experts} "
          f"experts, {nbytes / 1e9:.4f} GB of weights, bound {bound:.4f} ms;"
          f" device {busy:.4f} ms, host wall {wall:.4f} ms a call, "
          f"{ops:.1f} device ops and {syncs / calls:.1f} host reads a call;"
          f" x {cfg.n_layers} layers: bound {bound * cfg.n_layers:.3f} ms, "
          f"device {busy * cfg.n_layers:.3f} ms, wall "
          f"{wall * cfg.n_layers:.3f} ms a step")
    cpu = sorted(((e.self_cpu_time_total / calls, e.count / calls, e.key)
                  for e in events if str(e.device_type).endswith("CPU")),
                 reverse=True)[:6]
    for us, n, key in cpu:
        print(f"    host {us / 1e3:8.4f} ms a call  {n:6.1f}x  {key[:70]}")


def engine_report(model) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, 128) for _ in range(8)]
    system = ServingSystem(model, CollmConfig(theta=0.5))
    system.generate(prompts[:2], 2, num_slots=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = system.generate(prompts, 8, num_slots=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [(e.self_device_time_total, e.count, e.key) for e in events
           if str(e.device_type).endswith("CUDA")]
    busy = sum(d[0] for d in dev) / 1e6
    print(f"{model.cfg.name} engine, 8 slots x 8 new tokens ({r['stats'].tokens}"
          f" tokens): wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({busy / wall:.1%}), {sum(d[1] for d in dev)} device ops")
    for us, n, key in sorted(dev, reverse=True)[:8]:
        print(f"    device {us / 1e3:9.2f} ms {n:7d}x  {key[:70]}")
    cpu = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events
                  if str(e.device_type).endswith("CPU")), reverse=True)[:8]
    for us, n, key in cpu:
        print(f"    host   {us / 1e3:9.2f} ms {n:7d}x  {key[:70]}")


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["olmoe-1b-7b", "granite-moe-3b-a800m"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_profile: no CUDA card")
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__}")
    for arch in args.arch:
        model = build_model(get_config(arch), device="cuda",
                            dtype=torch.bfloat16, seed=0)
        for b in (1, 8):
            layer_report(model, b)
        engine_report(model)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
