#!/usr/bin/env python3
"""Where one chunked-prefill chunk of ee-llm-7b spends its time on the card.

    PYTHONPATH=src python3 tools/chunk_profile.py

Builds ee-llm-7b (bf16, random weights, seed 0) on the card and runs
page-sized prompt chunks through ``CoLLM.edge_prefill_chunk`` and
``cloud_prefill_chunk`` (the edge's 16 layers and the cloud's 24) over a
paged pool, as the batched engine's chunked prefill does for one stream.
Prints the host wall time a chunk (10 chunks after 3 to warm up, ending in
a synchronisation), a 512-token monolithic prefill of both partitions for
comparison, and, over 3 chunks under ``torch.profiler``, the device time,
the kernel launches a chunk, the costliest kernels and host operators.
Fails without a CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def chunk_fn(collm, edge, cloud, tbl, vocab, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, vocab, (1, 16), generator=gen, device=dev)

    def run(i):
        _, h1, _ = collm.edge_prefill_chunk(tokens, 16 * i, 16, edge, tbl)
        return collm.cloud_prefill_chunk(h1, 16 * i, 16, cloud, tbl)[0]
    return run


@torch.no_grad()
def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chunk_profile: no CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.collm import CoLLM, CollmConfig
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__}")
    cfg = get_config("ee-llm-7b")
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    collm = CoLLM(model, CollmConfig(kv_layout="paged", chunked_prefill=True))
    edge = collm.init_edge_cache_paged(1, 64, 16)
    cloud = collm.init_cloud_cache_paged(1, 64, 16)
    tbl = torch.arange(1, 33, dtype=torch.int32, device=dev)[None]
    run = chunk_fn(collm, edge, cloud, tbl, cfg.vocab_size, dev)
    for i in range(3):
        run(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 13):
        run(i)
    torch.cuda.synchronize()
    print(f"one 16-token chunk (edge + cloud): "
          f"{(time.perf_counter() - t0) / 10 * 1e3:.2f} ms wall")
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device=dev)
    for turn in range(2):
        row = collm.init_edge_cache(1, 512)
        crow = collm.init_cloud_cache(1, 512)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, h1, _ = collm.edge_prefill_padded(tokens, 512, row)
        collm.cloud_prefill_padded(h1, 512, crow)
        torch.cuda.synchronize()
        if turn:
            print(f"monolithic 512-token prefill (edge + cloud): "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for i in range(13, 16):
            run(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    host = [e for e in events if str(e.device_type).endswith("CPU")]
    launches = sum(e.count for e in host if e.key in ("cudaLaunchKernel",
                                                     "cuLaunchKernelEx"))
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    layers = sum(model.segments[i].length
                 for i in collm.edge_segs + collm.cloud_segs)
    print(f"under the profiler, a chunk: {busy / 3:.2f} ms device time, "
          f"{launches / 3:.0f} kernel launches ({launches / 3 / layers:.0f} "
          f"a layer of {layers})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 3e3:8.3f} ms "
              f"{e.count // 3:6d}x  {e.key[:80]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  host   {e.self_cpu_time_total / 3e3:8.3f} ms "
              f"{e.count // 3:6d}x  {e.key[:80]}")


if __name__ == "__main__":
    main()
