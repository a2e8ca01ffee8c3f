"""Serving launcher of the PyTorch/CUDA port: CE-CoLLM co-inference over
synthetic prompts through the continuous-batching engine
(``ServingSystem.generate``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ee-llm-7b \\
        --mode collm --theta 0.8 --clients 8 --num-slots 4 --max-new 16 \\
        --dtype bfloat16 --kv-layout paged --kv-dtype int8

Runs on ``--device cuda`` (the default; it fails when no card is present)
or ``--device cpu``.  Weights are random, initialised from ``--seed``.
``--kv-layout paged`` shares a block-paged KV pool across the slots
(``--page-size`` tokens a page, ``--num-pages`` pages; the default pool
equals the dense rings); ``--kv-dtype int8`` stores the pages quantized.
Prints the run's stats and, for the collm and standalone modes, the token
agreement against the undivided model (``--mode cloud``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.collm import CollmConfig
from repro_torch.data.synthetic import DataConfig, SyntheticCorpus
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ServingSystem, token_agreement

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ee-llm-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="collm",
                    choices=["collm", "standalone", "cloud"])
    ap.add_argument("--theta", type=float, default=0.8)
    ap.add_argument("--wire", default="float16",
                    choices=["float32", "float16", "int8"])
    ap.add_argument("--backfill", action="store_true")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--num-slots", type=int, default=None,
                    help="streams decoded together (default: min(clients, "
                         "8)); more clients than slots refill freed slots")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"],
                    help="paged: block-paged KV pool shared across slots")
    ap.add_argument("--kv-dtype", default="float32",
                    choices=["float32", "int8"],
                    help="int8: quantized KV pages with per-row absmax "
                         "scales (needs --kv-layout paged); float32 keeps "
                         "the model's dtype")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size; a smaller pool delays "
                         "admissions until pages free up")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.kv_layout != "paged" and (args.num_pages is not None
                                      or args.page_size != 16):
        # dense slots own fixed rings: there is no page pool to size
        ap.error("--num-pages/--page-size need --kv-layout paged")
    if args.kv_layout != "paged" and args.kv_dtype != "float32":
        ap.error("--kv-dtype int8 needs --kv-layout paged")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device, dtype=DTYPES[args.dtype],
                        seed=args.seed)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      batch_size=1, seed=args.seed))
    prompts = [data.sample_tokens(args.prompt_len)
               for _ in range(args.clients)]
    system = ServingSystem(model, CollmConfig(
        theta=args.theta, wire_format=args.wire, backfill=args.backfill,
        kv_layout=args.kv_layout, page_size=args.page_size,
        kv_dtype=args.kv_dtype))
    gen_kw = dict(num_slots=args.num_slots, num_pages=args.num_pages)
    r = system.generate(prompts, args.max_new, mode=args.mode, **gen_kw)
    st = r["stats"]
    sched = next(iter(system._schedulers.values()))
    print(f"mode={args.mode} theta={args.theta} wire={args.wire} "
          f"backfill={args.backfill} device={model.device} "
          f"dtype={args.dtype} kv={args.kv_layout}/{args.kv_dtype} "
          f"slots={r['num_slots']}")
    print(f"tokens={st.tokens} exits@l1={st.exits_l1} exits@l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} "
          f"request_rate={st.request_rate:.2%}")
    print(f"upload={st.upload_bytes/1e3:.1f}KB edge_t={st.edge_time:.2f}s "
          f"cloud_t={st.cloud_time:.2f}s")
    print(f"kv_cache_bytes={sched.kv_cache_bytes()} "
          f"pool={r['pool_stats']}")
    if args.mode != "cloud":
        base = system.generate(prompts, args.max_new, mode="cloud", **gen_kw)
        ags = [token_agreement(a, b)
               for a, b in zip(r["tokens"], base["tokens"])]
        print(f"agreement vs cloud (LCS-F1): "
              f"{[round(float(a), 3) for a in ags]}")
    print("content manager:", r["cm_stats"])
    return r


if __name__ == "__main__":
    main()
