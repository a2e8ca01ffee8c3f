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
``--preemption recompute|swap`` admits optimistically into the paged pool
and preempts a victim stream (``--preempt-policy``) when pages run out:

    PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
        --preemption swap --num-pages 64 --clients 8 --prompt-len 200

``--speculative`` commits provisional edge tokens while cloud replies are
in flight and ships up to ``--spec-k`` of them as one verification
request:

    PYTHONPATH=src python -m repro_torch.launch.serve --speculative \
        --spec-k 4 --channel sim

``--channel sim`` prices every cloud request on a WiFi-class link in
virtual time (``--tick-time`` of edge compute a decode tick, a
``--deadline`` after which the edge token is committed); ``--cloud-batch``
serves one single-slot engine per client against one shared cloud
(``ServingSystem.generate_multi``), whose requests a ``CloudBatcher``
computes in masked waves and, with ``--channel sim``, a batching
``CloudServicePoint`` (``--service-s`` a step, ``--batch-window``) prices:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --clients 4 --channel sim --cloud-batch

Prints the run's stats and, for the collm and standalone modes, the token
agreement against the undivided model (``--mode cloud``).
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.collm import CollmConfig
from repro_torch.core.netsim import NetworkParams
from repro_torch.core.transport import AsyncSimChannel, CloudServicePoint
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
    ap.add_argument("--preemption", default="off",
                    choices=["off", "recompute", "swap"],
                    help="optimistic paged admission: preempt victim "
                         "streams on OutOfPages and resume by re-prefill "
                         "(recompute) or host page swap (swap)")
    ap.add_argument("--preempt-policy", default="youngest",
                    choices=["youngest", "fewest-pages", "lru"],
                    help="victim selection under --preemption")
    ap.add_argument("--channel", default="sync", choices=["sync", "sim"],
                    help="sim: WiFi-class async channel in virtual time")
    ap.add_argument("--deadline", type=float, default=math.inf,
                    help="per-request reply budget (virtual s); a miss "
                         "commits the edge token")
    ap.add_argument("--tick-time", type=float, default=0.01,
                    help="virtual edge compute per decode tick (sim)")
    ap.add_argument("--speculative", action="store_true",
                    help="commit provisional edge tokens while cloud "
                         "replies are in flight")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="edge draft length: ship up to k provisional "
                         "tokens per verification request (needs "
                         "--speculative; 1 = classic speculative path)")
    ap.add_argument("--cloud-batch", action="store_true",
                    help="multi-client mode: one engine per client, cloud "
                         "requests coalesced by the shared CloudBatcher")
    ap.add_argument("--batch-window", type=float, default=0.004,
                    help="cloud service accumulation window (virtual s, "
                         "--cloud-batch with --channel sim)")
    ap.add_argument("--service-s", type=float, default=0.008,
                    help="virtual cost of one cloud service step (the "
                         "shared cloud of --cloud-batch with --channel "
                         "sim)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.cloud_batch and (args.preemption != "off"
                             or args.num_pages is not None):
        # multi-client mode runs one single-slot engine per client: a lone
        # slot has no victim to preempt, and generate_multi sizes its own
        # pools
        ap.error("--preemption/--num-pages apply to the single-engine "
                 "scheduler; drop --cloud-batch to use them")
    if args.cloud_batch and args.num_slots is not None:
        ap.error("--num-slots does not apply to --cloud-batch")
    if args.kv_layout != "paged" and (args.preemption != "off"
                                      or args.num_pages is not None
                                      or args.page_size != 16):
        # dense slots own fixed rings: there is no page pool to size or
        # oversubscribe
        ap.error("--preemption/--num-pages/--page-size need --kv-layout "
                 "paged")
    if args.kv_layout != "paged" and args.kv_dtype != "float32":
        ap.error("--kv-dtype int8 needs --kv-layout paged")
    if args.spec_k != 1 and not args.speculative:
        ap.error("--spec-k needs --speculative (drafting generalizes the "
                 "speculative path)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device, dtype=DTYPES[args.dtype],
                        seed=args.seed)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      batch_size=1, seed=args.seed))
    prompts = [data.sample_tokens(args.prompt_len)
               for _ in range(args.clients)]
    system = ServingSystem(model, CollmConfig(
        theta=args.theta, wire_format=args.wire, backfill=args.backfill,
        speculative=args.speculative, spec_k=args.spec_k,
        kv_layout=args.kv_layout, page_size=args.page_size,
        kv_dtype=args.kv_dtype, preemption=args.preemption,
        preempt_policy=args.preempt_policy))
    gen_kw = dict(num_slots=args.num_slots, num_pages=args.num_pages)
    if args.cloud_batch:
        multi_kw = {}
        if args.channel == "sim":
            # a single client has nobody to coalesce with: plain FIFO
            svc = CloudServicePoint(
                args.service_s,
                batch_window_s=args.batch_window if args.clients > 1 else 0.0,
                max_batch=args.clients)
            multi_kw.update(
                channels=[AsyncSimChannel(NetworkParams(),
                                          deadline_s=args.deadline,
                                          service=svc)
                          for _ in range(args.clients)],
                tick_time_s=args.tick_time)
        r = system.generate_multi(prompts, args.max_new, mode=args.mode,
                                  cloud_batch=True, **multi_kw)
        slots = f"engines={r['n_engines']}"
    else:
        run_kw = dict(gen_kw)
        if args.channel == "sim":
            run_kw.update(channel=AsyncSimChannel(NetworkParams(),
                                                  deadline_s=args.deadline),
                          tick_time_s=args.tick_time)
        r = system.generate(prompts, args.max_new, mode=args.mode, **run_kw)
        slots = f"slots={r['num_slots']}"
    st = r["stats"]
    print(f"mode={args.mode} theta={args.theta} wire={args.wire} "
          f"backfill={args.backfill} device={model.device} "
          f"dtype={args.dtype} kv={args.kv_layout}/{args.kv_dtype} "
          f"{slots} channel={args.channel} cloud_batch={args.cloud_batch}")
    print(f"tokens={st.tokens} exits@l1={st.exits_l1} exits@l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} "
          f"request_rate={st.request_rate:.2%}")
    print(f"upload={st.upload_bytes/1e3:.1f}KB edge_t={st.edge_time:.2f}s "
          f"cloud_t={st.cloud_time:.2f}s")
    if args.preemption != "off":
        print(f"preemptions={st.preemptions} policy={args.preempt_policy} "
              f"mode={args.preemption}")
    if args.speculative and st.draft_tokens:
        print(f"draft: k={args.spec_k} draft_tokens={st.draft_tokens} "
              f"accepted={st.accepted_tokens} "
              f"accept_rate={st.accepted_tokens / st.draft_tokens:.2%} "
              f"rewinds={st.spec_rewinds}")
    if args.channel == "sim":
        print(f"virtual_t={r['virtual_time']:.3f}s "
              f"deadline_misses={st.deadline_misses} "
              f"fallbacks={st.fallbacks} stall={st.stall_s:.3f}s "
              f"overlap={st.overlap_s:.3f}s late_drops={r['late_drops']}")
    if "batcher" in r:
        print(f"cloud batcher: {r['batcher']}")
    if not args.cloud_batch:
        sched = next(iter(system._schedulers.values()))
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
