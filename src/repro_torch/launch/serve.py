"""Serving launcher of the PyTorch/CUDA port: CE-CoLLM co-inference over
synthetic prompts through the continuous-batching engine
(``ServingSystem.generate``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ee-llm-7b \\
        --mode collm --theta 0.8 --clients 8 --num-slots 4 --max-new 16 \\
        --dtype bfloat16 --kv-layout paged --kv-dtype int8

Runs on ``--device cuda`` (the default; it fails when no card is present)
or ``--device cpu``.  Weights are random, initialised from ``--seed``, or
with ``--ckpt`` read from a checkpoint in the JAX package's format
(``repro_torch.launch.train --ckpt`` writes one; so does the JAX
package's trainer), cast to ``--dtype``.
``--arch`` is one of the dense decoders: ee-llm-7b, gemma3-12b (a
1024-token sliding window in 40 of its 48 layers; prompts past 2048
tokens take the chunked prefill path), command-r-35b, qwen1.5-110b or
stablelm-12b; one of the mixture-of-experts decoders, olmoe-1b-7b or
granite-moe-3b-a800m; or the recurrent xlstm-350m (mLSTM and sLSTM
blocks) or the hybrid zamba2-1.2b (Mamba2 layers and a shared attention
block), whose admissions prefill the exact prompt and which refuse
speculative decode, chunked prefill and swap preemption, as the JAX
package does.  whisper-medium and paligemma-3b are refused: they need
frames or patches, and the engines take token prompts only, as the JAX
package's do.  ``--smoke`` cuts any of them to 2 layers at d_model 256
(and 4 experts):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --smoke --device cpu --clients 3 --kv-layout paged

gemma3-12b fits one H100 in bfloat16:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --dtype bfloat16 --prompt-len 4096 --clients 8 --num-slots 8 \
        --kv-layout paged --page-size 64
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

``--chunked-prefill`` prefills each prompt one page a tick, interleaved
with the other slots' decode; ``--prefix-share`` puts every client's
prompt behind one system prompt (2.5 pages) and maps its pages once:

    PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
        --chunked-prefill --prefix-share --clients 8

``--arrival-rate`` replays the clients as an open-loop fleet (Poisson, or
bursty gamma with ``--arrival-cv2`` > 1, optionally ``--diurnal-amp``
modulated) in virtual time, ``--slo-ttft`` / ``--slo-tpot`` set the
service objectives, and ``--adaptive`` closes the engine's control loops
over the paged pool:

    PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
        --channel sim --arrival-rate 20 --slo-ttft 0.5 --slo-tpot 0.05 \
        --preemption swap --adaptive

``--cloud-tp N`` (with ``--cloud-dp M``, default 1) serves through the
cloud mesh (``CollmConfig.cloud_mesh = (M, N)``): the launcher builds the
kernels, then starts M * N ranks (``launch.mesh.spawn``; NCCL when every
rank has a card of its own, else gloo), each holding its share of the
weights; rank 0 prints the report and a ``mesh=`` line, and every run
ends by checking that all ranks emitted the same streams:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --cloud-tp 2 --cloud-dp 2 --clients 4

Prints the run's stats and, for the collm and standalone modes, the token
agreement against the undivided model (``--mode cloud``).
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from repro_torch.configs.registry import (ARCHS, get_config,
                                          get_smoke_config)
from repro_torch.launch.mesh import make_cloud_mesh, one_at_a_time, spawn
from repro_torch.core.collm import CollmConfig
from repro_torch.core.netsim import NetworkParams
from repro_torch.core.transport import AsyncSimChannel, CloudServicePoint
from repro_torch.core.workload import ArrivalProcess, arrival_times
from repro_torch.data.synthetic import DataConfig, SyntheticCorpus
from repro_torch.models.registry import build_model
from repro_torch.serving.adaptive import AdaptiveConfig, ResumeCostModel
from repro_torch.serving.engine import ServingSystem, token_agreement
from repro_torch.training.checkpoint import load_checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MESH_TIMEOUT_S = 1800.0     # a mesh run's ranks, and each collective


def load_model(cfg, *, device=None, dtype=torch.float32, seed: int = 0,
               ckpt=None, axis=None):
    """``cfg`` on ``device`` in ``dtype``: initialised from ``seed``, then,
    with ``ckpt``, its parameters read from that checkpoint (as the JAX
    package's launcher initialises and then loads); under a cloud-mesh
    rank's model ``axis``, that rank's share."""
    model = build_model(cfg, device=device, dtype=dtype, seed=seed,
                        axis=axis)
    if ckpt:
        extra = load_checkpoint(ckpt, model, cfg)
        print(f"loaded checkpoint {ckpt} {extra}")
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ee-llm-7b", choices=sorted(ARCHS))
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
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prefill prompts one page-sized chunk per tick "
                         "interleaved with decode (needs --kv-layout "
                         "paged)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="radix prefix cache: streams sharing a prompt "
                         "prefix map the same refcounted KV pages, "
                         "copy-on-write on divergence (needs "
                         "--chunked-prefill)")
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
    ap.add_argument("--cloud-tp", type=int, default=0,
                    help="model-axis size of the cloud mesh: ranks that "
                         "split the heads, FFNs and vocabulary (0 = single "
                         "device)")
    ap.add_argument("--cloud-dp", type=int, default=1,
                    help="data-axis (batch) size of the cloud mesh "
                         "(needs --cloud-tp)")
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
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop fleet replay: mean request arrivals "
                         "per virtual second (0 = closed loop, the whole "
                         "backlog at t=0)")
    ap.add_argument("--arrival-cv2", type=float, default=1.0,
                    help="interarrival squared coefficient of variation "
                         "(1 = Poisson, >1 = bursty gamma renewals)")
    ap.add_argument("--diurnal-amp", type=float, default=0.0,
                    help="sinusoidal arrival-rate modulation depth in "
                         "[0, 1)")
    ap.add_argument("--diurnal-period", type=float, default=10.0,
                    help="diurnal modulation period (virtual s)")
    ap.add_argument("--arrival-seed", type=int, default=0)
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="per-request time-to-first-token target "
                         "(virtual s) folded into SLO attainment")
    ap.add_argument("--slo-tpot", type=float, default=None,
                    help="per-request mean inter-token latency target "
                         "(virtual s)")
    ap.add_argument("--adaptive", action="store_true",
                    help="engine-side adaptive control: watermark AIMD on "
                         "the page pool, fluid-ODE admission gate, "
                         "per-victim swap-vs-recompute (needs --kv-layout "
                         "paged)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (without .npz) to load after init")
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
    if args.chunked_prefill and args.kv_layout != "paged":
        ap.error("--chunked-prefill writes chunks through the paged "
                 "decode path; needs --kv-layout paged")
    if args.prefix_share and not args.chunked_prefill:
        ap.error("--prefix-share admits the unshared suffix through "
                 "chunked prefill; needs --chunked-prefill")
    arch_cfg = ARCHS[args.arch]
    if arch_cfg.is_encdec or arch_cfg.vision_tokens:
        # the JAX package's engines prefill {"tokens": ...} alone, so its
        # CLI fails later, on a KeyError for the frames or patches
        ap.error(f"--arch {args.arch} needs "
                 f"{'frames' if arch_cfg.is_encdec else 'patches'} beside "
                 f"its tokens, and the serving engines take token prompts "
                 f"only, as the JAX package's do; drive it through "
                 f"Model.prefill and CoLLM (chip_smoke.py phase 12)")
    if args.arrival_rate < 0:
        ap.error("--arrival-rate must be >= 0")
    if args.arrival_rate == 0 and (args.arrival_cv2 != 1.0
                                   or args.diurnal_amp != 0.0):
        ap.error("--arrival-cv2/--diurnal-amp shape the arrival process; "
                 "need --arrival-rate > 0")
    if ((args.arrival_rate > 0 or args.slo_ttft is not None
         or args.slo_tpot is not None) and args.channel != "sim"):
        ap.error("--arrival-rate/--slo-* replay in virtual time; need "
                 "--channel sim")
    if args.adaptive and args.kv_layout != "paged":
        ap.error("--adaptive tunes the paged pool's watermark and "
                 "admission; needs --kv-layout paged")
    if args.adaptive and args.cloud_batch:
        ap.error("--adaptive drives the single-engine scheduler; drop "
                 "--cloud-batch to use it")
    if args.cloud_dp != 1 and not args.cloud_tp:
        ap.error("--cloud-dp sizes the data axis of the cloud mesh; "
                 "needs --cloud-tp")
    if args.cloud_tp < 0 or args.cloud_dp < 1:
        ap.error("--cloud-tp / --cloud-dp must be positive")
    if not args.cloud_tp:
        return serve(args)
    world = args.cloud_dp * args.cloud_tp
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build()          # once, before the ranks start
    threads = (max(1, (os.cpu_count() or 1) // world)
               if args.device == "cpu" else None)
    return spawn(_serve_rank, world, device=args.device,
                 timeout=MESH_TIMEOUT_S, args=(args,), threads=threads)[0]


def _serve_rank(rank: int, world: int, args):
    mesh = make_cloud_mesh((args.cloud_dp, args.cloud_tp),
                           device="cpu" if args.device == "cpu" else None)
    r = serve(args, mesh)
    return r if rank == 0 else None


def serve(args, mesh=None):
    """One run of the parsed ``args``; under a cloud ``mesh``, this rank's
    (rank 0 prints)."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    cloud_mesh = None if mesh is None else mesh.dims
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    def build():
        return load_model(cfg,
                          device=args.device if mesh is None else mesh.device,
                          dtype=DTYPES[args.dtype], seed=args.seed,
                          ckpt=args.ckpt,
                          axis=None if mesh is None else mesh.model_axis)
    model = build() if mesh is None else one_at_a_time(mesh, build)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      batch_size=1, seed=args.seed))
    prompts = [data.sample_tokens(args.prompt_len)
               for _ in range(args.clients)]
    if args.prefix_share:
        # the workload the flag exists for: every client opens with the
        # same system prompt (2.5 KV pages of it, so full pages can be
        # shared and the partial tail exercises copy-on-write), then its
        # own request
        system_prefix = data.sample_tokens(2 * args.page_size
                                           + args.page_size // 2)
        prompts = [np.concatenate([system_prefix, p]).astype(p.dtype)
                   for p in prompts]
    fleet_kw = {}
    if args.arrival_rate > 0:
        proc = ArrivalProcess(
            rate=args.arrival_rate,
            kind="poisson" if args.arrival_cv2 == 1.0 else "gamma",
            cv2=args.arrival_cv2, diurnal_amp=args.diurnal_amp,
            diurnal_period_s=args.diurnal_period)
        fleet_kw["arrivals"] = arrival_times(proc, len(prompts),
                                             seed=args.arrival_seed)
    if args.slo_ttft is not None:
        fleet_kw["slo_ttft_s"] = args.slo_ttft
    if args.slo_tpot is not None:
        fleet_kw["slo_tpot_s"] = args.slo_tpot
    system = ServingSystem(model, CollmConfig(
        theta=args.theta, wire_format=args.wire, backfill=args.backfill,
        speculative=args.speculative, spec_k=args.spec_k,
        kv_layout=args.kv_layout, page_size=args.page_size,
        kv_dtype=args.kv_dtype, preemption=args.preemption,
        preempt_policy=args.preempt_policy,
        chunked_prefill=args.chunked_prefill,
        prefix_share=args.prefix_share, cloud_mesh=cloud_mesh))
    gen_kw = dict(num_slots=args.num_slots, num_pages=args.num_pages)
    if args.cloud_batch:
        multi_kw = dict(fleet_kw)
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
        run_kw = dict(gen_kw, **fleet_kw)
        if args.channel == "sim":
            run_kw.update(channel=AsyncSimChannel(NetworkParams(),
                                                  deadline_s=args.deadline),
                          tick_time_s=args.tick_time)
        if args.adaptive:
            # per-victim swap-or-recompute needs the cost model; the
            # watermark loop and the admission gate hang off the config
            run_kw.update(adaptive=AdaptiveConfig(),
                          resume_cost=ResumeCostModel())
        r = system.generate(prompts, args.max_new, mode=args.mode, **run_kw)
        slots = f"slots={r['num_slots']}"
    st = r["stats"]
    if mesh is not None:
        say(mesh.describe())
    say(f"mode={args.mode} theta={args.theta} wire={args.wire} "
          f"backfill={args.backfill} device={model.device} "
          f"dtype={args.dtype} kv={args.kv_layout}/{args.kv_dtype} "
          f"{slots} channel={args.channel} cloud_batch={args.cloud_batch}")
    say(f"tokens={st.tokens} exits@l1={st.exits_l1} exits@l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} "
          f"request_rate={st.request_rate:.2%}")
    say(f"upload={st.upload_bytes/1e3:.1f}KB edge_t={st.edge_time:.2f}s "
          f"cloud_t={st.cloud_time:.2f}s")
    if args.preemption != "off":
        say(f"preemptions={st.preemptions} policy={args.preempt_policy} "
              f"mode={args.preemption}")
    if args.chunked_prefill:
        say(f"prefill_chunks={st.prefill_chunks} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"cow_copies={st.cow_copies}")
    if args.speculative and st.draft_tokens:
        say(f"draft: k={args.spec_k} draft_tokens={st.draft_tokens} "
              f"accepted={st.accepted_tokens} "
              f"accept_rate={st.accepted_tokens / st.draft_tokens:.2%} "
              f"rewinds={st.spec_rewinds}")
    if args.channel == "sim":
        say(f"virtual_t={r['virtual_time']:.3f}s "
              f"deadline_misses={st.deadline_misses} "
              f"fallbacks={st.fallbacks} stall={st.stall_s:.3f}s "
              f"overlap={st.overlap_s:.3f}s late_drops={r['late_drops']}")
    if fleet_kw:
        say(f"fleet: ttft_p50={st.ttft_p(50) * 1e3:.1f}ms "
              f"ttft_p99={st.ttft_p(99) * 1e3:.1f}ms "
              f"tpot_p50={st.token_lat_p(50) * 1e3:.1f}ms "
              f"tpot_p99={st.token_lat_p(99) * 1e3:.1f}ms "
              f"slo={st.slo_attainment:.2%} ({st.slo_met}/{st.slo_total}) "
              f"preempt_rate={st.preemption_rate:.3f} "
              f"miss_rate={st.deadline_miss_rate:.3f}")
    if args.adaptive and r.get("adaptive") is not None:
        say(f"adaptive: {r['adaptive']}")
    if "batcher" in r:
        say(f"cloud batcher: {r['batcher']}")
    if not args.cloud_batch:
        sched = next(iter(system._schedulers.values()))
        say(f"kv_cache_bytes={sched.kv_cache_bytes()} "
              f"pool={r['pool_stats']}")
    if args.mode != "cloud":
        base_sys = system
        if args.chunked_prefill:
            # chunked prefill is edge-resident; the cloud baseline runs on
            # a plain config (same weights, same greedy streams)
            base_sys = ServingSystem(model, CollmConfig(
                theta=args.theta, wire_format=args.wire,
                kv_layout=args.kv_layout, page_size=args.page_size,
                kv_dtype=args.kv_dtype, preemption=args.preemption,
                preempt_policy=args.preempt_policy, cloud_mesh=cloud_mesh))
        base = base_sys.generate(prompts, args.max_new, mode="cloud",
                                 **gen_kw)
        ags = [token_agreement(a, b)
               for a, b in zip(r["tokens"], base["tokens"])]
        say(f"agreement vs cloud (LCS-F1): "
              f"{[round(float(a), 3) for a in ags]}")
    say("content manager:", r["cm_stats"])
    return r


if __name__ == "__main__":
    main()
