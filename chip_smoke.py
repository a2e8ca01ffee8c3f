#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; a failure in any of them ends the run with a non-zero
exit code and no result line:

1. the card's name and power limit (``nvidia-smi``), then the build of every
   hand-written kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) with ptxas' registers, shared memory and spills;
2. each kernel against its plain PyTorch version on CUDA tensors at the
   shapes of the ee-llm-7b decode path (the ring decode attention at B=1
   and B=8, the paged one at 8 slots, at B=1 and as a 16-token prefill
   chunk, float32, bfloat16 and int8 pages; the wire quantizer at 1 and 8 rows; the int8 page writes, a
   decode step at 8 slots and at B=1, a 16-token prefill chunk and a
   512-token prefill scatter, every pool byte, beside the torch sequence
   the write kernels replaced; ``exit_heads``, both exits in one launch,
   at B = 1 and 8 slots with the int8 packet, ties across two blocks' V
   ranges and inside one), with its
   device time (CUDA
   events), the plain version's, one PyTorch library call's where one
   computes the same function, and the bound (bytes over 3.35 TB/s or
   operations over the peak rate of the type they run in, whichever is
   larger);
   the same checks and times at gemma3-12b's shapes as phase 8 runs them
   (H = 16 over KV = 8 heads of d = 256, 128-token pages and prefill
   chunks: the ring kernel over a 4136-slot ring and over a wrapped
   1024-slot window ring, both paged variants at 8 slots of 512-4096 keys
   with and without the 1024-token window, the int8 page writes with a
   4096-token scatter, the wire quantizer at d = 3840, the three exit
   kernels over the 262144 x 3840 unembedding); the same at the shapes of
   phases 9 and 10 and of the main path's tiny-ee: stablelm-12b's d = 160,
   G = 4 (both attention kernels, float and int8 pages, the int8 page
   writes with a 2048-token scatter), granite-moe-3b-a800m's G = 3 (both
   attention kernels) and its 49155 x 1536 unembedding, olmoe-1b-7b's
   50304 x 2048 one (``exit_heads`` and ``exit_quant``, and
   ``exit_quant`` at B = 24 and 40: two and three launches), and the
   paged kernel at tiny-ee's d = 32, G = 2; and at phase 11's: zamba2's
   shared attention block (H = KV = 32 of d = 64, G = 1: both attention
   kernels, float and int8 pages of 128 tokens, the int8 page writes) and
   its 32000 x 2048 unembedding, and xlstm's tied 50304 x 1024 one
   (``exit_heads`` at R = 2 and 16, ``exit_quant``); and at phase 12's:
   whisper-medium's self-attention ring (H = KV = 16 of d = 64) and its
   cross-attention over 1500 encoder keys, its untied 51865 x 1024
   unembedding and d = 1024 wire, paligemma-3b's ring at d = 256, G = 8
   (H = 8 over KV = 1), both paged variants there, its tied 257216 x 2048
   unembedding and d = 2048 wire; and at the shapes a rank of phase 14
   gives them (``check_mesh_kernel_shapes``: ee-llm-7b, command-r-35b,
   tiny-ee-tp; paligemma-3b's ring at G = 4, zamba2's shared block at 16
   of 32 heads, whisper's self- and cross-attention at 8 of 16 heads, the
   exit heads over xlstm's, zamba2's and paligemma's vocabulary halves);
   every exit kernel's max logit is held to its plain version's; a
   bfloat16 attention
   output is held to two bf16 ulps of its largest value, float32 to 2e-5;
   then a small model served on the card and on the CPU must give the same
   streams, sequentially and batched on dense, paged and int8-paged KV,
   under deadline misses with the standalone fallback, as N engines
   behind one batched cloud (equal to N engines with a cloud each), with
   speculative drafts of 1 and 4 tokens (dense and paged, and under
   deadline misses), under recompute and swap preemption (float32 and int8
   pages), with drafts in flight across preemptions behind the batched
   cloud, and through chunked prefill with prefix sharing (float32 and
   int8 pages, a second wave, swap preemption with cache eviction, behind
   the batched cloud), open-loop arrivals with SLOs and adaptive control;
   tiny-ee on paged float32 and int8 pages; a reduced gemma3 (8 layers, a
   32-token window) through ``generate_sequential``, ``generate`` on
   dense, paged and int8 pages, chunked prefill and the two-tier runtime
   on two CUDA streams; and reduced olmoe and granite (4 experts top-2,
   granite with 6 heads over 2) through ``generate_sequential`` and
   ``generate`` on dense, paged and int8 pages and chunked prefill; and
   reduced xlstm (4 layers, layer 3 an sLSTM) and zamba2 (4 layers, the
   shared block at layers 2 and 4) through ``generate_sequential`` in
   three modes and ``generate`` on dense KV, zamba2 also on paged and int8
   pages, under recompute preemption and behind one ``CloudBatcher``;
   and reduced whisper (4 decoder layers, 2 encoder layers over 64
   frames) and paligemma (16 patches, 4 heads over 1) through phase 12's
   calls at one row and three, in five modes;
3. ee-llm-7b at full width (18 of its 32 layers: ``DEPTH``; bfloat16,
   random weights from a seed)
   through ``ServingSystem.generate_sequential`` in five modes, plus
   ``CoLLM.fused_exit_upload`` on a real l_ee1 hidden, with every kernel's
   launch counter set to 0 before and read after; every serving run prints
   its exit-kernel launches per edge tick (one ``exit_heads`` launch for
   both exits of a tick, and the int8 wire packet with it);
4. the same model through the batched engine, ``ServingSystem.generate``
   with 8 slots and 12 prompts of 128-512 tokens, on dense and paged KV
   (bfloat16 and int8 pages) in the collm, cloud and standalone modes, with
   the launch counters set to 0 before and read after;
5. the paper's adaptive serving on the same model and prompts, paged
   bfloat16 KV, collm at phase 3's split θ, float16 wire, with the launch
   counters set to 0 before and read after: (a) an ``AsyncSimChannel``
   with an infinite deadline (phase 4's paged streams), (b) the same
   blocking (``overlap=False``), (c) a ``ScriptedChannel`` whose replies
   miss their deadline, with ``fallback_after=2``, (d) temperature / top-k
   sampling twice from one seed, (e) ``generate_multi``: 8 single-slot
   engines behind one ``CloudBatcher`` against 8 engines each with its own
   cloud, both over ``AsyncSimChannel``s sharing a batching or a FIFO
   ``CloudServicePoint`` (the paper's knee), and (f) the batched cloud on
   dense KV with an int8 wire;
6. speculative drafting and preemption on the same model and prompts, with
   the launch counters set to 0 before and read after: (a) drafts of 1
   token and (b) of 4 on paged bf16 KV over phase 5 (a)'s channel, (c)
   drafts of 4 on dense KV with an int8 wire, (d) drafts of 4 whose
   replies all miss a 20 ms deadline, (e) recompute preemption on int8
   pages and (f) swap preemption on bf16 pages, both in a pool of 140
   pages with a watermark of 4 and two forced preemptions, (g)
   ``generate_multi``: 4 single-slot engines drafting 4 tokens with swap
   preemption behind one ``CloudBatcher``, two of them preempted by
   schedule; streams are compared with phase 4's paged run and phase 5
   (a), and reported, not asserted;
7. chunked prefill, prefix sharing and fleet replay on the same model
   with the launch counters set to 0 before and read after: 12 prompts
   behind one 240-token system prompt plus copies of two of them, 8 slots,
   paged KV: (a) chunked prefill on bf16 pages (against the monolithic
   run), (b) with prefix sharing (must equal (a)), (c) and (d) the same
   on int8 pages (each chunk's int8 write one ``quantize_kv_write`` launch
   a layer), (e) a second wave of three prompts (terminal hits only), (f)
   sharing with swap preemption and cache eviction in a small pool, (g) 4
   engines sharing behind one ``CloudBatcher``, (h) Poisson arrivals at 20
   a second with SLO targets on phase 5 (a)'s channel and (i) the same
   with adaptive control;
8. gemma3-12b at full width (30 of its 48 layers, d_model 3840, a
   1024-token window in 25 of them, bfloat16, random weights), with the
   launch counters set to 0 before and read after: (a)
   ``generate_sequential`` with two 4096-token prompts in five modes
   (chunked prefill attention in the global layers, banded in the local
   ones), (b) one 32768-token prompt (its prefill time and peak memory),
   (c) ``generate`` with 8 slots and 8 prompts of 512-4096 tokens on
   dense, paged bf16 and paged int8 KV, (d) (c)'s paged run with chunked
   prefill, (e) ``TwoTierRuntime`` with a 4096-token prompt on two CUDA
   streams (θ = 1.1 with a float32 wire equals ``CoLLM.full_step``'s
   greedy stream; float16 and int8 wire, the prompt upload whole or in
   slices; the edge tick's host time against a synchronised cloud);
9. olmoe-1b-7b (10 of 16 layers, d_model 2048, 64 experts top-8) and
   then granite-moe-3b-a800m (18 of 32 layers, d_model 1536, 24 heads
   over 8, 40 experts top-8, tied) at full width (bfloat16, random
   weights, float32 routers; each model freed before the next), with
   the launch counters set to 0 before and read after: (a)
   ``generate_sequential`` with two 512-token prompts in five modes
   (collm θ = 1 float32 equals cloud), (b) ``generate`` with 8 slots and
   8 prompts of 256-2048 tokens on dense, paged bf16 and paged int8 KV
   (128-token pages), (c) (b)'s paged run with chunked prefill;
10. stablelm-12b at full width (22 of 40 layers, d_model 5120, 32 heads over 8
   of d = 160, bfloat16): ``generate`` with 8 slots and 8 prompts of
   512-2048 tokens, 16 new tokens, on dense, paged bf16 and paged int8
   KV, with the launch counters set to 0 before and read after;
11. xlstm-350m (18 of 24 layers, d_model 1024: 15 mLSTM and 3 sLSTM
   blocks, tied 50304-token vocabulary) and then zamba2-1.2b (24 of 38
   layers, d_model 2048: 20 Mamba2 layers and one shared attention block
   applied 4 times)
   at full width (bfloat16, random weights; each model freed before the
   next), with the launch counters set to 0 before and read after: (a)
   ``generate_sequential`` with two 512-token prompts in five modes
   (collm θ = 1 float32 equals cloud) and ``fused_exit_upload``, (b)
   ``generate`` with 8 slots and 12 prompts of 131-1019 tokens (none a
   multiple of the GLA chunk) on dense KV, and for zamba2 paged bf16 and
   paged int8 KV; each run's prefill wall and the cache bytes split into
   KV and recurrent state; each model must launch the kernels its path
   runs (xlstm: the exit kernels and the wire quantizer, no attention);
12. whisper-medium (24 encoder and 24 decoder layers, d_model 1024, 16
   heads of d = 64, layer norms, absolute positions, untied V = 51865)
   and then paligemma-3b (18 layers, d_model 2048, 8 heads over 1 of d =
   256, tied V = 257216) at full width (bfloat16, random weights; each
   model freed before the next), with the launch counters set to 0
   before and read after; the engines take token prompts only, so
   ``prefixed_stream`` composes ``Model.prefill``, ``Model.encode`` and
   ``CoLLM``'s prefills and steps itself: (a) and (c) one row of 64
   tokens with 1500 frames (whisper) or 256 tokens after 256 patches
   (paligemma), 64 new tokens, in five modes (collm θ = 1 float32 equals
   cloud: for paligemma only if the cloud prefill keeps the prefix-LM
   mask), (b) and (d) 8 rows: cloud, collm θ = 1 float32 (equal to
   cloud) and a split θ; each run prints tokens/s, exits, cloud requests,
   upload and ``enc_out`` bytes, the encoder's device time, peak memory
   and the launches of the ring kernel (self and cross), ``exit_heads``
   and the wire quantizer;
13. training and checkpoints, with the launch counters set to 0 before
   and read after: (a) tiny-ee in float32, 80 steps of the markov corpus
   (batch 8 x 64, AdamW lr 1e-3, warmup 10 of 300: ``tests/conftest.py``'s
   ``tiny_trained``) on the card and on the CPU from the same weights:
   step 1's loss and gradient norm within 1e-5, the last losses within
   1e-2, and on the card the last loss below 0.85 x the first; (b) one
   train step of each of the JAX package's ten reduced families (MoE,
   GLA / xLSTM, Mamba2, the encoder and the prefix-LM mask backward on
   CUDA) on the card and on the CPU: every loss and the gradient norm
   within 1e-4; (c) ee-llm-7b at full width (``DEPTH``'s 18 layers) in
   float32 with float32 AdamW state, 6 steps of one 2 x 512 batch of copy
   sequences: the loss falls; seconds a step, training tokens/s and peak
   memory beside the card's name and power limit; (d) (c)'s parameters
   written with ``save_checkpoint`` (the JAX package's format) and read
   into a fresh model through ``launch/serve.py``'s ``--ckpt`` loader:
   every tensor equal, and the same greedy streams of 2 clients at θ = 1
   on a float16 wire and θ = 0 on an int8 wire, then the loaded model
   through the batched engine on paged int8 KV with an int8 wire (the
   paged int8 attention and page-write kernels); (e) ``python -m
   repro_torch.launch.train --smoke --ckpt`` and then ``python -m
   repro_torch.launch.serve --smoke --ckpt`` on paged int8 KV with an
   int8 wire, as subprocesses: both exit 0 and the server prints its
   agreement line;
14. the cloud mesh (``CollmConfig.cloud_mesh``): ranks started by
   ``repro_torch.launch.mesh.spawn``, sharing the card over gloo (NCCL
   when every rank has a card of its own), each holding its share of the
   weights, with every rank's launch counters set to 0 before and read
   after: (a) tiny-ee-tp (4 heads over 2) in float32 over meshes (1, 2),
   (1, 4) and (2, 2): ``generate_multi`` on dense, paged and int8 pages
   and with 4-token drafts, ``generate`` with prefix sharing and with a
   recompute preemption, at a split θ: every rank's streams equal the
   single-device card's and the CPU's, and every rank launches the ring,
   both paged kernels, the int8 page writes and ``exit_heads``; (b)
   ee-llm-7b at full width and depth (32 layers, bf16) over (1, 2): two
   clients of 512 tokens, 32 new, split θ, dense and paged int8 KV
   (agreement with the single device reported), θ = 1 in float32 (8 new
   tokens) equal to the single device, tokens/s, each rank's parameter
   bytes equal to ``estimate_param_bytes_per_device``; (c) command-r-35b
   at full width and depth (40 layers, bf16) over (1, 2), after a
   single-device run of the same weights in a process of its own: two
   clients of 256 tokens, 16 new, cloud and collm at a split θ, dense and
   paged KV: agreement, tokens/s, peak memory a rank, each collective's
   calls and host time a token; (a) also holds reduced xlstm-350m,
   zamba2-1.2b, whisper-medium and paligemma-3b in float32 over (1, 2)
   and (2, 2) in four paths (cloud, collm at a split θ on a float16 and an
   int8 wire, standalone) to the single-device card and the CPU, and (d)
   serves the four at full width and depth in bf16 over (1, 2): 2 rows of
   64 tokens (whisper after its 1500 frames, paligemma after its 256
   patches), 8 new tokens, cloud and collm at a split θ on an int8 wire:
   each rank's parameter bytes equal to the rules' estimate with the
   port's departures (``sharding.rank_param_bytes``), its teacher-forced
   logits and exit tokens held to the single device's in float32 (and
   its bf16 logits to the single device's own bf16 error), tokens/s and
   each collective's calls and host time a token.  (a) runs beside phase 13,
   (b), (c) and (d) alone after it;
15. the tiers on two devices (``TwoTierRuntime`` with the edge tier on
   the host CPU and the cloud tier on the card, each a partition model of
   its own, with the launch counters set to 0 before each run and read
   after): (a) a reduced ee-llm-7b (4 layers, exits 1 and 2, float32):
   θ = 1.1 on a float32 wire equals ``CoLLM.full_step``'s greedy stream,
   and at a split θ on a float16 and an int8 wire, the prompt uploaded
   whole and in slices, the streams and channel rows equal both tiers'
   on the CPU; (b) ee-llm-7b at full width and depth, the edge (layers
   1-16, the exits, float32) on the CPU, the cloud (layers 9-32 and the
   head, bf16) on the card, one client of 256 tokens and 16 new: θ = 1.1
   on a float32 wire, the split θ on a float16 wire and on an int8 wire
   with the upload in 64-token slices, and θ = 0 (every token exits on
   the edge): tokens/s, edge tick and cloud round trip, exits and
   requests, wire and downlink bytes, the card's ring launches and the
   CPU edge's none, each tier's memory and parameter bytes against
   ``lower_tiers``', and agreement with both tiers on the card; (c)
   ``python -m repro_torch.launch.dryrun_collm`` with no card visible,
   for ee-llm-7b at 128 x 32768 on every wire and qwen1.5-110b with the
   cloud over a model axis of 4.  It runs alone, after phase 14;
16. the kernel table as one JSON line (launches: phases 3 to 15; each
   kernel's other shapes under "shapes", phase 14's per-rank ones among
   them), the ``nvidia-smi`` line, and the status line ``{"ok": true,
   "device": {...}}``.

Phases 1 and 2's kernel rows run alone on the card.  Then the serving
phases run in four processes at once, each group's phases in turn: 3-6
here; 7 (started with phase 3's split θ); 8, 10 and 9; phase 2's small
models, 11 and 12 (``GROUPS``).  Phase 13 needs most of the card and
runs in a fifth process once the other four have ended, with phase 14
(a) beside it; phase 14 (b) and (c) follow alone, then phase 15, whose
CPU edge loads the host's cores.  Each process counts its own launches
and the script adds them up; the groups' output follows phase 6's.

``--profile`` adds ``torch.profiler`` windows over a few collaborative
decode ticks of the sequential loop and of the batched engine on bf16 and
int8 pages (device time by kernel, the card's busy share, the host's
costliest operators), repeats phase 4's two paged runs in turns, and
profiles one 8-slot decode step of each phase 11 model (device time of
the recurrent layers, the shared attention block and the exits); every
phase then runs in this one process, one after the other.  Without a
CUDA card, or run from a directory without the repository, the script
fails before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline import hw  # noqa: E402  (the card's constants)

SEED = 0
CLIENTS, PROMPT_LEN, MAX_NEW = 2, 512, 32
SLOTS, BATCH_PROMPTS, PAGE_SIZE = 8, 12, 16     # phase 4
ENGINES = 8                                     # phase 5 (e), (f)
SPEC_ENGINES, SPEC_K = 4, 4                     # phase 6
PREEMPT_PAGES, WATERMARK = 140, 4               # phase 6 (e), (f)
PREEMPT_SCHEDULE = [(4, 0), (12, 1)]            # (tick, slot)
SHARED_PROMPTS, SHARED_PREFIX = 12, 240         # phase 7: 15 full pages
OWN_TOKENS = (16, 200)                          # phase 7: each prompt's own
SHARED_MAX_SEQ = 512                            # phase 7: one scheduler
SHARED_ENGINES, SWAP_PAGES = 4, 110             # phase 7 (g), (f)
KNEE_NET = dict(up_bw=3.8e6, down_bw=8e6, rtt=0.003)  # a WiFi-class link
FILLS = (128, 552)                      # phase 2 paged fills, keys a row
MAX_SEQ = PROMPT_LEN + MAX_NEW + 8      # generate_sequential's ring size
HBM_BYTES_PER_S = hw.HBM_BW                     # H100 SXM (roofline/hw.py)
PEAK_OPS_PER_S = {torch.bfloat16: hw.PEAK_FLOPS_BF16,  # dense tensor cores
                  torch.float32: hw.PEAK_FLOPS_F32}    # outside them
SLEEP_CYCLES = 200_000_000                      # ~0.1 s of a busy card
CFG = None      # ee-llm-7b's ModelConfig: the shapes of phases 2-7
GEMMA = "gemma3-12b"                            # phase 8, at full width
G_PROMPT, G_LONG, G_LONG_NEW = 4096, 32768, 16  # phase 8 (a), (e); (b)
G_LENS = (512, 640, 896, 1024, 1536, 2048, 3072, 4096)  # phase 8 (c)
G_PAGE = 128                    # phase 8 (c), (d): 108 prompt chunks
G_CHUNK = 512                   # phase 8 (e): prompt upload slices
G_FILLS = (512, 4096)           # phase 2 at gemma3's shapes: paged fills
STABLELM = "stablelm-12b"                       # phase 10, at full width
OLMOE, GRANITE = "olmoe-1b-7b", "granite-moe-3b-a800m"  # phase 9
M_LENS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)  # phase 9 (b), (c)
S_LENS = (512, 768, 1024, 1280, 1536, 1792, 2048, 2048)  # phase 10
S_NEW = 16                      # phase 10: new tokens a prompt
N_FILLS = (512, 2048)           # phase 2 at phases 9 and 10's shapes
XLSTM, ZAMBA2 = "xlstm-350m", "zamba2-1.2b"     # phase 11
# phase 11 (b): 12 prompts, no length a multiple of the 256-token GLA chunk
R_LENS = (131, 203, 317, 389, 451, 517, 601, 677, 743, 811, 907, 1019)
WHISPER, PALIGEMMA = "whisper-medium", "paligemma-3b"  # phase 12
P_PROMPT = {WHISPER: 64, PALIGEMMA: 256}        # phase 12: prompt tokens
P_NEW, P_ROWS = 64, 8                           # phase 12: new tokens, (b)
COLD_BYTES = 120e6              # ring sets timed in turn: past the 50 MB L2
# Decoder layers of the earlier full-width phases (3-11): widths, exits and
# every check as published, depth cut so that the whole script ends well
# inside its 1200-s limit on a shared host (their host-bound loops take
# time in proportion to the layers).  Each cut keeps both exits, a cloud
# segment, and every kind of layer the model has in each segment:
# gemma3-12b's global layers 6-30 (one in the cloud), xlstm's sLSTM
# blocks 4, 11 and 18, zamba2's shared block at 6-24.  Phase 12 (this
# slice's models) runs at full depth.
DEPTH = {"ee-llm-7b": 18, GEMMA: 30, OLMOE: 10, GRANITE: 18, STABLELM: 22,
         XLSTM: 18, ZAMBA2: 24}


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True)
    return out.stdout.strip()


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one ``fn(i)`` call.  The card first sleeps while the
    host queues every call, so the events time the calls back to back and
    not the host's launch overhead."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lap(t0: float, label: str) -> float:
    """Print the seconds since ``t0`` under ``label``; returns now."""
    now = time.perf_counter()
    print(f"{label}: {now - t0:.1f} s")
    return now


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def attn_tol(dtype, want: torch.Tensor) -> float:
    """An attention output's tolerance against its plain version: 2e-5 in
    float32; in bfloat16 two bf16 ulps of the largest output (2**-6 of
    it), which scales with the fill (outputs shrink as about
    sqrt(e / keys)) and stays below what a dropped page or key block
    moves."""
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -6 * float(want.float().abs().max())


def split_theta(stats) -> float:
    """A threshold between the two middle l_ee1 confidences of a run: about
    half its ticks exit early, and no confidence sits on the threshold."""
    c = sorted(l1 for l1, _ in stats.confidences)
    return (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def build_kernels() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in logs.items():
        entry, spills = None, ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry:
                spills = f"spill {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers(.*)", line)
            if m and entry:
                smem = re.search(r"(\d+) bytes smem", m.group(2))
                print(f"  ptxas {name}: {short_name(entry)} regs={m.group(1)} "
                      f"smem={smem.group(1) if smem else 0} B {spills}")
                entry = None


def short_name(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled symbol
    (``decode_attn_kernel<bf16,128,1>``), else its first 72 characters."""
    m = re.search(r"\d+([a-z][a-z_]*_kernel)I(.*?)EEv", mangled)
    if not m:
        return mangled[:72]
    args = re.sub(r"Li(\d+)E?", r",\1,", m.group(2))
    for code, name in (("13__nv_bfloat16", "bf16,"), ("6__half", "f16,"),
                       ("S1_", "same,")):
        args = args.replace(code, name)
    args = ",".join(a if a not in ("f", "a") else {"f": "f32", "a": "int8"}[a]
                    for a in re.split(r",+", args.replace("fa", "f,a")
                                      .replace("ff", "f,f")) if a)
    return f"{m.group(1)}<{args}>"


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------
def attn_inputs(b, s, dtype, dev, gen, *, masked_row=False):
    h, kv, d = CFG.n_heads, CFG.n_kv_heads, CFG.resolved_head_dim
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    cur = torch.tensor([s - 1, 400, 131, 0, s - 1, 300, 64, 17][:b],
                       dtype=torch.int32, device=dev)
    if masked_row:
        pos[-1] = -1                          # a row with no valid key
    return q, k, v, pos, cur


def time_ring(b, dev, gen) -> dict:
    """Device time of ``decode_attn`` at B=b, bf16, full ``MAX_SEQ``-key
    rings (ee-llm-7b: 552), beside its plain version and SDPA, on as many
    rings in turn as take ``COLD_BYTES`` of K/V (at least 4), with bytes
    and operations of the first."""
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    s = MAX_SEQ
    per = 2 * b * s * CFG.n_kv_heads * CFG.resolved_head_dim * 2
    n_sets = int(min(256, max(4, -(-COLD_BYTES // per))))
    sets = [attn_inputs(b, s, torch.bfloat16, dev, gen)
            for _ in range(n_sets)]
    for _, _, _, _, cur in sets:
        cur.fill_(s - 1)                      # every row attends all keys
    ms = device_ms(lambda i: decode_attn(*sets[i % n_sets]))
    plain = device_ms(lambda i: decode_attn_ref(*sets[i % n_sets]))
    h, kv, d = CFG.n_heads, CFG.n_kv_heads, CFG.resolved_head_dim
    sdpa = [(q.view(b, h, 1, d), k.transpose(1, 2).contiguous(),
             v.transpose(1, 2).contiguous(),
             ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :])
            for q, k, v, pos, cur in sets]
    lib = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        *sdpa[i % n_sets][:3], attn_mask=sdpa[i % n_sets][3],
        enable_gqa=True))
    q, k, v, pos, cur = sets[0]
    n_valid = int(((pos >= 0) & (pos <= cur[:, None])).sum())
    nbytes = (2 * q.numel() * q.element_size() + pos.numel() * 4 + b * 4
              + 2 * n_valid * kv * d * k.element_size())
    bnd, by = bound_ms(nbytes, 4 * h * n_valid * d, torch.bfloat16)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by, bytes=nbytes)


def check_decode_attn(dev, gen) -> dict:
    """The ring kernel against its plain version: float32 and bf16; B=1
    and B=4 (the split plan cuts S in splits) and B=8 (it does not); a row
    with no valid key; a window; a window that leaves only the last split
    valid; S=1 and S below one split.  Timed at B=1 (the sequential loop)
    and B=8 (the dense engine's 8 slots)."""
    from repro_torch.kernels.decode_attn.ops import (RING_ALIGN,
                                                     RING_MIN_KEYS,
                                                     decode_attn, split_plan)
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    s = MAX_SEQ
    splits, per = split_plan(s, CFG.n_kv_heads, align=RING_ALIGN,
                             min_per=RING_MIN_KEYS)
    last = s - (splits - 1) * per             # keys of the last split
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, window, masked in ((1, s, 0, False), (4, s, 0, True),
                                     (4, s, 128, False), (8, s, 0, True),
                                     (1, s, last, False), (2, 1, 0, False),
                                     (2, 40, 0, False)):
            q, k, v, pos, cur = attn_inputs(b, n, dtype, dev, gen,
                                            masked_row=masked)
            cur = cur.clamp(max=n - 1)
            got = decode_attn(q, k, v, pos, cur, window=window)
            want = decode_attn_ref(q, k, v, pos, cur, window=window)
            e, tol = max_err(got, want), attn_tol(dtype, want)
            if masked:
                check(bool(torch.all(got[-1] == 0)), "masked row is not 0")
            print(f"decode_attn {str(dtype)[6:]} B={b} S={n} window={window}"
                  f"{' masked-row' if masked else ''}: max|err|={e:.3g} "
                  f"(tol {tol:.3g})")
            check(e <= tol, f"decode_attn disagrees with its plain version")
            err = max(err, e)
    q, k, v, pos, cur = attn_inputs(1, s, torch.bfloat16, dev, gen)
    again = [decode_attn(q, k, v, pos, cur) for _ in range(2)]
    check(torch.equal(*again), "decode_attn differs between two calls")
    print(f"decode_attn bf16 B=1 in {splits} splits: two calls "
          f"bit-identical: True")
    row = dict(name="decode_attn",
               source="src/repro_torch/csrc/decode_attn.cu",
               replaces="src/repro/kernels/decode_attn/kernel.py:94",
               max_abs_err=err, **time_ring(1, dev, gen))
    row["b8"] = time_ring(8, dev, gen)
    return row


def paged_inputs(dtype, dev, gen, *, holes=False, sets=1, b=SLOTS,
                 chunk=False):
    """Float32 K/V pages at ``CFG``'s head shape in ``PAGE_SIZE``-token
    pages (ee-llm-7b: H = KV = 32, d = 128, 16-token pages) and, for each
    of ``sets`` tables, (q, pos, tbl, cur) of ``b`` rows with ragged fills
    of ``FILLS`` keys (ee-llm-7b: 128-552), pages handed out in
    shuffled order.  ``holes`` leaves one row's second table entry
    unmapped, punches never-written positions into the pages and maps
    nothing for the last row (output 0).  ``chunk``: the ``b`` rows are one
    stream's prefill chunk as ``chunk_attention_paged`` issues it, its
    last ``b`` tokens (cur = fill - b, ..., fill - 1) over one table.  The
    tables map disjoint pages of one pool, so that timed calls in turn
    find their pages outside the L2 cache."""
    h, kv, d = CFG.n_heads, CFG.n_kv_heads, CFG.resolved_head_dim
    ps = PAGE_SIZE
    n_lp = -(-FILLS[1] // ps)
    fills = torch.randint(FILLS[0], FILLS[1] + 1, (sets, 1 if chunk else b),
                          generator=gen, device=dev).tolist()
    n_pages = 1 + sum(-(-f // ps) for row in fills for f in row)
    kp = torch.randn((n_pages, ps, kv, d), generator=gen, device=dev)
    vp = torch.randn((n_pages, ps, kv, d), generator=gen, device=dev)
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device=dev)
    order = (1 + torch.randperm(n_pages - 1, generator=gen,
                                device=dev)).tolist()
    out = []
    for row_fills in fills:
        tbl = torch.full((len(row_fills), n_lp), -1, dtype=torch.int32,
                         device=dev)
        cur = torch.tensor([f - 1 for f in row_fills], dtype=torch.int32,
                           device=dev)
        for bi, fill in enumerate(row_fills):
            for lp in range(-(-fill // ps)):
                pg = order.pop()
                tbl[bi, lp] = pg
                n = min(ps, fill - lp * ps)
                pos[pg, :n] = torch.arange(lp * ps, lp * ps + n, device=dev)
        if chunk:
            tbl = tbl[:1].expand(b, n_lp).contiguous()
            cur = row_fills[0] - b + torch.arange(b, dtype=torch.int32,
                                                  device=dev)
        if holes:
            tbl[0, 1] = -1
            tbl[-1] = -1
            drop = torch.rand((n_pages, ps), generator=gen, device=dev) < 0.2
            pos[drop] = -1
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        out.append([q, pos, tbl, cur])
    return kp, vp, out


def paged_pool(kp, vp, dtype, int8: bool) -> dict:
    """The pool the kernel reads: pages in ``dtype``, or int8 codes with
    their per-(slot, kv head) scales quantized from the same pages."""
    if not int8:
        return dict(kp=kp.to(dtype), vp=vp.to(dtype))
    from repro_torch.models.attention import quantize_kv_rows
    kq, ks = quantize_kv_rows(kp)
    vq, vs = quantize_kv_rows(vp)
    return dict(kp=kq, vp=vq, k_scale=ks, v_scale=vs)


def paged_bytes_ops(pool, q, pos, tbl, cur, window=0) -> tuple:
    """Bytes the call must move: the K/V (and int8 scales) of the keys
    valid for some row (inside its window), each once (a chunk's rows
    share their keys), the
    position markers of its mapped pages, the table, cur, q and out;
    operations: 4 per (head, row, key valid for the row, element)."""
    h, d = q.shape[1], q.shape[2]
    kv, ps = pool["kp"].shape[2], pool["kp"].shape[1]
    pages = torch.unique(tbl[tbl >= 0]).long()
    rows = torch.nonzero(tbl >= 0)
    p = pos[tbl[rows[:, 0], rows[:, 1]].long()]          # (mapped, ps)
    c = cur[rows[:, 0]][:, None]
    valid = (p >= 0) & (p <= c)
    if window:
        valid &= c - p < window
    n_valid = int(valid.sum())
    # a key is read once however many rows attend to it
    ids = (tbl[rows[:, 0], rows[:, 1]].long()[:, None] * ps
           + torch.arange(ps, device=p.device))[valid]
    n_keys = int(torch.unique(ids).numel())
    per_key = 2 * kv * d * pool["kp"].element_size()
    if "k_scale" in pool:
        per_key += 2 * kv * 4
    nbytes = (n_keys * per_key + pages.numel() * ps * 4 + tbl.numel() * 4
              + cur.numel() * 4 + 2 * q.numel() * q.element_size())
    return nbytes, 4 * h * n_valid * d


PAGED_VARIANTS = (("decode_attn_paged", False),
                  ("decode_attn_paged_int8", True))


def time_paged(b, n_sets, dev, gen, chunk=False, window=0) -> dict:
    """Device time of both paged variants at ``b`` rows, bf16 q, on
    ``n_sets`` tables over disjoint pages of one pool (more than the 50 MB
    L2 in all) called in turn, beside the plain version and paged_gather +
    SDPA, under ``window``.  Both variants read the same tables and pages
    (int8 quantized from them); bytes and operations are the mean over
    the tables, as the times are."""
    from repro_torch.kernels.decode_attn.ops import decode_attn_paged
    from repro_torch.kernels.decode_attn.ref import decode_attn_paged_ref
    from repro_torch.models.attention import paged_gather
    kp, vp, sets = paged_inputs(torch.bfloat16, dev, gen, sets=n_sets, b=b,
                                chunk=chunk)
    h, d = CFG.n_heads, CFG.resolved_head_dim
    out = {}
    for name, int8 in PAGED_VARIANTS:
        pool = paged_pool(kp, vp, torch.bfloat16, int8)
        scales = ({k: pool[k] for k in ("k_scale", "v_scale")}
                  if int8 else {})
        calls = [(q, pool["kp"], pool["vp"], pos, tbl, cur)
                 for q, pos, tbl, cur in sets]
        ms = device_ms(lambda i: decode_attn_paged(
            *calls[i % n_sets], window=window, **scales))
        plain = device_ms(lambda i: decode_attn_paged_ref(
            *calls[i % n_sets], window=window, **scales))
        cache = {"kp": pool["kp"], "vp": pool["vp"]}
        if int8:
            cache.update(ks=pool["k_scale"], vs=pool["v_scale"])

        def library(i):
            q, pos, tbl, cur = sets[i % n_sets]
            k, v, kpos = paged_gather(dict(cache, pos=pos), tbl)
            mask = (kpos >= 0) & (kpos <= cur[:, None])
            if window:
                mask &= cur[:, None] - kpos < window
            return torch.nn.functional.scaled_dot_product_attention(
                q.view(b, h, 1, d), k.transpose(1, 2).to(q.dtype),
                v.transpose(1, 2).to(q.dtype),
                attn_mask=mask[:, None, None, :], enable_gqa=True)

        lib = device_ms(library)
        counts = [paged_bytes_ops(pool, *s, window=window) for s in sets]
        nbytes = sum(c[0] for c in counts) / n_sets
        ops = sum(c[1] for c in counts) / n_sets
        bnd, by = bound_ms(nbytes, ops, torch.bfloat16)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                         bound_by=by, bytes=nbytes)
    return out


def check_decode_attn_paged(dev, gen) -> list:
    """Both paged variants against their plain version, float32 and bf16
    q, in ``PAGE_SIZE``-token pages: 8 slots with ragged fills, with
    holes, gaps and a row with nothing mapped, with a single mapped page a
    row, one row (its pages cut in splits), and a prefill chunk of
    ``PAGE_SIZE`` tokens (as many rows over one table, phases 7 and 8);
    each without a window and, for a model with one (gemma3's local
    layers), under it, over fills past it.  Timed at 8 slots (the batched
    engine), at B=1 and as the chunk, and at 8 slots under the window."""
    from repro_torch.kernels.decode_attn.ops import decode_attn_paged
    from repro_torch.kernels.decode_attn.ref import decode_attn_paged_ref
    chunk = f" a {PAGE_SIZE}-token chunk"
    windows = (0, CFG.sliding_window) if CFG.sliding_window else (0,)
    errs = {}
    for name, int8 in PAGED_VARIANTS:
        err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for window in windows:
                for label, b, holes in (("", SLOTS, False),
                                        (" holes+gaps+empty row", SLOTS,
                                         True),
                                        (" one page a row", SLOTS, False),
                                        ("", 1, False),
                                        (chunk, PAGE_SIZE, False)):
                    kp, vp, [(q, pos, tbl, cur)] = paged_inputs(
                        dtype, dev, gen, holes=holes, b=b,
                        chunk=label == chunk)
                    if label == " one page a row":
                        tbl[:, 1:] = -1
                    pool = paged_pool(kp, vp, dtype, int8)
                    scales = ({k: pool[k] for k in ("k_scale", "v_scale")}
                              if int8 else {})
                    args = (q, pool["kp"], pool["vp"], pos, tbl, cur)
                    got = decode_attn_paged(*args, window=window, **scales)
                    want = decode_attn_paged_ref(*args, window=window,
                                                 **scales)
                    e, tol = max_err(got, want), attn_tol(dtype, want)
                    if holes:
                        check(bool(torch.all(got[-1] == 0)),
                              f"{name}: the unmapped row is not 0")
                    print(f"{name} {str(dtype)[6:]} B={b} fills "
                          f"{cur.min().item() + 1}-{cur.max().item() + 1}"
                          f" window={window}{label}: max|err|={e:.3g} "
                          f"(tol {tol:.3g})")
                    check(e <= tol,
                          f"{name} disagrees with its plain version")
                    err = max(err, e)
        errs[name] = err
    # 8 slots: 4 tables over one pool of > 50 MB; B=1 and the chunk: 12
    t8, t1 = time_paged(SLOTS, 4, dev, gen), time_paged(1, 12, dev, gen)
    tc = time_paged(PAGE_SIZE, 12, dev, gen, chunk=True)
    tw = (time_paged(SLOTS, 4, dev, gen, window=windows[-1])
          if CFG.sliding_window else {})
    return [dict(name=name, source=f"src/repro_torch/csrc/{name}.cu",
                 replaces="src/repro/kernels/decode_attn/kernel.py:236",
                 max_abs_err=errs[name], **t8[name], b1=t1[name],
                 chunk=tc[name], **({"window": tw[name]} if tw else {}))
            for name, _ in PAGED_VARIANTS]


def exit_inputs(b, dtype, dev, gen, tie=None, hidden=None):
    d, v = CFG.d_model, CFG.vocab_size
    h = (torch.randn((b, d), generator=gen, device=dev) * 3 if hidden is None
         else hidden.float())
    w = torch.randn((v, d), generator=gen, device=dev) * 0.02
    ns = torch.randn((d,), generator=gen, device=dev) * 0.1
    if tie is not None:
        # two equal one-hot read-out rows in different 64-row tiles, on row
        # 0's largest normalized element: the top logit twice, exactly, in
        # any summation order
        hn0 = h[0] * (1 + ns)
        j = int(hn0.abs().argmax())
        w[list(tie)] = 0.0
        w[list(tie), j] = 4.0 * torch.sign(hn0[j])
    return h.to(dtype), w.to(dtype), ns.to(dtype)


def exit_cases(dev, gen):
    tie = (100, CFG.vocab_size * 5 // 8)
    return [("bf16 B=1 tie", exit_inputs(1, torch.bfloat16, dev, gen, tie),
             tie),
            ("bf16 B=8", exit_inputs(8, torch.bfloat16, dev, gen), None),
            ("f32 B=1 tie", exit_inputs(1, torch.float32, dev, gen, tie),
             tie)]


def compare_exit(label, got, want, tie) -> float:
    """An exit kernel's (conf, tok, lse, max logit) against its plain
    version's: the max logit, what the mesh's ranks merge on, within
    1e-4 of the largest |max logit| (one float32 logit's rounding: on an
    H100's tensor cores at d = 8192 its error reached 2.4e-4 at logits
    near 10, where the lse, which averages many logits' errors, stayed
    within its absolute 1e-4)."""
    e_conf, e_lse = max_err(got[0], want[0]), max_err(got[2], want[2])
    e_mx = max_err(got[3], want[3])
    tol_mx = 1e-4 * max(1.0, float(want[3].float().abs().max()))
    same_tok = torch.equal(got[1], want[1])
    print(f"  {label}: max|conf err|={e_conf:.3g} (tol 1e-5) "
          f"max|lse err|={e_lse:.3g} (tol 1e-4) max|max logit err|="
          f"{e_mx:.3g} (tol {tol_mx:.3g}) tokens equal={same_tok}")
    check(e_conf <= 1e-5 and e_lse <= 1e-4 and e_mx <= tol_mx and same_tok,
          f"{label}: exit decision disagrees with its plain version")
    if tie is not None:
        check(int(got[1][0]) == tie[0], f"{label}: tie not at lowest index")
    return max(e_conf, e_lse, e_mx)


def exit_bound(b, w, with_packet: bool, exits: int = 1):
    """b rows over ``exits`` exits: W, the rows and the norm scales read
    once, (conf, tok, lse, max logit) written once (and the int8
    packet)."""
    d = w.shape[1]
    nbytes = (w.numel() + b * d + exits * d) * w.element_size() + b * 16
    if with_packet:
        nbytes += b * d + b * 4
    return bound_ms(nbytes, 2 * b * w.numel(), w.dtype)


def check_exit_head(dev, gen, cases) -> dict:
    from repro_torch.kernels.exit_head.ops import exit_head
    from repro_torch.kernels.exit_head.ref import exit_head_ref
    print(f"exit_head (d={CFG.d_model}, V={CFG.vocab_size}):")
    err = max(compare_exit(label, exit_head(*args), exit_head_ref(*args), tie)
              for label, args, tie in cases)
    h, w, ns = cases[0][1]
    ms = device_ms(lambda i: exit_head(h, w, ns))
    plain = device_ms(lambda i: exit_head_ref(h, w, ns))
    hn = (h.float() * torch.rsqrt(h.float().square().mean(-1, keepdim=True)
                                  + 1e-5) * (1 + ns.float())).to(h.dtype)

    def library(i):
        logits = torch.matmul(hn, w.T).float()
        return logits.logsumexp(-1), logits.argmax(-1)

    lib = device_ms(library)
    bnd, by = exit_bound(1, w, with_packet=False)
    return dict(name="exit_head", source="src/repro_torch/csrc/exit_head.cu",
                replaces="src/repro/kernels/exit_head/kernel.py:85",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib)


def tie_rows(n, dtype, dev):
    """Rows with absmax 127 (scale exactly 1), so x / scale lands on exact
    .5 ties; the last row is all zeros (scale 1e-12)."""
    x = (torch.randint(-126, 126, (n, CFG.d_model), device=dev) + 0.5).float()
    x[:, 0] = 127.0
    x[-1] = 0.0
    return x.to(dtype)


def check_quantize(dev, gen) -> dict:
    """The wire quantizer against its plain version, bit for bit, at the
    wire packet's shapes and at every layout of the kernel (a warp a row,
    narrower loads, a block of 256 or 1024 threads a row); timed at (1,
    4096) and (8, 4096) bf16."""
    from repro_torch.kernels.quantize.ops import quantize_int8
    from repro_torch.kernels.quantize.ref import quantize_int8_ref
    err = 0.0
    d = CFG.d_model
    cases = [(f"bf16 (1,{d})", torch.randn(
                 (1, d), generator=gen, device=dev).bfloat16()),
             (f"bf16 (8,{d})", torch.randn(
                 (8, d), generator=gen, device=dev).bfloat16() * 9),
             ("f32 .5 ties + zero row", tie_rows(4, torch.float32, dev))]
    for n, width in ((9, 130), (2, 257), (1, 12288)):
        cases.append((f"f32 ({n},{width})", torch.randn(
            (n, width), generator=gen, device=dev) * 5))
    for label, x in cases:
        (q, s), (qr, sr) = quantize_int8(x), quantize_int8_ref(x)
        e = max(max_err(q, qr), max_err(s, sr))
        print(f"quantize {label}: max|err|={e:.3g} (exact codes and scales)")
        check(torch.equal(q, qr) and torch.equal(s, sr),
              f"quantize {label} disagrees with its plain version")
        err = max(err, e)
    half = torch.tensor([[127.0, 2.5, 3.5, -0.5] + [0.0] * 4], device=dev)
    check(quantize_int8(half)[0][0, :4].tolist() == [127, 2, 4, 0],
          "quantize does not round half to even")
    out = {}
    for n in (1, SLOTS):
        x = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        ms = device_ms(lambda i: quantize_int8(x))
        plain = device_ms(lambda i: quantize_int8_ref(x))
        nbytes = x.numel() * 3 + 4 * n
        bnd, by = bound_ms(nbytes, 3 * x.numel(), torch.float32)
        out[n] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                      library_ms=None, bytes=nbytes)
    return dict(name="quantize", source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quantize/kernel.py:31",
                max_abs_err=err, **out[1], b8=out[SLOTS])


def kv_pool(n_pages, dev, gen) -> dict:
    """An int8 pool of ``PAGE_SIZE``-token pages at ``CFG``'s head shape
    with stale random contents, so that an entry left unwritten shows."""
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    shape = (n_pages, PAGE_SIZE, kv)
    return {"kp": torch.randint(-127, 128, shape + (d,), generator=gen,
                                device=dev, dtype=torch.int8),
            "vp": torch.randint(-127, 128, shape + (d,), generator=gen,
                                device=dev, dtype=torch.int8),
            "ks": torch.rand(shape, generator=gen, device=dev),
            "vs": torch.rand(shape, generator=gen, device=dev),
            "pos": torch.randint(-1, 600, shape[:2], generator=gen,
                                 device=dev, dtype=torch.int32)}


def pool_err(a, b) -> float:
    """The largest difference between two pools: every marker; codes and
    scales outside the trash page 0 (rows that share one of its slots
    leave either row's codes there)."""
    return max([max_err(a["pos"], b["pos"])]
               + [max_err(a[k][1:], b[k][1:]) for k in ("kp", "vp", "ks",
                                                         "vs")])


def write_inputs(b, dtype, dev, gen, *, masked=False):
    """One decode step's write of ``b`` rows into a pool of pages for
    ``FILLS[1]`` keys a row (ee-llm-7b: 35 pages, 552 keys): pages in
    shuffled order, positions drawn from 0 to ``FILLS[1]`` - 1; row
    1's entry unmapped, row 2 past its table, row 7 at a negative
    position; with ``masked``, every third row masked out."""
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    n_lp = -(-FILLS[1] // PAGE_SIZE)
    pool = kv_pool(1 + b * n_lp, dev, gen)
    tbl = (1 + torch.randperm(b * n_lp, generator=gen, device=dev)).view(
        b, n_lp).int()
    pos = torch.randint(0, FILLS[1], (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    if b >= 8:
        tbl[1, pos[1] // PAGE_SIZE] = -1
        pos[2] = n_lp * PAGE_SIZE + 3
        pos[7] = -3
    mask = (torch.arange(b, device=dev) % 3 != 2) if masked else None
    knew = (torch.randn((b, kv, d), generator=gen, device=dev) * 4).to(dtype)
    vnew = (torch.randn((b, kv, d), generator=gen, device=dev) * 4).to(dtype)
    return pool, (knew, vnew, pos, tbl, mask)


def chunk_write_inputs(dtype, dev, gen):
    """A final prefill chunk's int8 page write as ``chunk_attention_paged``
    issues it: one stream's ``PAGE_SIZE`` tokens from position 432 (11
    real, the pads masked out) as as many rows that share its table row
    of pages for ``FILLS[1]`` keys."""
    from repro_torch.models.attention import chunk_rows
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    n_lp = -(-FILLS[1] // PAGE_SIZE)
    pool = kv_pool(1 + n_lp, dev, gen)
    tbl = (1 + torch.randperm(n_lp, generator=gen, device=dev)).view(
        1, n_lp).int()
    pos = torch.tensor([432], dtype=torch.int32, device=dev)
    mask = (torch.arange(PAGE_SIZE, device=dev) < 11)[None]
    knew = (torch.randn((PAGE_SIZE, kv, d), generator=gen, device=dev)
            * 4).to(dtype)
    vnew = (torch.randn((PAGE_SIZE, kv, d), generator=gen, device=dev)
            * 4).to(dtype)
    return pool, (knew, vnew, *chunk_rows(pos, tbl, mask, PAGE_SIZE))


def scatter_inputs(length, n_real, pages, dtype, dev, gen):
    """A prefilled row of ``length`` ring slots (positions 0..n_real-1,
    then -1) over ``pages`` (ids; < 0 the trash page) of a fresh pool."""
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    pool = kv_pool(1 + max(pages), dev, gen)
    ar = torch.arange(length, device=dev, dtype=torch.int32)
    row = {"k": torch.randn((1, length, kv, d), generator=gen,
                            device=dev).to(dtype) * 3,
           "v": torch.randn((1, length, kv, d), generator=gen,
                            device=dev).to(dtype) * 3,
           "pos": torch.where(ar < n_real, ar, -1)[None]}
    return pool, (row, torch.tensor(pages, dtype=torch.int32, device=dev))


def clone_pool(pool) -> dict:
    return {k: v.clone() for k, v in pool.items()}


def host_ms(fn, iters: int = 50) -> float:
    """Wall time per call of ``fn(i)`` on the host clock, from the first
    call issued to the last finished on the card."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) that one call of ``fn``
    runs, counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA"))


def time_page_write(name, op, ref, pool, args, nbytes, nelem) -> dict:
    """Device time of one page-write entry beside its plain version and
    PR 13's torch sequence (the plain version quantizing through the wire
    kernel), each sequence's host wall time per call and device operations
    per call."""
    from repro_torch.kernels.quantize.ops import quantize_int8
    pr13 = lambda: ref(pool, *args, quantize=quantize_int8)  # noqa: E731
    r = dict(ms=device_ms(lambda i: op(pool, *args)),
             plain_ms=device_ms(lambda i: ref(pool, *args)),
             pr13_ms=device_ms(lambda i: pr13()),
             host_ms=host_ms(lambda i: op(pool, *args)),
             pr13_host_ms=host_ms(lambda i: pr13()),
             ops=device_ops(lambda: op(pool, *args)),
             pr13_ops=device_ops(pr13), library_ms=None, bytes=nbytes)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 3 * nelem, torch.float32)
    print(f"time {name} PR-13 torch sequence: {r['pr13_ms'] * 1e3:.2f} us "
          f"device, {r['pr13_host_ms'] * 1e3:.2f} us wall a call, "
          f"{r['pr13_ops']} device ops a call; the kernel "
          f"{r['host_ms'] * 1e3:.2f} us wall a call, {r['ops']} device ops")
    return r


def check_kv_write(dev, gen) -> dict:
    """``quantize_kv_write`` against its plain version and against PR 13's
    sequence, every pool byte outside page 0's codes and scales, at 8
    slots (with and without a mask, bf16 and f32), at B=1, and as a
    ``PAGE_SIZE``-token prefill chunk's write (phases 7 and 8's int8
    chunks); timed at 8 slots, at B=1 and as the chunk (bf16)."""
    from repro_torch.kernels.quantize.ops import (quantize_int8,
                                                  quantize_kv_write)
    from repro_torch.kernels.quantize.ref import quantize_kv_write_ref
    err = 0.0
    for b, dtype, masked in ((SLOTS, torch.bfloat16, True),
                             (SLOTS, torch.float32, False),
                             (1, torch.bfloat16, False),
                             (0, torch.bfloat16, True)):
        pool, args = (write_inputs(b, dtype, dev, gen, masked=masked)
                      if b else chunk_write_inputs(dtype, dev, gen))
        want = quantize_kv_write_ref(clone_pool(pool), *args)
        old = quantize_kv_write_ref(clone_pool(pool), *args,
                                    quantize=quantize_int8)
        got = quantize_kv_write(pool, *args)
        e, e_old = pool_err(got, want), pool_err(old, want)
        print(f"quantize_kv_write {str(dtype)[6:]} "
              f"{f'B={b}' if b else f'a {PAGE_SIZE}-token chunk'}"
              f"{' masked' if masked else ''}: pool max|err|={e:.3g} vs "
              f"plain, PR-13 sequence {e_old:.3g} (exact)")
        check(e == 0 and e_old == 0,
              "quantize_kv_write disagrees with its plain version")
        err = max(err, e)
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    out = {}
    for b in (SLOTS, 1, 0):
        pool, args = (write_inputs(b, torch.bfloat16, dev, gen) if b
                      else chunk_write_inputs(torch.bfloat16, dev, gen))
        rows = b or PAGE_SIZE
        nelem = 2 * rows * kv * d
        nbytes = (nelem * 2 + 8 * rows + nelem + 2 * rows * kv * 4
                  + 4 * rows)
        out[b] = time_page_write(
            f"quantize_kv_write "
            f"({f'B={b}' if b else f'a {PAGE_SIZE}-token chunk'})",
            quantize_kv_write, quantize_kv_write_ref, pool, args, nbytes,
            nelem)
    return dict(name="quantize_kv_write",
                source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quantize/kernel.py:31",
                max_abs_err=err, **out[SLOTS], b1=out[1], chunk=out[0])


def check_kv_scatter(dev, gen, length=512) -> dict:
    """``quantize_kv_scatter`` against its plain version and PR 13's
    sequence, in ``PAGE_SIZE``-token pages: a ``length``-token prefill
    (the last 12 slots padding) over its pages in reverse order, and a
    500-slot ring over its pages and two more (fills past it, the last two
    pages unmapped); timed at ``length`` tokens (bf16)."""
    from repro_torch.kernels.quantize.ops import (quantize_int8,
                                                  quantize_kv_scatter)
    from repro_torch.kernels.quantize.ref import quantize_kv_scatter_ref
    main = (length, length - 12, list(range(length // PAGE_SIZE, 0, -1)))
    ring = list(range(1, -(-500 // PAGE_SIZE) + 1)) + [-1, -1]
    err = 0.0
    for (n_slots, n_real, pages), dtype in (
            (main, torch.bfloat16), ((500, 480, ring), torch.float32)):
        pool, args = scatter_inputs(n_slots, n_real, pages, dtype, dev, gen)
        want = quantize_kv_scatter_ref(clone_pool(pool), *args)
        old = quantize_kv_scatter_ref(clone_pool(pool), *args,
                                      quantize=quantize_int8)
        got = quantize_kv_scatter(pool, *args)
        e, e_old = pool_err(got, want), pool_err(old, want)
        print(f"quantize_kv_scatter {str(dtype)[6:]} ring {n_slots} over "
              f"{len(pages)} pages: pool max|err|={e:.3g} vs plain, PR-13 "
              f"sequence {e_old:.3g} (exact)")
        check(e == 0 and e_old == 0,
              "quantize_kv_scatter disagrees with its plain version")
        err = max(err, e)
    pool, args = scatter_inputs(*main, torch.bfloat16, dev, gen)
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    n_tok = len(main[2]) * PAGE_SIZE
    nelem = 2 * n_tok * kv * d
    nbytes = (nelem * 2 + 4 * n_tok + 4 * len(main[2]) + nelem
              + 2 * n_tok * kv * 4 + 4 * n_tok)
    r = time_page_write(f"quantize_kv_scatter ({main[0]} tokens)",
                        quantize_kv_scatter, quantize_kv_scatter_ref, pool,
                        args, nbytes, nelem)
    return dict(name="quantize_kv_scatter",
                source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quantize/kernel.py:31",
                max_abs_err=err, **r)


def check_exit_quant(dev, gen, cases) -> dict:
    from repro_torch.kernels.exit_head.ops import exit_head
    from repro_torch.kernels.exit_quant.ops import exit_quant
    from repro_torch.kernels.exit_quant.ref import exit_quant_ref
    ties = exit_inputs(4, torch.float32, dev, gen,
                       hidden=tie_rows(4, torch.float32, dev))
    print(f"exit_quant (d={CFG.d_model}, V={CFG.vocab_size}):")
    err = 0.0
    for label, args, tie in cases + [("f32 B=4 .5 ties + zero row", ties,
                                      None)]:
        got, want = exit_quant(*args), exit_quant_ref(*args)
        err = max(err, compare_exit(label, got.head, want.head, tie))
        check(torch.equal(got.q, want.q) and torch.equal(got.scale,
                                                         want.scale),
              f"{label}: int8 packet disagrees with its plain version")
        head = exit_head(*args)
        check(all(torch.equal(a, b) for a, b in zip(got.head, head)),
              f"{label}: exit_quant's decision differs from exit_head's")
    h, w, ns = cases[0][1]
    ms = device_ms(lambda i: exit_quant(h, w, ns))
    plain = device_ms(lambda i: exit_quant_ref(h, w, ns))
    bnd, by = exit_bound(1, w, with_packet=True)
    return dict(name="exit_quant", source="src/repro_torch/csrc/exit_quant.cu",
                replaces="src/repro/kernels/exit_quant/kernel.py:98",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None)


def heads_inputs(e, b, dtype, dev, gen, ties):
    """(E, B, d) hiddens, the unembedding and (E, d) norm scales; row 0 of
    exit i tops out on the two equal one-hot read-out rows ``ties[i]``, on
    its largest normalized element, a column that row 0 of every other
    exit holds at 0 (so no exit's tie reaches another's top)."""
    d, v = CFG.d_model, CFG.vocab_size
    h = torch.randn((e, b, d), generator=gen, device=dev) * 3
    w = torch.randn((v, d), generator=gen, device=dev) * 0.02
    ns = torch.randn((e, d), generator=gen, device=dev) * 0.1
    for i, tie in enumerate(ties):
        hn0 = h[i, 0] * (1 + ns[i])
        j = int(hn0.abs().argmax())
        h[[k for k in range(e) if k != i], 0, j] = 0.0
        w[list(tie)] = 0.0
        w[list(tie), j] = 4.0 * torch.sign(hn0[j])
    return h.to(dtype), w.to(dtype), ns.to(dtype)


def heads_library(h, w, ns):
    """One torch.matmul of the stacked normed rows against W^T, then
    logsumexp and argmax: the library's version of ``exit_heads``."""
    hf = h.float()
    hn = (hf * torch.rsqrt(hf.square().mean(-1, keepdim=True) + 1e-5)
          * (1 + ns.float()[:, None])).to(h.dtype).reshape(-1, h.shape[-1])

    def library(i):
        logits = torch.matmul(hn, w.T).float()
        return logits.logsumexp(-1), logits.argmax(-1)
    return library


def check_exit_heads(dev, gen) -> dict:
    """``exit_heads``: both exits of a tick in one launch, at B = 1 (R = 2)
    and at 8 slots (R = 16), bf16 and float32, with the int8 packet of
    exit 0; against ``exit_heads_ref``.  Exit 0's row 0 ties across two
    blocks' V ranges, exit 1's row 0 inside one block's range.  Timed at
    R = 2 (the row's time) and R = 16, bf16."""
    from repro_torch.kernels.exit_head.ops import exit_heads
    from repro_torch.kernels.exit_head.ref import exit_heads_ref
    from repro_torch.kernels.quantize.ref import quantize_int8_ref
    v = CFG.vocab_size
    ties = ((100, v * 5 // 8), (150, 200))
    print(f"exit_heads (d={CFG.d_model}, V={v}):")
    err, timed = 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, SLOTS):
            h, w, ns = heads_inputs(2, b, dtype, dev, gen, ties)
            label = f"{str(dtype)[6:]} E=2 B={b} ties"
            got = exit_heads(h, w, ns, quant_exit=0)
            want = exit_heads_ref(h, w, ns, quant_exit=0)
            torch.cuda.synchronize()
            err = max(err, compare_exit(
                label, [x.reshape(-1) for x in got.head],
                [x.reshape(-1) for x in want.head], None))
            check(int(got[1][0, 0]) == ties[0][0]
                  and int(got[1][1, 0]) == ties[1][0],
                  f"{label}: a tie did not go to the lowest index")
            q, s = quantize_int8_ref(h[0])
            check(torch.equal(got.q, q) and torch.equal(got.scale, s)
                  and torch.equal(got.q, want.q),
                  f"{label}: int8 packet disagrees with its plain version")
            if dtype == torch.bfloat16:
                bnd, by = exit_bound(2 * b, w, with_packet=False, exits=2)
                timed[b] = dict(
                    ms=device_ms(lambda i: exit_heads(h, w, ns)),
                    plain_ms=device_ms(lambda i: exit_heads_ref(h, w, ns)),
                    library_ms=device_ms(heads_library(h, w, ns)),
                    bound_ms=bnd, bound_by=by)
            del h, w, ns
    return dict(name="exit_heads", source="src/repro_torch/csrc/exit_head.cu",
                replaces="src/repro/kernels/exit_head/kernel.py:85",
                max_abs_err=err, **timed[1], r16=timed[SLOTS])


def check_small_model(dev) -> None:
    """A small float32 model, one seed, served on the card (kernels) and on
    the CPU (plain versions): the same greedy streams and counters."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.collm import CollmConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingSystem
    cfg = ModelConfig(name="ee-small", arch_type="dense", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                      d_ff=512, vocab_size=500, exit_layers=(1, 2)).validate()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, 40)
               for i in range(2)]
    theta = split_theta(ServingSystem(cpu, CollmConfig(theta=1.0)
                                      ).generate_sequential(prompts, 16)["stats"])
    for mode, wire in (("cloud", "float32"), ("collm", "int8")):
        ccfg = CollmConfig(theta=theta, wire_format=wire, backfill=True)
        want = ServingSystem(cpu, ccfg).generate_sequential(prompts, 16, mode)
        got = ServingSystem(gpu, ccfg).generate_sequential(prompts, 16, mode)
        st = got["stats"]
        print(f"small model {mode}/{wire}: card == CPU: "
              f"{got['tokens'] == want['tokens']} (exits {st.exits_l1}/"
              f"{st.exits_l2}, cloud {st.cloud_requests})")
        check(got["tokens"] == want["tokens"], f"small model {mode}: the "
              "card's stream differs from the CPU's")
        for f in ("exits_l1", "exits_l2", "cloud_requests", "upload_bytes"):
            check(getattr(st, f) == getattr(want["stats"], f), f)
    # the batched engine: paged on the card == dense on the card == CPU;
    # int8 pages on the card == int8 pages on the CPU
    prompts += [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
                for i, n in ((2, 17), (3, 33))]
    for mode, wire in (("cloud", "float32"), ("collm", "int8")):
        runs = {}
        for name, model, layout, kv_dtype in (
                ("cpu", cpu, "dense", "float32"),
                ("dense", gpu, "dense", "float32"),
                ("paged", gpu, "paged", "float32"),
                ("cpu int8", cpu, "paged", "int8"),
                ("int8", gpu, "paged", "int8")):
            ccfg = CollmConfig(theta=theta, wire_format=wire, backfill=True,
                               kv_layout=layout, kv_dtype=kv_dtype)
            runs[name] = ServingSystem(model, ccfg).generate(
                prompts, 16, mode, num_slots=3)
        same = (runs["paged"]["tokens"] == runs["dense"]["tokens"]
                == runs["cpu"]["tokens"])
        same8 = runs["int8"]["tokens"] == runs["cpu int8"]["tokens"]
        print(f"small model batched {mode}/{wire}: paged card == dense card "
              f"== CPU: {same}; int8 pages card == CPU: {same8}")
        check(same, f"small model batched {mode}: the paged stream differs")
        check(same8, f"small model batched {mode}: the int8-page stream on "
              f"the card differs from the CPU's")
    check_small_tiny_ee(dev)
    check_small_adaptive(cpu, gpu, prompts, theta)
    check_small_spec_preempt(cpu, gpu, prompts, theta)
    check_small_prefix_fleet(cpu, gpu, theta)


def tiny_ee_config():
    """The main path's test model (``tests/conftest.py``): 4 layers,
    d_model 128, 4 heads over 2 of d = 32, V = 256, tied, exits 1 and 2."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="tiny-ee", arch_type="dense", n_layers=4,
                       d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                       vocab_size=256, tie_embeddings=True,
                       exit_layers=(1, 2)).validate()


def same_counts(got, want) -> bool:
    fields = ("exits_l1", "exits_l2", "cloud_requests", "upload_bytes")
    return got["tokens"] == want["tokens"] and all(
        getattr(got["stats"], f) == getattr(want["stats"], f)
        for f in fields)


def check_small_tiny_ee(dev) -> None:
    """tiny-ee (float32, one seed) through ``generate`` on paged float32
    and int8 pages (the paged kernel at d = 32): the card's streams and
    counters equal the CPU's."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingSystem
    cfg = tiny_ee_config()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(40 + i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((24, 9, 40, 17, 33))]
    theta = split_theta(ServingSystem(cpu, CollmConfig(theta=1.0)).generate(
        prompts, 16)["stats"])
    ops = kernel_ops()
    for kv_dtype in ("float32", "int8"):
        ccfg = CollmConfig(theta=theta, kv_layout="paged", kv_dtype=kv_dtype)
        want = ServingSystem(cpu, ccfg).generate(prompts, 16, num_slots=3)
        name = ("decode_attn_paged_int8" if kv_dtype == "int8"
                else "decode_attn_paged")
        before = ops[name].launches
        got = ServingSystem(gpu, ccfg).generate(prompts, 16, num_slots=3)
        same = same_counts(got, want)
        print(f"tiny-ee paged {kv_dtype}: card == CPU: {same} (exits "
              f"{got['stats'].exits_l1}/{got['stats'].exits_l2}, cloud "
              f"{got['stats'].cloud_requests}, {name} "
              f"{ops[name].launches - before} launches)")
        check(same and ops[name].launches > before, f"tiny-ee paged "
              f"{kv_dtype}: the card's run differs from the CPU's")


def moe_small(dev, arch):
    """A reduced MoE model in float32 from one seed, on the card and on
    the CPU: 4 layers, exits 1 and 2, 4 experts top-2; olmoe with 4 heads
    over 4 of d = 64, granite with its group of 3 (6 heads over 2 of
    d = 64, d_model 384)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    shape = {} if arch == OLMOE else dict(n_heads=6, d_model=384)
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=4, **shape),
                              exit_layers=(1, 2))
    if arch == GRANITE:
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    cfg = cfg.validate()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(50 + i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((41, 80, 57, 100))]
    return cpu, gpu, prompts


def check_small_moe(dev) -> None:
    """Phase 9's paths on reduced olmoe and granite: the MoE block (the
    capacity form in prefill, the decode form in steps and chunks) and,
    for granite, both attention kernels at G = 3, through
    ``generate_sequential`` (collm at a split θ), ``generate`` on dense,
    paged float32 and int8 pages, and chunked prefill.  The card's
    streams and counters equal the CPU's."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    for arch in (OLMOE, GRANITE):
        cpu, gpu, prompts = moe_small(dev, arch)
        theta = split_theta(ServingSystem(cpu, CollmConfig(
            theta=1.0)).generate_sequential(prompts, 16)["stats"])
        for label, kw in (("sequential", {}),
                          ("dense", dict(kv_layout="dense")),
                          ("paged", dict(kv_layout="paged")),
                          ("paged int8", dict(kv_layout="paged",
                                              kv_dtype="int8")),
                          ("chunked", dict(kv_layout="paged",
                                           chunked_prefill=True))):
            ccfg = CollmConfig(theta=theta, **kw)
            want, got = (
                ServingSystem(m, ccfg).generate_sequential(prompts, 16)
                if label == "sequential" else
                ServingSystem(m, ccfg).generate(prompts, 16, num_slots=3)
                for m in (cpu, gpu))
            same = same_counts(got, want)
            print(f"small {arch} {label}: card == CPU: {same} (exits "
                  f"{got['stats'].exits_l1}/{got['stats'].exits_l2}, cloud "
                  f"{got['stats'].cloud_requests})")
            check(same, f"small {arch} {label}: the card's run differs "
                  "from the CPU's")


def recurrent_small(dev, arch):
    """A reduced recurrent or hybrid model in float32 from one seed, on the
    card and on the CPU: 4 layers, exits 1 and 2, d_model 256, state 16,
    chunk 32; xlstm's layer 3 is its sLSTM block, zamba2's layers 1 and 3
    its shared attention block (4 heads over 4 of d = 64)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=4),
                              exit_layers=(1, 2)).validate()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(60 + i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((37, 50, 83, 101))]
    return cpu, gpu, prompts


def check_small_recurrent(dev) -> None:
    """Phase 11's paths on reduced xlstm and zamba2: the mLSTM, sLSTM and
    Mamba2 blocks (exact-length prefill, masked decode state) through
    ``generate_sequential`` (cloud, collm at a split θ, standalone) and
    ``generate`` on dense KV; zamba2's shared attention block also on
    paged float32 and int8 pages, under recompute preemption and behind
    one ``CloudBatcher``.  The card's streams and counters equal the
    CPU's."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    for arch in (XLSTM, ZAMBA2):
        cpu, gpu, prompts = recurrent_small(dev, arch)
        theta = split_theta(ServingSystem(cpu, CollmConfig(
            theta=1.0)).generate_sequential(prompts, 16)["stats"])
        runs = [(f"sequential {m}", {}, dict(mode=m)) for m in
                ("cloud", "collm", "standalone")]
        runs.append(("dense", dict(kv_layout="dense"), {}))
        if arch == ZAMBA2:
            runs += [("paged", dict(kv_layout="paged"), {}),
                     ("paged int8", dict(kv_layout="paged", kv_dtype="int8"),
                      {}),
                     ("recompute", dict(kv_layout="paged",
                                        preemption="recompute"),
                      dict(preempt_schedule=[(4, 0), (9, 1)])),
                     ("batcher", dict(kv_layout="paged"),
                      dict(cloud_batch=True))]
        for label, ccfg_kw, kw in runs:
            ccfg = CollmConfig(theta=theta, **ccfg_kw)

            def run(m):
                system = ServingSystem(m, ccfg)
                if label.startswith("sequential"):
                    return system.generate_sequential(prompts, 16, **kw)
                if label == "batcher":
                    return system.generate_multi(prompts, 16, **kw)
                return system.generate(prompts, 16, num_slots=3, **kw)

            want, got = run(cpu), run(gpu)
            same = same_counts(got, want) and (
                got["stats"].preemptions == want["stats"].preemptions)
            print(f"small {arch} {label}: card == CPU: {same} (exits "
                  f"{got['stats'].exits_l1}/{got['stats'].exits_l2}, cloud "
                  f"{got['stats'].cloud_requests}, preemptions "
                  f"{got['stats'].preemptions})")
            check(same, f"small {arch} {label}: the card's run differs "
                  "from the CPU's")


def check_exit_quant_rows(dev, gen, b) -> dict:
    """``exit_quant`` over ``b`` > 16 rows at ``CFG``'s unembedding (one
    launch per 16 rows), bf16 and float32, against its plain version;
    timed in bf16.  The bound reads W once for all ``b`` rows."""
    from repro_torch.kernels.exit_quant.ops import exit_quant
    from repro_torch.kernels.exit_quant.ref import exit_quant_ref
    print(f"exit_quant B={b} (d={CFG.d_model}, V={CFG.vocab_size}):")
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        h, w, ns = exit_inputs(b, dtype, dev, gen)
        label = f"{str(dtype)[6:]} B={b}"
        before = exit_quant.launches
        got, want = exit_quant(h, w, ns), exit_quant_ref(h, w, ns)
        check(exit_quant.launches - before == -(-b // 16),
              f"exit_quant {label}: not one launch per 16 rows")
        err = max(err, compare_exit(label, got.head, want.head, None))
        check(torch.equal(got.q, want.q) and torch.equal(got.scale,
                                                         want.scale),
              f"{label}: int8 packet disagrees with its plain version")
        if dtype == torch.bfloat16:
            timed = dict(ms=device_ms(lambda i: exit_quant(h, w, ns)),
                         plain_ms=device_ms(lambda i: exit_quant_ref(h, w,
                                                                    ns)))
        del h, w, ns
    bnd, by = exit_bound(b, torch.empty((CFG.vocab_size, CFG.d_model),
                                        dtype=torch.bfloat16, device="meta"),
                         with_packet=True)
    return dict(name="exit_quant", max_abs_err=err, **timed, bound_ms=bnd,
                bound_by=by, library_ms=None)


def check_new_kernel_shapes(dev, gen, rows) -> None:
    """Phase 2 again at the shapes of phases 9 and 10 and of the main
    path's tiny-ee: stablelm-12b's (H = 32 over KV = 8 heads of d = 160:
    both attention kernels, float and int8 pages, 128-token pages with
    fills of 512-2048 keys, and the int8 page writes with a 2048-token
    scatter), granite-moe-3b-a800m's (24 heads over 8 of d = 64, G = 3:
    both attention kernels; the exit kernels over its 49155 x 1536 tied
    unembedding, a 3-row tail past the last 512-row box; ``exit_quant``
    at B = 40, three launches), olmoe-1b-7b's (the exit kernels over 50304
    x 2048; ``exit_quant`` at B = 24, two launches) and tiny-ee's (the
    paged kernel at d = 32, G = 2, 16-token pages).  Each result is kept
    beside the ee-llm-7b row of its kernel under "shapes", by label."""
    from repro_torch.configs.registry import get_config

    def keep(label, results):
        keep_shapes(rows, label, results)

    n_seq = N_FILLS[1] + MAX_NEW + 8
    with shapes_of(get_config(STABLELM), N_FILLS, n_seq, G_PAGE):
        keep(f"{STABLELM}, d=160 G=4",
             [check_decode_attn(dev, gen), *check_decode_attn_paged(dev, gen),
              check_kv_write(dev, gen),
              check_kv_scatter(dev, gen, length=N_FILLS[1])])
    with shapes_of(get_config(GRANITE), N_FILLS, n_seq, G_PAGE):
        cases = exit_cases(dev, gen)
        keep(f"{GRANITE}, d=64 G=3, V=49155",
             [check_decode_attn(dev, gen), *check_decode_attn_paged(dev, gen),
              check_exit_quant(dev, gen, cases), check_exit_heads(dev, gen)])
        del cases
        keep(f"{GRANITE}, V=49155 B=40", [check_exit_quant_rows(dev, gen, 40)])
    with shapes_of(get_config(OLMOE), N_FILLS, n_seq, G_PAGE):
        cases = exit_cases(dev, gen)
        keep(f"{OLMOE}, V=50304",
             [check_exit_quant(dev, gen, cases), check_exit_heads(dev, gen)])
        del cases
        keep(f"{OLMOE}, V=50304 B=24", [check_exit_quant_rows(dev, gen, 24)])
    with shapes_of(tiny_ee_config(), (40, 200), 256, PAGE_SIZE):
        keep("tiny-ee, d=32 G=2", check_decode_attn_paged(dev, gen))
    torch.cuda.empty_cache()


def same_run(a, b) -> bool:
    """Streams, counters and virtual-time results of two runs."""
    fields = ("exits_l1", "exits_l2", "cloud_requests", "upload_bytes",
              "deadline_misses", "fallbacks")
    return (a["tokens"] == b["tokens"]
            and all(getattr(a["stats"], f) == getattr(b["stats"], f)
                    for f in fields)
            and a["virtual_time"] == b["virtual_time"]
            and a["late_drops"] == b["late_drops"]
            and a["channel_stats"] == b["channel_stats"])


def knee_channels(n, batched):
    """n ``AsyncSimChannel``s on a WiFi-class link sharing one cloud
    service point: batching (window 4 ms, up to n a step) or FIFO; 8 ms a
    service step."""
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel, CloudServicePoint
    svc = (CloudServicePoint(0.008, batch_window_s=0.004, max_batch=n)
           if batched else CloudServicePoint(0.008))
    return [AsyncSimChannel(NetworkParams(**KNEE_NET), service=svc)
            for _ in range(n)], svc


def check_small_adaptive(cpu, gpu, prompts, theta) -> None:
    """Phase 5's paths (c) and (e) on the small model: deadline misses
    with the standalone fallback, and N engines behind one batched cloud
    against N engines with a cloud each; the card equals the CPU, and
    batched equals FIFO."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.transport import ScriptedChannel
    from repro_torch.serving.engine import ServingSystem
    ccfg = CollmConfig(theta=theta, kv_layout="paged")
    runs = [ServingSystem(m, ccfg).generate(
        prompts, 16, num_slots=3, tick_time_s=0.005, fallback_after=2,
        channel=ScriptedChannel([0.5], deadline_s=0.02)) for m in (cpu, gpu)]
    st = runs[1]["stats"]
    print(f"small model deadline misses + fallback: card == CPU: "
          f"{same_run(*runs)} (misses {st.deadline_misses}, fallbacks "
          f"{st.fallbacks}, late drops {runs[1]['late_drops']})")
    check(same_run(*runs) and st.deadline_misses > 0 and st.fallbacks > 0,
          "small model under deadline misses: the card differs from the CPU")
    # θ = 1: every token is a cloud request, so the engines' requests
    # meet in the batcher's waves
    ccfg = CollmConfig(theta=1.0, kv_layout="paged")
    multi = {}
    for batched in (True, False):
        for name, m in (("cpu", cpu), ("card", gpu)):
            chans, _ = knee_channels(len(prompts), batched)
            multi[batched, name] = ServingSystem(m, ccfg).generate_multi(
                prompts, 16, cloud_batch=batched, channels=chans,
                tick_time_s=0.01)
    same = [same_run(multi[b, "card"], multi[b, "cpu"]) for b in (True,
                                                                   False)]
    eq = multi[True, "card"]["tokens"] == multi[False, "card"]["tokens"]
    row = multi[True, "card"]["batcher"]
    print(f"small model generate_multi: card == CPU batched {same[0]}, "
          f"FIFO {same[1]}; batched == FIFO: {eq}; batcher {row}")
    check(all(same) and eq and row["mean_batch"] > 1,
          "small model generate_multi: card, CPU, batched and FIFO differ")


def same_spec_run(a, b) -> bool:
    """``same_run`` plus the draft and preemption counters and the page
    pool's statistics."""
    fields = ("draft_tokens", "accepted_tokens", "spec_rewinds",
              "preemptions")
    return (same_run(a, b)
            and all(getattr(a["stats"], f) == getattr(b["stats"], f)
                    for f in fields)
            and a["stats"].accept_lens == b["stats"].accept_lens
            and a.get("pool_stats") == b.get("pool_stats")
            and a.get("oops") == b.get("oops"))


def check_small_spec_preempt(cpu, gpu, prompts, theta) -> None:
    """Phase 6's paths on the small model: speculative drafts of 1 and 4
    tokens on dense and paged KV, drafts whose replies miss their
    deadline, recompute and swap preemption (float32 and int8 pages) in a
    pool too small for the streams plus a forced preemption, and drafts in
    flight across preemptions behind the ``CloudBatcher``; the card
    (kernels) equals the CPU (plain versions) in each."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel, ScriptedChannel
    from repro_torch.serving.engine import ServingSystem
    channels = {
        "sim": (lambda: AsyncSimChannel(NetworkParams(), service_s=0.008),
                0.01),
        "miss": (lambda: ScriptedChannel([0.5], deadline_s=0.02), 0.005)}
    pool = dict(num_pages=7, preempt_schedule=[(3, 0)])
    cases = {
        "spec k=1 dense": (dict(speculative=True), "sim", {}),
        "spec k=4 dense": (dict(speculative=True, spec_k=4), "sim", {}),
        "spec k=1 paged": (dict(speculative=True, kv_layout="paged"), "sim",
                           {}),
        "spec k=4 paged": (dict(speculative=True, spec_k=4,
                                kv_layout="paged"), "sim", {}),
        "spec k=4 paged, every token drafted": (
            dict(speculative=True, spec_k=4, kv_layout="paged", theta=1.0),
            "sim", {}),
        "spec k=4 misses": (dict(speculative=True, spec_k=4,
                                 kv_layout="paged"), "miss", {}),
        "recompute": (dict(kv_layout="paged", preemption="recompute"), None,
                      pool),
        "swap": (dict(kv_layout="paged", preemption="swap"), None, pool),
        "int8 swap": (dict(kv_layout="paged", kv_dtype="int8",
                           preemption="swap"), None, pool)}
    for name, (ckw, ch, kw) in cases.items():
        runs = []
        for m in (cpu, gpu):
            call = dict(kw)
            if ch is not None:
                mk, tick = channels[ch]
                call.update(channel=mk(), tick_time_s=tick)
            runs.append(ServingSystem(m, CollmConfig(**{"theta": theta,
                                                        **ckw})
                                      ).generate(prompts, 16, num_slots=3,
                                                 **call))
        st = runs[1]["stats"]
        ok = same_spec_run(*runs)
        print(f"small model {name}: card == CPU: {ok} (drafts "
              f"{st.draft_tokens}, accepted {st.accepted_tokens}, rewinds "
              f"{st.spec_rewinds}, misses {st.deadline_misses}, preemptions "
              f"{st.preemptions})")
        moved = (st.preemptions >= 2 if "preemption" in ckw
                 else st.draft_tokens > 0)
        check(ok and moved, f"small model {name}: the card differs from the "
              f"CPU, or the path did not run")
    ccfg = CollmConfig(theta=theta, kv_layout="paged", speculative=True,
                       spec_k=4, preemption="swap")
    runs = [ServingSystem(m, ccfg).generate_multi(
        prompts, 16, cloud_batch=True, tick_time_s=0.01,
        channels=[ScriptedChannel([0.05], deadline_s=float("inf"))
                  for _ in prompts],
        preempt_schedules=[[(5, 0)], None, [(7, 0)], None])
        for m in (cpu, gpu)]
    st, row = runs[1]["stats"], runs[1]["batcher"]
    ok = (same_spec_run(*runs) and row == {**runs[0]["batcher"],
                                           "cloud_time_s": row["cloud_time_s"]})
    print(f"small model generate_multi, drafts in flight across swap "
          f"preemptions: card == CPU: {ok} (preemptions {st.preemptions}, "
          f"drafts {st.draft_tokens}, batcher swaps {row['swaps']})")
    check(ok and st.preemptions == 2 and st.draft_tokens > 0,
          "small model drafts across preemptions: the card differs")


PREFIX_FIELDS = ("prefix_hit_tokens", "cow_copies", "prefill_chunks",
                 "slo_total", "slo_met")


def same_prefix_run(a, b) -> bool:
    """``same_spec_run`` plus the prefix and SLO counters, the virtual
    time to first token and inter-token gaps, and the adaptive row."""
    return (same_spec_run(a, b)
            and all(getattr(a["stats"], f) == getattr(b["stats"], f)
                    for f in PREFIX_FIELDS)
            and a["stats"].ttft_s == b["stats"].ttft_s
            and a["stats"].token_lat_s == b["stats"].token_lat_s
            and a.get("adaptive") == b.get("adaptive"))


def shared_prompts(n, prefix, lo, hi, vocab, seed):
    """``n`` prompts behind one common ``prefix``-token system prompt,
    each with ``lo``-``hi`` tokens of its own, then exact copies of the
    first two (``n + 2`` in all)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, prefix)
    prompts = [np.concatenate([pre, rng.integers(0, vocab,
                                                 rng.integers(lo, hi + 1))])
               for _ in range(n)]
    return prompts + [prompts[0].copy(), prompts[1].copy()]


def check_small_prefix_fleet(cpu, gpu, theta) -> None:
    """Phase 7's paths on the small model: chunked prefill, prefix sharing
    (float32 and int8 pages), a second wave of terminal hits, sharing with
    swap preemption and cache eviction in a small pool, sharing behind
    the ``CloudBatcher``, open-loop arrivals with SLOs, and adaptive
    control; the card (kernels) equals the CPU (plain versions) in each,
    and each path moves its counter."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel
    from repro_torch.core.workload import ArrivalProcess, arrival_times
    from repro_torch.serving.adaptive import AdaptiveConfig, ResumeCostModel
    from repro_torch.serving.engine import ServingSystem
    prompts = shared_prompts(6, 40, 3, 20, 500, 7)
    arr = arrival_times(ArrivalProcess(rate=20.0), len(prompts), seed=0)
    chunked = dict(kv_layout="paged", chunked_prefill=True)
    share = dict(chunked, prefix_share=True)
    sim = dict(tick_time_s=0.01, arrivals=arr, slo_ttft_s=0.5,
               slo_tpot_s=0.05)
    cases = {
        "chunked": (chunked, {}, "prefill_chunks"),
        "shared": (share, {}, "prefix_hit_tokens"),
        "shared int8": (dict(share, kv_dtype="int8"), {},
                        "prefix_hit_tokens"),
        "shared, swap in 9 pages": (dict(share, preemption="swap"),
                                    dict(num_pages=9), "prefix_evictions"),
        "arrivals + SLOs": (chunked, sim, "slo_total"),
        "adaptive, swap": (dict(chunked, preemption="swap"),
                           dict(sim, adaptive=AdaptiveConfig(),
                                resume_cost=ResumeCostModel()),
                           "slo_total")}
    for name, (ckw, kw, counter) in cases.items():
        runs, systems = [], []
        for m in (cpu, gpu):
            call = dict(kw)
            if "arrivals" in call:
                call["channel"] = AsyncSimChannel(NetworkParams(),
                                                  service_s=0.008)
            systems.append(ServingSystem(m, CollmConfig(theta=theta, **ckw)))
            runs.append(systems[-1].generate(prompts, 16, num_slots=3,
                                             **call))
        if name == "shared":
            # a second wave through the same systems: terminal hits only
            for sysm, r in zip(systems, runs):
                r["wave2"] = sysm.generate(prompts[:3], 16, num_slots=3)
        st = runs[1]["stats"]
        moved = (runs[1]["pool_stats"][counter] if counter ==
                 "prefix_evictions" else getattr(st, counter))
        ok = same_prefix_run(*runs)
        print(f"small model {name}: card == CPU: {ok} (chunks "
              f"{st.prefill_chunks}, prefix hits {st.prefix_hit_tokens}, "
              f"cow {st.cow_copies}, {counter} {moved}, slo "
              f"{st.slo_met}/{st.slo_total}, adaptive "
              f"{runs[1].get('adaptive')})")
        check(ok and moved > 0, f"small model {name}: the card differs "
              f"from the CPU, or the path did not run")
        if name == "shared":
            w = [r["wave2"] for r in runs]
            check(same_prefix_run(*w) and w[1]["stats"].prefill_chunks == 0
                  and w[1]["tokens"] == runs[1]["tokens"][:3],
                  "small model second wave: not all terminal hits")
    multi = [ServingSystem(m, CollmConfig(theta=theta, **share))
             .generate_multi(prompts, 16, n_engines=4) for m in (cpu, gpu)]
    row = multi[1]["batcher"]
    ok = (same_prefix_run(*multi)
          and row == {**multi[0]["batcher"],
                      "cloud_time_s": row["cloud_time_s"]})
    print(f"small model shared behind the batcher: card == CPU: {ok} "
          f"(batcher {row})")
    check(ok and row["prefix_hit_tokens"] > 0,
          "small model sharing behind the batcher: the card differs")


def keep_shapes(rows, label, results) -> None:
    """Keep each result beside the row of its kernel, under "shapes"."""
    by_name = {r["name"]: r for r in rows}
    for g in results:
        by_name[g["name"]].setdefault("shapes", {})[label] = g


def check_recurrent_kernel_shapes(dev, gen, rows) -> None:
    """Phase 2 again at phase 11's shapes: zamba2-1.2b's shared attention
    block (H = KV = 32 heads of d = 64, G = 1: the ring kernel at B = 1
    and 8 slots, the paged kernel on bf16 and int8 pages of 128 tokens at
    8 slots and B = 1, the int8 page writes with a 2048-token scatter) and
    its 32000 x 2048 unembedding, and xlstm-350m's tied 50304 x 1024 one
    (``exit_heads`` at R = 2 and 16, ``exit_quant`` at B = 1 and 8).  Each
    result is kept beside the ee-llm-7b row of its kernel under "shapes",
    by label."""
    from repro_torch.configs.registry import get_config
    n_seq = N_FILLS[1] + MAX_NEW + 8
    with shapes_of(get_config(ZAMBA2), N_FILLS, n_seq, G_PAGE):
        cases = exit_cases(dev, gen)
        keep_shapes(rows, f"{ZAMBA2}, d=64 G=1 KV=32, V=32000",
                    [check_decode_attn(dev, gen),
                     *check_decode_attn_paged(dev, gen),
                     check_kv_write(dev, gen),
                     check_kv_scatter(dev, gen, length=N_FILLS[1]),
                     check_exit_quant(dev, gen, cases),
                     check_exit_heads(dev, gen)])
        del cases
    with shapes_of(get_config(XLSTM), N_FILLS, n_seq, G_PAGE):
        cases = exit_cases(dev, gen)
        keep_shapes(rows, f"{XLSTM}, V=50304 d=1024",
                    [check_exit_quant(dev, gen, cases),
                     check_exit_heads(dev, gen)])
        del cases
    torch.cuda.empty_cache()


def check_prefixed_kernel_shapes(dev, gen, rows) -> None:
    """Phase 2 again at phase 12's shapes: whisper-medium's self-attention
    (H = KV = 16 heads of d = 64, G = 1, a ring of its prompt and new
    tokens) and its cross-attention (the ring kernel over 1500 encoder
    keys, every one valid), its untied 51865 x 1024 unembedding (an odd V)
    and its d = 1024 wire; paligemma-3b's ring at d = 256, G = 8 (H = 8
    over KV = 1), both paged variants there (a shape check: no path of
    phase 12 pages), its tied 257216 x 2048 unembedding and its d = 2048
    wire.  Each result is kept beside the ee-llm-7b row of its kernel
    under "shapes", by label."""
    from repro_torch.configs.registry import get_config
    wcfg, pcfg = get_config(WHISPER), get_config(PALIGEMMA)
    with shapes_of(wcfg, N_FILLS, P_PROMPT[WHISPER] + P_NEW + 8, G_PAGE):
        keep_shapes(rows, f"{WHISPER} self, d=64 G=1",
                    [check_decode_attn(dev, gen)])
    with shapes_of(wcfg, N_FILLS, wcfg.encoder_seq, G_PAGE):
        cases = exit_cases(dev, gen)
        keep_shapes(rows, f"{WHISPER} cross, {wcfg.encoder_seq} keys; "
                    f"V=51865 d=1024",
                    [check_decode_attn(dev, gen),
                     check_quantize(dev, gen),
                     check_exit_quant(dev, gen, cases),
                     check_exit_heads(dev, gen)])
        del cases
    n_seq = pcfg.vision_tokens + P_PROMPT[PALIGEMMA] + P_NEW + 8
    with shapes_of(pcfg, N_FILLS, n_seq, G_PAGE):
        cases = exit_cases(dev, gen)
        keep_shapes(rows, f"{PALIGEMMA}, d=256 G=8; V=257216 d=2048",
                    [check_decode_attn(dev, gen),
                     *check_decode_attn_paged(dev, gen),
                     check_quantize(dev, gen),
                     check_exit_quant(dev, gen, cases),
                     check_exit_heads(dev, gen)])
        del cases
    torch.cuda.empty_cache()


def rank_config(cfg, model: int):
    """The shapes one rank of a model axis of ``model`` gives the kernels:
    its query and KV heads (``head_split``) and its vocabulary slice (the
    whole vocabulary where the axis does not divide it)."""
    from repro_torch.launch.sharding import Axis
    from repro_torch.models.attention import head_split
    s = head_split(cfg, Axis(0, model))
    v = cfg.vocab_size
    return dataclasses.replace(
        cfg, name=f"{cfg.name} rank of (1, {model})", n_heads=s.heads,
        n_kv_heads=s.kv_heads, head_dim=cfg.resolved_head_dim,
        vocab_size=v // model if v % model == 0 else v).validate()


def check_mesh_kernel_shapes(dev, gen, rows) -> None:
    """Phase 2 again at the shapes each rank of phase 14 gives the kernels:
    ee-llm-7b over (1, 2) (16 of 32 heads, G = 1, d = 128; the exit heads
    over a 16000 x 4096 slice), command-r-35b over (1, 2) (32 heads over
    4, G = 8, d = 128; a 128000 x 8192 slice) and tiny-ee-tp over (1, 4)
    (one head over one, d = 32): both attention kernels (128-token pages
    for the two full-width models, 16 for tiny-ee-tp), the int8 page
    writes of the rank's KV heads and, at full width, the exit kernels.
    Each result is kept beside the ee-llm-7b row of its kernel under
    "shapes", by label."""
    from repro_torch.configs.registry import get_config
    n_seq = N_FILLS[1] + MAX_NEW + 8
    for name in (CFG_NAME_14B, COMMAND_R):
        cfg = rank_config(get_config(name), 2)
        with shapes_of(cfg, N_FILLS, n_seq, G_PAGE):
            cases = exit_cases(dev, gen)
            keep_shapes(rows, f"{cfg.name}: {cfg.n_heads} heads over "
                        f"{cfg.n_kv_heads} of d={cfg.resolved_head_dim}; "
                        f"V={cfg.vocab_size} d={cfg.d_model}",
                        [check_decode_attn(dev, gen),
                         *check_decode_attn_paged(dev, gen),
                         check_kv_write(dev, gen),
                         check_exit_quant(dev, gen, cases),
                         check_exit_heads(dev, gen)])
            del cases
    cfg = rank_config(tiny_ee_tp_config(), 4)
    with shapes_of(cfg, (40, 200), 256, PAGE_SIZE):
        keep_shapes(rows, f"{cfg.name}: 1 head over 1 of d=32",
                    [check_decode_attn(dev, gen),
                     *check_decode_attn_paged(dev, gen),
                     check_kv_write(dev, gen)])
    check_family_rank_shapes(dev, gen, rows)
    torch.cuda.empty_cache()


def check_family_rank_shapes(dev, gen, rows) -> None:
    """Phase 2 again at the shapes a rank of (1, 2) gives the kernels in
    phase 14 (d): paligemma-3b's ring at d = 256 with 4 query heads over
    its one KV head (G = 4) and its 128608 x 2048 vocabulary slice;
    zamba2-1.2b's shared block at 16 of 32 heads of d = 64 (the ring, both
    paged variants and the int8 page writes) and its 16000 x 2048 slice;
    whisper-medium's self-attention and its cross-attention over 1500
    encoder keys at 8 of 16 heads of d = 64 (its odd vocabulary stays
    whole on every rank: phase 12's rows); xlstm-350m's 25152 x 1024
    slice.  ``exit_heads`` also holds its max logit, which the ranks
    merge on, to the plain version's."""
    from repro_torch.configs.registry import get_config
    n_seq = N_FILLS[1] + MAX_NEW + 8
    pcfg = rank_config(get_config(PALIGEMMA), 2)
    with shapes_of(pcfg, N_FILLS, pcfg.vision_tokens + P_PROMPT[PALIGEMMA]
                   + P_NEW + 8, G_PAGE):
        keep_shapes(rows, f"{pcfg.name}: d=256 G=4; V={pcfg.vocab_size} "
                    f"d=2048", [check_decode_attn(dev, gen),
                                check_exit_heads(dev, gen)])
    zcfg = rank_config(get_config(ZAMBA2), 2)
    with shapes_of(zcfg, N_FILLS, n_seq, G_PAGE):
        keep_shapes(rows, f"{zcfg.name}: d=64 G=1 KV=16; V={zcfg.vocab_size}"
                    f" d=2048", [check_decode_attn(dev, gen),
                                 *check_decode_attn_paged(dev, gen),
                                 check_kv_write(dev, gen),
                                 check_exit_heads(dev, gen)])
    wcfg = rank_config(get_config(WHISPER), 2)
    with shapes_of(wcfg, N_FILLS, P_PROMPT[WHISPER] + P_NEW + 8, G_PAGE):
        keep_shapes(rows, f"{wcfg.name} self: d=64 G=1 KV=8",
                    [check_decode_attn(dev, gen)])
    with shapes_of(wcfg, N_FILLS, wcfg.encoder_seq, G_PAGE):
        keep_shapes(rows, f"{wcfg.name} cross: {wcfg.encoder_seq} keys, d=64"
                    f" G=1 KV=8", [check_decode_attn(dev, gen)])
    xcfg = rank_config(get_config(XLSTM), 2)
    with shapes_of(xcfg, N_FILLS, n_seq, G_PAGE):
        keep_shapes(rows, f"{xcfg.name}: V={xcfg.vocab_size} d=1024",
                    [check_exit_heads(dev, gen)])


def prefixed_small(dev, arch):
    """A reduced whisper or paligemma in float32 from one seed, on the card
    and on the CPU: 4 decoder layers with exits 1 and 2, d_model 256,
    whisper 2 encoder layers over 64 frames, paligemma 16 patches (4 heads
    over 1)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=4),
                              exit_layers=(1, 2),
                              encoder_layers=min(2, get_config(
                                  arch).encoder_layers)).validate()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def check_small_prefixed(dev) -> None:
    """Phase 12's path on reduced whisper and paligemma: one row and three
    (the masked cloud step) through ``prefixed_stream`` in the cloud,
    collm at θ = 1 with a float32 wire, at a split θ with a float16 wire,
    at θ = 0 with an int8 wire, and standalone.  The card's streams and
    counters equal the CPU's, and at θ = 1 the collm stream equals the
    cloud's."""
    for arch in (WHISPER, PALIGEMMA):
        cpu, gpu = prefixed_small(dev, arch)
        for rows in (1, 3):
            batch = prefixed_batch(cpu.cfg, rows, 12, SEED + rows)
            full = prefixed_stream(cpu, batch, "collm", 1.0, "float32", 16)
            theta = split_confidence(full["confs"])
            for mode, th, wire in (("cloud", 1.0, "float32"),
                                   ("collm", 1.0, "float32"),
                                   ("collm", theta, "float16"),
                                   ("collm", 0.0, "int8"),
                                   ("standalone", theta, "float16")):
                want = prefixed_stream(cpu, batch, mode, th, wire, 16)
                got = prefixed_stream(gpu, {k: v.to(dev) for k, v in
                                            batch.items()}, mode, th, wire,
                                      16)
                same = all(got[k] == want[k] for k in PREFIXED_COUNTS)
                print(f"small {arch} {rows} rows {mode} theta={th:.6g} "
                      f"{wire}: card == CPU: {same} (exits "
                      f"{got['exits_l1']}/{got['exits_l2']}, cloud "
                      f"{got['cloud_requests']})")
                check(same, f"small {arch} {mode}: the card's stream "
                      "differs from the CPU's")
                if mode == "cloud":
                    cloud = got["tokens"]
                elif th == 1.0:
                    check(got["tokens"] == cloud, f"small {arch}: collm at "
                          "theta=1 float32 differs from cloud")


def print_time(label, r) -> None:
    lib = r["library_ms"]
    print(f"time {label}: {r['ms'] * 1e3:.2f} us (bound "
          f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}"
          f"{'; %.0f bytes' % r['bytes'] if 'bytes' in r else ''}; plain "
          f"{r['plain_ms'] * 1e3:.2f} us; library "
          f"{'-' if lib is None else '%.2f us' % (lib * 1e3)})")


SHAPE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
SUB_SHAPES = ("b8", "b1", "chunk", "window", "r16")


def shape_rows(r) -> list:
    """Every shape a kernel's row holds besides its own (gemma3-12b's, the
    "shapes" of later models, and their B=8, B=1, chunk, window and R=16
    variants) as flat records for the kernel table's JSON line."""
    out = []

    def add(label, g):
        out.append(dict({k: g[k] for k in SHAPE_KEYS if k in g},
                        shape=label))
        for sub in SUB_SHAPES:
            if sub in g:
                add(f"{label}, {sub.upper()}", g[sub])

    for sub in SUB_SHAPES:
        if sub in r:
            add(f"{CFG.name}, {sub.upper()}", r[sub])
    if "gemma" in r:
        add(GEMMA, r["gemma"])
    for label, g in r.get("shapes", {}).items():
        add(label, g)
    return out


@contextlib.contextmanager
def shapes_of(cfg, fills, max_seq, page_size):
    """Run phase 2's checks at another model's shapes: ``CFG``, the paged
    fills, the ring length they read and the page size (a prefill chunk's
    length too), swapped for the block."""
    global CFG, FILLS, MAX_SEQ, PAGE_SIZE
    saved = CFG, FILLS, MAX_SEQ, PAGE_SIZE
    CFG, FILLS, MAX_SEQ, PAGE_SIZE = cfg, fills, max_seq, page_size
    try:
        yield
    finally:
        CFG, FILLS, MAX_SEQ, PAGE_SIZE = saved


def wrapped_rings(b, dtype, dev, gen, size, lag=0):
    """(q, k, v, pos, cur) of gemma3's local layers: a ``size``-slot ring
    (the window) that has wrapped, position p in slot p % size, each row
    at its own position past the window.  ``lag``: each row's query sits
    that many positions past its newest key, so that a window of ``size``
    drops the ``lag`` oldest keys (at ``lag`` 0 every key is inside)."""
    h, kv, d = CFG.n_heads, CFG.n_kv_heads, CFG.resolved_head_dim
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, size, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, size, kv, d), generator=gen, device=dev).to(dtype)
    cur = torch.randint(size, 4 * size, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    p = (cur[:, None] - size + 1
         + torch.arange(size, dtype=torch.int32, device=dev))
    pos = torch.empty_like(p).scatter_(1, (p % size).long(), p)
    return q, k, v, pos, cur + lag


def check_window_ring(dev, gen) -> dict:
    """The ring kernel over gemma3's local layers: a wrapped 1024-slot
    ring under its 1024-token window, against its plain version (float32
    and bf16, B = 1, 2 and 8), with the query at the newest key (every key
    inside the window, as a decode step reads it) and 100 positions past
    it (the window drops the 100 oldest keys); timed at B = 1 on 12 rings
    in turn (100 MB) beside its plain version and SDPA with the same
    mask."""
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    w = CFG.sliding_window
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, lag in ((1, 0), (2, 0), (SLOTS, 0), (2, 100), (SLOTS, 100)):
            args = wrapped_rings(b, dtype, dev, gen, w, lag=lag)
            want = decode_attn_ref(*args, window=w)
            e = max_err(decode_attn(*args, window=w), want)
            tol = attn_tol(dtype, want)
            print(f"decode_attn {str(dtype)[6:]} B={b} wrapped ring of {w} "
                  f"window={w} query {lag} past the newest key: "
                  f"max|err|={e:.3g} (tol {tol:.3g})")
            check(e <= tol, "decode_attn disagrees with its plain version "
                  "over a wrapped window ring")
            err = max(err, e)
    sets = [wrapped_rings(1, torch.bfloat16, dev, gen, w) for _ in range(12)]
    ms = device_ms(lambda i: decode_attn(*sets[i % 12], window=w))
    plain = device_ms(lambda i: decode_attn_ref(*sets[i % 12], window=w))
    h, kv, d = CFG.n_heads, CFG.n_kv_heads, CFG.resolved_head_dim
    sdpa = [(q.view(1, h, 1, d), k.transpose(1, 2).contiguous(),
             v.transpose(1, 2).contiguous(),
             ((pos >= 0) & (pos <= cur[:, None])
              & (cur[:, None] - pos < w))[:, None, None, :])
            for q, k, v, pos, cur in sets]
    lib = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        *sdpa[i % 12][:3], attn_mask=sdpa[i % 12][3], enable_gqa=True))
    q, k, _, pos, cur = sets[0]
    n_valid = int(((pos >= 0) & (pos <= cur[:, None])
                   & (cur[:, None] - pos < w)).sum())
    nbytes = (2 * q.numel() * q.element_size() + pos.numel() * 4 + 4
              + 2 * n_valid * kv * d * k.element_size())
    bnd, by = bound_ms(nbytes, 4 * h * n_valid * d, torch.bfloat16)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by, bytes=nbytes, max_abs_err=err)


def check_gemma_kernels(dev, gen, rows) -> None:
    """Phase 2 again at gemma3-12b's shapes as phase 8 serves them (H = 16
    over KV = 8 heads of d = 256, d_model 3840, V = 262144, 128-token
    pages and prefill chunks): the ring kernel over a global layer's
    4136-slot ring and a local layer's wrapped window ring, both paged
    variants at 8 slots with fills of 512-4096 keys, without a window (the
    global layers) and under the 1024-token one (the local layers; d = 256
    is new to the paged kernel), the int8 page writes at KV = 8, d = 256
    with a 4096-token scatter, the wire quantizer at d = 3840, both exit kernels
    over the 262144 x 3840 tied unembedding.  Each result is kept beside
    the ee-llm-7b row of its kernel under "gemma"."""
    from repro_torch.configs.registry import get_config
    gcfg = get_config(GEMMA)
    with shapes_of(gcfg, G_FILLS, G_PROMPT + MAX_NEW + 8, G_PAGE):
        cases = exit_cases(dev, gen)
        grows = [check_decode_attn(dev, gen),
                 *check_decode_attn_paged(dev, gen),
                 check_exit_head(dev, gen, cases), check_quantize(dev, gen),
                 check_kv_write(dev, gen),
                 check_kv_scatter(dev, gen, length=G_PROMPT),
                 check_exit_quant(dev, gen, cases),
                 check_exit_heads(dev, gen)]
        del cases
        window = check_window_ring(dev, gen)
    for r, g in zip(rows, grows):
        check(r["name"] == g["name"], "phase 2 rows out of order")
        r["gemma"] = g
    rows[0]["gemma"]["window"] = window
    torch.cuda.empty_cache()


def gemma_small(dev):
    """A reduced gemma3 (8 layers, exits after 3 and 6, a 32-token window
    over 5 of every 6 layers, d = 64 heads) in float32 from one seed, on
    the card and on the CPU, and prompts longer than the window."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced(get_config(GEMMA), n_layers=8),
                              exit_layers=(3, 6)).validate()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(30 + i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((41, 80, 57, 100))]
    return cpu, gpu, prompts


def check_small_gemma(dev) -> None:
    """Phase 8's paths on a reduced gemma3: banded prefill in the local
    layers and the windowed ring and paged kernels, through
    ``generate_sequential`` (collm at a split θ), ``generate`` on dense,
    paged float32 and int8 pages, chunked prefill, and the two-tier
    runtime on two streams of the card (θ = 1.1 float32, and the split θ
    with float16 and a sliced prompt upload, int8).  The card's streams
    (and counters, wire bytes) equal the CPU's."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.disagg import TwoTierRuntime
    from repro_torch.serving.engine import ServingSystem
    cpu, gpu, prompts = gemma_small(dev)
    full = ServingSystem(cpu, CollmConfig(theta=1.0)).generate_sequential(
        prompts, 16)
    theta = split_theta(full["stats"])
    for label, kw in (("sequential", {}), ("dense", dict(kv_layout="dense")),
                      ("paged", dict(kv_layout="paged")),
                      ("paged int8", dict(kv_layout="paged",
                                          kv_dtype="int8")),
                      ("chunked", dict(kv_layout="paged",
                                       chunked_prefill=True))):
        ccfg = CollmConfig(theta=theta, **kw)
        want, got = (ServingSystem(m, ccfg).generate_sequential(prompts, 16)
                     if label == "sequential" else
                     ServingSystem(m, ccfg).generate(prompts, 16, num_slots=3)
                     for m in (cpu, gpu))
        same = same_counts(got, want)
        print(f"small gemma3 {label}: card == CPU: {same} (exits "
              f"{got['stats'].exits_l1}/{got['stats'].exits_l2}, cloud "
              f"{got['stats'].cloud_requests})")
        check(same, f"small gemma3 {label}: the card's run differs from the "
              "CPU's")
    for th, wire, chunk in ((1.1, "float32", 0), (theta, "float16", 16),
                            (theta, "int8", 0)):
        runs = []
        for m in (cpu, gpu):
            rt = TwoTierRuntime(m, CollmConfig(theta=th, wire_format=wire),
                                m.device, m.device)
            rt.build()
            runs.append(rt.decode(prompts[1], 16, max_seq=128,
                                  upload_chunk=chunk))
        same = (runs[1][0] == runs[0][0]
                and runs[1][1]["wire_bytes"] == runs[0][1]["wire_bytes"])
        print(f"small gemma3 two-tier theta={th:.6g} {wire} upload_chunk="
              f"{chunk}: card == CPU: {same} (wire {runs[1][1]['wire_bytes']}"
              f" B)")
        check(same, "small gemma3 two-tier: the card differs from the CPU")


# ---------------------------------------------------------------------------
# phase 3: ee-llm-7b through the serving loop
# ---------------------------------------------------------------------------
def kernel_ops() -> dict:
    """Each kernel's wrapper; ``wrapper.launches`` counts its launches."""
    from repro_torch.kernels.decode_attn.ops import (decode_attn,
                                                     decode_attn_paged,
                                                     decode_attn_paged_int8)
    from repro_torch.kernels.exit_head.ops import exit_head, exit_heads
    from repro_torch.kernels.exit_quant.ops import exit_quant
    from repro_torch.kernels.quantize.ops import (quantize_int8,
                                                  quantize_kv_scatter,
                                                  quantize_kv_write)
    return {"decode_attn": decode_attn,
            "decode_attn_paged": decode_attn_paged,
            "decode_attn_paged_int8": decode_attn_paged_int8,
            "exit_head": exit_head, "quantize": quantize_int8,
            "quantize_kv_write": quantize_kv_write,
            "quantize_kv_scatter": quantize_kv_scatter,
            "exit_quant": exit_quant, "exit_heads": exit_heads}


EXIT_KERNELS = ("exit_head", "exit_heads", "exit_quant")
EDGE_TICKS = ("edge_step", "edge_step_masked", "standalone_step",
              "edge_prefill", "edge_prefill_padded", "edge_prefill_chunk")


@contextlib.contextmanager
def edge_ticks():
    """Counts the edge ticks (``CoLLM``'s edge decode steps and prefills,
    each of which decides its exits) made while open: yields a one-element
    list that holds the count."""
    from repro_torch.core.collm import CoLLM
    n = [0]
    saved = {name: getattr(CoLLM, name) for name in EDGE_TICKS}

    def counted(fn):
        def wrapped(self, *a, **kw):
            n[0] += 1
            return fn(self, *a, **kw)
        return wrapped

    for name, fn in saved.items():
        setattr(CoLLM, name, counted(fn))
    try:
        yield n
    finally:
        for name, fn in saved.items():
            setattr(CoLLM, name, fn)


def exits_per_tick(launched: dict, ticks: int) -> str:
    """Exit-kernel launches per edge tick of a run ('-' without ticks)."""
    n = sum(launched[k] for k in EXIT_KERNELS)
    return f"{n / ticks:.2f}" if ticks else "-"


def serve(model, prompts, mode, theta, wire, backfill=False,
          max_new=MAX_NEW):
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    system = ServingSystem(model, CollmConfig(theta=theta, wire_format=wire,
                                              backfill=backfill))
    before = {n: op.launches for n, op in kernel_ops().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with edge_ticks() as ticks:
        r = system.generate_sequential(prompts, max_new, mode=mode)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {n: op.launches - before[n] for n, op in kernel_ops().items()}
    st = r["stats"]
    toks = np.asarray(r["tokens"])
    check(toks.shape == (len(prompts), max_new) and toks.min() >= 0
          and toks.max() < model.cfg.vocab_size, f"{mode}: bad tokens")
    print(f"serve {mode:10s} theta={theta:.6g} wire={wire:7s} "
          f"backfill={backfill!s:5s} tokens={st.tokens} "
          f"tokens/s={st.tokens / dt:.2f} wall={dt:.2f}s "
          f"exits_l1={st.exits_l1} exits_l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} upload_bytes={st.upload_bytes} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB "
          f"edge_ticks={ticks[0]} exit_launches/tick="
          f"{exits_per_tick(launched, ticks[0])} launches={launched}")
    r["wall_s"], r["peak_bytes"] = dt, torch.cuda.max_memory_allocated()
    return r


def check_fused_upload(model, prompts, theta) -> None:
    """fused_exit_upload (one exit_quant launch) on the l_ee1 hidden of a
    real decode tick equals edge_step's l_ee1 decision and int8 packet;
    that packet (from edge_step's exit_heads launch) equals
    ``transport.quantize``; each exit alone through ``exit_decision`` (one
    exit_head launch) equals edge_step's decision, bit for bit."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.transport import quantize
    from repro_torch.models.cache_tree import map_tensors
    from repro_torch.serving.engine import ServingSystem
    collm = ServingSystem(model, CollmConfig(theta=theta,
                                             wire_format="int8")).collm
    dev = model.device
    caches = collm.init_edge_cache(1, MAX_SEQ)
    batch = {"tokens": torch.as_tensor(prompts[0][None], device=dev)}
    dec, _, caches = collm.edge_prefill(batch, caches)
    tok = dec[collm.l_ee2].token[:, None].long()
    before = map_tensors(caches, torch.clone)
    _, exit_h, _ = model.decode_step(tok, caches, PROMPT_LEN, collm.edge_segs)
    # edge_step from the caches as they were before that step (a recurrent
    # state has advanced; ring slots are written again with the same K/V)
    out = collm.edge_step(tok, before, PROMPT_LEN)
    conf, ftok, pkt = collm.fused_exit_upload(exit_h[collm.l_ee1])
    ref = out.decisions[collm.l_ee1]
    same = (torch.equal(ftok, ref.token)
            and torch.equal(pkt["data"], out.upload["data"])
            and torch.equal(pkt["scale"], out.upload["scale"]))
    e = max_err(conf, ref.confidence)
    print(f"fused_exit_upload == edge_step (token, int8 packet): {same}; "
          f"max|conf err|={e:.3g} (tol 1e-6)")
    check(same and e <= 1e-6, "fused_exit_upload differs from edge_step")
    # 24 rows around the real hidden: two exit_quant launches, equal to
    # exit_decision's two exit_head launches and transport.quantize
    h1 = exit_h[collm.l_ee1]
    g24 = torch.Generator(device=dev)
    g24.manual_seed(SEED)
    h24 = (h1.float() + 0.1 * torch.randn((24,) + h1.shape[1:],
                                          generator=g24, device=dev)
           ).to(h1.dtype)
    conf24, tok24, pkt24 = collm.fused_exit_upload(h24)
    ref24 = collm.exit_decision(collm.l_ee1, h24[:, 0])
    wire24 = quantize(h24, "int8")
    same = (torch.equal(conf24, ref24.confidence)
            and torch.equal(tok24, ref24.token)
            and all(torch.equal(pkt24[k], wire24[k]) for k in wire24))
    print(f"fused_exit_upload at B=24 == exit_decision + "
          f"transport.quantize: {same}")
    check(same, "fused_exit_upload at B=24 differs")
    # edge_step's packet comes from its exit_heads launch: the wire's bytes
    wire = quantize(exit_h[collm.l_ee1], "int8")
    same = all(torch.equal(wire[k], out.upload[k]) for k in wire)
    print(f"edge_step int8 packet (exit_heads) == transport.quantize: {same}")
    check(same, "edge_step's int8 packet differs from transport.quantize")
    # each exit alone (one exit_head launch) == its share of the launch
    alone = {l: collm.exit_decision(l, h) for l, h in exit_h.items()}
    same = all(torch.equal(d.confidence, out.decisions[l].confidence)
               and torch.equal(d.token, out.decisions[l].token)
               for l, d in alone.items())
    print(f"exit_decision (exit_head) == edge_step's exit_heads decisions: "
          f"{same}")
    check(same, "exit_head's decision differs from exit_heads'")


# ---------------------------------------------------------------------------
# phase 4: ee-llm-7b through the batched engine
# ---------------------------------------------------------------------------
def serve_batched(model, prompts, label, mode, theta, wire, layout="paged",
                  kv_dtype="float32", backfill=False, page_size=PAGE_SIZE,
                  chunked=False, max_new=MAX_NEW):
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    system = ServingSystem(model, CollmConfig(
        theta=theta, wire_format=wire, backfill=backfill, kv_layout=layout,
        page_size=page_size, kv_dtype=kv_dtype, chunked_prefill=chunked))
    before = {n: op.launches for n, op in kernel_ops().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with edge_ticks() as ticks:
        r = system.generate(prompts, max_new, mode=mode, num_slots=SLOTS)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r["launched"] = {n: op.launches - before[n]
                     for n, op in kernel_ops().items()}
    sched = next(iter(system._schedulers.values()))
    r["paged_layers"] = sum("kp" in c.get("self", {})
                            for tree in sched._trees()
                            for layers in tree.values() for c in layers)
    r["kv_split"] = kv_split(sched._trees())
    st = r["stats"]
    check(all(len(t) == max_new and min(t) >= 0
              and max(t) < model.cfg.vocab_size for t in r["tokens"]),
          f"{label}: bad tokens")
    print(f"batched {label:18s} mode={mode:10s} theta={theta:.6g} "
          f"wire={wire:7s} tokens={st.tokens} tokens/s={st.tokens / dt:.2f} "
          f"wall={dt:.2f}s exits_l1={st.exits_l1} exits_l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} upload_bytes={st.upload_bytes}"
          f" kv_cache_bytes={sched.kv_cache_bytes()} peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}GiB "
          f"pool={r['pool_stats']} chunks={st.prefill_chunks} "
          f"edge_ticks={ticks[0]} exit_launches/tick="
          f"{exits_per_tick(r['launched'], ticks[0])} "
          f"launches={r['launched']}")
    r["wall_s"] = dt
    return r


def kv_split(trees) -> dict:
    """The bytes of cache trees: attention KV (with its scales and position
    markers) and recurrent state."""
    from repro_torch.models.cache_tree import cache_bytes
    kv = sum(cache_bytes(c["self"]) for tree in trees
             for layers in tree.values() for c in layers if "self" in c)
    return {"kv": kv, "state": sum(cache_bytes(t) for t in trees) - kv}


def phase4_prompts() -> list:
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, CFG.vocab_size, int(n))
            for n in rng.integers(128, 513, BATCH_PROMPTS)]


def serve_phase4(model, theta) -> dict:
    """12 prompts of 128-512 tokens through 8 slots (slots refill, pages
    are freed and reused), on dense and paged KV; returns the runs."""
    prompts = phase4_prompts()
    runs = {
        "dense": serve_batched(model, prompts, "dense", "collm", theta,
                               "float16", layout="dense"),
        "paged": serve_batched(model, prompts, "paged", "collm", theta,
                               "float16"),
        "paged+backfill": serve_batched(model, prompts, "paged+backfill",
                                        "collm", theta, "float16",
                                        backfill=True),
        "paged-int8": serve_batched(model, prompts, "paged-int8", "collm",
                                    theta, "float16", kv_dtype="int8"),
        "paged cloud": serve_batched(model, prompts, "paged cloud", "cloud",
                                     1.0, "float32"),
        "paged standalone": serve_batched(model, prompts, "paged standalone",
                                          "standalone", theta, "float16"),
        "paged theta=1": serve_batched(model, prompts, "paged theta=1",
                                       "collm", 1.0, "float32"),
    }
    check(runs["paged theta=1"]["tokens"] == runs["paged cloud"]["tokens"],
          "batched paged collm at theta=1 with a float32 wire differs from "
          "paged cloud")
    print("batched paged collm theta=1 float32 == paged cloud: True")
    for name, r in runs.items():
        launched = r["launched"]
        if name == "dense":
            check(launched["decode_attn"] > 0, "dense: decode_attn idle")
        elif name == "paged-int8":
            # one write per int8 attention call, one scatter per prefilled
            # paged layer of each admitted prompt
            check(launched["decode_attn_paged_int8"] > 0
                  and launched["quantize_kv_write"]
                  == launched["decode_attn_paged_int8"]
                  and launched["quantize_kv_scatter"]
                  == BATCH_PROMPTS * r["paged_layers"],
                  f"paged-int8: int8 page writes {launched} do not follow "
                  f"the int8 attention calls and {BATCH_PROMPTS} x "
                  f"{r['paged_layers']} prefilled layers")
        else:
            check(launched["decode_attn_paged"] > 0,
                  f"{name}: decode_attn_paged was not launched")
    for name in ("dense", "paged", "paged+backfill", "paged-int8"):
        st = runs[name]["stats"]
        check(st.exits_l1 + st.exits_l2 > 0 and st.cloud_requests > 0,
              f"{name}: the split theta gives no mix of exits and cloud "
              f"requests")
    for name in ("paged", "paged-int8"):
        print(f"agreement {name} vs dense: "
              f"{agreement(runs[name]['tokens'], runs['dense']['tokens'])}")
    return runs


def agreement(a, b) -> str:
    from repro_torch.serving.engine import token_agreement
    ags = [token_agreement(x, y) for x, y in zip(a, b)]
    same = sum(x == y for x, y in zip(a, b))
    return (f"{same}/{len(ags)} streams equal, mean LCS-F1 "
            f"{float(np.mean(ags)):.4f}")


# ---------------------------------------------------------------------------
# phase 5: ee-llm-7b through the paper's adaptive serving
# ---------------------------------------------------------------------------
def adaptive_run(label, fn):
    """Run ``fn`` (a ``generate`` or ``generate_multi``) synchronised, check
    its streams, print its host and virtual times and counters."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = r["stats"]
    check(all(len(t) == MAX_NEW and min(t) >= 0 and max(t) < CFG.vocab_size
              for t in r["tokens"]), f"{label}: bad tokens")
    print(f"adaptive {label:26s} tokens={st.tokens} tokens/s="
          f"{st.tokens / dt:.2f} wall={dt:.2f}s virtual_t="
          f"{r['virtual_time']:.6f}s exits_l1={st.exits_l1} "
          f"exits_l2={st.exits_l2} cloud_requests={st.cloud_requests} "
          f"deadline_misses={st.deadline_misses} fallbacks={st.fallbacks} "
          f"stall={st.stall_s:.6f}s overlap={st.overlap_s:.6f}s "
          f"late_drops={r['late_drops']} channel={r['channel_stats']}"
          + (f" batcher={r['batcher']}" if "batcher" in r else ""))
    return r


def serve_phase5(model, theta, paged) -> dict:
    """Phase 4's 12 prompts (8 for the multi-engine runs) on paged bf16 KV
    with a float16 wire: the channel options (a)-(c) and the sampler (d)
    at the split θ; one batched cloud for 8 edge clients against 8 clouds
    (e) and the batched cloud on dense KV with an int8 wire (f) at θ = 0.8,
    as ``tests/test_cloud_batcher.py`` sets up the knee (with random
    weights no token exits there: every token is a cloud request).
    ``paged`` is phase 4's paged bf16 run; returns run (a)."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel, ScriptedChannel
    from repro_torch.kernels.decode_attn.ops import decode_attn_paged
    from repro_torch.serving.cloud_batcher import CloudBatcher
    from repro_torch.serving.engine import ServingSystem
    prompts = phase4_prompts()
    ccfg = CollmConfig(theta=theta, wire_format="float16", kv_layout="paged",
                       page_size=PAGE_SIZE)

    def gen(label, **kw):
        system = ServingSystem(model, ccfg)
        return adaptive_run(label, lambda: system.generate(
            prompts, MAX_NEW, num_slots=SLOTS, **kw))

    def sim():
        return AsyncSimChannel(NetworkParams(), service_s=0.008)

    a = gen("(a) async, no deadline", channel=sim(), tick_time_s=0.01)
    check(a["tokens"] == paged["tokens"] and a["stats"].deadline_misses == 0,
          "(a): the async streams differ from phase 4's paged run")
    b = gen("(b) blocking", channel=sim(), tick_time_s=0.01, overlap=False)
    check(b["tokens"] == a["tokens"]
          and b["virtual_time"] >= a["virtual_time"],
          "(b): the blocking run differs from (a) or finished earlier")
    print(f"(a) == phase 4 paged: True; (b) == (a): True; virtual time "
          f"{a['virtual_time']:.6f} s overlapped, {b['virtual_time']:.6f} s "
          f"blocking")
    c = gen("(c) deadline + fallback", tick_time_s=0.005, fallback_after=2,
            channel=ScriptedChannel([0.5], deadline_s=0.02))
    st, n = c["stats"], len(prompts)
    served = st.exits_l1 + st.exits_l2 + st.cloud_requests
    sent = c["channel_stats"]["requests"]
    check(st.deadline_misses > 0 and st.fallbacks >= 1
          and c["late_drops"] == st.deadline_misses
          and st.tokens - n <= served <= st.tokens
          and (st.cloud_requests - n + st.deadline_misses <= sent
               <= st.cloud_requests + st.deadline_misses),
          "(c): misses, fallbacks, late drops or the accounting are off")
    d = [gen(f"(d) temperature, run {i}", sampler="temperature",
             temperature=0.8, top_k=50, seed=0) for i in (1, 2)]
    check(d[0]["tokens"] == d[1]["tokens"], "(d): one seed, two streams")
    print(f"(d) two runs from seed 0 equal: True; vs greedy (phase 4 "
          f"paged): {agreement(d[0]['tokens'], paged['tokens'])}")

    # (e): launches of paged attention inside the batcher's waves, i.e. on
    # its pooled cloud cache, counted by wrapping its wave step
    pool_launches = [0]
    wave = CloudBatcher._compute

    def counted(self, entries):
        before = decode_attn_paged.launches
        wave(self, entries)
        pool_launches[0] += decode_attn_paged.launches - before

    multi = {}
    knee = CollmConfig(theta=0.8, wire_format="float16", kv_layout="paged",
                       page_size=PAGE_SIZE)
    CloudBatcher._compute = counted
    try:
        for batched in (True, False):
            chans, svc = knee_channels(ENGINES, batched)
            system = ServingSystem(model, knee)
            multi[batched] = adaptive_run(
                f"(e) {'batched cloud' if batched else 'FIFO clouds'}",
                lambda: system.generate_multi(
                    prompts[:ENGINES], MAX_NEW, cloud_batch=batched,
                    channels=chans, tick_time_s=0.01))
            multi[batched]["busy_s"] = svc.busy_s
            multi[batched]["batches"] = svc.batches
    finally:
        CloudBatcher._compute = wave
    bat, fifo = multi[True], multi[False]
    print(f"(e) batched vs FIFO: virtual time {bat['virtual_time']:.6f} vs "
          f"{fifo['virtual_time']:.6f} s, service busy {bat['busy_s']:.6f} vs "
          f"{fifo['busy_s']:.6f} s in {bat['batches']} vs {fifo['batches']} "
          f"steps; paged attention launches on the batcher's pool "
          f"{pool_launches[0]}; streams "
          f"{agreement(fifo['tokens'], bat['tokens'])}")
    check(bat["batcher"]["mean_batch"] > 1,
          "(e): the batcher served no wave of more than one row")
    check(pool_launches[0] > 0,
          "(e): no paged attention launch on the batcher's pool")
    check(bat["virtual_time"] < fifo["virtual_time"]
          and bat["busy_s"] < fifo["busy_s"],
          "(e): the batched cloud is not below the FIFO clouds")
    dense = ServingSystem(model, CollmConfig(theta=0.8, wire_format="int8"))
    chans, _ = knee_channels(ENGINES, True)
    f = adaptive_run("(f) batched cloud, dense int8", lambda:
                     dense.generate_multi(prompts[:ENGINES], MAX_NEW,
                                          channels=chans, tick_time_s=0.01))
    check(f["batcher"]["mean_batch"] > 1, "(f): no batched wave")
    return a


# ---------------------------------------------------------------------------
# phase 6: ee-llm-7b with speculative drafting and preemption
# ---------------------------------------------------------------------------
class Meter:
    """Counts, during a ``with`` block, what a run's engines do out of
    sight of its result: every page pool and swap pool they create (pool
    high water, pages in use at the end; swap-pool high water in bytes),
    and the host seconds of the synchronising steps of this slice — a
    draft reply's token copy, and the page copies of a swap out and in
    (the engine's and the ``CloudBatcher``'s), and the resumes.  It wraps
    the classes' methods and restores them on exit."""

    def __init__(self):
        from repro_torch.core.paging import PagePool, SwapPool
        from repro_torch.serving.cloud_batcher import CloudBatcher
        from repro_torch.serving.engine import BatchScheduler
        self.pools, self.swaps = [], []
        self.swap_high = 0
        self.host = {}                       # name -> [calls, seconds]
        meter = self
        self._patches = []

        def register(cls, store):
            init = cls.__init__

            def wrapped(obj, *a, **kw):
                init(obj, *a, **kw)
                store.append(obj)
            self._patches.append((cls, "__init__", init, wrapped))

        def timed(cls, name):
            fn = getattr(cls, name)

            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    row = meter.host.setdefault(f"{cls.__name__}.{name}",
                                                [0, 0.0])
                    row[0] += 1
                    row[1] += time.perf_counter() - t0
            self._patches.append((cls, name, fn, wrapped))

        put = SwapPool.put

        def put_high(pool, key, snap):
            put(pool, key, snap)
            meter.swap_high = max(meter.swap_high, sum(
                SwapPool._nbytes(v) for sp in meter.swaps
                for v in sp._store.values()))
        register(PagePool, self.pools)
        register(SwapPool, self.swaps)
        self._patches.append((SwapPool, "put", put, put_high))
        for name in ("_draft_tokens", "_swap_out_slot", "_swap_in_slot",
                     "_resume"):
            timed(BatchScheduler, name)
        for name in ("swap_out", "swap_in"):
            timed(CloudBatcher, name)

    def __enter__(self):
        for cls, name, _, new in self._patches:
            setattr(cls, name, new)
        return self

    def __exit__(self, *exc):
        for cls, name, old, _ in self._patches:
            setattr(cls, name, old)


def phase6_run(label, fn, refs) -> dict:
    """Run ``fn`` (a ``generate`` or ``generate_multi``) synchronised under
    a ``Meter``; check its streams and print its line: tokens/s, exits and
    cloud requests, drafts, preemptions, resumes, swaps, pools, virtual
    time, launches per kernel, agreement with ``refs``."""
    ops = kernel_ops()
    before = {n: op.launches for n, op in ops.items()}
    with Meter() as meter:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    r["launched"] = {n: op.launches - before[n] for n, op in ops.items()}
    st = r["stats"]
    swaps = [sp.stats for sp in meter.swaps]
    r["swap_out"] = sum(s_.swapped_out for s_ in swaps)
    r["swap_bytes"] = sum(s_.bytes_out for s_ in swaps)
    r["swap_held"] = sum(s_.held for s_ in swaps)
    r["in_use"] = sum(p.pages_in_use() for p in meter.pools)
    high = [p.stats.high_water for p in meter.pools]
    r["resumes"] = meter.host.get("BatchScheduler._resume", [0])[0]
    check(all(min(t) >= 0 and max(t) < CFG.vocab_size for t in r["tokens"])
          and all(len(t) == MAX_NEW for t in r["tokens"]),
          f"{label}: a stream did not end at {MAX_NEW} tokens")
    host = {k: f"{v[0]}x {v[1]:.3f}s" for k, v in sorted(meter.host.items())}
    print(f"phase6 {label:28s} tokens={st.tokens} tokens/s="
          f"{st.tokens / dt:.2f} wall={dt:.2f}s virtual_t="
          f"{r['virtual_time']:.6f}s exits_l1={st.exits_l1} "
          f"exits_l2={st.exits_l2} cloud_requests={st.cloud_requests} "
          f"draft_tokens={st.draft_tokens} accepted={st.accepted_tokens} "
          f"rewinds={st.spec_rewinds} misses={st.deadline_misses} "
          f"preemptions={st.preemptions} oops={r.get('oops')} "
          f"resumes={r['resumes']} swaps={r['swap_out']} "
          f"swap_bytes={r['swap_bytes']} swap_high_water_bytes="
          f"{meter.swap_high} pool_high_water={high} pages_in_use_end="
          f"{r['in_use']} late_drops={r['late_drops']} host={host} "
          f"launches={r['launched']}"
          + (f" batcher={r['batcher']}" if "batcher" in r else ""))
    for name, ref in refs.items():
        print(f"  agreement {label} vs {name}: "
              f"{agreement(r['tokens'], ref['tokens'])}")
    return r


def serve_phase6(model, theta, paged, async_a) -> None:
    """Phase 4's 12 prompts, 8 slots, 32 new tokens at the split θ: (a)-(d)
    speculative drafting, (e)-(f) preemption, (g) 4 engines behind one
    ``CloudBatcher`` drafting with swap preemption.  ``paged`` is phase
    4's paged bf16 run, ``async_a`` phase 5 (a): the streams are compared
    with both and reported (bf16 GEMMs of another row count or a prefill
    in place of decode steps may flip near-tied argmaxes of random
    weights); the small float32 model of phase 2 holds them exactly."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel, ScriptedChannel
    from repro_torch.serving.engine import ServingSystem
    prompts = phase4_prompts()
    refs = {"phase 4 paged": paged, "phase 5 (a)": async_a}

    def gen(label, ccfg_kw, **kw):
        system = ServingSystem(model, CollmConfig(
            theta=theta, page_size=PAGE_SIZE, **ccfg_kw))
        r = phase6_run(label, lambda: system.generate(
            prompts, MAX_NEW, num_slots=SLOTS, **kw), refs)
        sched = next(iter(system._schedulers.values()))
        r["paged_layers"] = sum("kp" in c["self"] for tree in sched._trees()
                                for layers in tree.values() for c in layers)
        check(not sched._preempted, f"{label}: a stream stays preempted")
        return r

    def sim():
        return AsyncSimChannel(NetworkParams(), service_s=0.008)

    paged_bf16 = dict(kv_layout="paged", wire_format="float16")
    spec = dict(speculative=True, **paged_bf16)
    runs = {
        "a": gen("(a) spec k=1, paged", spec, channel=sim(),
                 tick_time_s=0.01),
        "b": gen(f"(b) spec k={SPEC_K}, paged", dict(spec, spec_k=SPEC_K),
                 channel=sim(), tick_time_s=0.01),
        "c": gen(f"(c) spec k={SPEC_K}, dense, int8 wire",
                 dict(speculative=True, spec_k=SPEC_K, wire_format="int8"),
                 channel=sim(), tick_time_s=0.01),
        "d": gen(f"(d) spec k={SPEC_K}, 20 ms misses",
                 dict(spec, spec_k=SPEC_K), tick_time_s=0.005,
                 channel=ScriptedChannel([0.5], deadline_s=0.02)),
        "e": gen("(e) recompute, int8 pages",
                 dict(kv_layout="paged", kv_dtype="int8",
                      preemption="recompute"),
                 num_pages=PREEMPT_PAGES, watermark=WATERMARK,
                 preempt_schedule=PREEMPT_SCHEDULE),
        "f": gen("(f) swap, bf16 pages",
                 dict(paged_bf16, preemption="swap"),
                 num_pages=PREEMPT_PAGES, watermark=WATERMARK,
                 preempt_schedule=PREEMPT_SCHEDULE),
    }
    chans, _ = knee_channels(SPEC_ENGINES, True)
    multi = ServingSystem(model, CollmConfig(
        theta=theta, page_size=PAGE_SIZE, spec_k=SPEC_K,
        preemption="swap", **spec))
    runs["g"] = phase6_run(
        f"(g) {SPEC_ENGINES} engines, k={SPEC_K}, swap", lambda:
        multi.generate_multi(prompts[:SPEC_ENGINES], MAX_NEW,
                             channels=chans, tick_time_s=0.01,
                             preempt_schedules=[[(4, 0)], None, [(9, 0)],
                                                None]),
        {n: {"tokens": r["tokens"][:SPEC_ENGINES]} for n, r in refs.items()})
    for key in "abcdg":
        st = runs[key]["stats"]
        check(0 < st.draft_tokens and st.accepted_tokens <= st.draft_tokens,
              f"phase 6 ({key}): no draft dispatched, or more accepted than "
              f"drafted")
    check(runs["d"]["stats"].deadline_misses > 0
          and runs["d"]["stats"].accepted_tokens == 0,
          "phase 6 (d): the drafts did not miss their deadline")
    for key in "efg":
        r = runs[key]
        check(r["stats"].preemptions >= 1 and r["in_use"] == 0
              and r["swap_held"] == 0
              and r["resumes"] == r["stats"].preemptions,
              f"phase 6 ({key}): no preemption, a stream not resumed, or "
              f"pages or snapshots left at the end")
    e, f = runs["e"], runs["f"]
    check(e["launched"]["decode_attn_paged_int8"] > 0
          and e["launched"]["quantize_kv_write"] > 0
          and e["launched"]["quantize_kv_scatter"]
          == (BATCH_PROMPTS + e["stats"].preemptions) * e["paged_layers"],
          f"phase 6 (e): int8 page writes {e['launched']} do not cover "
          f"{BATCH_PROMPTS} admissions and {e['stats'].preemptions} "
          f"re-prefills of {e['paged_layers']} layers")
    check(f["launched"]["decode_attn_paged"] > 0 and f["swap_out"] >= 1,
          "phase 6 (f): no paged attention launch, or nothing swapped")
    check(runs["c"]["launched"]["decode_attn"] > 0
          and runs["c"]["launched"]["exit_heads"] > 0,
          "phase 6 (c): no ring attention or exit launch (whose int8 wire "
          "packet the edge uploads)")
    check(runs["g"]["batcher"]["swaps"] >= 1,
          "phase 6 (g): the batcher swapped nothing")


# ---------------------------------------------------------------------------
# phase 7: ee-llm-7b with chunked prefill, prefix sharing and fleet replay
# ---------------------------------------------------------------------------
def phase7_prompts(vocab: int) -> list:
    """12 prompts behind one 240-token system prompt (15 full pages), each
    with 16-200 tokens of its own (seed 2), then copies of prompts 0 and
    1: 14 in all."""
    return shared_prompts(SHARED_PROMPTS, SHARED_PREFIX, *OWN_TOKENS, vocab,
                          seed=2)


def phase7_run(label, fn, sync) -> dict:
    """Run ``fn`` (a ``generate`` or ``generate_multi``) between two
    ``sync`` calls under a ``Meter``; print tokens/s, the chunk and
    prefix counters, the pools, the wire bytes, the virtual time and the
    time to first token, SLO attainment and the launches per kernel."""
    ops = kernel_ops()
    before = {n: op.launches for n, op in ops.items()}
    with Meter() as meter:
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        dt = time.perf_counter() - t0
    r["launched"] = {n: op.launches - before[n] for n, op in ops.items()}
    r["pools"] = [dataclasses.asdict(p.stats) for p in meter.pools]
    r["evictions"] = sum(p["prefix_evictions"] for p in r["pools"])
    r["allocs"] = sum(p["allocs"] for p in r["pools"])
    r["wall_s"] = dt
    st = r["stats"]
    check(all(len(t) == r["max_new"] for t in r["tokens"]),
          f"{label}: a stream did not end at its max_new tokens")
    slo = (f" ttft_p50={st.ttft_p(50):.6f}s ttft_p99={st.ttft_p(99):.6f}s "
           f"tpot_p50={st.token_lat_p(50):.6f}s tpot_p99="
           f"{st.token_lat_p(99):.6f}s slo={st.slo_met}/{st.slo_total}"
           if st.slo_total else "")
    print(f"phase7 {label:34s} tokens={st.tokens} tokens/s="
          f"{st.tokens / dt:.2f} wall={dt:.2f}s exits_l1={st.exits_l1} "
          f"exits_l2={st.exits_l2} cloud_requests={st.cloud_requests} "
          f"prefill_chunks={st.prefill_chunks} prefix_hit_tokens="
          f"{st.prefix_hit_tokens} cow_copies={st.cow_copies} "
          f"upload_bytes={st.upload_bytes} allocs={r['allocs']} "
          f"evictions={r['evictions']} preemptions={st.preemptions} "
          f"virtual_t={r['virtual_time']:.6f}s{slo} "
          f"adaptive={r.get('adaptive')} launches={r['launched']}"
          + (f" batcher={r['batcher']}" if "batcher" in r else ""))
    return r


def serve_phase7(model, theta, max_new=MAX_NEW, slots=SLOTS,
                 sync=torch.cuda.synchronize) -> dict:
    """Phase 7 on ``model`` (paged KV, 16-token pages, float16 wire, the
    split θ), phase 7's 14 prompts: (a) chunked prefill, bf16 pages,
    against the monolithic paged run; (b) with prefix sharing, which must
    equal (a); (c) and (d) the same on int8 pages, (d) == (c), every int8
    chunk write one ``quantize_kv_write`` launch a paged layer; (e) a
    second wave of prompts 0-2 through (b)'s system (all terminal hits);
    (f) (b) with swap preemption in a pool small enough to evict cached
    prefixes; (g) 4 engines sharing behind one ``CloudBatcher`` against
    the unshared batched run (two prompts an engine: an engine maps only
    pages its own cache holds); (h) open-loop Poisson
    arrivals with SLOs on phase 5 (a)'s channel and configuration
    (monolithic prefill), which must keep the closed-loop monolithic
    streams; (i) (h) with adaptive control and swap preemption.  Returns
    the runs."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel
    from repro_torch.core.workload import ArrivalProcess, arrival_times
    from repro_torch.serving.adaptive import AdaptiveConfig, ResumeCostModel
    from repro_torch.serving.engine import ServingSystem
    prompts = phase7_prompts(model.cfg.vocab_size)

    def mk(**kw):
        return ServingSystem(model, CollmConfig(
            theta=theta, page_size=PAGE_SIZE, kv_layout="paged",
            wire_format="float16", **kw))

    def gen(label, system, ps=prompts, **kw):
        def fn():
            r = system.generate(ps, max_new, num_slots=slots,
                                max_seq=SHARED_MAX_SEQ, **kw)
            r["max_new"] = max_new
            return r
        r = phase7_run(label, fn, sync)
        sched = next(iter(system._schedulers.values()))
        r["paged_layers"] = sum(len(layers) for tree in sched._trees()
                                for layers in tree.values())
        check(not sched._preempted, f"{label}: a stream stays preempted")
        return r

    def multi(label, system):
        def fn():
            r = system.generate_multi(prompts[:2 * SHARED_ENGINES], max_new,
                                      n_engines=SHARED_ENGINES,
                                      max_seq=SHARED_MAX_SEQ)
            r["max_new"] = max_new
            return r
        return phase7_run(label, fn, sync)

    chunked = dict(chunked_prefill=True)
    share = dict(chunked, prefix_share=True)
    runs = {"mono": gen("monolithic, bf16", mk())}
    runs["a"] = gen("(a) chunked, bf16", mk(**chunked))
    sys_b = mk(**share)
    runs["b"] = gen("(b) chunked + shared, bf16", sys_b)
    runs["c"] = gen("(c) chunked, int8", mk(**chunked, kv_dtype="int8"))
    runs["d"] = gen("(d) chunked + shared, int8",
                    mk(**share, kv_dtype="int8"))
    runs["e"] = gen("(e) second wave of prompts 0-2", sys_b, ps=prompts[:3])
    del sys_b
    runs["f"] = gen(f"(f) shared, swap, {SWAP_PAGES} pages",
                    mk(**share, preemption="swap"), num_pages=SWAP_PAGES)
    runs["g_un"] = multi(f"(g) {SHARED_ENGINES} engines, chunked",
                         mk(**chunked))
    runs["g"] = multi(f"(g) {SHARED_ENGINES} engines, shared", mk(**share))
    arrivals = arrival_times(ArrivalProcess(rate=20.0), len(prompts),
                             seed=0)
    fleet = dict(arrivals=arrivals, slo_ttft_s=0.5, slo_tpot_s=0.05,
                 tick_time_s=0.01)

    def sim():
        return AsyncSimChannel(NetworkParams(), service_s=0.008)
    runs["h"] = gen("(h) open loop, 20/s, SLOs", mk(), channel=sim(),
                    **fleet)
    runs["i"] = gen("(i) (h) + adaptive, swap", mk(preemption="swap"),
                    channel=sim(), adaptive=AdaptiveConfig(),
                    resume_cost=ResumeCostModel(), **fleet)
    a, b, c, d = runs["a"], runs["b"], runs["c"], runs["d"]
    print(f"phase 7 (a) chunked vs monolithic paged: "
          f"{agreement(a['tokens'], runs['mono']['tokens'])}")
    sa, sb = a["stats"], b["stats"]
    check(b["tokens"] == a["tokens"] and sb.prefix_hit_tokens > 0
          and sb.cow_copies >= 1 and sb.prefill_chunks < sa.prefill_chunks
          and b["allocs"] < a["allocs"]
          and sb.upload_bytes < sa.upload_bytes,
          "phase 7 (b): sharing changed a stream, or moved no counter")
    check(d["tokens"] == c["tokens"] and d["stats"].prefix_hit_tokens > 0,
          "phase 7 (d): int8 sharing changed a stream")
    for key in "cd":
        # a chunk's layer is one int8 write and one attention launch, as a
        # decode step's is; nothing is scattered
        r = runs[key]
        lc = r["launched"]
        check(lc["quantize_kv_write"] == lc["decode_attn_paged_int8"]
              >= r["stats"].prefill_chunks * r["paged_layers"]
              and lc["quantize_kv_scatter"] == 0,
              f"phase 7 ({key}): int8 writes {lc} are not one launch an "
              f"attention call, or fewer than one a chunk and paged layer")
    e = runs["e"]
    check(e["stats"].prefill_chunks == 0 and e["tokens"] == b["tokens"][:3]
          and e["stats"].prefix_hit_tokens == sum(len(p)
                                                  for p in prompts[:3]),
          "phase 7 (e): the second wave computed a chunk or changed")
    check(runs["f"]["tokens"] == b["tokens"] and runs["f"]["evictions"] >= 1,
          "phase 7 (f): no eviction, or the streams changed")
    g, g_un = runs["g"], runs["g_un"]
    check(g["tokens"] == g_un["tokens"]
          and g["batcher"]["prefix_hit_tokens"] > 0,
          "phase 7 (g): the batcher shared nothing, or streams changed")
    h, i = runs["h"], runs["i"]
    check(h["tokens"] == runs["mono"]["tokens"] and i["tokens"] == h["tokens"]
          and h["stats"].slo_total == len(prompts),
          "phase 7 (h), (i): open-loop or adaptive runs changed a stream")
    return runs


# ---------------------------------------------------------------------------
# phase 8: gemma3-12b at full width
# ---------------------------------------------------------------------------
def gemma_prompts(lens, seed) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 262144, int(n)) for n in lens]


def full_greedy(model, prompt, n: int) -> list:
    """The undivided model's greedy stream (``CoLLM.full_step``), as
    ``tests/test_disagg.py`` builds its reference."""
    from repro_torch.core.collm import CoLLM, CollmConfig
    co = CoLLM(model, CollmConfig())
    caches = model.init_cache(1, len(prompt) + n + 8)
    tokens = torch.as_tensor(prompt[None], device=model.device)
    x, _, caches, _ = model.prefill({"tokens": tokens}, caches)
    tok = model.logits(x[:, -1:])[:, 0].argmax(-1)
    out = [int(tok[0])]
    for t in range(n - 1):
        tok, _, caches = co.full_step(tok[:, None], caches, len(prompt) + t)
        out.append(int(tok[0]))
    return out


def two_tier_run(model, prompt, theta, wire, chunk, sync=False):
    """``TwoTierRuntime.decode`` of one prompt: the edge and the cloud on
    two streams of the card; ``sync`` swaps in a channel that synchronises
    the cloud stream on the host after every transfer and cloud step (the
    blocking baseline)."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.disagg import DeviceTransferChannel, TwoTierRuntime

    class SyncedChannel(DeviceTransferChannel):
        def put(self, packet):
            out = super().put(packet)
            self.cloud_stream.synchronize()
            return out

        def submit_packet(self, packet, pos, **kw):
            handle = super().submit_packet(packet, pos, **kw)
            self.cloud_stream.synchronize()
            return handle

    rt = TwoTierRuntime(model, CollmConfig(theta=theta, wire_format=wire),
                        model.device, model.device)
    rt.build()
    if sync:
        rt.channel = SyncedChannel(
            lambda pkt, caches, pos: rt.cloud_collm.cloud_step(pkt, caches,
                                                              pos),
            rt.cloud_device, edge_stream=rt.edge_stream,
            cloud_stream=rt.cloud_stream)
    ops = kernel_ops()
    before = {n: op.launches for n, op in ops.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with edge_ticks() as edge:
        toks, info = rt.decode(prompt, MAX_NEW,
                               max_seq=len(prompt) + MAX_NEW + 8,
                               upload_chunk=chunk)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ticks = np.asarray(info["tick_s"]) * 1e3
    info.update(wall_s=dt, tick_ms=float(ticks.mean()),
                launched={n: op.launches - before[n] for n, op in ops.items()})
    print(f"two-tier theta={theta:.6g} wire={wire:7s} upload_chunk={chunk:3d}"
          f"{' cloud synced' if sync else ''}: wall={dt:.2f}s wire_bytes="
          f"{info['wire_bytes']} channel={info['channel']} edge tick host "
          f"mean={ticks.mean():.3f} ms median={np.median(ticks):.3f} ms "
          f"edge_ticks={edge[0]} exit_launches/tick="
          f"{exits_per_tick(info['launched'], edge[0])} "
          f"launches={info['launched']}")
    check(len(toks) == MAX_NEW and 0 <= min(toks) and max(toks) < 262144,
          "two-tier: bad tokens")
    return toks, info


def serve_phase8(model) -> dict:
    """gemma3-12b at full width (30 of 48 layers, d_model 3840, bf16,
    random weights): (a) ``generate_sequential`` with two 4096-token prompts in
    the cloud, collm θ = 1 float32 (equal to cloud; its confidences give
    the split θ), split-θ float16, θ = 0 int8 and standalone modes; (b)
    one 32768-token prompt at the split θ, its prefill (to the first
    token) timed alone, then 16 new tokens; (c) ``generate``, 8 slots, 8
    prompts of 512-4096 tokens, on dense, paged bf16 and paged int8 KV
    (128-token pages); (d) (c)'s paged bf16 run with chunked prefill,
    against its monolithic run; (e) ``TwoTierRuntime`` with a 4096-token
    prompt: θ = 1.1 float32 wire (must equal ``CoLLM.full_step``'s greedy
    stream), the split θ with float16 and int8 wire and the prompt upload
    whole or in 512-token slices, and float16 against runs that
    synchronise the cloud stream after every transfer, in turns.  Random weights
    flip near-tied bf16 argmaxes: streams other than (e)'s θ = 1.1 are
    reported by agreement."""
    out = {}
    prompts = gemma_prompts((G_PROMPT, G_PROMPT), SEED + 3)
    cloud = serve(model, prompts, "cloud", 1.0, "float32")
    full = serve(model, prompts, "collm", 1.0, "float32")
    check(full["tokens"] == cloud["tokens"], "phase 8 (a): collm at "
          "theta=1 with a float32 wire differs from cloud")
    print("phase 8 (a) collm theta=1 float32 == cloud: True")
    theta = split_theta(full["stats"])
    mix = serve(model, prompts, "collm", theta, "float16")
    r0 = serve(model, prompts, "collm", 0.0, "int8")
    check(r0["stats"].exits_l1 == len(prompts) * (MAX_NEW - 1),
          "phase 8 (a) theta=0: not every token exited at l_ee1")
    alone = serve(model, prompts, "standalone", theta, "float16")
    for name, r in (("split theta", mix), ("theta=0 int8", r0),
                    ("standalone", alone)):
        print(f"phase 8 (a) {name} vs cloud: "
              f"{agreement(r['tokens'], cloud['tokens'])}")
    torch.cuda.empty_cache()

    long = gemma_prompts((G_LONG,), SEED + 4)
    first = serve(model, long, "collm", theta, "float16", max_new=1)
    r_long = serve(model, long, "collm", theta, "float16",
                   max_new=G_LONG_NEW)
    out["long"] = dict(prefill_s=first["wall_s"],
                       prefill_peak=first["peak_bytes"],
                       wall_s=r_long["wall_s"], peak=r_long["peak_bytes"])
    print(f"phase 8 (b) {G_LONG}-token prompt: prefill to the first token "
          f"{first['wall_s']:.3f} s, peak {first['peak_bytes'] / 2**30:.2f} "
          f"GiB; with {G_LONG_NEW} new tokens {r_long['wall_s']:.3f} s, peak "
          f"{r_long['peak_bytes'] / 2**30:.2f} GiB; first token == the "
          f"run's: {first['tokens'][0][0] == r_long['tokens'][0][0]}")
    torch.cuda.empty_cache()

    batch = gemma_prompts(G_LENS, SEED + 5)
    runs = {name: serve_batched(model, batch, name, "collm", theta,
                                "float16", layout=layout, kv_dtype=kv,
                                page_size=G_PAGE, chunked=chunked)
            for name, layout, kv, chunked in (
                ("dense", "dense", "float32", False),
                ("paged", "paged", "float32", False),
                ("paged-int8", "paged", "int8", False),
                ("paged chunked", "paged", "float32", True))}
    for name in ("paged", "paged-int8"):
        print(f"phase 8 (c) {name} vs dense: "
              f"{agreement(runs[name]['tokens'], runs['dense']['tokens'])}")
    print(f"phase 8 (d) chunked vs monolithic paged: "
          f"{agreement(runs['paged chunked']['tokens'], runs['paged']['tokens'])}")
    launched = runs["paged-int8"]["launched"]
    check(runs["dense"]["launched"]["decode_attn"] > 0
          and runs["paged"]["launched"]["decode_attn_paged"] > 0
          and launched["decode_attn_paged_int8"] > 0
          and launched["quantize_kv_write"] == launched[
              "decode_attn_paged_int8"]
          and launched["quantize_kv_scatter"] > 0
          and runs["paged chunked"]["stats"].prefill_chunks > 0,
          "phase 8 (c), (d): a layout did not run its kernels")
    out["batched"] = runs
    torch.cuda.empty_cache()

    one = batch[-1]
    ref = full_greedy(model, one, MAX_NEW)
    exact, _ = two_tier_run(model, one, 1.1, "float32", 0)
    print(f"phase 8 (e) two-tier theta=1.1 float32 == full_step greedy: "
          f"{exact == ref}")
    check(exact == ref, "phase 8 (e): the two-tier stream at theta=1.1 with "
          "a float32 wire differs from the full model's greedy stream")
    tiers = {}
    for wire in ("float16", "int8"):
        for chunk in (0, G_CHUNK):
            tiers[wire, chunk] = two_tier_run(model, one, theta, wire, chunk)
            print(f"phase 8 (e) {wire} upload_chunk={chunk} vs theta=1.1: "
                  f"{agreement([tiers[wire, chunk][0]], [exact])}")
    # the overlap, in turns: in flight, synced, synced, in flight
    turns = [two_tier_run(model, one, theta, "float16", 0, sync=sync)
             for sync in (False, True, True, False)]
    lapped = [turns[i][1]["tick_ms"] for i in (0, 3)]
    synced = [turns[i][1]["tick_ms"] for i in (1, 2)]
    print(f"phase 8 (e) edge tick host time (mean of the run's ticks), "
          f"cloud in flight {lapped[0]:.3f} / {lapped[1]:.3f} ms vs cloud "
          f"synced after every transfer {synced[0]:.3f} / {synced[1]:.3f} "
          f"ms; streams equal: "
          f"{all(t[0] == tiers['float16', 0][0] for t in turns)}")
    out["tiers"] = tiers
    return out


# ---------------------------------------------------------------------------
# phases 9 and 10: the MoE decoders and stablelm-12b at full width
# ---------------------------------------------------------------------------
def vocab_prompts(lens, vocab, seed) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)) for n in lens]


def smoke_config(name):
    """``name``'s configuration cut to the depth ``DEPTH`` gives it (its
    full depth where ``DEPTH`` names none)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(name)
    return dataclasses.replace(
        cfg, n_layers=DEPTH.get(name, cfg.n_layers)).validate()


def depth_of(cfg) -> str:
    from repro_torch.configs.registry import get_config
    full = get_config(cfg.name).n_layers
    return (f"{cfg.n_layers} layers" if cfg.n_layers == full
            else f"{cfg.n_layers} of {full} layers")


def build_full(name, dev):
    """``name`` at full width in bf16, random weights from ``SEED``, at the
    depth of ``smoke_config``."""
    from repro_torch.models.registry import build_model
    cfg = smoke_config(name)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    moe = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
           f"d_ff {cfg.moe.expert_d_ff}" if cfg.moe else "")
    print(f"model: {cfg.name} {depth_of(cfg)} d={cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of d={cfg.resolved_head_dim}"
          f"{moe} V={cfg.vocab_size}, {n_params / 1e9:.3f} B parameters, "
          f"{n_bytes / 1e9:.2f} GB (bf16; MoE routers and Mamba2 gates "
          f"float32), initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def serve_full(model, phase, lens, max_new, *, sequential, chunked) -> dict:
    """A model at full width (bf16, random weights): with ``sequential``,
    ``generate_sequential`` with two 512-token prompts in the cloud,
    collm θ = 1 float32 (must equal cloud; its confidences give the split
    θ), split-θ float16, θ = 0 int8 and standalone modes; then
    ``generate`` with 8 slots and prompts of ``lens`` tokens on dense,
    paged bf16 and paged int8 KV (128-token pages), and with ``chunked``
    the paged bf16 run again with chunked prefill.  Streams of random bf16
    weights other than collm θ = 1's are reported by agreement."""
    cfg = model.cfg
    out = {}
    theta = None
    if sequential:
        prompts = vocab_prompts((PROMPT_LEN, PROMPT_LEN), cfg.vocab_size,
                                SEED + 6)
        cloud = serve(model, prompts, "cloud", 1.0, "float32")
        full = serve(model, prompts, "collm", 1.0, "float32")
        check(full["tokens"] == cloud["tokens"], f"phase {phase} (a) "
              f"{cfg.name}: collm at theta=1 with a float32 wire differs "
              "from cloud")
        print(f"phase {phase} (a) {cfg.name} collm theta=1 float32 == "
              f"cloud: True")
        theta = split_theta(full["stats"])
        mix = serve(model, prompts, "collm", theta, "float16")
        r0 = serve(model, prompts, "collm", 0.0, "int8")
        check(r0["stats"].exits_l1 == len(prompts) * (MAX_NEW - 1),
              f"phase {phase} (a) theta=0: not every token exited at l_ee1")
        alone = serve(model, prompts, "standalone", theta, "float16")
        for name, r in (("split theta", mix), ("theta=0 int8", r0),
                        ("standalone", alone)):
            print(f"phase {phase} (a) {cfg.name} {name} vs cloud: "
                  f"{agreement(r['tokens'], cloud['tokens'])}")
        out["sequential"] = dict(cloud=cloud, full=full, mix=mix, r0=r0,
                                 alone=alone)
        torch.cuda.empty_cache()
    if theta is None:
        # the split θ of a θ = 1 batched run's confidences
        probe = serve_batched(model, vocab_prompts(lens[:2], cfg.vocab_size,
                                                   SEED + 8),
                              "theta probe", "collm", 1.0, "float32",
                              layout="dense", max_new=max_new)
        theta = split_theta(probe["stats"])
    batch = vocab_prompts(lens, cfg.vocab_size, SEED + 7)
    layouts = [("dense", "dense", "float32", False),
               ("paged", "paged", "float32", False),
               ("paged-int8", "paged", "int8", False)]
    if chunked:
        layouts.append(("paged chunked", "paged", "float32", True))
    runs = {name: serve_batched(model, batch, f"{cfg.name} {name}", "collm",
                                theta, "float16", layout=layout, kv_dtype=kv,
                                page_size=G_PAGE, chunked=ch,
                                max_new=max_new)
            for name, layout, kv, ch in layouts}
    for name in ("paged", "paged-int8"):
        print(f"phase {phase} (b) {cfg.name} {name} vs dense: "
              f"{agreement(runs[name]['tokens'], runs['dense']['tokens'])}")
    if chunked:
        print(f"phase {phase} (c) {cfg.name} chunked vs monolithic paged: "
              f"{agreement(runs['paged chunked']['tokens'], runs['paged']['tokens'])}")
    launched = runs["paged-int8"]["launched"]
    check(runs["dense"]["launched"]["decode_attn"] > 0
          and runs["paged"]["launched"]["decode_attn_paged"] > 0
          and launched["decode_attn_paged_int8"] > 0
          and launched["quantize_kv_write"] == launched[
              "decode_attn_paged_int8"]
          and launched["quantize_kv_scatter"] > 0
          and (not chunked or runs["paged chunked"]["stats"].prefill_chunks
               > 0),
          f"phase {phase} {cfg.name}: a layout did not run its kernels")
    out["batched"] = runs
    torch.cuda.empty_cache()
    return out


def serve_phase(phase, names, dev, ops, **kw) -> dict:
    """Each model of ``names`` built, served (``serve_full``) with the
    launch counters set to 0 before and read after, and freed; returns the
    launches of all of them."""
    total = {name: 0 for name in ops}
    t0 = time.perf_counter()
    for arch in names:
        model = build_full(arch, dev)
        reset(ops)
        ta = time.perf_counter()
        serve_full(model, phase, **kw)
        launched = counted(ops)
        print(f"phase {phase} ({arch} at full width) launches: {launched} in "
              f"{time.perf_counter() - ta:.1f} s")
        for name in ("decode_attn", "decode_attn_paged",
                     "decode_attn_paged_int8", "exit_heads",
                     "quantize_kv_write", "quantize_kv_scatter"):
            check(launched[name] > 0,
                  f"{name} was not launched in phase {phase} ({arch})")
        total = {name: n + launched[name] for name, n in total.items()}
        del model
        free()
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 11: the recurrent and hybrid decoders at full width
# ---------------------------------------------------------------------------
XLSTM_KERNELS = ("exit_heads", "exit_head", "exit_quant", "quantize")
ATTN_KERNELS = ("decode_attn", "decode_attn_paged", "decode_attn_paged_int8",
                "quantize_kv_write", "quantize_kv_scatter")


def with_prefill(fn):
    """``fn()``'s result with its prefill wall ("prefill_s") and the share
    of its sLSTM blocks ("slstm_s"), printed: the seconds of the model's
    ``prefill`` and ``slstm`` spans, on the card's clock."""
    from repro_torch.tracing import timed
    with timed("prefill", "slstm") as spans:
        r = fn()
    r["prefill_s"], r["slstm_s"] = spans["prefill"], spans["slstm"]
    print(f"  prefill wall {spans['prefill']:.3f} s (sLSTM blocks "
          f"{spans['slstm']:.3f} s)")
    return r


def profile_decode_split(model) -> None:
    """``--profile``: one collaborative decode step of 8 slots (the edge
    step and the cloud step of every row) over dense caches whose rings
    hold 1024 valid keys.  Timed without the profiler (host wall, and the
    span of its device events), then under it: the device time of its
    kernels, their busy share of the unprofiled wall, and that time split
    by the model's spans (recurrent layers, the shared attention block,
    the exits).  Every row takes the cloud step, so no path depends on
    the exit threshold."""
    from repro_torch.core.collm import CoLLM
    collm = CoLLM(model)
    fill, dev = 1024, model.device
    edge = collm.init_edge_cache(SLOTS, fill + 8)
    cloud = collm.init_cloud_cache(SLOTS, fill + 8)
    for tree in (edge, cloud):
        for layers in tree.values():
            for c in layers:
                if "self" in c:
                    c["self"]["pos"][:, :fill] = torch.arange(fill,
                                                              device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SLOTS,), fill, dtype=torch.int32, device=dev)

    def step():
        out = collm.edge_step(tok, edge, pos)
        collm.cloud_step(out.upload, cloud, pos)
        torch.cuda.synchronize()

    step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    step()
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    label = f"phase 11 {model.cfg.name} 8-slot decode step"
    print(f"profile {label}: {wall * 1e3:.3f} ms wall without the "
          f"profiler, {start.elapsed_time(end):.3f} ms between its first "
          "and last device events")
    profile_window(label, step, wall)


def serve_recurrent(arch, dev, ops, profile=False) -> dict:
    """Phase 11 for ``arch`` at full width (bf16, random weights from
    ``SEED``): (a) ``generate_sequential`` with two 512-token prompts in
    phase 3's five modes (collm θ = 1 float32 equals cloud; its
    confidences give the split θ) and ``fused_exit_upload`` on a real
    l_ee1 hidden; (b) ``generate`` with 8 slots and the 12 prompts of
    ``R_LENS`` at the split θ with a float16 wire, on dense KV and, for
    zamba2, on paged bf16 and int8 KV of 128-token pages.  Every run
    prints its prefill wall; the batched ones the cache bytes split into
    KV and recurrent state.  Returns the launches of the model's runs."""
    model = build_full(arch, dev)
    cfg = model.cfg
    reset(ops)
    t0 = time.perf_counter()
    prompts = vocab_prompts((PROMPT_LEN, PROMPT_LEN), cfg.vocab_size,
                            SEED + 6)
    seq = {}
    for name, mode, theta, wire in (("cloud", "cloud", 1.0, "float32"),
                                    ("full", "collm", 1.0, "float32")):
        seq[name] = with_prefill(lambda: serve(model, prompts, mode, theta,
                                               wire))
    check(seq["full"]["tokens"] == seq["cloud"]["tokens"], f"phase 11 (a) "
          f"{arch}: collm at theta=1 with a float32 wire differs from cloud")
    print(f"phase 11 (a) {arch} collm theta=1 float32 == cloud: True")
    theta = split_theta(seq["full"]["stats"])
    for name, mode, th, wire in (("split theta", "collm", theta, "float16"),
                                 ("theta=0 int8", "collm", 0.0, "int8"),
                                 ("standalone", "standalone", theta,
                                  "float16")):
        seq[name] = with_prefill(lambda: serve(model, prompts, mode, th,
                                               wire))
        print(f"phase 11 (a) {arch} {name} vs cloud: "
              f"{agreement(seq[name]['tokens'], seq['cloud']['tokens'])}")
    check(seq["theta=0 int8"]["stats"].exits_l1
          == len(prompts) * (MAX_NEW - 1),
          f"phase 11 (a) {arch} theta=0: not every token exited at l_ee1")
    mix = seq["split theta"]["stats"]
    check(mix.exits_l1 + mix.exits_l2 > 0 and mix.cloud_requests > 0,
          f"phase 11 (a) {arch}: no mix of exits and cloud requests")
    check_fused_upload(model, prompts, theta)
    torch.cuda.empty_cache()
    batch = vocab_prompts(R_LENS, cfg.vocab_size, SEED + 9)
    layouts = [("dense", "dense", "float32")]
    if arch == ZAMBA2:
        layouts += [("paged", "paged", "float32"),
                    ("paged-int8", "paged", "int8")]
    runs = {}
    for name, layout, kv in layouts:
        runs[name] = with_prefill(lambda: serve_batched(
            model, batch, f"{arch} {name}", "collm", theta, "float16",
            layout=layout, kv_dtype=kv, page_size=G_PAGE))
        split = runs[name]["kv_split"]
        print(f"  kv_cache_bytes: KV {split['kv']} + recurrent state "
              f"{split['state']} ({split['state'] // SLOTS} a slot, edge "
              f"and cloud partitions)")
    dense = runs["dense"]["tokens"]
    for name in ("paged", "paged-int8"):
        if name in runs:
            print(f"phase 11 (b) {arch} {name} vs dense: "
                  f"{agreement(runs[name]['tokens'], dense)}")
    launched = counted(ops)
    print(f"phase 11 ({arch} at full width) launches: {launched} in "
          f"{time.perf_counter() - t0:.1f} s")
    need = XLSTM_KERNELS + (ATTN_KERNELS if arch == ZAMBA2 else ())
    for name in need:
        check(launched[name] > 0,
              f"{name} was not launched in phase 11 ({arch})")
    if arch == ZAMBA2:
        check(launched["quantize_kv_write"]
              == launched["decode_attn_paged_int8"],
              f"phase 11 ({arch}): not one int8 page write a paged int8 "
              "attention call")
    else:
        check(all(launched[name] == 0 for name in ATTN_KERNELS),
              f"phase 11 ({arch}): an attention kernel ran in a model "
              "without attention")
    if profile:
        profile_decode_split(model)
    del model, seq, runs
    free()
    return launched


# ---------------------------------------------------------------------------
# phase 12: the encoder-decoder and vision-prefix models at full width
# ---------------------------------------------------------------------------
PREFIXED_COUNTS = ("tokens", "exits_l1", "exits_l2", "cloud_requests",
                   "upload_bytes", "enc_bytes")


def prefixed_batch(cfg, rows, prompt_len, seed) -> dict:
    """``rows`` prompts of ``prompt_len`` tokens with their frames
    (whisper) or patches (paligemma), N(0, 1) x 0.1, drawn on the CPU from
    a generator seeded with ``seed``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, prompt_len),
                                     generator=gen)}
    key, n = (("frames", cfg.encoder_seq) if cfg.is_encdec
              else ("patches", cfg.vision_tokens))
    batch[key] = torch.randn((rows, n, cfg.d_model), generator=gen) * 0.1
    return batch


def split_confidence(confs) -> float:
    """A θ between the two middle larger-exit confidences of a θ = 1 run:
    about half its ticks go to the cloud, the others exit at l_ee1 or
    l_ee2 (``confs``: (ticks x rows, 2) l_ee1 and l_ee2 confidences)."""
    c = sorted(max(c12) for c12 in confs)
    return (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2


@contextlib.contextmanager
def cross_decodes():
    """Counts the cross decodes (each one launch of the ring kernel on the
    card) made while open: yields a one-element list that holds the
    count."""
    from repro_torch.models import blocks
    n = [0]
    fn = blocks.cross_decode_attention

    def counted(*a, **kw):
        n[0] += 1
        return fn(*a, **kw)

    blocks.cross_decode_attention = counted
    try:
        yield n
    finally:
        blocks.cross_decode_attention = fn


@torch.no_grad()
def prefixed_stream(model, batch, mode, theta, wire, max_new,
                    cloud_mesh=None) -> dict:
    """Greedy decode of ``batch``'s rows through the ``Model`` and
    ``CoLLM`` calls (the engines take token prompts only): ``cloud`` is
    ``Model.prefill`` + ``full_step``; ``collm`` is ``edge_prefill``, the
    prompt's l_ee1 hiddens and ``Model.encode``'s output quantized to the
    wire and opened by the cloud once, ``cloud_prefill``, then each tick
    ``edge_step`` and, for the rows below θ, one ``cloud_step`` whose
    write mask keeps the other rows' cloud KV (their uploads released, as
    the sequential engine does); ``standalone`` is ``edge_prefill`` +
    ``standalone_step``.  Returns the tokens per row, exits, cloud
    requests, upload and ``enc_out`` bytes, the ticks' (l_ee1, l_ee2)
    confidences and, on the card, the wall, the encoder's device time,
    the peak memory and the kernel launches.  ``cloud_mesh``: the model
    is a rank's share of that mesh (phase 14)."""
    from repro_torch.core import transport
    from repro_torch.core.collm import CoLLM, CollmConfig
    from repro_torch.core.exits import first_confident_exit
    from repro_torch.tracing import timed
    cfg, dev, dt = model.cfg, model.device, model.dtype
    cuda = dev.type == "cuda"
    b = batch["tokens"].shape[0]
    max_seq = cfg.vision_tokens + batch["tokens"].shape[1] + max_new + 8
    collm = CoLLM(model, CollmConfig(theta=theta, wire_format=wire,
                                     cloud_mesh=cloud_mesh))
    st = dict(exits_l1=0, exits_l2=0, cloud_requests=0, upload_bytes=0,
              enc_bytes=0)
    toks, confs, encodes = [], [], 0
    before = {n: op.launches for n, op in kernel_ops().items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed("encode") as spans, cross_decodes() as cross:
        if mode == "cloud":
            caches = model.init_cache(b, max_seq)
            x, _, caches, _ = model.prefill(batch, caches)
            encodes += cfg.is_encdec
            tok = model.logits(x[:, -1:])[:, 0].argmax(-1).to(torch.int32)
            pos = x.shape[1]
            toks.append(tok)
            for _ in range(max_new - 1):
                tok, _, caches = collm.full_step(tok[:, None], caches, pos)
                toks.append(tok)
                pos += 1
        else:
            edge = collm.init_edge_cache(b, max_seq)
            decisions, h1, edge = collm.edge_prefill(batch, edge)
            encodes += cfg.is_encdec
            pos = h1.shape[1]
            if mode == "standalone":
                tok = decisions[collm.l_ee2].token
                toks.append(tok)
                for _ in range(max_new - 1):
                    tok, _, edge = collm.standalone_step(tok[:, None], edge,
                                                         pos)
                    toks.append(tok)
                    pos += 1
                st["exits_l2"] = b * (max_new - 1)
            else:
                up = transport.quantize(h1, wire)
                st["upload_bytes"] += transport.packet_bytes(up)
                enc = None
                if cfg.is_encdec:
                    enc_up = transport.quantize(model.encode(batch["frames"]),
                                                wire)
                    encodes += 1
                    st["enc_bytes"] = transport.packet_bytes(enc_up)
                    enc = transport.dequantize(enc_up, dt)
                cloud = collm.init_cloud_cache(b, max_seq)
                logits, cloud = collm.cloud_prefill(
                    transport.dequantize(up, dt), cloud, enc_out=enc)
                tok, exited, _ = first_confident_exit(decisions, theta)
                st["cloud_requests"] += int((~exited).sum())
                tok = torch.where(exited, tok,
                                  logits[:, 0].argmax(-1).to(tok.dtype))
                toks.append(tok)
                l1 = torch.zeros((b,), dtype=torch.int32, device=dev)
                l2 = torch.zeros_like(l1)
                for _ in range(max_new - 1):
                    out = collm.edge_step(tok[:, None], edge, pos)
                    c12 = torch.stack([out.decisions[l].confidence.float()
                                       for l in (collm.l_ee1, collm.l_ee2)],
                                      dim=-1)
                    confs.append(c12)
                    at1 = c12[:, 0] >= theta
                    l1 += out.exited & at1
                    l2 += out.exited & ~at1
                    # each row's packet and its int32 position
                    st["upload_bytes"] += (transport.packet_bytes(out.upload)
                                           + 4 * b)
                    need = ~out.exited
                    n_need = int(need.sum())
                    tok = out.token
                    if n_need:
                        cl, cloud = collm.cloud_step(
                            out.upload, cloud, pos,
                            write_mask=None if n_need == b else need)
                        tok = torch.where(need, cl.argmax(-1).to(tok.dtype),
                                          tok)
                        st["cloud_requests"] += n_need
                    toks.append(tok)
                    pos += 1
                st["exits_l1"] = int(l1.sum())
                st["exits_l2"] = int(l2.sum())
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st["tokens"] = torch.stack(toks, dim=1).tolist()
    st["confs"] = (torch.cat(confs).tolist() if confs else [])
    st.update(wall_s=wall, encode_s=spans["encode"], encodes=encodes,
              cross=cross[0],
              launches={n: op.launches - before[n]
                        for n, op in kernel_ops().items()},
              peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if cuda
                        else 0.0))
    return st


def print_prefixed(arch, label, r, rows) -> None:
    n = rows * P_NEW
    ring = r["launches"]["decode_attn"]
    enc = (f" encoder {r['encode_s'] / r['encodes'] * 1e3:.2f} ms a pass"
           if r["encodes"] else "")
    print(f"phase 12 {arch} {label:24s} rows={rows} tokens={n} "
          f"tokens/s={n / r['wall_s']:.2f} wall={r['wall_s']:.2f}s "
          f"exits_l1={r['exits_l1']} exits_l2={r['exits_l2']} "
          f"cloud_requests={r['cloud_requests']} "
          f"upload_bytes={r['upload_bytes']} enc_out_bytes={r['enc_bytes']}"
          f"{enc} peak_mem={r['peak_gib']:.2f}GiB launches: ring self "
          f"{ring - r['cross']}, ring cross {r['cross']}, exit_heads "
          f"{r['launches']['exit_heads']}, quantize "
          f"{r['launches']['quantize']}")


def serve_prefixed(arch, dev, ops) -> dict:
    """Phase 12 for ``arch`` at full width (bf16, random weights from
    ``SEED``): (a) or (c) one row of ``P_PROMPT`` tokens with its 1500
    frames or 256 patches, ``P_NEW`` new tokens, through
    ``prefixed_stream`` in five modes: cloud (``full_step``), collm θ = 1
    with a float32 wire (must equal cloud: for paligemma only if the
    cloud prefill keeps the prefix-LM mask), a split θ with a float16
    wire, θ = 0 with an int8 wire (every token exits at l_ee1) and
    standalone; (b) or (d) 8 rows of equal prompt length: cloud, collm θ
    = 1 float32 (must equal cloud) and the split θ (the masked cloud
    step).  Returns the launches of the model's runs."""
    model = build_full(arch, dev)
    cfg = model.cfg
    reset(ops)
    t0 = time.perf_counter()
    one = {k: v.to(dev) for k, v in prefixed_batch(
        cfg, 1, P_PROMPT[arch], SEED + 12).items()}
    seq = {}
    for name, mode, theta, wire in (("cloud", "cloud", 1.0, "float32"),
                                    ("theta=1 float32", "collm", 1.0,
                                     "float32")):
        seq[name] = prefixed_stream(model, one, mode, theta, wire, P_NEW)
        print_prefixed(arch, name, seq[name], 1)
    check(seq["theta=1 float32"]["tokens"] == seq["cloud"]["tokens"],
          f"phase 12 {arch}: collm at theta=1 with a float32 wire differs "
          "from cloud")
    print(f"phase 12 {arch} collm theta=1 float32 == cloud: True")
    theta = split_confidence(seq["theta=1 float32"]["confs"])
    for name, mode, th, wire in (("split theta float16", "collm", theta,
                                  "float16"),
                                 ("theta=0 int8", "collm", 0.0, "int8"),
                                 ("standalone", "standalone", theta,
                                  "float16")):
        seq[name] = prefixed_stream(model, one, mode, th, wire, P_NEW)
        print_prefixed(arch, name, seq[name], 1)
        print(f"phase 12 {arch} {name} vs cloud: "
              f"{agreement(seq[name]['tokens'], seq['cloud']['tokens'])}")
    check(seq["theta=0 int8"]["exits_l1"] == P_NEW - 1
          and seq["theta=0 int8"]["cloud_requests"] == 0,
          f"phase 12 {arch} theta=0: not every token exited at l_ee1")
    mix = seq["split theta float16"]
    check(mix["exits_l1"] + mix["exits_l2"] > 0 and mix["cloud_requests"] > 0,
          f"phase 12 {arch}: no mix of exits and cloud requests")
    rows = {k: v.to(dev) for k, v in prefixed_batch(
        cfg, P_ROWS, P_PROMPT[arch], SEED + 13).items()}
    many = {}
    for name, mode, th, wire in (("cloud", "cloud", 1.0, "float32"),
                                 ("theta=1 float32", "collm", 1.0,
                                  "float32"),
                                 ("split theta float16", "collm", theta,
                                  "float16")):
        many[name] = prefixed_stream(model, rows, mode, th, wire, P_NEW)
        print_prefixed(arch, name, many[name], P_ROWS)
    check(many["theta=1 float32"]["tokens"] == many["cloud"]["tokens"],
          f"phase 12 {arch}: {P_ROWS} rows at theta=1 float32 differ from "
          "cloud")
    split = agreement(many["split theta float16"]["tokens"],
                      many["cloud"]["tokens"])
    print(f"phase 12 {arch} {P_ROWS} rows collm theta=1 float32 == cloud: "
          f"True; split theta vs cloud: {split}")
    for r in [*seq.values(), *many.values()]:
        toks = np.asarray(r["tokens"])
        check(toks.shape[1] == P_NEW and toks.min() >= 0
              and toks.max() < cfg.vocab_size, f"phase 12 {arch}: bad tokens")
    launched = counted(ops)
    cross = sum(r["cross"] for r in [*seq.values(), *many.values()])
    print(f"phase 12 ({arch} at full width) launches: {launched} (ring "
          f"cross {cross}) in {time.perf_counter() - t0:.1f} s")
    for name in ("decode_attn", "exit_heads", "quantize"):
        check(launched[name] > 0,
              f"{name} was not launched in phase 12 ({arch})")
    if cfg.is_encdec:
        check(0 < cross < launched["decode_attn"],
              f"phase 12 ({arch}): the ring kernel ran no self or no cross "
              "decode")
    del model
    free()
    return launched


def profile_window(label, fn, wall=None) -> None:
    """Device time by kernel, the card's busy share, the kernels' device
    time by the model's spans (``repro_torch.tracing``) and the host's
    costliest operators over one call of ``fn``.  The busy share is of
    ``wall``, the seconds of an unprofiled call of ``fn``, when given,
    else of the profiled call's wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.tracing import PREFIX
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        profiled = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: a CPU op's device time repeats its kernels', and a
    # span's device row covers them, gaps included
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith(PREFIX)]
    busy = sum(r[0] for r in rows) / 1e6
    which = "profiled" if wall is None else "unprofiled"
    wall = profiled if wall is None else wall
    print(f"profile {label}: {len(rows)} kernels, device busy {busy:.6f}s "
          f"of {wall:.6f}s {which} wall ({busy / wall:.1%})")
    # a span's host row sums the device time of the kernels it launched
    split = {}
    for e in prof.events():
        if e.name.startswith(PREFIX) and str(e.device_type).endswith("CPU"):
            work = e.name[len(PREFIX):]
            split[work] = split.get(work, 0.0) + e.device_time_total / 1e3
    if split:
        print("  device ms of the kernels by span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(split.items())))
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    cpu = [(e.self_cpu_time_total, e.count, e.key) for e in events
           if str(e.device_type).endswith("CPU")
           and not e.key.startswith(PREFIX)]
    print(f"  host: top operators by self time (under the profiler)")
    for us, count, key in sorted(cpu, reverse=True)[:8]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def profile_runs(model, prompts, theta) -> None:
    """``--profile``: a few collaborative decode ticks of the sequential
    loop, then the batched engine on bf16 and int8 pages (8 prompts, 32
    new tokens) under the profiler, and the two paged runs of phase 4
    twice more in turns without it (their run-to-run spread)."""
    profile_window("sequential collm", lambda: serve(
        model, [prompts[0][:64]], "collm", theta, "float16"))
    batch = phase4_prompts()
    for kv_dtype in ("float32", "int8"):
        profile_window(f"batched paged {kv_dtype}", lambda: serve_batched(
            model, batch[:SLOTS], f"profile {kv_dtype}", "collm", theta,
            "float16", kv_dtype=kv_dtype))
    for kv_dtype in ("float32", "int8", "int8", "float32"):
        serve_batched(model, batch, f"repeat paged {kv_dtype}", "collm",
                      theta, "float16", kv_dtype=kv_dtype)


# ---------------------------------------------------------------------------
# phase 13: training and checkpoints
# ---------------------------------------------------------------------------
# (a): tests/conftest.py's tiny_trained (batch 8 x 64, 80 steps)
T_STEPS, T_BATCH, T_SEQ = 80, 8, 64
# (c): ee-llm-7b at full width, DEPTH's depth, float32; (d): its serving
F_STEPS, F_BATCH, F_SEQ, F_LR = 6, 2, 512, 3e-4
F_CLIENTS, F_PROMPT, F_NEW = 2, 64, 16
CKPT_DIR = ROOT / "artifacts"      # git-ignored: (d) and (e)'s checkpoints
FAMILY_RTOL = 1e-4                 # (b): card against CPU, float32


def train_steps(model, ocfg, batches) -> list:
    """``make_train_step`` over ``batches`` (numpy); each step's metrics
    as floats, and its host seconds under "s"."""
    from repro_torch.training.optim import init_adamw
    from repro_torch.training.train_step import make_train_step
    step = make_train_step(model, ocfg)
    state, out = init_adamw(model), []
    for b in batches:
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in b.items()}
        batch["tokens"] = batch["tokens"].long()
        state, mets = step(state, batch)
        out.append({k: float(v) for k, v in mets.items()})  # synchronises
        out[-1]["s"] = time.perf_counter() - t0
    return out


def step_times(run) -> str:
    """A run's first step (it imports ``torch._dynamo`` for
    ``torch.utils.checkpoint``, and on the card warms it up) and the
    median of the others, ms."""
    rest = np.median([r["s"] for r in run[1:]]) if len(run) > 1 else 0.0
    return f"first step {run[0]['s'] * 1e3:.1f} ms, then {rest * 1e3:.2f} ms"


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def check_train_tiny(dev) -> None:
    """(a) tiny-ee, float32, 80 steps of the markov corpus on the card and
    on the CPU from the same weights and batches."""
    from repro_torch.data.synthetic import DataConfig, SyntheticCorpus
    from repro_torch.models.registry import build_model
    from repro_torch.training.optim import AdamWConfig
    cfg = tiny_ee_config()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    batches = list(SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=T_SEQ, batch_size=T_BATCH,
        kind="markov", seed=SEED)).batches(T_STEPS))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=300)
    on_card = train_steps(gpu, ocfg, batches)
    on_cpu = train_steps(cpu, ocfg, batches)
    e_loss = rel_err(on_card[0]["loss"], on_cpu[0]["loss"])
    e_norm = rel_err(on_card[0]["grad_norm"], on_cpu[0]["grad_norm"])
    e_last = rel_err(on_card[-1]["loss"], on_cpu[-1]["loss"])
    print(f"13 (a) tiny-ee {T_STEPS} steps of {T_BATCH}x{T_SEQ}: card loss "
          f"{on_card[0]['loss']:.6f} -> {on_card[-1]['loss']:.6f} "
          f"({step_times(on_card)}), CPU {on_cpu[0]['loss']:.6f} -> "
          f"{on_cpu[-1]['loss']:.6f} ({step_times(on_cpu)}); step 1 rel err "
          f"loss {e_loss:.2e} grad_norm {e_norm:.2e}, last loss "
          f"{e_last:.2e}")
    check(e_loss <= 1e-5 and e_norm <= 1e-5,
          "13 (a): step 1 differs between the card and the CPU")
    check(e_last <= 1e-2, "13 (a): the last losses differ")
    check(on_card[-1]["loss"] < 0.85 * on_card[0]["loss"],
          "13 (a): the loss did not fall below 0.85 x the first")


def family_batch(cfg, seed) -> dict:
    """2 x 16 tokens and labels, and whisper's frames or paligemma's
    patches, numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "mask": np.ones((b, s), np.float32)}
    if cfg.is_encdec:
        batch["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.vision_tokens:
        batch["patches"] = (rng.normal(size=(b, cfg.vision_tokens,
                                             cfg.d_model))
                            * 0.1).astype(np.float32)
    return batch


def check_train_families(dev) -> None:
    """(b) each of the JAX package's ten reduced families (2 layers,
    d_model 256), float32: one train step on the card and on the CPU from
    the same weights and batch; every loss and the gradient norm within
    ``FAMILY_RTOL``."""
    from repro_torch.configs.registry import ARCHS, get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.optim import AdamWConfig
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for i, arch in enumerate(a for a in ARCHS if a != CFG.name):
        cfg = get_smoke_config(arch)
        cpu = build_model(cfg, device="cpu", seed=SEED)
        gpu = build_model(cfg, device=dev, seed=SEED)
        gpu.load_state_dict(cpu.state_dict())
        batch = family_batch(cfg, SEED + i)
        got = train_steps(gpu, ocfg, [batch])[0]
        want = train_steps(cpu, ocfg, [batch])[0]
        errs = {k: rel_err(got[k], want[k]) for k in want
                if k not in ("lr", "s")
                and (k != "aux_loss" or want[k] != 0.0)}
        worst = max(errs, key=errs.get)
        print(f"13 (b) {arch}: loss {got['loss']:.6f} (CPU "
              f"{want['loss']:.6f}) aux {got['aux_loss']:.3e} grad_norm "
              f"{got['grad_norm']:.6f}; largest rel err {errs[worst]:.2e} "
              f"({worst})")
        check((got["aux_loss"] == 0.0) == (want["aux_loss"] == 0.0),
              f"13 (b) {arch}: an aux loss on one device only")
        check(errs[worst] <= FAMILY_RTOL,
              f"13 (b) {arch}: {worst} differs between the card and the CPU")


def train_full(dev):
    """(c) ee-llm-7b at full width and ``DEPTH``'s depth in float32 (the
    JAX package trains in float32): ``F_STEPS`` steps on one batch of
    copy sequences.  Returns (model, config)."""
    from repro_torch import tracing
    from repro_torch.data.synthetic import DataConfig, SyntheticCorpus
    from repro_torch.models.registry import build_model
    from repro_torch.training.optim import AdamWConfig, init_adamw
    from repro_torch.training.train_step import make_train_step
    cfg = smoke_config(CFG.name)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"13 (c) model: {cfg.name} {depth_of(cfg)} d={cfg.d_model} "
          f"heads {cfg.n_heads} of d={cfg.resolved_head_dim} d_ff="
          f"{cfg.d_ff} V={cfg.vocab_size} exits {cfg.exit_layers}, "
          f"{n_params / 1e9:.3f} B parameters in float32, initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    # copy sequences draw no markov table (V x V float64: 8 GB here)
    b = next(SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=F_SEQ, batch_size=F_BATCH,
        kind="copy", seed=SEED)).batches(1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    batch["tokens"] = batch["tokens"].long()
    step = make_train_step(model, AdamWConfig(lr=F_LR, warmup_steps=1,
                                              total_steps=F_STEPS))
    state = init_adamw(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, spans = [], [], []
    for _ in range(F_STEPS):
        t0 = time.perf_counter()
        with tracing.timed("gradients", "optimizer") as sp:
            state, mets = step(state, batch)
            losses.append(float(mets["loss"]))       # synchronises
        secs.append(time.perf_counter() - t0)
        spans.append(sp)
        check(np.isfinite(losses[-1]) and np.isfinite(
            float(mets["grad_norm"])), "13 (c): a loss is not finite")
    peak = torch.cuda.max_memory_allocated()
    tokens = F_BATCH * F_SEQ
    s_step = float(np.median(secs[1:]))
    # matmul work a step: forward, recompute under remat, backward
    flops = 8 * n_params * tokens
    print(f"13 (c) {F_STEPS} steps of {F_BATCH}x{F_SEQ} tokens: losses "
          f"{[round(l, 4) for l in losses]}; s/step {[round(s, 3) for s in secs]} "
          f"(median after the first {s_step:.3f} s, "
          f"{tokens / s_step:.1f} training tokens/s, "
          f"{flops / s_step / 1e12:.1f} TFLOP/s of 8*N*T); device s a step "
          f"(spans): gradients "
          f"{[round(sp['gradients'], 3) for sp in spans]}, optimizer "
          f"{[round(sp['optimizer'], 3) for sp in spans]}; peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated) | {nvidia_smi()}")
    check(losses[-1] < losses[0], "13 (c): the loss on the batch did not "
          "fall")
    del state, step
    model.zero_grad(set_to_none=True)
    free()
    return model, cfg


def check_checkpoint(model, cfg, dev) -> None:
    """(d) (c)'s parameters through ``save_checkpoint`` and ``serve.py``'s
    ``--ckpt`` loader into a fresh model (another seed): every tensor
    equal, and the same greedy streams of 2 clients (64-token prompts, 16
    new tokens) at θ = 1 on a float16 wire and at θ = 0 on an int8
    wire; then the loaded model through the batched engine on int8 pages
    (``launch.serve --kv-layout paged --kv-dtype int8 --wire int8``, in
    this process, so its launches count)."""
    from repro_torch.launch.serve import load_model
    from repro_torch.training.checkpoint import save_checkpoint
    CKPT_DIR.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase13-", dir=CKPT_DIR)
    try:
        path = os.path.join(tmp, cfg.name)
        t0 = time.perf_counter()
        save_checkpoint(path, model, cfg, extra={"steps": F_STEPS})
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(path + ".npz")
        t0 = time.perf_counter()
        fresh = load_model(cfg, device=dev, dtype=torch.float32,
                           seed=SEED + 1, ckpt=path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        same = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                     fresh.parameters()))
        print(f"13 (d) checkpoint: {nbytes} bytes written in {t_save:.1f} s "
              f"({nbytes / t_save / 1e9:.2f} GB/s), read into a fresh model "
              f"in {t_load:.1f} s; every tensor equal: {same}")
        check(same, "13 (d): the loaded parameters differ")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, F_PROMPT)
                   for _ in range(F_CLIENTS)]
        for theta, wire in ((1.0, "float16"), (0.0, "int8")):
            want = serve(model, prompts, "collm", theta, wire,
                         max_new=F_NEW)
            got = serve(fresh, prompts, "collm", theta, wire, max_new=F_NEW)
            print(f"13 (d) theta={theta} {wire} wire: loaded == trained: "
                  f"{got['tokens'] == want['tokens']}")
            check(got["tokens"] == want["tokens"],
                  f"13 (d): the loaded model's stream differs at theta="
                  f"{theta}")
        serve_batched(fresh, prompts, "13 (d) paged int8", "collm", 0.0,
                      "int8", kv_dtype="int8", max_new=F_NEW)
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_launchers() -> None:
    """(e) the entry points a user runs, as subprocesses: ``launch.train
    --smoke --ckpt`` on the card, then ``launch.serve --ckpt`` on paged
    int8 KV with an int8 wire."""
    CKPT_DIR.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase13-", dir=CKPT_DIR)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = os.path.join(tmp, "ee-llm-7b-smoke")
    cmds = [["repro_torch.launch.train", "--arch", CFG.name, "--smoke",
             "--steps", "20", "--ckpt", path],
            ["repro_torch.launch.serve", "--arch", CFG.name, "--smoke",
             "--ckpt", path, "--kv-layout", "paged", "--kv-dtype", "int8",
             "--wire", "int8"]]
    try:
        for cmd in cmds:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", *cmd], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=300)
            lines = r.stdout.splitlines()
            keep = [l for l in lines if l.startswith(
                ("step", "saved", "loaded", "agreement"))]
            print(f"13 (e) {' '.join(cmd)}: exit {r.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in keep:
                print(f"    {line}")
            check(r.returncode == 0, f"13 (e) {cmd[0]} failed: "
                  f"{r.stderr[-2000:]}")
        check(any(l.startswith("agreement vs cloud") for l in lines),
              "13 (e): the server printed no agreement line")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_13(dev, ops) -> dict:
    """Phase 13: training on the card, then the trained model's JAX-format
    checkpoint served through the kernels."""
    reset(ops)
    t13 = time.perf_counter()
    with torch.enable_grad():
        check_train_tiny(dev)
        t0 = lap(t13, "13 (a)")
        check_train_families(dev)
        t0 = lap(t0, "13 (b)")
        model, cfg = train_full(dev)
        t0 = lap(t0, "13 (c)")
    check_checkpoint(model, cfg, dev)
    del model
    free()
    t0 = lap(t0, "13 (d)")
    check_launchers()
    lap(t0, "13 (e)")
    got = counted(ops)
    print(f"phase 13 (training, checkpoints) launches: {got} in "
          f"{time.perf_counter() - t13:.1f} s")
    # the int8 wire packet comes from the exit_heads launch; the
    # launchers' subprocesses count their own launches
    for name in ("decode_attn", "exit_heads", "decode_attn_paged_int8",
                 "quantize_kv_write"):
        check(got[name] > 0, f"{name} was not launched in phase 13")
    return got


# ---------------------------------------------------------------------------
# phase 14: the cloud mesh (ranks on torch.distributed)
# ---------------------------------------------------------------------------
MESHES_14A = ((1, 2), (1, 4), (2, 2), (2, 1))   # (a): tiny-ee-tp, float32
SWAP_14 = ("swap", "swap-int8")          # (a), (b): swap preemption, both
SWAP_SCHEDULE = [(2, 1), (2, 0)]         # slots swapped out at tick 2: each
                                         # stream resumes in the other's
                                         # slot, over a data axis of 2 in
                                         # the other column
MULTI_SWAP_SCHEDULES = [[(2, 0)], None, None, [(2, 0)]]   # (a): the first
                                         # and last of four engines; the
                                         # first takes the last's batcher
                                         # row, the other column's
COMMAND_R = "command-r-35b"              # (c), at full width and depth
C_PROMPT, C_NEW = 256, 16                # (c): prompt tokens, new tokens
B_F32_NEW = 8                            # (b): new tokens of the f32 check
SWAP_NEW = 12                            # (b): new tokens of the swap runs
MESH_KERNELS = ("decode_attn", "decode_attn_paged", "decode_attn_paged_int8",
                "quantize_kv_write", "exit_heads")
DEADLINE_14 = 420                        # seconds a spawn of ranks may take
CFG_NAME_14B = "ee-llm-7b"               # (b), at full width and depth
LOGIT_TOL_14 = 0.1                       # (b), (c): teacher-forced bf16
                                         # logits, mesh against single
                                         # device: max |diff| / max |logit|
LOGIT_TOL_F32 = 1e-3                     # (d): the same in float32


def wide_theta(stats) -> float:
    """A threshold in the widest gap between the l_ee1 confidences of a
    run's middle half: about half its ticks exit early, and rounding that
    differs between the card, the CPU and the ranks' merged exit heads
    moves no confidence across it."""
    c = sorted(l1 for l1, _ in stats.confidences)
    lo, hi = len(c) // 4, max(len(c) // 4 + 1, 3 * len(c) // 4)
    i = max(range(lo, hi), key=lambda j: c[j + 1] - c[j])
    return (c[i] + c[i + 1]) / 2


def tiny_ee_tp_config():
    """The JAX package's tensor-parallel test model (``tests/test_cloud_tp.py``):
    tiny-ee's shape, 4 heads over 2 KV heads, so at model = 4 each rank
    keeps one query head and ``wk`` / ``wv`` stay whole."""
    return dataclasses.replace(tiny_ee_config(), name="tiny-ee-tp")


def mesh_scenarios():
    """Phase 14 (a)'s paths: name -> (how it runs, CollmConfig fields)."""
    return {"dense": ("multi", {}),
            "paged": ("multi", {"kv_layout": "paged"}),
            "int8": ("multi", {"kv_layout": "paged", "kv_dtype": "int8"}),
            "spec4": ("multi", {"speculative": True, "spec_k": 4}),
            "prefix": ("prefix", dict(kv_layout="paged", page_size=8,
                                      chunked_prefill=True,
                                      prefix_share=True)),
            "preempt": ("preempt", dict(kv_layout="paged",
                                        preemption="recompute")),
            "swap": ("swap", dict(kv_layout="paged", preemption="swap")),
            "swap-int8": ("swap", dict(kv_layout="paged", kv_dtype="int8",
                                       preemption="swap")),
            "swap-multi": ("swap-multi", dict(kv_layout="paged",
                                              preemption="swap"))}


def mesh_prompts():
    rng = np.random.default_rng(SEED)
    multi = [rng.integers(0, 256, n) for n in (7, 12, 9)]
    sysp = rng.integers(0, 256, 20)
    prefix = [np.concatenate([sysp, rng.integers(0, 256, n)]) for n in (5, 7)]
    preempt = [rng.integers(0, 256, n) for n in (7, 9)]
    return multi, prefix, preempt


def mesh_scenario(model, theta, name, dims=None, info=None) -> tuple:
    """One of ``mesh_scenarios`` on ``model`` (a rank's share under
    ``dims``): (streams, exits, prefix-hit tokens, preemptions); a swap
    scenario fills ``info`` (``swap_info``)."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    kind, ckw = mesh_scenarios()[name]
    system = ServingSystem(model, CollmConfig(theta=theta, cloud_mesh=dims,
                                              **ckw))
    multi, prefix, preempt = mesh_prompts()
    if kind == "multi":
        r = system.generate_multi(multi, 8)
    elif kind == "prefix":
        r = system.generate(prefix, 8)
    elif kind == "swap-multi":     # four engines behind one CloudBatcher
        r = system.generate_multi(multi + preempt[:1], 8,
                                  preempt_schedules=MULTI_SWAP_SCHEDULES)
    elif kind == "swap":
        with SwapSpy() as spy:
            r = system.generate(preempt, 8, num_slots=2,
                                preempt_schedule=SWAP_SCHEDULE)
        if info is not None:
            info.update(swap_info(system, spy))
    else:
        r = system.generate(preempt, 8, num_slots=2,
                            preempt_schedule=[(2, 0)])
    st = r["stats"]
    return (r["tokens"], st.exits_l1 + st.exits_l2, st.prefix_hit_tokens,
            st.preemptions)


class SwapSpy:
    """Within it, the engine's preemptions and resumes are recorded as
    (event, stream, slot), and each swap-out's pages snapshot timed on the
    card (``seconds``: every snapshot, gathered and, over a data axis, sent
    to every column)."""

    def __enter__(self):
        from repro_torch.serving.engine import BatchScheduler as BS
        self.moves, self.seconds = [], []
        self.saved = (BS._preempt, BS._resume, BS._swap_out_slot)
        pre, res, snap = self.saved
        spy = self

        def spy_pre(sched, s):
            spy.moves.append(("out", s.req.device_id, s.index))
            return pre(sched, s)

        def spy_res(sched, ck, slot):
            spy.moves.append(("in", ck.req.device_id, slot.index))
            return res(sched, ck, slot)

        def spy_snap(sched, s):
            sync()
            t0 = time.perf_counter()
            out = snap(sched, s)
            sync()
            spy.seconds.append(time.perf_counter() - t0)
            return out
        BS._preempt, BS._resume, BS._swap_out_slot = spy_pre, spy_res, \
            spy_snap
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.engine import BatchScheduler as BS
        BS._preempt, BS._resume, BS._swap_out_slot = self.saved
        return False

    def crossed(self, columns: int, slots: int = 2) -> bool:
        """Some stream resumed in another data column than it left."""
        left = {d: s for ev, d, s in self.moves if ev == "out"}
        per = slots // columns
        return any(s // per != left[d] // per
                   for ev, d, s in self.moves if ev == "in")


def swap_info(system, spy) -> dict:
    """A swap run's pool: its pages and columns, the rank's cloud pool
    (pages, bytes), the swap pool's stats, the snapshots' seconds and
    whether a resumed stream crossed columns."""
    import dataclasses as dc
    from repro_torch.models.cache_tree import cache_bytes
    sched = next(iter(system._schedulers.values()))
    node = sched.cloud_caches[next(iter(sched.cloud_caches))][0]["self"]
    return {"pool_pages": sched.pool.num_pages,
            "columns": sched.pool.columns,
            "cloud_pages": int(node["kp"].shape[0]),
            "cloud_bytes": cache_bytes(sched.cloud_caches),
            "swap": dc.astuple(sched.swap.stats),
            "snapshot_s": sum(spy.seconds),
            "crossed": spy.crossed(sched.pool.columns),
            "moves": list(spy.moves)}


def check_swap_info(label, info, one, dims) -> None:
    """A mesh's swap run against the single device's (``one``): the
    swaps counted alike, the pool's pages alike, a rank's cloud pool its
    column's P / D pages and a trash page (the single device's bytes in
    that proportion without a model axis, the snapshots' bytes too), and
    over a data axis a resumed stream in the other column."""
    d = dims[0]
    p = one["pool_pages"]
    check(info["swap"][:2] == one["swap"][:2] == (2, 2),
          f"{label}: swap counts {info['swap'][:2]}, single device "
          f"{one['swap'][:2]}")
    check(info["pool_pages"] == p and info["columns"] == d
          and info["cloud_pages"] == p // d + 1,
          f"{label}: pool of {info['pool_pages']} pages in "
          f"{info['columns']} columns, {info['cloud_pages']} on the rank")
    if dims[1] == 1:
        check(info["cloud_bytes"] * (p + 1)
              == one["cloud_bytes"] * (p // d + 1)
              and info["swap"] == one["swap"],
              f"{label}: cloud pool {info['cloud_bytes']} B or snapshots "
              f"{info['swap']} off the single device's")
    if d > 1:
        check(info["crossed"], f"{label}: no stream resumed in another "
              f"column ({info['moves']})")


def rank_setup():
    """A rank's card, float32 products exact (as ``setup``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rank_14a(rank, world, dims, state, theta) -> dict:
    """Phase 14 (a) on one rank of ``dims``: its share of tiny-ee-tp from
    the whole model's ``state``, every path, its own launches."""
    from repro_torch.launch.mesh import make_cloud_mesh
    from repro_torch.models.transformer import Model
    rank_setup()
    mesh = make_cloud_mesh(dims)
    model = Model(tiny_ee_tp_config(), device=mesh.device,
                  axis=mesh.model_axis).load_whole(state)
    ops = kernel_ops()
    reset(ops)
    swaps = {name: {} for name in SWAP_14}
    runs = {name: mesh_scenario(model, theta, name, dims, swaps.get(name))
            for name in mesh_scenarios()}
    return {"runs": runs, "launches": counted(ops), "swaps": swaps,
            "mesh": mesh.describe(), "device": str(mesh.device)}


def phase_14a(dev, ops) -> dict:
    """Phase 14 (a): tiny-ee-tp in float32 over meshes (1, 2), (1, 4) and
    (2, 2), ranks sharing the card: every path's streams equal the
    single-device card's and the CPU's, at a split θ (exits fire, so the
    merged exit heads decide), and every rank launches the ring, both
    paged kernels, the int8 page writes and ``exit_heads``."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.transformer import Model
    reset(ops)
    t0 = time.perf_counter()
    cfg = tiny_ee_tp_config()
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    gpu = Model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    full = ServingSystem(cpu, CollmConfig(theta=1.0)).generate_sequential(
        mesh_prompts()[0], 8)
    theta = wide_theta(full["stats"])
    want = {name: mesh_scenario(cpu, theta, name)
            for name in mesh_scenarios()}
    one_swap = {name: {} for name in SWAP_14}
    one = {name: mesh_scenario(gpu, theta, name, info=one_swap.get(name))
           for name in mesh_scenarios()}
    check(one == want, "14 (a): the card's single-device runs differ from "
          "the CPU's")
    check(want["prefix"][2] > 0 and want["preempt"][3] == 1
          and want["dense"][1] > 0 and want["swap"][3] == 2
          and want["swap-multi"][3] == 2,
          "14 (a): no prefix hits, preemptions or exits")
    print(f"14 (a) tiny-ee-tp float32, theta {theta:.6f}: single device "
          f"card == CPU in {len(want)} paths (exits {want['dense'][1]}, "
          f"prefix hits {want['prefix'][2]})")
    got = counted(ops)
    state = cpu.state_dict()
    for dims in MESHES_14A:
        t1 = time.perf_counter()
        outs = spawn(rank_14a, dims[0] * dims[1], device="cuda",
                     timeout=DEADLINE_14, args=(dims, state, theta))
        for rank, out in enumerate(outs):
            check(out["runs"] == want,
                  f"14 (a) {dims}: rank {rank}'s runs differ from the "
                  f"single device's")
            for name in MESH_KERNELS:
                check(out["launches"][name] > 0,
                      f"14 (a) {dims}: rank {rank} launched no {name}")
            for name in SWAP_14:
                check_swap_info(f"14 (a) {dims} rank {rank} {name}",
                                out["swaps"][name], one_swap[name], dims)
            got = total(got, out["launches"])
        print(f"14 (a) {outs[0]['mesh']} on {outs[0]['device']}...: "
              f"{len(outs)} ranks x {len(want)} paths == single device; "
              f"rank 0 launches {outs[0]['launches']} "
              f"({time.perf_counter() - t1:.1f} s)")
        for name in SWAP_14:
            i, o = outs[0]["swaps"][name], one_swap[name]
            print(f"  {name}: rank 0's cloud pool {i['cloud_pages']} pages "
                  f"{i['cloud_bytes']} B (single device {o['cloud_pages']} "
                  f"pages {o['cloud_bytes']} B), snapshots {i['swap'][2]} B "
                  f"in {i['snapshot_s'] * 1e3:.3f} ms (single device "
                  f"{o['swap'][2]} B in {o['snapshot_s'] * 1e3:.3f} ms), "
                  f"moves {i['moves']}")
    print(f"phase 14 (a) launches: {got} in {time.perf_counter() - t0:.1f} s")
    return got


def sync() -> None:
    torch.cuda.synchronize()


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def timed_generate(system, prompts, max_new, **kw):
    sync()
    t0 = time.perf_counter()
    r = system.generate(prompts, max_new, **kw)
    sync()
    r["seconds"] = time.perf_counter() - t0
    return r


def mesh_runs(model, prompts, max_new, theta, runs, dims=None) -> dict:
    """``runs`` ({label: (mode, CollmConfig fields)}) of ``model`` at
    ``theta`` with a float16 wire, each timed: {label: (streams,
    tokens/s, exits, cloud requests)}."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    out = {}
    for label, (mode, ckw) in runs.items():
        system = ServingSystem(model, CollmConfig(theta=theta,
                                                  cloud_mesh=dims, **ckw))
        r = timed_generate(system, prompts, max_new, mode=mode,
                           num_slots=len(prompts))
        st = r["stats"]
        out[label] = (r["tokens"], st.tokens / r["seconds"],
                      st.exits_l1 + st.exits_l2, st.cloud_requests)
    return out


def ee_runs():
    return {"dense": ("collm", {}),
            "paged-int8": ("collm", dict(kv_layout="paged", kv_dtype="int8",
                                         page_size=G_PAGE))}


def f32_runs():
    return {"dense": ("collm", {"wire_format": "float32"})}


def swap_runs(model, prompts, max_new, theta, dims=None) -> dict:
    """ee-llm-7b's swap paths: paged float and int8 pools with
    ``preemption="swap"`` forced on both of two slots at tick 2
    (``SWAP_SCHEDULE``), on a float16 wire: {label: (streams, tokens/s,
    exits, cloud requests, ``swap_info``)}."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    out = {}
    for label, ckw in (("paged swap", {}),
                       ("paged-int8 swap", {"kv_dtype": "int8"})):
        system = ServingSystem(model, CollmConfig(
            theta=theta, cloud_mesh=dims, kv_layout="paged",
            page_size=G_PAGE, preemption="swap", **ckw))
        with SwapSpy() as spy:
            r = timed_generate(system, prompts, max_new, num_slots=2,
                               preempt_schedule=SWAP_SCHEDULE)
        st = r["stats"]
        out[label] = (r["tokens"], st.tokens / r["seconds"],
                      st.exits_l1 + st.exits_l2, st.cloud_requests,
                      swap_info(system, spy))
    return out


def rank_bytes(model) -> int:
    """Device bytes behind the model's parameters (their storages: a
    parameter that viewed a whole tensor would count it all)."""
    return sum(p.untyped_storage().nbytes() for p in model.parameters())


def estimate_bytes(cfg, dims, itemsize) -> float:
    from repro_torch.bridge import param_leaves
    from repro_torch.launch.sharding import (AXES, MeshShape,
                                             estimate_param_bytes_per_device)
    return estimate_param_bytes_per_device(
        param_leaves(cfg, itemsize), MeshShape(dims, AXES), False,
        cfg.resolved_head_dim)


def forced(model, prompts, streams, logits=True, inputs=None) -> dict:
    """Teacher-forced heads of ``model`` on a run's ``streams``: one
    forward of each client's prompt and its stream but the last token
    (after its frames or patches: ``inputs``, a ``prefixed_batch``),
    read at the T positions that chose the stream's tokens.  On the CPU, a
    list with one entry a client: "margin" (heads, T), each head's top-2
    logit margin, the exit layers' heads first, then the final one;
    "tok", "conf" (exits, T), the ``exit_heads`` kernel's merged token and
    confidence; with ``logits``, "logits" (heads, T, V) in the dtype the
    heads compute in (the model's).  Every rank of a mesh runs it (its collectives)."""
    from repro_torch.core.exits import evaluate_exits
    layers = tuple(sorted(model.cfg.exit_layers))
    norms = torch.stack([model.exit_norms[str(l)] for l in layers])
    out = {"margin": [], "tok": [], "conf": [], "logits": []}
    prefix = model.cfg.vision_tokens
    with torch.no_grad():
        for c, (p, s) in enumerate(zip(prompts, streams)):
            seq = np.concatenate([np.asarray(p, np.int64),
                                  np.asarray(s[:-1], np.int64)])
            batch = {"tokens": torch.as_tensor(seq, device=model.device)[None]}
            for k, v in (inputs or {}).items():
                if k != "tokens":
                    batch[k] = v[c:c + 1].to(model.device)
            h = model.forward_train_hiddens(batch)
            at = slice(prefix + len(p) - 1, prefix + len(seq))
            hs = [h["exits"][l][0, at] for l in layers]
            lg = torch.stack(
                [model.exit_logits(l, x) for l, x in zip(layers, hs)]
                + [model.logits(h["final"][0, at])])
            top = lg.float().topk(2, dim=-1).values
            out["margin"].append((top[..., 0] - top[..., 1]).cpu())
            if logits:
                out["logits"].append(lg.cpu())
            decs, _ = evaluate_exits(hs, model.unembed_weight(), norms,
                                     model.cfg.norm_eps,
                                     axis=model.vocab_axis)
            out["tok"].append(torch.stack([d.token for d in decs]).cpu())
            out["conf"].append(torch.stack([d.confidence for d in decs])
                               .float().cpu())
    return out


def head_names(cfg) -> list:
    return [f"exit {l}" for l in sorted(cfg.exit_layers)] + ["final"]


def hold_forced(label, cfg, ref, got, tol=None, ulp=2.0 ** -8) -> None:
    """A rank's teacher-forced heads ``got`` against the single device's
    ``ref`` on the same tokens (``forced``).  Each head's logits lie
    within ``tol`` (``LOGIT_TOL_14``) of its largest |logit| (a vocabulary
    offset, or a rank reading another rank's heads, moves them by about
    that largest |logit|).  With e = that head's largest difference plus
    one rounding (``ulp``: bf16's) of its largest logit (the kernel's
    logits are not rounded to the model's dtype), the exit kernel's
    merged log-confidence lies within 2 e of the single device's (the max
    logit and the lse each move at most e), and its token is the single
    device's wherever the single device's top-2 margin exceeds 2 e."""
    tol = LOGIT_TOL_14 if tol is None else tol
    ref_l, got_l = (torch.cat(f["logits"], 1).float() for f in (ref, got))
    ref_c, got_c = (torch.cat(f["conf"], 1).log() for f in (ref, got))
    ref_t, got_t = (torch.cat(f["tok"], 1) for f in (ref, got))
    margin = torch.cat(ref["margin"], 1)
    v = ref_l.shape[-1]
    for k, name in enumerate(head_names(cfg)):
        big = ref_l[k].abs().max().item()
        d = (got_l[k] - ref_l[k]).abs().max().item()
        roll = (ref_l[k].roll(v // 2, -1) - ref_l[k]).abs().max().item()
        line = (f"  {label} {name}: teacher-forced logits max |diff| "
                f"{d:.6g} = {d / big:.6g} of max |logit| {big:.6g} (limit "
                f"{tol}; shifted by V/2: {roll / big:.6g})")
        check(d <= tol * big,
              f"14 {label} {name}: the mesh's logits differ from the "
              f"single device's by {d / big:.4g} of the largest")
        if k < len(cfg.exit_layers):
            e = d + big * ulp
            dlog = (got_c[k] - ref_c[k]).abs().max()
            wide = margin[k] > 2 * e
            same = got_t[k] == ref_t[k]
            line += (f"; kernel max |diff log conf| {dlog.item():.6g} "
                     f"(limit {2 * e:.6g}), tokens equal {int(same.sum())}/"
                     f"{same.numel()}, at {int(wide.sum())} margins above "
                     f"{2 * e:.6g}: {int(same[wide].sum())}")
            check(dlog.item() <= 2 * e and bool(same[wide].all()),
                  f"14 {label} {name}: the mesh's exit kernel differs from "
                  f"the single device's")
        print(line)


def first_splits(label, cfg, theta, ref_runs, ref_forced, runs) -> None:
    """For each stream of ``runs`` that differs from the single device's
    (``ref_runs``), the single device's top-2 logit margins and exit
    confidences at the first token that differs (``ref_forced``: ``forced``
    on each of its runs' streams, through the model's float-KV forward
    whatever the run's KV layout): near ties, or confidences near θ,
    explain a bf16 split; wide margins would not."""
    names = head_names(cfg)
    for run, (toks, *_) in runs.items():
        for c, (a, b) in enumerate(zip(toks, ref_runs[run][0])):
            if a == b:
                continue
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            f = ref_forced[run]
            if i == len(b):         # the single device's stream ended
                print(f"  {label} {run} client {c}: {len(a)} tokens for "
                      f"the single device's {len(b)}")
                continue
            m = ", ".join(f"{n} {f['margin'][c][k, i].item():.4g}"
                          for k, n in enumerate(names))
            conf = ", ".join(f"{n} {f['conf'][c][k, i].item():.4f}"
                             for k, n in enumerate(names[:-1]))
            print(f"  {label} {run} client {c}: first differs at token {i} "
                  f"({a[i] if i < len(a) else '-'} for {b[i]}); single "
                  f"device's top-2 "
                  f"margins {m}; exit confidences {conf} (theta "
                  f"{theta:.6f})")


def rank_14b(rank, world, cfg, prompts, theta, max_new, streams) -> dict:
    """Phase 14 (b) on one rank of (1, 2): its share of ee-llm-7b (all 32
    layers) in bf16 at ``theta`` on dense and paged int8 KV, its heads
    teacher-forced on the single device's dense ``streams``, then in
    float32 at θ = 1."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_cloud_mesh
    from repro_torch.models.registry import build_model
    rank_setup()
    dims = (1, world)
    mesh = make_cloud_mesh(dims)
    ops = kernel_ops()
    sharding.reset_counts()
    model = build_model(cfg, device=mesh.device, dtype=torch.bfloat16,
                        seed=SEED, axis=mesh.model_axis)
    out = {"mesh": mesh.describe(), "bytes": rank_bytes(model),
           "estimate": estimate_bytes(cfg, dims, 2)}
    reset(ops)
    out["bf16"] = mesh_runs(model, prompts, max_new, theta, ee_runs(), dims)
    launches = counted(ops)
    out["forced"] = forced(model, prompts, streams, logits=rank == 0)
    del model
    free()
    model = build_model(cfg, device=mesh.device, dtype=torch.float32,
                        seed=SEED, axis=mesh.model_axis)
    reset(ops)
    out["f32"] = mesh_runs(model, prompts, B_F32_NEW, 1.0, f32_runs(), dims)
    out["launches"] = total(launches, counted(ops))
    out["collectives"] = dict(sharding.COUNTS)
    out["peak_gib"] = peak_gib()
    # the same two ranks as a data axis of 2: the whole model on each, the
    # paged pool split over the columns, swaps across them
    del model
    free()
    swap_dims = (world, 1)
    model = build_model(cfg, device=mesh.device, dtype=torch.bfloat16,
                        seed=SEED)
    reset(ops)
    out["swap"] = swap_runs(model, prompts, SWAP_NEW, theta, swap_dims)
    out["swap_launches"] = counted(ops)
    out["launches"] = total(out["launches"], out["swap_launches"])
    out["swap_peak_gib"] = peak_gib()
    return out


def print_mesh_runs(label, runs) -> None:
    for name, (toks, tps, exits, cloud) in runs.items():
        print(f"  {label} {name}: {tps:.2f} tokens/s, exits {exits}, cloud "
              f"requests {cloud}")


def phase_14b(dev, ops) -> dict:
    """Phase 14 (b): ee-llm-7b at full width and depth over (1, 2)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.collm import CollmConfig
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingSystem
    t0 = time.perf_counter()
    cfg = get_config(CFG_NAME_14B)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN)
               for _ in range(CLIENTS)]
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    r = ServingSystem(model, CollmConfig(theta=1.0)).generate(
        prompts, MAX_NEW, num_slots=CLIENTS)
    theta = split_theta(r["stats"])
    reset(ops)
    one = mesh_runs(model, prompts, MAX_NEW, theta, ee_runs())
    one_swap = swap_runs(model, prompts, SWAP_NEW, theta)
    got = counted(ops)
    one_forced = {name: forced(model, prompts, one[name][0],
                               logits=name == "dense") for name in one}
    one_forced.update({name: forced(model, prompts, one_swap[name][0],
                                    logits=False) for name in one_swap})
    del model
    free()
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=SEED)
    reset(ops)
    one32 = mesh_runs(model, prompts, B_F32_NEW, 1.0, f32_runs())
    got = total(got, counted(ops))
    del model
    free()
    print(f"14 (b) {cfg.name} {cfg.n_layers} layers d={cfg.d_model}, "
          f"{CLIENTS} clients x {PROMPT_LEN} tokens, theta {theta:.6f}: "
          f"single device")
    print_mesh_runs("single", one)
    print_mesh_runs("single f32 theta=1", one32)
    outs = spawn(rank_14b, 2, device="cuda", timeout=DEADLINE_14,
                 args=(cfg, prompts, theta, MAX_NEW, one["dense"][0]))
    hold_forced("(b) dense", cfg, one_forced["dense"], outs[0]["forced"])
    for rank, out in enumerate(outs):
        print(f"14 (b) rank {rank} {out['mesh']}: parameters "
              f"{out['bytes'] / 1e9:.3f} GB (estimate "
              f"{out['estimate'] / 1e9:.3f} GB), peak {out['peak_gib']:.2f} "
              f"GiB, collectives {out['collectives']}")
        check(out["bytes"] == out["estimate"],
              f"14 (b) rank {rank}: its parameters are not the estimate")
        check(out["f32"]["dense"][0] == one32["dense"][0],
              f"14 (b) rank {rank}: float32 theta=1 differs from the "
              f"single device")
        for name in ee_runs():
            print(f"  rank {rank} {name}: agreement with the single device "
                  f"{agreement(out['bf16'][name][0], one[name][0])}")
        print_mesh_runs(f"rank {rank}", out["bf16"])
        first_splits(f"(b) rank {rank}", cfg, theta, one, one_forced,
                     out["bf16"])
        for name in ("decode_attn", "decode_attn_paged_int8",
                     "quantize_kv_write", "exit_heads"):
            check(out["launches"][name] > 0,
                  f"14 (b) rank {rank} launched no {name}")
        got = total(got, out["launches"])
    check(outs[0]["bf16"]["dense"][0] == outs[1]["bf16"]["dense"][0],
          "14 (b): the ranks' streams differ")
    for label, (toks, tps, exits, cloud, info) in one_swap.items():
        print(f"14 (b) single {label}: {tps:.2f} tokens/s, exits {exits}, "
              f"cloud requests {cloud}; cloud pool {info['cloud_pages']} "
              f"pages {info['cloud_bytes'] / 1e6:.3f} MB, snapshots "
              f"{info['swap'][2] / 1e6:.3f} MB in "
              f"{info['snapshot_s'] * 1e3:.3f} ms, moves {info['moves']}")
    for rank, out in enumerate(outs):
        for name in ("decode_attn_paged", "decode_attn_paged_int8",
                     "quantize_kv_write"):
            check(out["swap_launches"][name] > 0,
                  f"14 (b) (2, 1) rank {rank} launched no {name}")
        for label, (toks, tps, exits, cloud, info) in out["swap"].items():
            check_swap_info(f"14 (b) (2, 1) rank {rank} {label}", info,
                            one_swap[label][4], (2, 1))
            print(f"14 (b) (2, 1) rank {rank} {label}: {tps:.2f} tokens/s, "
                  f"exits {exits}, cloud requests {cloud}; agreement with "
                  f"the single device {agreement(toks, one_swap[label][0])}"
                  f"; cloud pool {info['cloud_pages']} pages "
                  f"{info['cloud_bytes'] / 1e6:.3f} MB, snapshots "
                  f"{info['swap'][2] / 1e6:.3f} MB in "
                  f"{info['snapshot_s'] * 1e3:.3f} ms, moves "
                  f"{info['moves']}, peak {out['swap_peak_gib']:.2f} GiB")
        first_splits(f"(b) (2, 1) rank {rank}", cfg, theta,
                     {k: v[:4] for k, v in one_swap.items()}, one_forced,
                     {k: v[:4] for k, v in out["swap"].items()})
    print(f"14 (b) float32 theta=1 over (1, 2) == single device: True; "
          f"{time.perf_counter() - t0:.1f} s")
    return got


def c_runs():
    return {"cloud dense": ("cloud", {}),
            "cloud paged": ("cloud", dict(kv_layout="paged",
                                          page_size=G_PAGE)),
            "collm dense": ("collm", {}),
            "collm paged": ("collm", dict(kv_layout="paged",
                                          page_size=G_PAGE))}


def c_config():
    """command-r-35b at full width and depth (every cut: none)."""
    from repro_torch.configs.registry import get_config
    return get_config(COMMAND_R)


def c_prompts(cfg):
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, C_PROMPT)
            for _ in range(CLIENTS)]


def rank_14c_single(rank, world, cfg, prompts, max_new) -> dict:
    """Phase 14 (c)'s single-device run, in a process of its own: θ = 1
    (equal to cloud) for the split θ, then ``c_runs`` at it."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingSystem
    rank_setup()
    ops = kernel_ops()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    sync()
    init_s = time.perf_counter() - t0
    r = ServingSystem(model, CollmConfig(theta=1.0)).generate(
        prompts, max_new, num_slots=len(prompts))
    theta = split_theta(r["stats"])
    reset(ops)
    runs = mesh_runs(model, prompts, max_new, theta, c_runs())
    launches = counted(ops)
    check(r["tokens"] == runs["cloud dense"][0],
          "14 (c): collm theta=1 differs from cloud on one device")
    heads = {name: forced(model, prompts, runs[name][0],
                          logits=name == "cloud dense") for name in runs}
    return {"theta": theta, "runs": runs, "forced": heads,
            "bytes": rank_bytes(model),
            "init_s": init_s, "launches": launches,
            "peak_gib": peak_gib()}


def rank_14c(rank, world, cfg, prompts, max_new, theta, streams) -> dict:
    """Phase 14 (c) on one rank of (1, 2): its share of command-r-35b
    (built one rank after the other, so that one rank's whole-parameter
    draws never meet the other's), ``c_runs`` at ``theta``, the
    collectives' counts and host seconds, then its heads teacher-forced
    on the single device's cloud ``streams``."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_cloud_mesh, one_at_a_time
    from repro_torch.models.registry import build_model
    rank_setup()
    dims = (1, world)
    mesh = make_cloud_mesh(dims)
    ops = kernel_ops()
    t0 = time.perf_counter()
    model = one_at_a_time(mesh, lambda: build_model(
        cfg, device=mesh.device, dtype=torch.bfloat16, seed=SEED,
        axis=mesh.model_axis))
    init_s = time.perf_counter() - t0
    reset(ops)
    sharding.reset_counts()
    runs = mesh_runs(model, prompts, max_new, theta, c_runs(), dims)
    out = {"mesh": mesh.describe(), "runs": runs, "init_s": init_s,
           "bytes": rank_bytes(model),
           "estimate": estimate_bytes(cfg, dims, 2),
           "launches": counted(ops),
           "collectives": dict(sharding.COUNTS),
           "collective_s": dict(sharding.SECONDS)}
    out["forced"] = forced(model, prompts, streams, logits=rank == 0)
    out["peak_gib"] = peak_gib()
    return out


def phase_14c(dev, ops) -> dict:
    """Phase 14 (c): command-r-35b at full width over (1, 2)."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    cfg = c_config()
    prompts = c_prompts(cfg)
    (one,) = spawn(rank_14c_single, 1, device="cuda",
                   timeout=DEADLINE_14, args=(cfg, prompts, C_NEW))
    print(f"14 (c) {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} V={cfg.vocab_size}: single device "
          f"{one['bytes'] / 1e9:.2f} GB initialised in {one['init_s']:.1f} "
          f"s, peak {one['peak_gib']:.2f} GiB, theta {one['theta']:.6f}")
    print_mesh_runs("single", one["runs"])
    got = one["launches"]
    outs = spawn(rank_14c, 2, device="cuda", timeout=DEADLINE_14,
                 args=(cfg, prompts, C_NEW, one["theta"],
                       one["runs"]["cloud dense"][0]))
    hold_forced("(c) cloud", cfg, one["forced"]["cloud dense"],
                outs[0]["forced"])
    tokens = sum(len(t) for t in outs[0]["runs"]["collm dense"][0])
    for rank, out in enumerate(outs):
        print(f"14 (c) rank {rank} {out['mesh']}: parameters "
              f"{out['bytes'] / 1e9:.3f} GB (estimate "
              f"{out['estimate'] / 1e9:.3f} GB), initialised in "
              f"{out['init_s']:.1f} s, peak {out['peak_gib']:.2f} GiB")
        check(out["bytes"] == out["estimate"],
              f"14 (c) rank {rank}: its parameters are not the estimate")
        for name in c_runs():
            print(f"  rank {rank} {name}: agreement with the single device "
                  f"{agreement(out['runs'][name][0], one['runs'][name][0])}")
        print_mesh_runs(f"rank {rank}", out["runs"])
        first_splits(f"(c) rank {rank}", cfg, one["theta"], one["runs"],
                     one["forced"], out["runs"])
        runs_tokens = sum(len(t) for r in out["runs"].values() for t in r[0])
        per = {k: f"{out['collectives'][k] / runs_tokens:.1f} calls, "
                  f"{out['collective_s'][k] / runs_tokens * 1e3:.3f} ms"
               for k in out["collectives"]}
        print(f"  rank {rank} collectives a token: {per}")
        for name in ("decode_attn", "decode_attn_paged", "exit_heads"):
            check(out["launches"][name] > 0,
                  f"14 (c) rank {rank} launched no {name}")
        got = total(got, out["launches"])
    for name in c_runs():
        check(outs[1]["runs"][name][0] == outs[0]["runs"][name][0],
              f"14 (c) {name}: the ranks' streams differ")
    check(tokens > 0, "14 (c): no tokens")
    print(f"14 (c): {time.perf_counter() - t0:.1f} s")
    return got


# -- this slice's families: the recurrent, hybrid, encoder-decoder and
# vision-prefix models on the mesh --------------------------------------
FAMILIES_14 = (XLSTM, ZAMBA2, WHISPER, PALIGEMMA)
MESHES_14A_FAM = ((1, 2), (2, 2))       # (a): the families, reduced, f32
D_PROMPT, D_NEW, D_ROWS = 64, 8, 2      # (d): tokens, new tokens, rows


def family_config(arch, full: bool):
    """``arch`` at full width and depth, or reduced as the CPU tests have
    it (4 layers with exits 1 and 2, d_model 256; whisper 2 encoder layers
    over 64 frames, paligemma 16 patches)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if full:
        return cfg
    return dataclasses.replace(reduced(cfg, n_layers=4), exit_layers=(1, 2),
                               encoder_layers=min(2, cfg.encoder_layers)
                               ).validate()


def family_inputs(cfg, rows, prompt_len, seed):
    """Token prompts (a list) for a token-prompt model, else a
    ``prefixed_batch`` of ``rows`` rows."""
    if cfg.is_encdec or cfg.vision_tokens:
        return prefixed_batch(cfg, rows, prompt_len, seed)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, prompt_len)
            for _ in range(rows)]


FAMILY_PATHS = {"cloud": ("cloud", "float16"),
                "collm float16": ("collm", "float16"),
                "collm int8": ("collm", "int8"),
                "standalone": ("standalone", "float16")}
D_PATHS = ("cloud", "collm int8")       # (d)


def family_runs(model, inputs, theta, max_new, dims=None,
                names=tuple(FAMILY_PATHS)) -> dict:
    """The family's paths ``names`` at ``theta`` (``FAMILY_PATHS``: cloud,
    collm on a float16 and an int8 wire, standalone); ``generate`` over
    every row at once for a token-prompt model (zamba2 on paged KV),
    ``prefixed_stream`` otherwise: {path: (streams, tokens/s, exits, cloud
    requests)}."""
    paths = {k: FAMILY_PATHS[k] for k in names}
    if isinstance(inputs, dict):
        inputs = {k: v.to(model.device) for k, v in inputs.items()}
        out = {}
        for label, (mode, wire) in paths.items():
            r = prefixed_stream(model, inputs, mode, theta, wire, max_new,
                                cloud_mesh=dims)
            n = sum(len(t) for t in r["tokens"])
            out[label] = (r["tokens"], n / r["wall_s"],
                          r["exits_l1"] + r["exits_l2"], r["cloud_requests"])
        return out
    paged = ({"kv_layout": "paged", "page_size": G_PAGE}
             if model.cfg.name.startswith(ZAMBA2) else {})
    return mesh_runs(model, inputs, max_new, theta,
                     {label: (mode, dict(paged, wire_format=wire))
                      for label, (mode, wire) in paths.items()}, dims)


def family_theta(model, inputs, max_new) -> float:
    """A θ between the middle quartiles of a θ = 1 collm run's per-tick
    larger exit confidence (a quarter to three quarters of the ticks go
    to the cloud), in the widest gap there between any two confidences of
    either exit: rounding that differs between the card, the CPU and the
    ranks moves no confidence across it."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    if isinstance(inputs, dict):
        confs = prefixed_stream(model, {k: v.to(model.device)
                                        for k, v in inputs.items()},
                                "collm", 1.0, "float32", max_new)["confs"]
    else:
        confs = ServingSystem(model, CollmConfig(theta=1.0)).generate(
            inputs, max_new, num_slots=len(inputs))["stats"].confidences
    top = sorted(max(pair) for pair in confs)
    lo, hi = top[len(top) // 4], top[3 * len(top) // 4]
    c = sorted({lo, hi} | {x for pair in confs for x in pair
                           if lo <= x <= hi})
    i = max(range(len(c) - 1), key=lambda j: c[j + 1] - c[j])
    return (c[i] + c[i + 1]) / 2


def rank_14a_families(rank, world, dims, specs) -> dict:
    """Phase 14 (a)'s families on one rank of ``dims``: each reduced
    model's share from the whole model's state, every path."""
    from repro_torch.launch.mesh import make_cloud_mesh
    from repro_torch.models.transformer import Model
    rank_setup()
    mesh = make_cloud_mesh(dims)
    ops = kernel_ops()
    reset(ops)
    runs = {}
    for arch, (state, inputs, theta) in specs.items():
        model = Model(family_config(arch, False), device=mesh.device,
                      axis=mesh.model_axis).load_whole(state)
        runs[arch] = {k: v[0] for k, v in family_runs(
            model, inputs, theta, 8, dims).items()}
    return {"runs": runs, "launches": counted(ops), "mesh": mesh.describe()}


def phase_14a_families(dev, ops) -> dict:
    """Phase 14 (a) for the four families, reduced, in float32 over (1, 2)
    and (2, 2) (the pools' rows over the data axis): every rank's streams
    in every path equal the single-device card's and the CPU's."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    reset(ops)
    specs, want = {}, {}
    for arch in FAMILIES_14:
        cfg = family_config(arch, False)
        cpu = build_model(cfg, device="cpu", seed=SEED)
        gpu = build_model(cfg, device=dev, seed=SEED)
        gpu.load_state_dict(cpu.state_dict())
        inputs = family_inputs(cfg, 2, 12 if cfg.vision_tokens or
                               cfg.is_encdec else 37, SEED)
        theta = family_theta(cpu, inputs, 8)
        want[arch] = {k: v[0] for k, v in family_runs(cpu, inputs, theta,
                                                      8).items()}
        one = {k: v[0] for k, v in family_runs(gpu, inputs, theta,
                                               8).items()}
        check(one == want[arch], f"14 (a) {arch}: the card's single-device "
              f"runs differ from the CPU's")
        specs[arch] = (cpu.state_dict(), inputs, theta)
        del gpu
    got = counted(ops)
    for dims in MESHES_14A_FAM:
        t1 = time.perf_counter()
        outs = spawn(rank_14a_families, dims[0] * dims[1], device="cuda",
                     timeout=DEADLINE_14, args=(dims, specs))
        for rank, out in enumerate(outs):
            for arch in FAMILIES_14:
                check(out["runs"][arch] == want[arch],
                      f"14 (a) {arch} {dims}: rank {rank}'s runs differ "
                      f"from the single device's")
            for name in ("decode_attn", "decode_attn_paged", "exit_heads"):
                check(out["launches"][name] > 0,
                      f"14 (a) families {dims}: rank {rank} launched no "
                      f"{name}")
            got = total(got, out["launches"])
        print(f"14 (a) {', '.join(FAMILIES_14)} reduced float32, "
              f"{outs[0]['mesh']}: {len(outs)} ranks x 4 paths == single "
              f"device card == CPU ({time.perf_counter() - t1:.1f} s)")
    print(f"phase 14 (a) families: {time.perf_counter() - t0:.1f} s")
    return got


def bf16_envelope(label, cfg, ref32, ref, got) -> None:
    """The mesh's bf16 teacher-forced logits ``got`` against the single
    device's ``ref``, and both against the single device's float32
    ``ref32`` on the same tokens, each head's largest difference as a
    share of its largest |logit|: the mesh lies no farther from float32
    than the single device's own bf16 logits do, plus ``LOGIT_TOL_14``
    (xlstm's bf16 heads lie up to 0.34 of it from float32 on one device,
    so a fixed bound between two bf16 runs would not hold; a rank reading
    another's heads moves them by about the largest |logit|)."""
    r32, r16, g16 = (torch.cat(f["logits"], 1).float()
                     for f in (ref32, ref, got))
    for k, name in enumerate(head_names(cfg)):
        big = r32[k].abs().max().item()
        d_mesh = (g16[k] - r16[k]).abs().max().item() / big
        d_one = (r16[k] - r32[k]).abs().max().item() / big
        d_mesh32 = (g16[k] - r32[k]).abs().max().item() / big
        print(f"  {label} {name}: mesh vs single {d_mesh:.6g}, single bf16 "
              f"vs float32 {d_one:.6g}, mesh bf16 vs float32 "
              f"{d_mesh32:.6g} of max |logit| {big:.6g} (limit "
              f"{d_one + LOGIT_TOL_14:.6g})")
        check(d_mesh32 <= d_one + LOGIT_TOL_14,
              f"14 {label} {name}: the mesh's bf16 logits lie "
              f"{d_mesh32:.4g} of the largest from float32, the single "
              f"device's {d_one:.4g}")


def bf16_twin(model):
    """``model`` (float32, or a rank's share of it) rounded to bf16: the
    same parameters in a bf16 model (the float32 ones of a bf16 model stay
    float32), so one draw from the seed gives both."""
    from repro_torch.models.transformer import Model
    twin = Model(model.cfg, device=model.device, dtype=torch.bfloat16,
                 axis=model.axis)
    twin.load_state_dict(model.state_dict())
    return twin


def nonzero(launches) -> dict:
    return {k: n for k, n in launches.items() if n}


def rank_14d(rank, world, specs) -> dict:
    """Phase 14 (d) on one rank of (1, 2): each family's share at full
    width and depth drawn once from the seed in float32 (one parameter at
    a time) and rounded to bf16; in bf16 its paths at the single device's
    θ (the launches and collectives counted there alone), its parameter
    bytes and its heads teacher-forced on the single device's cloud
    streams; then the float32 share's heads on the same streams."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_cloud_mesh
    from repro_torch.models.registry import build_model
    rank_setup()
    dims = (1, world)
    mesh = make_cloud_mesh(dims)
    ops = kernel_ops()
    out = {"mesh": mesh.describe()}
    for arch, (inputs, theta, streams) in specs.items():
        cfg = family_config(arch, True)
        m32 = build_model(cfg, device=mesh.device, dtype=torch.float32,
                          seed=SEED, axis=mesh.model_axis)
        model = bf16_twin(m32)
        reset(ops)
        sharding.reset_counts()
        runs = family_runs(model, inputs, theta, D_NEW, dims, D_PATHS)
        res = {"runs": runs, "bytes": rank_bytes(model),
               "estimate": family_estimate(cfg, dims),
               "collectives": dict(sharding.COUNTS),
               "collective_s": dict(sharding.SECONDS),
               "launches": counted(ops)}
        prompts = (inputs["tokens"].tolist() if isinstance(inputs, dict)
                   else inputs)
        extra = inputs if isinstance(inputs, dict) else None
        res["forced"] = forced(model, prompts, streams, logits=rank == 0,
                               inputs=extra)
        del model
        free()
        res["forced32"] = forced(m32, prompts, streams, logits=rank == 0,
                                 inputs=extra)
        out[arch] = res
        del m32
        free()
    out["peak_gib"] = peak_gib()
    return out


def family_estimate(cfg, dims) -> float:
    """A rank's parameter bytes by the rules, with the port's departures
    (``sharding.rank_param_bytes``; bf16, float32 Mamba2 gates)."""
    from repro_torch.bridge import port_leaves
    from repro_torch.launch.sharding import AXES, MeshShape, rank_param_bytes
    return rank_param_bytes(port_leaves(cfg, 2), MeshShape(dims, AXES), cfg)


def phase_14d(dev, ops) -> dict:
    """Phase 14 (d): xlstm-350m, zamba2-1.2b, whisper-medium and
    paligemma-3b at full width and depth in bf16 over (1, 2), two ranks
    sharing the card: 2 rows of 64 tokens (whisper after its 1500 frames,
    paligemma after its 256 patches), 8 new tokens, in the cloud and in
    collm at a split θ on an int8 wire; each model is drawn once from the
    seed in float32 and rounded to bf16 (``bf16_twin``), and the kernel
    launches are counted in those served runs alone, the single device's
    and each rank's.  Each rank's parameter bytes equal the rules'
    estimate with the departures.  Teacher-forced on the
    single device's cloud streams, the mesh's float32 heads lie within
    ``LOGIT_TOL_F32`` of the single device's float32 ones and its exit
    tokens equal them at every wide margin (``hold_forced``); its bf16
    heads lie no farther from the float32 ones than the single device's
    bf16 heads plus ``LOGIT_TOL_14`` (``bf16_envelope``).  Tokens/s of
    both, agreement, and each collective's calls and host seconds a
    token, are printed."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    specs, one, one_forced, one_forced32 = {}, {}, {}, {}
    got = []
    for arch in FAMILIES_14:
        cfg = family_config(arch, True)
        m32 = build_model(cfg, device=dev, dtype=torch.float32, seed=SEED)
        model = bf16_twin(m32)
        inputs = family_inputs(cfg, D_ROWS, D_PROMPT, SEED)
        theta = family_theta(model, inputs, D_NEW)
        reset(ops)
        one[arch] = family_runs(model, inputs, theta, D_NEW,
                                names=D_PATHS)
        got.append(counted(ops))
        prompts = (inputs["tokens"].tolist() if isinstance(inputs, dict)
                   else inputs)
        extra = inputs if isinstance(inputs, dict) else None
        streams = one[arch]["cloud"][0]
        one_forced[arch] = forced(model, prompts, streams, inputs=extra)
        specs[arch] = (inputs, theta, streams)
        print(f"14 (d) {arch} {cfg.n_layers} layers d={cfg.d_model}, "
              f"{D_ROWS} rows x {D_PROMPT} tokens, {D_NEW} new, theta "
              f"{theta:.6f}: single device, launches {nonzero(got[-1])}")
        print_mesh_runs("single", one[arch])
        del model
        free()
        one_forced32[arch] = forced(m32, prompts, streams, inputs=extra)
        del m32
        free()
    got = total(*got)
    outs = spawn(rank_14d, 2, device="cuda", timeout=DEADLINE_14,
                 args=(specs,))
    for arch in FAMILIES_14:
        cfg = family_config(arch, True)
        hold_forced(f"(d) {arch} float32", cfg, one_forced32[arch],
                    outs[0][arch]["forced32"], tol=LOGIT_TOL_F32,
                    ulp=2.0 ** -23)
        bf16_envelope(f"(d) {arch} bf16", cfg, one_forced32[arch],
                      one_forced[arch], outs[0][arch]["forced"])
        for rank, out in enumerate(outs):
            res = out[arch]
            print(f"14 (d) {arch} rank {rank} {out['mesh']}: parameters "
                  f"{res['bytes'] / 1e9:.4f} GB (estimate with departures "
                  f"{res['estimate'] / 1e9:.4f} GB), launches "
                  f"{nonzero(res['launches'])}")
            check(res["bytes"] == res["estimate"],
                  f"14 (d) {arch} rank {rank}: its parameters are not the "
                  f"estimate")
            runs = res["runs"]
            for name in runs:
                print(f"  rank {rank} {name}: agreement with the single "
                      f"device {agreement(runs[name][0], one[arch][name][0])}")
            print_mesh_runs(f"rank {rank}", runs)
            n = sum(len(t) for r in res["runs"].values() for t in r[0])
            per = {k: f"{res['collectives'][k] / n:.1f} calls, "
                      f"{res['collective_s'][k] / n * 1e3:.3f} ms"
                   for k in res["collectives"] if res["collectives"][k]}
            print(f"  rank {rank} collectives a token: {per}")
            check(res["launches"]["exit_heads"] > 0,
                  f"14 (d) {arch} rank {rank} launched no exit_heads")
            got = total(got, res["launches"])
        check(outs[1][arch]["runs"]["cloud"][0]
              == outs[0][arch]["runs"]["cloud"][0],
              f"14 (d) {arch}: the ranks' streams differ")
    print(f"14 (d): peak {outs[0]['peak_gib']:.2f} GiB a rank; "
          f"{time.perf_counter() - t0:.1f} s")
    return got


def phase_14(dev, ops) -> dict:
    """Phase 14 (b), (c) and (d), alone on the card after phase 13 and
    (a)."""
    t0 = time.perf_counter()
    print(f"phase 14 card: {nvidia_smi()}")
    got = total(phase_14b(dev, ops), phase_14c(dev, ops),
                phase_14d(dev, ops))
    print(f"phase 14 (b, c, d) launches: {got} in "
          f"{time.perf_counter() - t0:.1f} s")
    return got


# ---------------------------------------------------------------------------
# phase 15: the tiers on two devices, the edge on the CPU, the cloud on the
# card
# ---------------------------------------------------------------------------
T_PROMPT, T_NEW, T_CHUNK = 256, 16, 64      # (b): one client; upload slices
T_SMALL_PROMPT, T_SMALL_CHUNK = 40, 8       # (a)
DRYRUN_WIRES = ("float32", "float16", "int8")   # (c), at 128 x 32768
# (c): ``python -m repro_torch.launch.dryrun``'s named subset, a process
# each: every assigned arch at decode_32k on the 16x16 mesh (``DryRuns``),
# and each other shape kind once (train_4k with FSDP, prefill_32k on the pods, long_500k
# on both meshes where it lowers, and where it is skipped).  ``--all`` takes
# about ten minutes of one host core (xlstm-350m's training and prefill
# steps ~1 min each), over the script's budget; its seconds per
# combination: PERF.md
DRYRUN_SUBSET = {
    "train": ["--arch", "qwen1.5-110b", "--shape", "train_4k"],
    "prefill": ["--arch", "gemma3-12b", "--shape", "prefill_32k",
                "--multi-pod"],
    "long": ["--arch", "zamba2-1.2b", "--shape", "long_500k",
             "--both-meshes"],
    "skip": ["--arch", "command-r-35b", "--shape", "long_500k"]}


def host_rss() -> int:
    """This process's resident host memory, bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tiers_on(edge, cloud, theta, wire):
    """A split ``TwoTierRuntime`` on the given tier models (their weights
    shared, nothing copied), at ``theta`` on a ``wire`` wire."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.disagg import TwoTierRuntime
    rt = TwoTierRuntime(edge, CollmConfig(theta=theta, wire_format=wire),
                        edge.device, cloud.device, edge_dtype=edge.dtype,
                        cloud_dtype=cloud.dtype, split=True)
    rt.build(edge, cloud)
    return rt


def tiers_run(ops, rt, prompt, max_new, chunk=0) -> tuple:
    """``rt.decode`` of one prompt with the launch counters set to 0 before
    and read after; the run's wall, exits and requests added to info."""
    reset(ops)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, info = rt.decode(prompt, max_new,
                           max_seq=len(prompt) + max_new + 8,
                           upload_chunk=chunk)
    torch.cuda.synchronize()
    info["wall_s"] = time.perf_counter() - t0
    info["launched"] = counted(ops)
    info["requests"] = info["channel"]["requests"]
    info["exits"] = max_new - 1 - info["requests"]
    return toks, info


def split_of(info) -> float:
    """A split θ over a two-tier run's ticks: between the two middle
    values of each tick's larger exit confidence (a tick exits when
    either exit clears θ), so about half the ticks exit.  Phases 3-8 take
    the l_ee1 confidences alone; on ee-llm-7b's float32 edge their median
    sent every tick of phase 15 (b) out at l_ee2."""
    c = sorted(max(c12) for c12 in info["confidences"])
    return (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2


def edge_launches(launched) -> int:
    """Launches of the kernels only the edge tier calls: a CPU edge runs
    their plain versions, so none."""
    return sum(launched[k] for k in EXIT_KERNELS + ("quantize",))


def phase_15a(dev, ops) -> dict:
    """(a): a reduced ee-llm-7b in float32, the edge on the CPU, the cloud
    on the card, against the full model's greedy stream and against both
    tiers on the CPU."""
    from repro_torch.configs.base import reduced
    from repro_torch.models.transformer import Model
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced(CFG, n_layers=4),
                              exit_layers=(1, 2)).validate()
    cpu = build_model(cfg, device="cpu", seed=SEED)
    gpu = build_model(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    state = cpu.state_dict()
    edge = Model(cfg, device="cpu", tier="edge").load_whole(state)
    cloud = Model(cfg, device=dev, tier="cloud").load_whole(state)
    cloud_cpu = Model(cfg, device="cpu", tier="cloud").load_whole(state)
    prompt = np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, T_SMALL_PROMPT)
    n = MAX_NEW // 2
    launched = dict.fromkeys(ops, 0)
    ref = full_greedy(gpu, prompt, n)
    exact, info = tiers_run(ops, tiers_on(edge, cloud, 1.1, "float32"),
                            prompt, n)
    launched = total(launched, info["launched"])
    print(f"phase 15 (a) theta=1.1 float32, edge on the CPU, cloud on the "
          f"card == full_step greedy: {exact == ref}")
    check(exact == ref, "phase 15 (a): the two-device stream at theta=1.1 "
          "with a float32 wire differs from the full model's greedy stream")
    theta = split_of(info)
    for wire in ("float16", "int8"):
        for chunk in (0, T_SMALL_CHUNK):
            got, gi = tiers_run(ops, tiers_on(edge, cloud, theta, wire),
                                prompt, n, chunk)
            want, wi = tiers_run(ops, tiers_on(edge, cloud_cpu, theta, wire),
                                 prompt, n, chunk)
            launched = total(launched, gi["launched"])
            same = (got == want and gi["channel"] == wi["channel"]
                    and gi["wire_bytes"] == wi["wire_bytes"])
            print(f"phase 15 (a) theta={theta:.6g} {wire} upload_chunk="
                  f"{chunk}: CPU edge + card cloud == CPU + CPU: {same} "
                  f"(exits {gi['exits']}, cloud requests {gi['requests']}, "
                  f"channel {gi['channel']}, downlink {gi['bytes_down']} B, "
                  f"ring launches {gi['launched']['decode_attn']}, edge "
                  f"kernel launches {edge_launches(gi['launched'])})")
            check(same, f"phase 15 (a) {wire} chunk {chunk}: the two-device "
                  f"run differs from both tiers on the CPU")
            check(gi["exits"] > 0 and gi["requests"] > 0
                  and gi["launched"]["decode_attn"] > 0
                  and edge_launches(gi["launched"]) == 0,
                  f"phase 15 (a) {wire}: no mix of exits and requests, no "
                  f"ring launch on the card, or an edge kernel launched")
    return launched


def print_tiers_run(label, toks, info, n) -> None:
    ticks = np.asarray(info["tick_s"]) * 1e3
    trips = np.asarray(info["round_trip_s"]) * 1e3
    print(f"phase 15 (b) {label}: {n / info['wall_s']:.2f} tokens/s "
          f"({n} tokens in {info['wall_s']:.3f} s, prompt included); edge "
          f"tick host mean {ticks.mean():.1f} ms median "
          f"{np.median(ticks):.1f} ms; cloud round trip "
          f"{trips.mean() if trips.size else float('nan'):.2f} ms mean over "
          f"{trips.size}; exits {info['exits']}, cloud requests "
          f"{info['requests']}; wire {info['wire_bytes'] / (n - 1):.0f} B a "
          f"token; downlink {info['bytes_down']} B; ring launches "
          f"{info['launched']['decode_attn']}, CPU edge kernel launches "
          f"{edge_launches(info['launched'])}")


def phase_15b(dev, ops, before_runs) -> tuple:
    """(b): ee-llm-7b at full width and depth, the edge tier in float32 on
    the CPU, the cloud tier in bf16 on the card; ``before_runs()`` is
    called once the tiers are built, before the timed runs.  Returns
    (launches, wire bytes a token of each wire)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.collm import CollmConfig
    from repro_torch.core.disagg import TwoTierRuntime
    from repro_torch.models.transformer import Model
    from repro_torch.models.registry import build_model
    cfg = get_config("ee-llm-7b")
    print(f"phase 15 (b) host: {os.cpu_count()} cores, torch threads "
          f"{torch.get_num_threads()}; card: {nvidia_smi()}")
    t0 = time.perf_counter()
    whole = build_model(cfg, device=dev, dtype=torch.float32, seed=SEED)
    torch.cuda.synchronize()
    rss0, card0 = host_rss(), torch.cuda.memory_allocated()
    rt = TwoTierRuntime(whole, CollmConfig(theta=1.1, wire_format="float32"),
                        "cpu", dev, edge_dtype=torch.float32,
                        cloud_dtype=torch.bfloat16)
    rt.build()
    del whole
    free()
    edge, cloud = rt.edge_model, rt.cloud_model
    rss1, card1 = host_rss(), torch.cuda.memory_allocated()
    low_edge, low_cloud, _ = rt.lower_tiers(1, T_PROMPT + T_NEW + 8)
    print(f"phase 15 (b) tiers built in {time.perf_counter() - t0:.1f} s "
          f"(the whole model drawn in float32 on the card, then split): "
          f"edge {len(low_edge.param_names)} tensors, "
          f"{param_bytes(edge) / 1e9:.3f} GB float32 on the CPU (host RSS "
          f"{rss0 / 1e9:.2f} -> {rss1 / 1e9:.2f} GB); cloud "
          f"{param_bytes(cloud) / 1e9:.3f} GB bf16 on the card (allocated "
          f"{card0 / 1e9:.2f} GB with the whole model, {card1 / 1e9:.2f} GB "
          f"after); lower_tiers parameter bytes: edge "
          f"{low_edge.param_bytes}, cloud {low_cloud.param_bytes}")
    check(param_bytes(edge) == low_edge.param_bytes
          and param_bytes(cloud) == low_cloud.param_bytes,
          "phase 15 (b): a tier's parameter bytes differ from lower_tiers'")
    prompt = np.random.default_rng(SEED + 16).integers(0, cfg.vocab_size,
                                                       T_PROMPT)
    before_runs()
    launched = dict.fromkeys(ops, 0)
    exact, info = tiers_run(ops, rt, prompt, T_NEW)
    theta = split_of(info)
    modes = {"theta=1.1 float32": (1.1, "float32", 0),
             f"split theta={theta:.6g} float16": (theta, "float16", 0),
             f"split theta={theta:.6g} int8 upload_chunk={T_CHUNK}":
                 (theta, "int8", T_CHUNK),
             "theta=0 int8": (0.0, "int8", 0)}
    runs = {}
    for label, (th, wire, chunk) in modes.items():
        runs[label] = (exact, info) if th == 1.1 else tiers_run(
            ops, tiers_on(edge, cloud, th, wire), prompt, T_NEW, chunk)
        toks, ri = runs[label]
        launched = total(launched, ri["launched"])
        print_tiers_run(label, toks, ri, T_NEW)
        check(len(toks) == T_NEW and 0 <= min(toks)
              and max(toks) < cfg.vocab_size, f"phase 15 (b) {label}: bad "
              f"tokens")
        check(edge_launches(ri["launched"]) == 0, f"phase 15 (b) {label}: "
              f"an edge kernel launched")
        check(ri["bytes_down"] == 4 * (1 + ri["requests"]),
              f"phase 15 (b) {label}: downlink bytes")
        check(not label.startswith("split")
              or (ri["exits"] > 0 and ri["requests"] > 0),
              f"phase 15 (b) {label}: no mix of exits and cloud requests")
        check((ri["launched"]["decode_attn"] > 0) == (ri["requests"] > 0),
              f"phase 15 (b) {label}: ring launches without cloud steps or "
              f"cloud steps without them")
    per_token = {wire: runs[label][1]["wire_bytes"] / (T_NEW - 1)
                 for label, (th, wire, _) in modes.items() if th > 0}
    check(per_token == {"float32": 16384, "float16": 8192, "int8": 4100}
          and runs["theta=0 int8"][1]["requests"] == 0
          and runs["theta=0 int8"][1]["exits"] == T_NEW - 1
          and runs["theta=1.1 float32"][1]["exits"] == 0,
          f"phase 15 (b): wire bytes a token {per_token}, or theta=0 or 1.1 "
          f"did not route every token")
    # both tiers on the card, from the same weights (the edge in float32),
    # after a 2-token warm-up of the card's edge
    on_card = Model(cfg, device=dev, tier="edge").load_whole(
        edge.state_dict())
    tiers_run(ops, tiers_on(on_card, cloud, 1.1, "float32"), prompt, 2)
    for label, (th, wire, chunk) in modes.items():
        toks, ci = tiers_run(ops, tiers_on(on_card, cloud, th, wire), prompt,
                             T_NEW, chunk)
        print(f"phase 15 (b) {label}, both tiers on the card: "
              f"{T_NEW / ci['wall_s']:.2f} tokens/s; agreement with the CPU "
              f"edge: {agreement([toks], [runs[label][0]])} (reported, not "
              f"held: the edge's float32 products differ by device)")
    del on_card, rt, edge, cloud
    free()
    return launched, per_token


class DryRuns:
    """(c): ``python -m repro_torch.launch.dryrun_collm`` with no card
    visible, ee-llm-7b at 128 x 32768 on every wire and qwen1.5-110b with
    its cloud over (1, 4), and ``python -m repro_torch.launch.dryrun`` over
    ``DRYRUN_SUBSET``, each in a process of its own, all started at once;
    ``wait`` collects them, ``check`` reads their records."""

    def __init__(self):
        self.out = Path(tempfile.mkdtemp(prefix="dryrun_collm_"))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT / "src"))
        base = [sys.executable, "-m", "repro_torch.launch.dryrun_collm",
                "--batch", "128", "--seq", "32768", "--out", str(self.out)]
        cmds = {w: base + ["--arch", "ee-llm-7b", "--wire", w]
                for w in DRYRUN_WIRES}
        cmds["qwen1.5-110b tp4"] = base + ["--arch", "qwen1.5-110b",
                                           "--wire", "float16",
                                           "--cloud-tp", "4"]
        self.port = self.out / "dryrun"
        from repro_torch.configs.registry import ASSIGNED
        subset = {**{f"decode {a}": ["--arch", a, "--shape", "decode_32k"]
                     for a in ASSIGNED}, **DRYRUN_SUBSET}
        for k, argv in subset.items():
            cmds[f"dryrun {k}"] = [sys.executable, "-m",
                                   "repro_torch.launch.dryrun", "--out",
                                   str(self.port)] + argv
        self.t0 = time.perf_counter()
        self.procs = {}
        for k, c in cmds.items():
            self.procs[k] = subprocess.Popen(
                c, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)

    def wait(self) -> None:
        errs = {k: p.communicate(timeout=300)[1]
                for k, p in self.procs.items()}
        for k, p in self.procs.items():
            check(p.returncode == 0, f"phase 15 (c) dryrun_collm {k}: exit "
                  f"{p.returncode}\n{errs[k][-2000:]}")
        print(f"phase 15 (c): the dry runs took "
              f"{time.perf_counter() - self.t0:.1f} s")

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.out, ignore_errors=True)

    def check(self, per_token) -> None:
        out = self.out
        for w in DRYRUN_WIRES:
            rec = json.loads((out / f"collm_ee-llm-7b_128x32768_{w}.json")
                             .read_text())
            tiers = {t: (rec[t]["cost_analysis"]["flops"],
                         rec[t]["memory_analysis"]["argument_size_in_bytes"]
                         / 1e9) for t in ("edge", "cloud")}
            print(f"phase 15 (c) ee-llm-7b 128 x 32768 {w}: wire "
                  f"{rec['wire_bytes_per_token']} B a decode step (128 x "
                  f"{per_token.get(w)} live); edge flops "
                  f"{tiers['edge'][0]:.4g}, arguments {tiers['edge'][1]:.1f} "
                  f"GB; cloud flops {tiers['cloud'][0]:.4g}, arguments "
                  f"{tiers['cloud'][1]:.1f} GB; lowered in {rec['lower_s']} s")
            check(rec["wire_bytes_per_token"] == 128 * per_token[w],
                  f"phase 15 (c) {w}: the dry run's wire bytes differ from "
                  f"the live runtime's")
        rec = json.loads((out / "collm_qwen1.5-110b_128x32768_float16_tp4dp1"
                                ".json").read_text())
        coll = rec["cloud"]["collectives"].get("all-reduce", {})
        print(f"phase 15 (c) qwen1.5-110b 128 x 32768 float16, cloud over "
              f"(1, 4): a rank's parameters "
              f"{rec['cloud']['param_bytes'] / 1e9:.2f} GB, caches "
              f"{rec['cloud']['cache_bytes'] / 1e9:.2f} GB; "
              f"{coll.get('count')} all-reduces a step, "
              f"{coll.get('wire_bytes', 0) / 1e6:.1f} MB on the wire; "
              f"edge {rec['edge']['param_bytes'] / 1e9:.2f} GB")
        check(coll.get("count", 0) > 0, "phase 15 (c): no collective in "
              "qwen1.5-110b's cloud tier")
        self.check_port()

    def check_port(self) -> None:
        """Every record of ``repro_torch.launch.dryrun`` ok or skipped, ok
        ones with FLOPs; every arch and every shape kind covered."""
        recs = [json.loads(f.read_text())
                for f in sorted(self.port.glob("*.json"))]
        ok = [r for r in recs if r["status"] == "ok"]
        for r in recs:
            check(r["status"] in ("ok", "skipped"),
                  f"phase 15 (c) dryrun {r['arch']} {r['shape']} "
                  f"{r['mesh']}: {r['status']} {r.get('error')}")
            if r["status"] == "ok":
                check(r["cost_analysis"]["flops"] > 0,
                      f"phase 15 (c) dryrun {r['arch']} {r['shape']}: no "
                      f"flops")
                print(f"phase 15 (c) dryrun {r['arch']} {r['shape']} "
                      f"{r['mesh']}: arguments "
                      f"{r['arg_bytes_per_device'] / 1e9:.3f} GB a device "
                      f"(fsdp {r['fsdp']}), flops "
                      f"{r['cost_analysis']['flops']:.4g} at rank 0's share "
                      f"({r['step']['rows']} rows, {r['step']['dtype']}), "
                      f"{r['lower_s']} s")
        archs = {r["arch"] for r in ok}
        kinds = {r["shape"] for r in ok} | {r["shape"] for r in recs
                                            if r["status"] == "skipped"}
        check(len(archs) == 10 and kinds == {"decode_32k", "train_4k",
                                             "prefill_32k", "long_500k"},
              f"phase 15 (c) dryrun: {sorted(archs)} {sorted(kinds)}")
        print(f"phase 15 (c) dryrun: {len(ok)} ok, {len(recs) - len(ok)} "
              f"skipped, {len(archs)} archs, step passes "
              f"{sum(r['lower_s'] for r in ok):.1f} s in all")


def phase_15(dev, ops) -> dict:
    """Phase 15: (c)'s dry runs start first and run beside (a) and (b)'s
    build; (b)'s timed runs wait for them, since they load the host's
    cores as the CPU edge does."""
    t0 = time.perf_counter()
    dry = DryRuns()
    try:
        got = phase_15a(dev, ops)
        t0 = lap(t0, "phase 15 (a)")
        launched, per_token = phase_15b(dev, ops, dry.wait)
        t0 = lap(t0, "phase 15 (b)")
        dry.check(per_token)
    finally:
        dry.stop()
    got = total(got, launched)
    print(f"phase 15 (the tiers on two devices) launches: {got}")
    return got


# ---------------------------------------------------------------------------
# the serving phases' groups, one process each
# ---------------------------------------------------------------------------
# After phase 2's timings, which have the card to themselves, the serving
# phases run in four processes at once, each group's phases in turn: each
# phase keeps the card busy 8-25% of its time (its host loop is the
# bound), so together they finish in about the time of the longest group,
# well inside the script's 1200-s limit.  Every group sets the launch
# counters of its own process to 0 before each phase and reads them after;
# the parent adds them up.  The models of 8, 10 and 9 (up to 28 GiB a
# phase) take turns in one process.
GROUPS = {"7": "phase 7", "8-10-9": "phases 8, 10 and 9",
          "small-11-12": "phase 2's small models, phases 11 and 12",
          "13": "phase 13", "14a": "phase 14 (a)",
          "14": "phase 14 (b), (c) and (d)",
          "15": "phase 15 (the tiers on two devices)"}
# Each process's share of the card's memory, GiB, over the most its phases
# hold at once (3-6 12.5, 7 10.2, 8 28.1, 12 7.2): a process keeps what it
# frees cached for itself, and without a cap the groups together filled
# the card and one ran out.  With these the four, and their CUDA contexts,
# stay ~5 GiB below the card's 79.  Phase 13 trains a float32 ee-llm-7b
# (parameters, gradients and AdamW's two moments: 62.5 GB) and so runs
# alone, after the others have ended.
# Phase 14 (a)'s ranks (tiny-ee-tp and the four reduced families, 2-4
# processes of ~0.5 GiB each) start in the memory that phases 3-6 held, as
# soon as those end, beside the last serving groups and then phase 13
# (beside phase 13 alone they slowed it: the card's host has 8 cores);
# (b), (c) and (d)
# (command-r-35b: two ranks of 30.3 GB, and before them one process of
# 60.6 GB; (d)'s up to 17.5 GB, paligemma-3b in float32 beside its bf16
# twin) have the card to themselves after
# both.  The caps hold the group processes; ranks are processes of their
# own.
# Phase 15 draws ee-llm-7b in float32 on the card (28 GB) beside its
# bf16 cloud tier (10.4 GB), then holds the cloud tier and a float32 edge
# tier on the card (24.5 GB); its edge on the CPU holds 14 GB of host
# memory.  It runs last, alone: its CPU edge loads the host's cores.
CAP_GIB = {"3-6": 16, "7": 13, "8-10-9": 34, "small-11-12": 9, "13": 76,
           "14a": 2, "14": 76, "15": 44}


def cap_memory(group: str) -> None:
    """Hold this process to ``CAP_GIB[group]`` of the card: past it, the
    caching allocator frees what it keeps cached before it asks for more."""
    torch.cuda.empty_cache()
    card = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(CAP_GIB[group] * 2**30 / card)


def reset(ops) -> None:
    for op in ops.values():
        op.launches = 0


def counted(ops) -> dict:
    return {name: op.launches for name, op in ops.items()}


def total(*runs) -> dict:
    return {name: sum(r[name] for r in runs) for name in runs[0]}


def free() -> None:
    """Give a deleted model's memory back to the card: its modules sit in
    reference cycles that only the cycle collector breaks."""
    gc.collect()
    torch.cuda.empty_cache()


def build_ee(dev):
    """ee-llm-7b at full width and ``DEPTH``'s depth, bf16, from ``SEED``."""
    from repro_torch.models.registry import build_model
    cfg = smoke_config(CFG.name)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {depth_of(cfg)} d={cfg.d_model} "
          f"V={cfg.vocab_size}, {n_params / 1e9:.3f} B parameters in bf16, "
          f"initialised in {time.perf_counter() - t0:.1f} s")
    return model


def phases_3_to_6(dev, ops, on_theta, profile) -> dict:
    """Phases 3-6 on ee-llm-7b; ``on_theta(theta)`` gets phase 3's split
    θ as soon as it is known."""
    model = build_ee(dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, model.cfg.vocab_size, PROMPT_LEN)
               for _ in range(CLIENTS)]
    reset(ops)
    t3 = time.perf_counter()
    cloud = serve(model, prompts, "cloud", 1.0, "float32")
    full = serve(model, prompts, "collm", 1.0, "float32")
    check(full["tokens"] == cloud["tokens"],
          "collm at theta=1 with a float32 wire differs from cloud")
    print("collm theta=1 float32 == cloud: True")
    theta = split_theta(full["stats"])
    r0 = serve(model, prompts, "collm", 0.0, "int8")
    check(r0["stats"].exits_l1 == CLIENTS * (MAX_NEW - 1)
          and r0["stats"].cloud_requests == 0,
          "theta=0: not every token exited at l_ee1")
    mixes = [serve(model, prompts, "collm", theta, "float16", bf)
             for bf in (False, True)]
    for r in mixes:
        check(r["stats"].exits_l1 > 0 and r["stats"].cloud_requests > 0,
              "median theta: no mix of exits and cloud requests")
    serve(model, prompts, "standalone", theta, "float16")
    check_fused_upload(model, prompts, theta)
    launches = counted(ops)
    print(f"phase 3 (generate_sequential) launches: {launches} in "
          f"{time.perf_counter() - t3:.1f} s")
    on_theta(theta)
    torch.cuda.empty_cache()

    reset(ops)
    t4 = time.perf_counter()
    phase4 = serve_phase4(model, theta)
    batched = counted(ops)
    print(f"phase 4 (generate) launches: {batched} in "
          f"{time.perf_counter() - t4:.1f} s")
    torch.cuda.empty_cache()

    reset(ops)
    t5 = time.perf_counter()
    async_a = serve_phase5(model, theta, phase4["paged"])
    adaptive = counted(ops)
    print(f"phase 5 (adaptive serving) launches: {adaptive} in "
          f"{time.perf_counter() - t5:.1f} s")
    for name in ("decode_attn", "decode_attn_paged", "exit_heads"):
        check(adaptive[name] > 0, f"{name} was not launched in phase 5")
    torch.cuda.empty_cache()

    reset(ops)
    t6 = time.perf_counter()
    serve_phase6(model, theta, phase4["paged"], async_a)
    spec = counted(ops)
    print(f"phase 6 (drafting and preemption) launches: {spec} in "
          f"{time.perf_counter() - t6:.1f} s")
    for name in ("decode_attn", "decode_attn_paged", "decode_attn_paged_int8",
                 "exit_heads", "quantize_kv_write", "quantize_kv_scatter"):
        check(spec[name] > 0, f"{name} was not launched in phase 6")
    if profile:
        profile_runs(model, prompts, theta)
    del model
    free()
    return total(launches, batched, adaptive, spec)


def phase_7(dev, ops, theta) -> dict:
    """Phase 7 on its own ee-llm-7b (the same weights as phases 3-6) at
    phase 3's split θ."""
    model = build_ee(dev)
    reset(ops)
    t7 = time.perf_counter()
    serve_phase7(model, theta)
    shared = counted(ops)
    print(f"phase 7 (chunked prefill, prefix sharing, fleet replay) "
          f"launches: {shared} in {time.perf_counter() - t7:.1f} s")
    for name in ("decode_attn_paged", "decode_attn_paged_int8", "exit_heads",
                 "quantize_kv_write"):
        check(shared[name] > 0, f"{name} was not launched in phase 7")
    del model
    free()
    return shared


def phase_8(dev, ops) -> dict:
    from repro_torch.models.registry import build_model
    gcfg = smoke_config(GEMMA)
    t0 = time.perf_counter()
    gmodel = build_model(gcfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in gmodel.parameters())
    print(f"model: {gcfg.name} {depth_of(gcfg)} d={gcfg.d_model} "
          f"V={gcfg.vocab_size} window {gcfg.sliding_window} in "
          f"{sum(w > 0 for w in gcfg.layer_windows())} layers, "
          f"{n_params / 1e9:.3f} B parameters in bf16, initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    reset(ops)
    t8 = time.perf_counter()
    serve_phase8(gmodel)
    gemma = counted(ops)
    print(f"phase 8 ({GEMMA} at full width) launches: {gemma} in "
          f"{time.perf_counter() - t8:.1f} s")
    for name in ("decode_attn", "decode_attn_paged", "decode_attn_paged_int8",
                 "exit_heads", "quantize", "quantize_kv_write",
                 "quantize_kv_scatter"):
        check(gemma[name] > 0, f"{name} was not launched in phase 8")
    del gmodel
    free()
    return gemma


def phase_of(number, archs, serve_one, dev, ops, **kw) -> dict:
    """Phase ``number``: ``serve_one(arch, dev, ops, **kw)`` for each of
    ``archs`` in turn; their launches added up."""
    t0 = time.perf_counter()
    got = total(*(serve_one(arch, dev, ops, **kw) for arch in archs))
    print(f"phase {number}: {time.perf_counter() - t0:.1f} s")
    return got


def small_models(dev) -> None:
    """Phase 2's small models, each served on the card and on the CPU."""
    t0 = time.perf_counter()
    for small in (check_small_model, check_small_gemma, check_small_moe,
                  check_small_recurrent, check_small_prefixed):
        small(dev)
        t0 = lap(t0, f"phase 2, {small.__name__}")


def run_group(group, dev, ops, theta, profile) -> dict:
    """The phases of ``group`` in turn; their launches added up."""
    if group == "7":
        return phase_7(dev, ops, theta)
    if group == "8-10-9":
        return total(phase_8(dev, ops),
                     serve_phase(10, (STABLELM,), dev, ops, lens=S_LENS,
                                 max_new=S_NEW, sequential=False,
                                 chunked=False),
                     serve_phase(9, (OLMOE, GRANITE), dev, ops, lens=M_LENS,
                                 max_new=MAX_NEW, sequential=True,
                                 chunked=True))
    if group == "small-11-12":
        small_models(dev)
        return total(phase_of(11, (XLSTM, ZAMBA2), serve_recurrent, dev, ops,
                              profile=profile),
                     phase_of(12, (WHISPER, PALIGEMMA), serve_prefixed, dev,
                              ops))
    if group == "13":
        return phase_13(dev, ops)
    if group == "14a":
        return total(phase_14a(dev, ops), phase_14a_families(dev, ops))
    if group == "14":
        return phase_14(dev, ops)
    if group == "15":
        return phase_15(dev, ops)
    raise ValueError(f"no group {group!r}")


class Group:
    """One group of phases in a process of its own; its output goes to a
    temporary file, echoed by :meth:`finish` after the parent's phases."""
    MARK = "group launches: "

    def __init__(self, group: str, theta=None):
        self.group = group
        self.out = tempfile.TemporaryFile("w+")
        cmd = [sys.executable, str(Path(__file__).resolve()), "--group",
               group, "--parent", str(os.getpid())]
        if theta is not None:
            cmd += ["--theta", repr(theta)]
        self.proc = subprocess.Popen(cmd, stdout=self.out,
                                     stderr=subprocess.STDOUT)

    def finish(self) -> dict:
        code = self.proc.wait()
        self.out.seek(0)
        launches = None
        for line in self.out.read().splitlines():
            if line.startswith(self.MARK):
                launches = json.loads(line[len(self.MARK):])
            else:
                print(line)
        print(f"group {self.group} ({GROUPS[self.group]}): exit {code}")
        check(code == 0 and launches is not None,
              f"group {self.group} ({GROUPS[self.group]}) failed")
        return launches

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def die_with(parent: int) -> None:
    """Have the kernel kill this process when ``parent`` exits, so that no
    group outlives a parent that failed or was stopped."""
    import ctypes
    import signal
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        raise SystemExit("chip_smoke: the parent process is gone")


def setup():
    """The card, with float32 products kept exact; raises without one."""
    global CFG
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is False)")
    from repro_torch.configs.registry import get_config
    CFG = get_config("ee-llm-7b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@torch.no_grad()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="add the profiles; every phase then runs in this "
                         "process, one after the other")
    ap.add_argument("--group", choices=sorted(GROUPS), help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--theta", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.group:                  # a group started by the parent below
        die_with(args.parent)
        dev = setup()
        cap_memory(args.group)
        t0 = time.perf_counter()
        got = run_group(args.group, dev, kernel_ops(), args.theta, False)
        print(f"group {args.group}: {time.perf_counter() - t0:.1f} s")
        print(Group.MARK + json.dumps(got))
        return
    dev = setup()
    smi = nvidia_smi()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t2 = time.perf_counter()
    cases = exit_cases(dev, gen)
    rows = [check_decode_attn(dev, gen), *check_decode_attn_paged(dev, gen),
            check_exit_head(dev, gen, cases), check_quantize(dev, gen),
            check_kv_write(dev, gen), check_kv_scatter(dev, gen),
            check_exit_quant(dev, gen, cases), check_exit_heads(dev, gen)]
    del cases
    part = lap(t2, "phase 2, ee-llm-7b's shapes")
    check_gemma_kernels(dev, gen, rows)
    part = lap(part, f"phase 2, {GEMMA}'s shapes")
    check_new_kernel_shapes(dev, gen, rows)
    part = lap(part, "phase 2, phases 9 and 10's shapes")
    check_recurrent_kernel_shapes(dev, gen, rows)
    part = lap(part, "phase 2, phase 11's shapes")
    check_prefixed_kernel_shapes(dev, gen, rows)
    part = lap(part, "phase 2, phase 12's shapes")
    check_mesh_kernel_shapes(dev, gen, rows)
    lap(part, "phase 2, phase 14's per-rank shapes")
    for r in rows:
        print_time(r["name"], r)
        for shape in ("b8", "b1", "chunk", "r16"):
            if shape in r:
                print_time(f"{r['name']} ({shape.upper()})", r[shape])
        g = r["gemma"]
        print_time(f"{r['name']} ({GEMMA})", g)
        for shape in ("b8", "b1", "chunk", "window", "r16"):
            if shape in g:
                print_time(f"{r['name']} ({GEMMA}, {shape.upper()})",
                           g[shape])
        for label, g in r.get("shapes", {}).items():
            print_time(f"{r['name']} ({label})", g)
            for shape in ("b8", "b1", "chunk", "r16"):
                if shape in g:
                    print_time(f"{r['name']} ({label}, {shape.upper()})",
                               g[shape])
    torch.cuda.empty_cache()
    print(f"phase 2 (the kernels' rows): {time.perf_counter() - t2:.1f} s")

    ops = kernel_ops()
    groups, theta = {}, []

    def start_7(split):             # phase 7 waits for phase 3's split θ
        theta.append(split)
        if not args.profile:
            groups["7"] = Group("7", split)
    try:
        # with --profile every phase runs here: the profiles see no other
        late = ("13", "14a", "14", "15")
        if not args.profile:
            cap_memory("3-6")
            groups.update((g, Group(g)) for g in GROUPS
                          if g not in ("7",) + late)
        t3 = time.perf_counter()
        launches = phases_3_to_6(dev, ops, start_7, args.profile)
        print(f"phases 3-6: {time.perf_counter() - t3:.1f} s")
        if not args.profile:
            # 14 (a) in the memory that 3-6 held, beside the last groups
            torch.cuda.empty_cache()
            groups["14a"] = Group("14a")
        for g in GROUPS:
            if g in late and g not in groups and not args.profile:
                # 13 once every earlier group ended, then 14 (b, c, d)
                # alone on the card once 13 and 14 (a) ended
                torch.cuda.empty_cache()
                groups[g] = Group(g)
            launches = total(launches, run_group(g, dev, ops, theta[0], True)
                             if args.profile else groups[g].finish())
    finally:
        for g in groups.values():
            g.stop()
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [dict({k: r[k] for k in keys},
                                       shapes=shape_rows(r))
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
