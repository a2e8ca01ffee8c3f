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
   and B=8, the paged one at 8 slots and at B=1, float32, bfloat16 and int8
   pages; the wire quantizer at 1 and 8 rows; the int8 page writes, a
   decode step at 8 slots and at B=1 and a 512-token prefill scatter, every
   pool byte, beside PR 13's torch sequence for the same write), with its
   device time (CUDA
   events), the plain version's, one PyTorch library call's where one
   computes the same function, and the bound (bytes over 3.35 TB/s or
   operations over the peak rate of the type they run in, whichever is
   larger);
   then a small model served on the card and on the CPU must give the same
   streams, sequentially and batched on dense, paged and int8-paged KV,
   under deadline misses with the standalone fallback, as N engines
   behind one batched cloud (equal to N engines with a cloud each), with
   speculative drafts of 1 and 4 tokens (dense and paged, and under
   deadline misses), under recompute and swap preemption (float32 and int8
   pages), and with drafts in flight across preemptions behind the batched
   cloud;
3. ee-llm-7b at full width (32 layers, bfloat16, random weights from a seed)
   through ``ServingSystem.generate_sequential`` in five modes, plus
   ``CoLLM.fused_exit_upload`` on a real l_ee1 hidden, with every kernel's
   launch counter set to 0 before and read after;
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
7. the kernel table as one JSON line (launches: phases 3 to 6), the
   ``nvidia-smi`` line, and the status line ``{"ok": true, "device":
   {...}}``.

``--profile`` adds ``torch.profiler`` windows over a few collaborative
decode ticks of the sequential loop and of the batched engine on bf16 and
int8 pages (device time by kernel, the card's busy share, the host's
costliest operators), and repeats phase 4's two paged runs in turns.  Without a
CUDA card, or run from a directory without the repository, the script
fails before printing any result.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
CLIENTS, PROMPT_LEN, MAX_NEW = 2, 512, 32
SLOTS, BATCH_PROMPTS, PAGE_SIZE = 8, 12, 16     # phase 4
ENGINES = 8                                     # phase 5 (e), (f)
SPEC_ENGINES, SPEC_K = 4, 4                     # phase 6
PREEMPT_PAGES, WATERMARK = 140, 4               # phase 6 (e), (f)
PREEMPT_SCHEDULE = [(4, 0), (12, 1)]            # (tick, slot)
KNEE_NET = dict(up_bw=3.8e6, down_bw=8e6, rtt=0.003)  # a WiFi-class link
FILLS = (128, 552)                      # phase 2 paged fills, keys a row
MAX_SEQ = PROMPT_LEN + MAX_NEW + 8      # generate_sequential's ring size
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,       # dense tensor-core bf16
                  torch.float32: 67e12}         # float32 outside tensor cores
SLEEP_CYCLES = 200_000_000                      # ~0.1 s of a busy card
CFG = None      # ee-llm-7b's ModelConfig: the shapes of every phase


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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


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


def time_ring(b, n_sets, dev, gen) -> dict:
    """Device time of ``decode_attn`` at B=b, bf16, full 552-key rings,
    beside its plain version and SDPA, on ``n_sets`` rings in turn (more
    than the 50 MB L2 in all), with bytes and operations of the first."""
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    s = MAX_SEQ
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
        *sdpa[i % n_sets][:3], attn_mask=sdpa[i % n_sets][3]))
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
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, n, window, masked in ((1, s, 0, False), (4, s, 0, True),
                                     (4, s, 128, False), (8, s, 0, True),
                                     (1, s, last, False), (2, 1, 0, False),
                                     (2, 40, 0, False)):
            q, k, v, pos, cur = attn_inputs(b, n, dtype, dev, gen,
                                            masked_row=masked)
            cur = cur.clamp(max=n - 1)
            got = decode_attn(q, k, v, pos, cur, window=window)
            want = decode_attn_ref(q, k, v, pos, cur, window=window)
            e = max_err(got, want)
            if masked:
                check(bool(torch.all(got[-1] == 0)), "masked row is not 0")
            print(f"decode_attn {str(dtype)[6:]} B={b} S={n} window={window}"
                  f"{' masked-row' if masked else ''}: max|err|={e:.3g} "
                  f"(tol {tol})")
            check(e <= tol, f"decode_attn disagrees with its plain version")
            err = max(err, e)
    q, k, v, pos, cur = attn_inputs(1, s, torch.bfloat16, dev, gen)
    again = [decode_attn(q, k, v, pos, cur) for _ in range(2)]
    check(torch.equal(*again), "decode_attn differs between two calls")
    print(f"decode_attn bf16 B=1 in {splits} splits: two calls "
          f"bit-identical: True")
    # B=1: 12 rings (108 MB) in turn; B=8: 4 rings of 72 MB
    row = dict(name="decode_attn",
               source="src/repro_torch/csrc/decode_attn.cu",
               replaces="src/repro/kernels/decode_attn/kernel.py:94",
               max_abs_err=err, **time_ring(1, 12, dev, gen))
    row["b8"] = time_ring(8, 4, dev, gen)
    return row


def paged_inputs(dtype, dev, gen, *, holes=False, sets=1, b=SLOTS):
    """Float32 K/V pages at ee-llm-7b's head shape (H = KV = 32, d = 128,
    16-token pages) and, for each of ``sets`` tables, (q, pos, tbl, cur)
    of ``b`` rows with ragged fills of 128-552 keys, pages handed out in
    shuffled order.  ``holes`` leaves one row's second table entry
    unmapped, punches never-written positions into the pages and maps
    nothing for the last row (output 0).  The tables map disjoint pages of
    one pool, so that timed calls in turn find their pages outside the L2
    cache."""
    h, kv, d = CFG.n_heads, CFG.n_kv_heads, CFG.resolved_head_dim
    ps = PAGE_SIZE
    n_lp = -(-FILLS[1] // ps)
    fills = torch.randint(FILLS[0], FILLS[1] + 1, (sets, b), generator=gen,
                          device=dev).tolist()
    n_pages = 1 + sum(-(-f // ps) for row in fills for f in row)
    kp = torch.randn((n_pages, ps, kv, d), generator=gen, device=dev)
    vp = torch.randn((n_pages, ps, kv, d), generator=gen, device=dev)
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device=dev)
    order = (1 + torch.randperm(n_pages - 1, generator=gen,
                                device=dev)).tolist()
    out = []
    for row_fills in fills:
        tbl = torch.full((b, n_lp), -1, dtype=torch.int32, device=dev)
        cur = torch.tensor([f - 1 for f in row_fills], dtype=torch.int32,
                           device=dev)
        for bi, fill in enumerate(row_fills):
            for lp in range(-(-fill // ps)):
                pg = order.pop()
                tbl[bi, lp] = pg
                n = min(ps, fill - lp * ps)
                pos[pg, :n] = torch.arange(lp * ps, lp * ps + n, device=dev)
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


def paged_bytes_ops(pool, q, pos, tbl, cur) -> tuple:
    """Bytes the call must move: the K/V (and int8 scales) of its valid
    keys, the position markers of its mapped pages, the table, cur, q and
    out; operations: 4 per (head, valid key, element)."""
    h, d = q.shape[1], q.shape[2]
    kv, ps = pool["kp"].shape[2], pool["kp"].shape[1]
    pages = torch.unique(tbl[tbl >= 0]).long()
    rows = torch.nonzero(tbl >= 0)
    p = pos[tbl[rows[:, 0], rows[:, 1]].long()]          # (mapped, ps)
    c = cur[rows[:, 0]][:, None]
    n_valid = int(((p >= 0) & (p <= c)).sum())
    per_key = 2 * kv * d * pool["kp"].element_size()
    if "k_scale" in pool:
        per_key += 2 * kv * 4
    nbytes = (n_valid * per_key + pages.numel() * ps * 4 + tbl.numel() * 4
              + cur.numel() * 4 + 2 * q.numel() * q.element_size())
    return nbytes, 4 * h * n_valid * d


PAGED_VARIANTS = (("decode_attn_paged", False, ((torch.float32, 2e-5),
                                                 (torch.bfloat16, 2e-2))),
                  ("decode_attn_paged_int8", True, ((torch.bfloat16, 2e-2),)))


def time_paged(b, n_sets, dev, gen) -> dict:
    """Device time of both paged variants at ``b`` rows, bf16 q, on
    ``n_sets`` tables over disjoint pages of one pool (more than the 50 MB
    L2 in all) called in turn, beside the plain version and paged_gather +
    SDPA.  Both variants read the same tables and pages (int8 quantized
    from them); bytes and operations are the mean over the tables, as the
    times are."""
    from repro_torch.kernels.decode_attn.ops import decode_attn_paged
    from repro_torch.kernels.decode_attn.ref import decode_attn_paged_ref
    from repro_torch.models.attention import paged_gather
    kp, vp, sets = paged_inputs(torch.bfloat16, dev, gen, sets=n_sets, b=b)
    h, d = CFG.n_heads, CFG.resolved_head_dim
    out = {}
    for name, int8, _ in PAGED_VARIANTS:
        pool = paged_pool(kp, vp, torch.bfloat16, int8)
        scales = ({k: pool[k] for k in ("k_scale", "v_scale")}
                  if int8 else {})
        calls = [(q, pool["kp"], pool["vp"], pos, tbl, cur)
                 for q, pos, tbl, cur in sets]
        ms = device_ms(lambda i: decode_attn_paged(*calls[i % n_sets],
                                                   **scales))
        plain = device_ms(lambda i: decode_attn_paged_ref(*calls[i % n_sets],
                                                          **scales))
        cache = {"kp": pool["kp"], "vp": pool["vp"]}
        if int8:
            cache.update(ks=pool["k_scale"], vs=pool["v_scale"])

        def library(i):
            q, pos, tbl, cur = sets[i % n_sets]
            k, v, kpos = paged_gather(dict(cache, pos=pos), tbl)
            mask = (kpos >= 0) & (kpos <= cur[:, None])
            return torch.nn.functional.scaled_dot_product_attention(
                q.view(b, h, 1, d), k.transpose(1, 2).to(q.dtype),
                v.transpose(1, 2).to(q.dtype),
                attn_mask=mask[:, None, None, :])

        lib = device_ms(library)
        counts = [paged_bytes_ops(pool, *s) for s in sets]
        nbytes = sum(c[0] for c in counts) / n_sets
        ops = sum(c[1] for c in counts) / n_sets
        bnd, by = bound_ms(nbytes, ops, torch.bfloat16)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                         bound_by=by, bytes=nbytes)
    return out


def check_decode_attn_paged(dev, gen) -> list:
    """Both paged variants against their plain version: 8 slots with
    ragged fills, with holes, gaps and a row with nothing mapped, with a
    single mapped page a row, and one row (its pages cut in splits).  Timed
    at 8 slots (the batched engine) and at B=1."""
    from repro_torch.kernels.decode_attn.ops import decode_attn_paged
    from repro_torch.kernels.decode_attn.ref import decode_attn_paged_ref
    errs = {}
    for name, int8, dtypes in PAGED_VARIANTS:
        err = 0.0
        for dtype, tol in dtypes:
            for label, b, holes in (("", SLOTS, False),
                                    (" holes+gaps+empty row", SLOTS, True),
                                    (" one page a row", SLOTS, False),
                                    ("", 1, False)):
                kp, vp, [(q, pos, tbl, cur)] = paged_inputs(
                    dtype, dev, gen, holes=holes, b=b)
                if label == " one page a row":
                    tbl[:, 1:] = -1
                pool = paged_pool(kp, vp, dtype, int8)
                scales = ({k: pool[k] for k in ("k_scale", "v_scale")}
                          if int8 else {})
                args = (q, pool["kp"], pool["vp"], pos, tbl, cur)
                got = decode_attn_paged(*args, **scales)
                want = decode_attn_paged_ref(*args, **scales)
                e = max_err(got, want)
                if holes:
                    check(bool(torch.all(got[-1] == 0)),
                          f"{name}: the unmapped row is not 0")
                print(f"{name} {str(dtype)[6:]} B={b} fills "
                      f"{cur.min().item() + 1}-{cur.max().item() + 1}"
                      f"{label}: max|err|={e:.3g} (tol {tol})")
                check(e <= tol, f"{name} disagrees with its plain version")
                err = max(err, e)
        errs[name] = err
    # 8 slots: 4 tables over one pool of > 50 MB; B=1: 12 tables
    t8, t1 = time_paged(SLOTS, 4, dev, gen), time_paged(1, 12, dev, gen)
    return [dict(name=name, source="src/repro_torch/csrc/decode_attn_paged.cu",
                 replaces="src/repro/kernels/decode_attn/kernel.py:236",
                 max_abs_err=errs[name], **t8[name], b1=t1[name])
            for name, _, _ in PAGED_VARIANTS]


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
    e_conf, e_lse = max_err(got[0], want[0]), max_err(got[2], want[2])
    same_tok = torch.equal(got[1], want[1])
    print(f"  {label}: max|conf err|={e_conf:.3g} (tol 1e-5) "
          f"max|lse err|={e_lse:.3g} (tol 1e-4) tokens equal={same_tok}")
    check(e_conf <= 1e-5 and e_lse <= 1e-4 and same_tok,
          f"{label}: exit decision disagrees with its plain version")
    if tie is not None:
        check(int(got[1][0]) == tie[0], f"{label}: tie not at lowest index")
    return max(e_conf, e_lse)


def exit_bound(b, w, with_packet: bool):
    d = w.shape[1]
    nbytes = (w.numel() + b * d + d) * w.element_size() + b * 12
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
    """An int8 page pool at ee-llm-7b's head shape with stale random
    contents, so that an entry left unwritten shows."""
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
    """One decode step's write of ``b`` rows into a pool of 35 pages a row
    (552 keys): pages in shuffled order, positions drawn from 0-551; row
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
    slots (with and without a mask, bf16 and f32) and at B=1; timed at 8
    slots and at B=1 (bf16)."""
    from repro_torch.kernels.quantize.ops import (quantize_int8,
                                                  quantize_kv_write)
    from repro_torch.kernels.quantize.ref import quantize_kv_write_ref
    err = 0.0
    for b, dtype, masked in ((SLOTS, torch.bfloat16, True),
                             (SLOTS, torch.float32, False),
                             (1, torch.bfloat16, False)):
        pool, args = write_inputs(b, dtype, dev, gen, masked=masked)
        want = quantize_kv_write_ref(clone_pool(pool), *args)
        old = quantize_kv_write_ref(clone_pool(pool), *args,
                                    quantize=quantize_int8)
        got = quantize_kv_write(pool, *args)
        e, e_old = pool_err(got, want), pool_err(old, want)
        print(f"quantize_kv_write {str(dtype)[6:]} B={b}"
              f"{' masked' if masked else ''}: pool max|err|={e:.3g} vs "
              f"plain, PR-13 sequence {e_old:.3g} (exact)")
        check(e == 0 and e_old == 0,
              "quantize_kv_write disagrees with its plain version")
        err = max(err, e)
    kv, d = CFG.n_kv_heads, CFG.resolved_head_dim
    out = {}
    for b in (SLOTS, 1):
        pool, args = write_inputs(b, torch.bfloat16, dev, gen)
        nelem = 2 * b * kv * d
        nbytes = nelem * 2 + 8 * b + nelem + 2 * b * kv * 4 + 4 * b
        out[b] = time_page_write(f"quantize_kv_write (B={b})",
                                 quantize_kv_write, quantize_kv_write_ref,
                                 pool, args, nbytes, nelem)
    return dict(name="quantize_kv_write",
                source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quantize/kernel.py:31",
                max_abs_err=err, **out[SLOTS], b1=out[1])


def check_kv_scatter(dev, gen) -> dict:
    """``quantize_kv_scatter`` against its plain version and PR 13's
    sequence: a 512-token prefill over 32 pages, and a 500-slot ring over
    34 pages (fills past it, the last two pages unmapped); timed at 512
    tokens (bf16)."""
    from repro_torch.kernels.quantize.ops import (quantize_int8,
                                                  quantize_kv_scatter)
    from repro_torch.kernels.quantize.ref import quantize_kv_scatter_ref
    main = (512, 500, list(range(32, 0, -1)))
    err = 0.0
    for (length, n_real, pages), dtype in (
            (main, torch.bfloat16),
            ((500, 480, list(range(1, 33)) + [-1, -1]), torch.float32)):
        pool, args = scatter_inputs(length, n_real, pages, dtype, dev, gen)
        want = quantize_kv_scatter_ref(clone_pool(pool), *args)
        old = quantize_kv_scatter_ref(clone_pool(pool), *args,
                                      quantize=quantize_int8)
        got = quantize_kv_scatter(pool, *args)
        e, e_old = pool_err(got, want), pool_err(old, want)
        print(f"quantize_kv_scatter {str(dtype)[6:]} ring {length} over "
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
    r = time_page_write("quantize_kv_scatter (512 tokens)",
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
        err = max(err, compare_exit(label, got[:3], want[:3], tie))
        check(torch.equal(got[3], want[3]) and torch.equal(got[4], want[4]),
              f"{label}: int8 packet disagrees with its plain version")
        head = exit_head(*args)
        check(all(torch.equal(a, b) for a, b in zip(got[:3], head)),
              f"{label}: exit_quant's decision differs from exit_head's")
    h, w, ns = cases[0][1]
    ms = device_ms(lambda i: exit_quant(h, w, ns))
    plain = device_ms(lambda i: exit_quant_ref(h, w, ns))
    bnd, by = exit_bound(1, w, with_packet=True)
    return dict(name="exit_quant", source="src/repro_torch/csrc/exit_quant.cu",
                replaces="src/repro/kernels/exit_quant/kernel.py:98",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None)


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
    check_small_adaptive(cpu, gpu, prompts, theta)
    check_small_spec_preempt(cpu, gpu, prompts, theta)


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


def print_time(label, r) -> None:
    lib = r["library_ms"]
    print(f"time {label}: {r['ms'] * 1e3:.2f} us (bound "
          f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}"
          f"{'; %.0f bytes' % r['bytes'] if 'bytes' in r else ''}; plain "
          f"{r['plain_ms'] * 1e3:.2f} us; library "
          f"{'-' if lib is None else '%.2f us' % (lib * 1e3)})")


# ---------------------------------------------------------------------------
# phase 3: ee-llm-7b through the serving loop
# ---------------------------------------------------------------------------
def kernel_ops() -> dict:
    """Each kernel's wrapper; ``wrapper.launches`` counts its launches."""
    from repro_torch.kernels.decode_attn.ops import (decode_attn,
                                                     decode_attn_paged,
                                                     decode_attn_paged_int8)
    from repro_torch.kernels.exit_head.ops import exit_head
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
            "exit_quant": exit_quant}


def serve(model, prompts, mode, theta, wire, backfill=False):
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    system = ServingSystem(model, CollmConfig(theta=theta, wire_format=wire,
                                              backfill=backfill))
    before = {n: op.launches for n, op in kernel_ops().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = system.generate_sequential(prompts, MAX_NEW, mode=mode)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {n: op.launches - before[n] for n, op in kernel_ops().items()}
    st = r["stats"]
    toks = np.asarray(r["tokens"])
    check(toks.shape == (len(prompts), MAX_NEW) and toks.min() >= 0
          and toks.max() < model.cfg.vocab_size, f"{mode}: bad tokens")
    print(f"serve {mode:10s} theta={theta:.6g} wire={wire:7s} "
          f"backfill={backfill!s:5s} tokens={st.tokens} "
          f"tokens/s={st.tokens / dt:.2f} wall={dt:.2f}s "
          f"exits_l1={st.exits_l1} exits_l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} upload_bytes={st.upload_bytes} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB "
          f"launches={launched}")
    return r


def check_fused_upload(model, prompts, theta) -> None:
    """fused_exit_upload (one exit_quant launch) on the l_ee1 hidden of a
    real decode tick equals edge_step's l_ee1 decision and int8 packet."""
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    collm = ServingSystem(model, CollmConfig(theta=theta,
                                             wire_format="int8")).collm
    dev = model.device
    caches = collm.init_edge_cache(1, MAX_SEQ)
    batch = {"tokens": torch.as_tensor(prompts[0][None], device=dev)}
    dec, _, caches = collm.edge_prefill(batch, caches)
    tok = dec[collm.l_ee2].token[:, None].long()
    _, exit_h, _ = model.decode_step(tok, caches, PROMPT_LEN, collm.edge_segs)
    # edge_step rewrites the same ring slots with the same K/V
    out = collm.edge_step(tok, caches, PROMPT_LEN)
    conf, ftok, pkt = collm.fused_exit_upload(exit_h[collm.l_ee1])
    ref = out.decisions[collm.l_ee1]
    same = (torch.equal(ftok, ref.token)
            and torch.equal(pkt["data"], out.upload["data"])
            and torch.equal(pkt["scale"], out.upload["scale"]))
    e = max_err(conf, ref.confidence)
    print(f"fused_exit_upload == edge_step (token, int8 packet): {same}; "
          f"max|conf err|={e:.3g} (tol 1e-6)")
    check(same and e <= 1e-6, "fused_exit_upload differs from edge_step")


# ---------------------------------------------------------------------------
# phase 4: ee-llm-7b through the batched engine
# ---------------------------------------------------------------------------
def serve_batched(model, prompts, label, mode, theta, wire, layout="paged",
                  kv_dtype="float32", backfill=False):
    from repro_torch.core.collm import CollmConfig
    from repro_torch.serving.engine import ServingSystem
    system = ServingSystem(model, CollmConfig(
        theta=theta, wire_format=wire, backfill=backfill, kv_layout=layout,
        page_size=PAGE_SIZE, kv_dtype=kv_dtype))
    before = {n: op.launches for n, op in kernel_ops().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = system.generate(prompts, MAX_NEW, mode=mode, num_slots=SLOTS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r["launched"] = {n: op.launches - before[n]
                     for n, op in kernel_ops().items()}
    sched = next(iter(system._schedulers.values()))
    r["paged_layers"] = sum("kp" in c["self"] for tree in sched._trees()
                            for layers in tree.values() for c in layers)
    st = r["stats"]
    check(all(len(t) == MAX_NEW and min(t) >= 0
              and max(t) < model.cfg.vocab_size for t in r["tokens"]),
          f"{label}: bad tokens")
    print(f"batched {label:18s} mode={mode:10s} theta={theta:.6g} "
          f"wire={wire:7s} tokens={st.tokens} tokens/s={st.tokens / dt:.2f} "
          f"wall={dt:.2f}s exits_l1={st.exits_l1} exits_l2={st.exits_l2} "
          f"cloud_requests={st.cloud_requests} upload_bytes={st.upload_bytes}"
          f" kv_cache_bytes={sched.kv_cache_bytes()} peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}GiB "
          f"pool={r['pool_stats']} launches={r['launched']}")
    return r


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
          and runs["c"]["launched"]["quantize"] > 0,
          "phase 6 (c): no ring attention or wire quantizer launch")
    check(runs["g"]["batcher"]["swaps"] >= 1,
          "phase 6 (g): the batcher swapped nothing")


def profile_window(label, fn) -> None:
    """Device time by kernel, the card's busy share and the host's
    costliest operators over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: a CPU op's device time repeats its kernels'
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if str(e.device_type).endswith("CUDA")]
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile {label}: {len(rows)} kernels, device busy {busy:.3f}s "
          f"of {wall:.3f}s wall ({busy / wall:.1%})")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    cpu = [(e.self_cpu_time_total, e.count, e.key) for e in events
           if str(e.device_type).endswith("CPU")]
    print(f"  host: top operators by self time (under the profiler)")
    for us, count, key in sorted(cpu, reverse=True)[:8]:
        print(f"  {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


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


@torch.no_grad()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    global CFG
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is False)")
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model

    CFG = get_config("ee-llm-7b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = exit_cases(dev, gen)
    rows = [check_decode_attn(dev, gen), *check_decode_attn_paged(dev, gen),
            check_exit_head(dev, gen, cases), check_quantize(dev, gen),
            check_kv_write(dev, gen), check_kv_scatter(dev, gen),
            check_exit_quant(dev, gen, cases)]
    del cases
    for r in rows:
        print_time(r["name"], r)
        for shape in ("b8", "b1"):
            if shape in r:
                print_time(f"{r['name']} ({shape.upper()})", r[shape])
    check_small_model(dev)
    torch.cuda.empty_cache()

    cfg = CFG
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"V={cfg.vocab_size}, {n_params / 1e9:.3f} B parameters in bf16, "
          f"initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN)
               for _ in range(CLIENTS)]

    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
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
    launches = {name: op.launches for name, op in ops.items()}
    print(f"phase 3 (generate_sequential) launches: {launches}")
    torch.cuda.empty_cache()

    for op in ops.values():
        op.launches = 0
    phase4 = serve_phase4(model, theta)
    batched = {name: op.launches for name, op in ops.items()}
    print(f"phase 4 (generate) launches: {batched}")
    torch.cuda.empty_cache()

    for op in ops.values():
        op.launches = 0
    async_a = serve_phase5(model, theta, phase4["paged"])
    adaptive = {name: op.launches for name, op in ops.items()}
    print(f"phase 5 (adaptive serving) launches: {adaptive}")
    for name in ("decode_attn", "decode_attn_paged", "exit_head", "quantize"):
        check(adaptive[name] > 0, f"{name} was not launched in phase 5")
    torch.cuda.empty_cache()

    for op in ops.values():
        op.launches = 0
    t6 = time.perf_counter()
    serve_phase6(model, theta, phase4["paged"], async_a)
    spec = {name: op.launches for name, op in ops.items()}
    print(f"phase 6 (drafting and preemption) launches: {spec} in "
          f"{time.perf_counter() - t6:.1f} s")
    for name in ("decode_attn", "decode_attn_paged", "decode_attn_paged_int8",
                 "exit_head", "quantize", "quantize_kv_write",
                 "quantize_kv_scatter"):
        check(spec[name] > 0, f"{name} was not launched in phase 6")
    launches = {name: n + batched[name] + adaptive[name] + spec[name]
                for name, n in launches.items()}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    if args.profile:
        profile_runs(model, prompts, theta)

    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
