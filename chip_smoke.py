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
   pages), with its device time (CUDA
   events), the plain version's, one PyTorch library call's where one
   computes the same function, and the bound (bytes over 3.35 TB/s or
   operations over the peak rate of the input type, whichever is larger);
   then a small model served on the card and on the CPU must give the same
   streams, sequentially and batched on dense and paged KV;
3. ee-llm-7b at full width (32 layers, bfloat16, random weights from a seed)
   through ``ServingSystem.generate_sequential`` in five modes, plus
   ``CoLLM.fused_exit_upload`` on a real l_ee1 hidden, with every kernel's
   launch counter set to 0 before and read after;
4. the same model through the batched engine, ``ServingSystem.generate``
   with 8 slots and 12 prompts of 128-512 tokens, on dense and paged KV
   (bfloat16 and int8 pages) in the collm, cloud and standalone modes, with
   the launch counters set to 0 before and read after;
5. the kernel table as one JSON line (launches: phases 3 and 4), the
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
    from repro_torch.kernels.quantize.ops import quantize_int8
    from repro_torch.kernels.quantize.ref import quantize_int8_ref
    err = 0.0
    d = CFG.d_model
    for label, x in ((f"bf16 (1,{d})", torch.randn(
                         (1, d), generator=gen, device=dev).bfloat16()),
                     (f"bf16 (8,{d})", torch.randn(
                         (8, d), generator=gen, device=dev).bfloat16() * 9),
                     ("f32 .5 ties + zero row",
                      tie_rows(4, torch.float32, dev))):
        (q, s), (qr, sr) = quantize_int8(x), quantize_int8_ref(x)
        e = max(max_err(q, qr), max_err(s, sr))
        print(f"quantize {label}: max|err|={e:.3g} (exact codes and scales)")
        check(torch.equal(q, qr) and torch.equal(s, sr),
              f"quantize {label} disagrees with its plain version")
        err = max(err, e)
    half = torch.tensor([[127.0, 2.5, 3.5, -0.5] + [0.0] * 4], device=dev)
    check(quantize_int8(half)[0][0, :4].tolist() == [127, 2, 4, 0],
          "quantize does not round half to even")
    x = torch.randn((1, d), generator=gen, device=dev).bfloat16()
    ms = device_ms(lambda i: quantize_int8(x))
    plain = device_ms(lambda i: quantize_int8_ref(x))
    bnd, by = bound_ms(x.numel() * 3 + 4, 3 * x.numel(), torch.bfloat16)
    return dict(name="quantize", source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quantize/kernel.py:31",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None)


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
    # the batched engine: paged on the card == dense on the card == CPU
    prompts += [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
                for i, n in ((2, 17), (3, 33))]
    for mode, wire in (("cloud", "float32"), ("collm", "int8")):
        runs = {}
        for name, model, layout in (("cpu", cpu, "dense"),
                                    ("dense", gpu, "dense"),
                                    ("paged", gpu, "paged")):
            ccfg = CollmConfig(theta=theta, wire_format=wire, backfill=True,
                               kv_layout=layout)
            runs[name] = ServingSystem(model, ccfg).generate(
                prompts, 16, mode, num_slots=3)
        same = (runs["paged"]["tokens"] == runs["dense"]["tokens"]
                == runs["cpu"]["tokens"])
        print(f"small model batched {mode}/{wire}: paged card == dense card "
              f"== CPU: {same}")
        check(same, f"small model batched {mode}: the paged stream differs")


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
    from repro_torch.kernels.quantize.ops import quantize_int8
    return {"decode_attn": decode_attn,
            "decode_attn_paged": decode_attn_paged,
            "decode_attn_paged_int8": decode_attn_paged_int8,
            "exit_head": exit_head, "quantize": quantize_int8,
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


def serve_phase4(model, theta) -> None:
    """12 prompts of 128-512 tokens through 8 slots (slots refill, pages
    are freed and reused), on dense and paged KV."""
    from repro_torch.serving.engine import token_agreement
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
            check(launched["decode_attn_paged_int8"] > 0
                  and launched["quantize"] > 0,
                  "paged-int8: int8 paged attention or int8 KV writes idle")
        else:
            check(launched["decode_attn_paged"] > 0,
                  f"{name}: decode_attn_paged was not launched")
    for name in ("dense", "paged", "paged+backfill", "paged-int8"):
        st = runs[name]["stats"]
        check(st.exits_l1 + st.exits_l2 > 0 and st.cloud_requests > 0,
              f"{name}: the split theta gives no mix of exits and cloud "
              f"requests")
    for name in ("paged", "paged-int8"):
        ags = [token_agreement(a, b) for a, b in
               zip(runs[name]["tokens"], runs["dense"]["tokens"])]
        same = sum(a == b for a, b in zip(runs[name]["tokens"],
                                          runs["dense"]["tokens"]))
        print(f"agreement {name} vs dense: {same}/{len(ags)} streams equal, "
              f"mean LCS-F1 {float(np.mean(ags)):.4f}")


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
    serve_phase4(model, theta)
    batched = {name: op.launches for name, op in ops.items()}
    print(f"phase 4 (generate) launches: {batched}")
    launches = {name: n + batched[name] for name, n in launches.items()}
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
