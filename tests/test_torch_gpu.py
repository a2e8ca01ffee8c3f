"""PyTorch port on the card: each hand-written CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the serving loop on the card
against the same loop on the CPU.

The batched engine (``ServingSystem.generate``) is held to the same: a
small float32 model served on block-paged KV on the card gives the streams
of the dense layout on the card and on the CPU; so do its deadline misses
and standalone fallback under a ``ScriptedChannel``, and N single-slot
engines behind one ``CloudBatcher`` (``generate_multi``); ``top_k=1``
sampling is greedy on the card.  So are speculative drafts (k = 1 and 4)
with their rewinds, recompute and swap preemption (float32 and int8
pages), and drafts in flight across a preemption behind the
``CloudBatcher``; a rewind of paged rows whose block table has unmapped
entries, and an int8 swap round trip (byte-exact), are checked directly.

Every test carries the ``gpu`` marker and skips where no CUDA card is
present (decided in the ``cuda`` fixture, never at import).  On a machine
with a card:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \
        tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package (``--noconftest`` skips
``tests/conftest.py``, which does), so it also runs where only PyTorch is
installed.  Tolerances: float32 2e-5 for attention, 1e-5
for exit confidences and 1e-4 for logsumexp (the kernels sum in another
order than cuBLAS), 2e-2 for bfloat16 attention outputs (one bfloat16
rounding of results near 1), exact tokens and int8 codes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    PAGED_MIN_PAGES, RING_ALIGN, RING_MIN_KEYS, decode_attn,
    decode_attn_paged, decode_attn_paged_int8, split_plan)
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_paged_ref, decode_attn_ref)
from repro_torch.kernels.exit_head.ops import exit_head  # noqa: E402
from repro_torch.kernels.exit_head.ref import exit_head_ref  # noqa: E402
from repro_torch.kernels.exit_quant.ops import exit_quant  # noqa: E402
from repro_torch.kernels.exit_quant.ref import exit_quant_ref  # noqa: E402
from repro_torch.kernels.quantize.ops import (  # noqa: E402
    quantize_int8, quantize_kv_scatter, quantize_kv_write)
from repro_torch.kernels.quantize.ref import (  # noqa: E402
    quantize_int8_ref, quantize_kv_scatter_ref, quantize_kv_write_ref)
from repro_torch.models.attention import quantize_kv_rows  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402

pytestmark = pytest.mark.gpu

SMALL = ModelConfig(name="ee-small", arch_type="dense", n_layers=4,
                    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                    d_ff=256, vocab_size=500, exit_layers=(1, 2)).validate()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,kv,d,s,window", [
    (4, 32, 32, 128, 552, 0),        # ee-llm-7b decode, ragged S
    (3, 8, 2, 64, 300, 48),          # GQA with a window
    (2, 16, 2, 128, 97, 0),          # group of 8
])
def test_decode_attn_kernel(cuda, dtype, atol, b, h, kv, d, s, window):
    rng = np.random.default_rng(s)
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32), cuda, dtype)
    k = _t(rng.normal(size=(b, s, kv, d)).astype(np.float32), cuda, dtype)
    v = _t(rng.normal(size=(b, s, kv, d)).astype(np.float32), cuda, dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[0, s // 2:] = -1                      # part-filled ring
    pos[-1] = -1                              # no valid key: output 0
    cur = np.array([s - 1] + [s // (i + 2) for i in range(b - 1)], np.int32)
    pos, cur = _t(pos, cuda), _t(cur, cuda)
    before = decode_attn.launches
    got = decode_attn(q, k, v, pos, cur, window=window)
    torch.cuda.synchronize()
    assert decode_attn.launches == before + 1
    want = decode_attn_ref(q, k, v, pos, cur, window=window)
    assert got.dtype == dtype and torch.all(got[-1] == 0)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,window", [
    (1, 552, 0),        # the sequential loop's decode shape: split in 3
    (8, 552, 0),        # the dense engine's 8 slots
    (2, 1, 0),          # one key
    (2, 40, 0),         # fewer keys than one split
    (1, 552, None),     # a window that leaves only the last split valid
])
def test_decode_attn_kernel_splits(cuda, dtype, atol, b, s, window):
    """ee-llm-7b's heads (H = KV = 32, d = 128) at the shapes where the
    split plan cuts S or does not; two calls give the same bits (the
    splits merge in a fixed order, without atomics)."""
    h, kv, d = 32, 32, 128
    splits, per = split_plan(s, b * kv, align=RING_ALIGN,
                             min_per=RING_MIN_KEYS)
    if window is None:
        assert splits > 1
        window = s - (splits - 1) * per       # keys of the last split
    rng = np.random.default_rng(b * 1000 + s)
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32), cuda, dtype)
    k = _t(rng.normal(size=(b, s, kv, d)).astype(np.float32), cuda, dtype)
    v = _t(rng.normal(size=(b, s, kv, d)).astype(np.float32), cuda, dtype)
    pos = _t(np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy(),
             cuda)
    cur = _t(np.full((b,), s - 1, np.int32), cuda)
    got = decode_attn(q, k, v, pos, cur, window=window)
    again = decode_attn(q, k, v, pos, cur, window=window)
    torch.cuda.synchronize()
    want = decode_attn_ref(q, k, v, pos, cur, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(got, again)


def _paged_pool(b, kv, d, ps, n_lp, rng, *, gaps):
    """A page pool with ragged per-row fills through a scattered block
    table (pages handed out in shuffled order, a hole in one row's table,
    the last row with nothing mapped) and, with ``gaps``, positions that
    were never written."""
    n_pages = 1 + b * n_lp
    kp = rng.normal(size=(n_pages, ps, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kv, d)).astype(np.float32)
    pos = np.full((n_pages, ps), -1, np.int32)
    tbl = np.full((b, n_lp), -1, np.int32)
    cur = np.zeros((b,), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for bi in range(b - 1):
        fill = int(rng.integers(ps // 2, n_lp * ps))
        cur[bi] = fill - 1
        for lp in range(-(-fill // ps)):
            if bi == 0 and lp == 1:
                continue                      # a hole in the table
            pg = int(free.pop())
            tbl[bi, lp] = pg
            n = min(ps, fill - lp * ps)
            pos[pg, :n] = np.arange(lp * ps, lp * ps + n)
            if gaps:
                pos[pg, :n][rng.random(n) < 0.3] = -1
    cur[-1] = n_lp * ps - 1                   # nothing mapped: output 0
    return kp, vp, pos, tbl, cur


@pytest.mark.parametrize("dtype,int8,atol", [
    (torch.float32, False, 2e-5), (torch.bfloat16, False, 2e-2),
    (torch.float16, False, 2e-3), (torch.bfloat16, True, 2e-2),
    (torch.float32, True, 2e-5)])
@pytest.mark.parametrize("b,h,kv,d,ps,n_lp,window,gaps", [
    (8, 32, 32, 128, 16, 35, 0, False),   # ee-llm-7b decode, 8 slots
    (3, 8, 2, 64, 16, 9, 48, True),       # GQA 4 with a window, gaps
    (2, 16, 2, 128, 8, 12, 0, True),      # group of 8, 8-token pages
    (3, 4, 2, 64, 32, 4, 0, False),       # group of 2, 32-token pages
])
def test_decode_attn_paged_kernel(cuda, dtype, int8, atol, b, h, kv, d, ps,
                                  n_lp, window, gaps):
    rng = np.random.default_rng(b * 100 + d + ps)
    kp, vp, pos, tbl, cur = _paged_pool(b, kv, d, ps, n_lp, rng, gaps=gaps)
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32), cuda, dtype)
    pos, tbl, cur = _t(pos, cuda), _t(tbl, cuda), _t(cur, cuda)
    if int8:
        kq, ks = quantize_kv_rows(_t(kp, cuda))
        vq, vs = quantize_kv_rows(_t(vp, cuda))
        op, args = decode_attn_paged_int8, (q, kq, vq, ks, vs, pos, tbl, cur)
        want = decode_attn_paged_ref(q, kq, vq, pos, tbl, cur, window,
                                     k_scale=ks, v_scale=vs)
    else:
        kp, vp = _t(kp, cuda, dtype), _t(vp, cuda, dtype)
        op, args = decode_attn_paged, (q, kp, vp, pos, tbl, cur)
        want = decode_attn_paged_ref(q, kp, vp, pos, tbl, cur, window)
    before = op.launches
    got = op(*args, window=window)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    assert got.dtype == dtype and torch.all(got[-1] == 0)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,int8,atol", [
    (torch.float32, False, 2e-5), (torch.bfloat16, False, 2e-2),
    (torch.float16, False, 2e-3), (torch.bfloat16, True, 2e-2)])
@pytest.mark.parametrize("b,h,kv,d,n_lp,one_page", [
    (8, 32, 32, 128, 35, True),    # 8 slots, a single mapped page a row
    (2, 8, 2, 64, 40, False),      # 4 (row, kv head) pairs: pages split
    (1, 32, 32, 128, 35, False),   # ee-llm-7b at one row: pages split
])
def test_decode_attn_paged_kernel_splits(cuda, dtype, int8, atol, b, h, kv,
                                         d, n_lp, one_page):
    ps = 16
    splits, _ = split_plan(n_lp, b * kv, min_per=PAGED_MIN_PAGES)
    assert (splits == 1) == one_page
    rng = np.random.default_rng(b * 100 + n_lp)
    kp, vp, pos, tbl, cur = _paged_pool(b + 1, kv, d, ps, n_lp, rng,
                                        gaps=True)
    kp, vp, pos, tbl, cur = kp, vp, pos, tbl[:b], cur[:b]
    if one_page:
        tbl[:, 1:] = -1
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32), cuda, dtype)
    pos, tbl, cur = _t(pos, cuda), _t(tbl, cuda), _t(cur, cuda)
    if int8:
        kq, ks = quantize_kv_rows(_t(kp, cuda))
        vq, vs = quantize_kv_rows(_t(vp, cuda))
        args, kw = (q, kq, vq, pos, tbl, cur), dict(k_scale=ks, v_scale=vs)
    else:
        args, kw = (q, _t(kp, cuda, dtype), _t(vp, cuda, dtype), pos, tbl,
                    cur), {}
    got = decode_attn_paged(*args, **kw)
    again = decode_attn_paged(*args, **kw)
    torch.cuda.synchronize()
    want = decode_attn_paged_ref(*args, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(got, again)


PAGED_SMALL = ModelConfig(name="ee-small-64", arch_type="dense", n_layers=4,
                          d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                          d_ff=512, vocab_size=500,
                          exit_layers=(1, 2)).validate()


@pytest.mark.parametrize("mode,backfill", [("collm", False),
                                           ("collm", True), ("cloud", False),
                                           ("standalone", False)])
def test_generate_paged_on_the_card_matches_dense(cuda, mode, backfill):
    """float32 weights from one seed: ``generate`` on block-paged KV on the
    card (the paged kernel in every layer) gives the streams of the dense
    layout on the card and on the CPU; more prompts than slots, so pages
    are freed and reused.  int8 pages run the int8 variant to the end."""
    cpu = build_model(PAGED_SMALL, device="cpu", seed=5)
    gpu = build_model(PAGED_SMALL, device=cuda, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(i).integers(0, PAGED_SMALL.vocab_size, n)
               for i, n in enumerate((24, 9, 40, 17, 30))]
    full = ServingSystem(cpu, CollmConfig(theta=1.0)).generate(prompts, 16)
    c = sorted(l1 for l1, _ in full["stats"].confidences)
    theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
    kw = dict(theta=theta, backfill=backfill)
    runs = {}
    for name, dev, layout in (("cpu", cpu, {}), ("dense", gpu, {}),
                              ("paged", gpu, dict(kv_layout="paged")),
                              ("int8", gpu, dict(kv_layout="paged",
                                                 kv_dtype="int8"))):
        before = (decode_attn_paged.launches, decode_attn_paged_int8.launches)
        runs[name] = ServingSystem(dev, CollmConfig(**kw, **layout)).generate(
            prompts, 16, mode, num_slots=3)
        runs[name]["launched"] = (decode_attn_paged.launches - before[0],
                                  decode_attn_paged_int8.launches - before[1])
    assert runs["paged"]["tokens"] == runs["dense"]["tokens"] \
        == runs["cpu"]["tokens"]
    for name in ("exits_l1", "exits_l2", "cloud_requests", "upload_bytes"):
        assert getattr(runs["paged"]["stats"], name) == \
            getattr(runs["cpu"]["stats"], name)
    assert runs["paged"]["launched"][0] > 0 == runs["paged"]["launched"][1]
    assert runs["int8"]["launched"][1] > 0 == runs["int8"]["launched"][0]
    assert [len(t) for t in runs["int8"]["tokens"]] == [16] * len(prompts)


def _split_theta(model, prompts):
    """θ between the two middle l_ee1 confidences of a θ = 1 run: about
    half the ticks exit, and none sits on θ."""
    full = ServingSystem(model, CollmConfig(theta=1.0)).generate(prompts, 16)
    c = sorted(l1 for l1, _ in full["stats"].confidences)
    return (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2


def _paged_pair(cuda, seed):
    cpu = build_model(PAGED_SMALL, device="cpu", seed=seed)
    gpu = build_model(PAGED_SMALL, device=cuda, seed=seed)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(i).integers(0, PAGED_SMALL.vocab_size, n)
               for i, n in enumerate((24, 9, 40, 17))]
    return cpu, gpu, prompts


def _same_run(got, want):
    assert got["tokens"] == want["tokens"]
    for name in ("exits_l1", "exits_l2", "cloud_requests", "upload_bytes",
                 "deadline_misses", "fallbacks"):
        assert getattr(got["stats"], name) == getattr(want["stats"], name)
    assert got["virtual_time"] == want["virtual_time"]
    assert got["late_drops"] == want["late_drops"]
    assert got["channel_stats"] == want["channel_stats"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_generate_deadline_fallback_on_the_card_matches_cpu(cuda, layout):
    """Replies slower than their deadline (``ScriptedChannel``) with
    ``fallback_after=2``: the card's run misses, drops and falls back
    exactly as the CPU's, token for token and in virtual time."""
    from repro_torch.core.transport import ScriptedChannel
    cpu, gpu, prompts = _paged_pair(cuda, seed=7)
    ccfg = CollmConfig(theta=_split_theta(cpu, prompts), kv_layout=layout)
    runs = [ServingSystem(m, ccfg).generate(
        prompts, 16, num_slots=3, tick_time_s=0.005, fallback_after=2,
        channel=ScriptedChannel([0.5], deadline_s=0.02)) for m in (cpu, gpu)]
    _same_run(runs[1], runs[0])
    st = runs[1]["stats"]
    assert st.deadline_misses > 0 and st.fallbacks >= 1
    assert runs[1]["late_drops"] == st.deadline_misses


@pytest.mark.parametrize("cloud_batch", [True, False])
def test_generate_multi_on_the_card_matches_cpu(cuda, cloud_batch):
    """Four single-slot engines on paged KV, ``AsyncSimChannel``s sharing
    one service point (batching with the ``CloudBatcher``, FIFO without):
    the card equals the CPU, and the batched streams equal the FIFO
    streams on the card."""
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel, CloudServicePoint
    cpu, gpu, prompts = _paged_pair(cuda, seed=8)
    ccfg = CollmConfig(theta=_split_theta(cpu, prompts), kv_layout="paged")

    def run(model, batched):
        svc = (CloudServicePoint(0.008, batch_window_s=0.004, max_batch=4)
               if batched else CloudServicePoint(0.008))
        chans = [AsyncSimChannel(NetworkParams(), service=svc)
                 for _ in prompts]
        before = decode_attn_paged.launches
        r = ServingSystem(model, ccfg).generate_multi(
            prompts, 16, cloud_batch=batched, channels=chans,
            tick_time_s=0.01)
        r["launched"] = decode_attn_paged.launches - before
        return r

    got, want = run(gpu, cloud_batch), run(cpu, cloud_batch)
    _same_run(got, want)
    assert got["launched"] > 0
    if cloud_batch:
        assert got["batcher"]["mean_batch"] > 1
        assert got["batcher"] == {**want["batcher"], "cloud_time_s":
                                  got["batcher"]["cloud_time_s"]}
        assert got["tokens"] == run(gpu, False)["tokens"]


def test_top_k_one_sampling_equals_greedy_on_the_card(cuda):
    """``temperature_sample`` with ``top_k=1`` on CUDA logits is the
    argmax, and ``generate`` with it gives the greedy streams."""
    from repro_torch.serving import sampler
    lg = torch.randn((64, 32000), device=cuda) * 4
    gen = torch.Generator(device=cuda).manual_seed(0)
    assert torch.equal(sampler.temperature_sample(gen, lg, 0.8, top_k=1),
                       sampler.greedy(lg))
    _, gpu, prompts = _paged_pair(cuda, seed=9)
    ccfg = CollmConfig(theta=_split_theta(gpu, prompts), kv_layout="paged")
    greedy = ServingSystem(gpu, ccfg).generate(prompts, 16, num_slots=3)
    sampled = ServingSystem(gpu, ccfg).generate(
        prompts, 16, num_slots=3, sampler="temperature", temperature=0.8,
        top_k=1)
    assert sampled["tokens"] == greedy["tokens"]
    again = [ServingSystem(gpu, ccfg).generate(
        prompts, 16, num_slots=3, sampler="temperature", temperature=0.8,
        top_k=50, seed=3)["tokens"] for _ in range(2)]
    assert again[0] == again[1]


def _exit_inputs(b, d, v, dev, dtype, tie=None, seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.02).astype(np.float32)
    ns = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    if tie is not None:
        # equal one-hot rows on row 0's largest normalized element: an exact
        # tie of the top logit in any summation order
        j = int(np.abs(h[0] * (1 + ns)).argmax())
        w[list(tie)] = 0.0
        w[list(tie), j] = 4.0 * np.sign(h[0, j] * (1 + ns[j]))
    return _t(h, dev, dtype), _t(w, dev, dtype), _t(ns, dev, dtype)


def _check_exit(got, want):
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,v,tie", [(1, 4096, 32000, (100, 20000)),
                                       (8, 4096, 32000, None),
                                       (3, 256, 300, (5, 299))])
def test_exit_head_and_exit_quant_kernels(cuda, dtype, b, d, v, tie):
    h, w, ns = _exit_inputs(b, d, v, cuda, dtype, tie, seed=b + v)
    got = exit_head(h, w, ns)
    want = exit_head_ref(h, w, ns)
    _check_exit(got, want)
    if tie is not None:
        assert int(got[1][0]) == tie[0]       # ties go to the lowest index
    fused = exit_quant(h, w, ns)
    torch.cuda.synchronize()
    for a, e in zip(fused[:3], got):          # same arithmetic as exit_head
        assert torch.equal(a, e)
    q, s = quantize_int8_ref(h)
    assert torch.equal(fused[3], q) and torch.equal(fused[4], s)
    _check_exit(fused[:3], exit_quant_ref(h, w, ns)[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernel_half_even_ties_and_zero_row(cuda, dtype):
    rng = np.random.default_rng(0)
    x = (rng.integers(-126, 126, size=(6, 4096)) + 0.5).astype(np.float32)
    x[:, 0] = 127.0                           # scale exactly 1: x.5 ties
    x[1] = rng.normal(size=4096) * 7
    x[-1] = 0.0                               # scale 1e-12, codes 0
    xt = _t(x, cuda, dtype)
    q, s = quantize_int8(xt)
    torch.cuda.synchronize()
    qr, sr = quantize_int8_ref(xt)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert float(s[-1]) == np.float32(1e-12) and not q[-1].any()
    row = _t(np.array([[127, 2.5, 3.5, -0.5] + [0] * 4], np.float32), cuda)
    assert quantize_int8(row)[0][0, :4].tolist() == [127, 2, 4, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [
    (1, 4096), (8, 4096),             # the wire row, 1 and 8 rows
    (3, 8), (9, 130), (5, 100),       # a warp a row: narrower loads
    (4, 256), (2, 257),               # the warp / block boundary, odd d
    (2, 8192), (1, 12288),            # a block of 256, of 1024 threads
])
def test_quantize_kernel_shapes(cuda, dtype, n, d):
    """The wire quantizer at every layout of the kernel, bit for bit."""
    rng = np.random.default_rng(n * d)
    x = (rng.normal(size=(n, d)) * rng.choice([0.01, 1.0, 300.0], (n, 1)))
    x = _t(x.astype(np.float32), cuda, dtype)
    before = quantize_int8.launches
    q, s = quantize_int8(x)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before + 1
    qr, sr = quantize_int8_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)


PS = 16


def _kv_pool(rng, num_pages, kvh, d, dev):
    """An int8 page pool with stale random contents."""
    return {
        "kp": _t(rng.integers(-127, 128, (num_pages, PS, kvh, d), np.int8),
                 dev),
        "vp": _t(rng.integers(-127, 128, (num_pages, PS, kvh, d), np.int8),
                 dev),
        "ks": _t(rng.random((num_pages, PS, kvh), np.float32), dev),
        "vs": _t(rng.random((num_pages, PS, kvh), np.float32), dev),
        "pos": _t(rng.integers(-1, 50, (num_pages, PS), np.int32), dev),
    }


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def _same_kv_pool(got, want):
    """Every marker; codes and scales outside the trash page 0 (rows that
    share one of its slots leave either row's codes there)."""
    assert torch.equal(got["pos"], want["pos"])
    for k in ("kp", "vp", "ks", "vs"):
        assert torch.equal(got[k][1:], want[k][1:]), k


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b", [1, 8])
def test_quantize_kv_write_kernel(cuda, b, d, dtype, masked):
    """A decode step's int8 page write in one launch against its plain
    version: rows with their own pages; row 1's entry unmapped, row 2 past
    its table, row 7 at a negative position; some rows masked."""
    rng = np.random.default_rng(b * 10 + d + masked)
    kvh, n_lp = 4, 3
    pool = _kv_pool(rng, 1 + b * n_lp, kvh, d, cuda)
    tbl = (1 + rng.permutation(b * n_lp)).reshape(b, n_lp).astype(np.int32)
    pos = rng.integers(0, n_lp * PS, b).astype(np.int32)
    if b > 1:
        tbl[1, pos[1] // PS] = -1
        pos[2] = n_lp * PS + 3
        pos[7] = -3
    mask = None
    if masked:
        mask = _t(np.arange(b) % 3 != 2, cuda)
    knew = _t((rng.normal(size=(b, kvh, d)) * 5).astype(np.float32), cuda,
              dtype)
    vnew = _t((rng.normal(size=(b, kvh, d)) * 5).astype(np.float32), cuda,
              dtype)
    vnew[0, 0] = 0
    args = (knew, vnew, _t(pos, cuda), _t(tbl, cuda), mask)
    want = quantize_kv_write_ref(_clone(pool), *args)
    before = quantize_kv_write.launches
    got = quantize_kv_write(pool, *args)
    torch.cuda.synchronize()
    assert quantize_kv_write.launches == before + 1
    _same_kv_pool(got, want)


@pytest.mark.parametrize("case", ["short", "long", "first"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_quantize_kv_scatter_kernel(cuda, d, dtype, case):
    """A prefilled row's int8 scatter in one launch against its plain
    version: a ring shorter than its pages (fills past it), longer
    (trimmed), and unmapped page ids."""
    rng = np.random.default_rng(d + len(case))
    kvh = 4
    length, n_real, pages = {"short": (40, 27, [5, 2, 3, -1]),
                             "long": (80, 80, [3, 1, 4, 6]),
                             "first": (48, 48, [-1, 2, 5])}[case]
    pool = _kv_pool(rng, 7, kvh, d, cuda)
    pos = np.where(np.arange(length) < n_real, np.arange(length), -1)
    row = {k: _t((rng.normal(size=(1, length, kvh, d)) * 3).astype(
        np.float32), cuda, dtype) for k in ("k", "v")}
    row["k"][0, 1, 0] = 0
    row["pos"] = _t(pos[None].astype(np.int32), cuda)
    pages = _t(np.array(pages, np.int32), cuda)
    want = quantize_kv_scatter_ref(_clone(pool), row, pages)
    before = quantize_kv_scatter.launches
    got = quantize_kv_scatter(pool, row, pages)
    torch.cuda.synchronize()
    assert quantize_kv_scatter.launches == before + 1
    _same_kv_pool(got, want)


@pytest.mark.parametrize("mode,theta,wire,backfill", [
    ("cloud", 1.0, "float32", False),
    ("collm", 1.0, "float32", False),
    ("collm", 0.0, "int8", False),
    ("collm", None, "float16", True),
    ("standalone", None, "float16", False),
])
def test_generate_sequential_on_the_card_matches_cpu(cuda, mode, theta, wire,
                                                     backfill):
    """float32 weights from one seed on both devices: the card's kernels
    and the CPU's plain versions give the same greedy streams and counters.
    ``theta=None`` puts θ between the two middle l_ee1 confidences of a
    θ = 1 run, so about half the ticks exit and none sits on θ."""
    cpu = build_model(SMALL, device="cpu", seed=3)
    gpu = build_model(SMALL, device=cuda, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(i).integers(0, SMALL.vocab_size, n)
               for i, n in enumerate((24, 9))]
    if theta is None:
        full = ServingSystem(cpu, CollmConfig(theta=1.0)).generate_sequential(
            prompts, 16)
        c = sorted(l1 for l1, _ in full["stats"].confidences)
        theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
    ccfg = CollmConfig(theta=theta, wire_format=wire, backfill=backfill)
    want = ServingSystem(cpu, ccfg).generate_sequential(prompts, 16, mode)
    got = ServingSystem(gpu, ccfg).generate_sequential(prompts, 16, mode)
    assert got["tokens"] == want["tokens"]
    for name in ("exits_l1", "exits_l2", "cloud_requests", "upload_bytes"):
        assert getattr(got["stats"], name) == getattr(want["stats"], name)


def _spec_fields(got, want):
    for name in ("draft_tokens", "accepted_tokens", "spec_rewinds",
                 "preemptions"):
        assert getattr(got["stats"], name) == getattr(want["stats"], name)
    assert got["stats"].accept_lens == want["stats"].accept_lens


@pytest.mark.parametrize("layout,k", [("dense", 1), ("dense", 4),
                                      ("paged", 4)])
def test_speculative_on_the_card_matches_cpu(cuda, layout, k):
    """Speculative drafts of k tokens, verified in one ring pass, with
    rewinds (the cloud's KV invalidated past each): the card equals the
    CPU token for token, in its counters and in virtual time."""
    from repro_torch.core.netsim import NetworkParams
    from repro_torch.core.transport import AsyncSimChannel
    cpu, gpu, prompts = _paged_pair(cuda, seed=9)
    ccfg = CollmConfig(theta=_split_theta(cpu, prompts), kv_layout=layout,
                       speculative=True, spec_k=k)
    runs = [ServingSystem(m, ccfg).generate(
        prompts, 16, num_slots=3, tick_time_s=0.01,
        channel=AsyncSimChannel(NetworkParams(), service_s=0.008))
        for m in (cpu, gpu)]
    _same_run(runs[1], runs[0])
    _spec_fields(runs[1], runs[0])
    assert runs[1]["stats"].draft_tokens > 0


@pytest.mark.parametrize("pre,kv_dtype", [("recompute", "float32"),
                                          ("swap", "float32"),
                                          ("recompute", "int8"),
                                          ("swap", "int8")])
def test_preemption_on_the_card_matches_cpu(cuda, pre, kv_dtype):
    """A pool too small for the streams' worst case (a natural preemption),
    plus a forced schedule: the card preempts, swaps or re-prefills (int8 pages through
    ``quantize_kv_scatter``) and resumes exactly as the CPU does, and its
    pool and swap pool drain."""
    cpu, gpu, prompts = _paged_pair(cuda, seed=10)
    ccfg = CollmConfig(theta=_split_theta(cpu, prompts), kv_layout="paged",
                       kv_dtype=kv_dtype, preemption=pre)
    runs, systems = [], []
    for m in (cpu, gpu):
        system = ServingSystem(m, ccfg)
        before = quantize_kv_scatter.launches
        runs.append(system.generate(prompts, 16, num_slots=3, num_pages=6,
                                    preempt_schedule=[(3, 0), (5, 1)]))
        runs[-1]["scatters"] = quantize_kv_scatter.launches - before
        systems.append(system)
    _same_run(runs[1], runs[0])
    _spec_fields(runs[1], runs[0])
    assert runs[1]["pool_stats"] == runs[0]["pool_stats"]
    assert (runs[1]["preemptions"], runs[1]["oops"]) == \
        (runs[0]["preemptions"], runs[0]["oops"])
    assert runs[1]["oops"] >= 1 and runs[1]["preemptions"] >= 3
    sched = next(iter(systems[1]._schedulers.values()))
    assert sched.pool.free_pages == sched.pool.num_pages
    if pre == "swap":
        cpu_swap = next(iter(systems[0]._schedulers.values())).swap.stats
        assert sched.swap.stats == cpu_swap and len(sched.swap) == 0
    if kv_dtype == "int8":
        # one scatter per prefilled layer at each admission, and again at
        # each recompute resume
        assert runs[1]["scatters"] > 0
        if pre == "recompute":
            layers = PAGED_SMALL.n_layers + PAGED_SMALL.exit_layers[-1] \
                - PAGED_SMALL.exit_layers[0]
            assert runs[1]["scatters"] > len(prompts) * layers


@pytest.mark.parametrize("pre", ["recompute", "swap"])
def test_draft_inflight_preemption_batcher_on_the_card(cuda, pre):
    """k = 4 drafts in flight when two single-slot engines behind one
    ``CloudBatcher`` are preempted: the card equals the CPU, and every
    cloud row comes back."""
    from repro_torch.core.transport import ScriptedChannel
    cpu, gpu, prompts = _paged_pair(cuda, seed=11)
    ccfg = CollmConfig(theta=_split_theta(cpu, prompts), kv_layout="paged",
                       speculative=True, spec_k=4, preemption=pre)
    runs = []
    for m in (cpu, gpu):
        system = ServingSystem(m, ccfg)
        runs.append(system.generate_multi(
            prompts, 16, cloud_batch=True, tick_time_s=0.01,
            channels=[ScriptedChannel([0.05], deadline_s=float("inf"))
                      for _ in prompts],
            preempt_schedules=[[(5, 0)], None, [(7, 0)], None]))
        assert system.cloud.cm.cloud_slots_free() == len(prompts)
    _same_run(runs[1], runs[0])
    _spec_fields(runs[1], runs[0])
    assert runs[1]["stats"].preemptions == 2
    assert runs[1]["batcher"] == {**runs[0]["batcher"], "cloud_time_s":
                                  runs[1]["batcher"]["cloud_time_s"]}


def test_paged_rewind_with_unmapped_entries_on_the_card(cuda):
    """``invalidate_rows_after`` on paged pools scatters each row's cut
    through its block table; unmapped entries all land on the trash page
    (duplicate indices, in no fixed order on CUDA), which is harmless only
    because its markers stay -1.  On the card: exactly the markers at or
    past each row's cut are -1, nothing else moved, the trash page stays
    invalid, and the result equals the CPU's."""
    from repro_torch.core.collm import CoLLM
    ps, n_pages = 16, 8
    tbl = np.array([[1, 2, -1, -1], [3, -1, -1, -1], [4, 5, 6, -1],
                    [-1, -1, -1, -1]], np.int32)
    cut = np.array([20, 2**31 - 1, 35, 3], np.int32)
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(PAGED_SMALL, device=dev, seed=12)
        co = CoLLM(model, CollmConfig(kv_layout="paged"))
        caches = co.init_cloud_cache_paged(4, n_pages, ps)
        for layers in caches.values():
            for c in layers:
                pos = c["self"]["pos"]
                for row in tbl:
                    for lp, page in enumerate(row):
                        if page >= 0:
                            pos[page] = torch.arange(lp * ps, (lp + 1) * ps)
        co.invalidate_rows_after(caches, cut, torch.as_tensor(tbl,
                                                              device=dev))
        out[str(dev)] = [c["self"]["pos"].cpu() for layers in caches.values()
                         for c in layers]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(got, want)
        assert (got[0] == -1).all() and (got[7:] == -1).all()
        for r, row in enumerate(tbl):
            for lp, page in enumerate(row):
                if page >= 0:
                    p = torch.arange(lp * ps, (lp + 1) * ps)
                    assert torch.equal(got[page],
                                       torch.where(p >= int(cut[r]), -1, p))


def test_int8_swap_roundtrip_on_the_card_is_byte_exact(cuda):
    """An int8 slot written on the card (``quantize_kv_scatter``), swapped
    to host memory, its pages freed and reset, and written back into other
    pages: every byte of int8 data, float32 scales and markers comes back
    as it was."""
    from repro_torch.core.paging import PagePool, SwapPool
    from repro_torch.models.attention import (init_paged_attn_cache,
                                              paged_reset_pages,
                                              paged_scatter_prefill)
    from repro_torch.serving.cloud_batcher import (gather_slot_pages,
                                                   rebind_slot_pages,
                                                   snapshot_to_device,
                                                   _write_pages_tree)
    ps, num_pages, n = 16, 10, 70
    pool = PagePool(num_pages, ps, 2, 6)
    cache = {0: [{"self": init_paged_attn_cache(
        PAGED_SMALL, num_pages, ps, device=cuda, kv_dtype="int8")}]}
    node = cache[0][0]["self"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    kvh, hd = PAGED_SMALL.n_kv_heads, PAGED_SMALL.resolved_head_dim
    row = {"k": 2 * torch.randn((1, 80, kvh, hd), generator=gen,
                                device=cuda),
           "v": 2 * torch.randn((1, 80, kvh, hd), generator=gen,
                                device=cuda),
           "pos": torch.where(torch.arange(80, device=cuda) < n,
                              torch.arange(80, device=cuda), -1
                              ).to(torch.int32)[None]}
    pool.alloc(1, 0)                       # another stream holds page 1
    pages = [pool.alloc(0, lp) for lp in range(5)]
    before = quantize_kv_scatter.launches
    paged_scatter_prefill(node, row, pages)
    assert quantize_kv_scatter.launches == before + 1
    logical, snap = gather_slot_pages(pool, 0, cache)
    assert snap[0][0]["self"]["kp"].device.type == "cpu"
    swap = SwapPool()
    swap.put(0, {"logical": logical, "trees": snap})
    paged_reset_pages(node, pool.free_slot(0))
    pool.alloc(1, 1)                       # the freed pages move around
    got = swap.take(0)
    padded = rebind_slot_pages(pool, 0, got["logical"])
    assert set(padded.tolist()) != set(pages)
    _write_pages_tree(cache, padded, snapshot_to_device(got["trees"], cuda))
    _, again = gather_slot_pages(pool, 0, cache)
    for key, leaf in snap[0][0]["self"].items():
        assert torch.equal(again[0][0]["self"][key], leaf), key
    assert swap.stats.bytes_out == swap.stats.bytes_in > 0
