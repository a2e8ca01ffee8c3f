"""PyTorch port on the card: each hand-written CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the serving loop on the card
against the same loop on the CPU.

The batched engine (``ServingSystem.generate``) is held to the same: a
small float32 model served on block-paged KV on the card gives the streams
of the dense layout on the card and on the CPU.

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
from repro_torch.kernels.quantize.ops import quantize_int8  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_int8_ref  # noqa: E402
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
