"""PyTorch port: the split plan of the two decode-attention kernels and the
arithmetic of their split-then-merge, on the CPU.

On the card, ``decode_attn`` and ``decode_attn_paged`` cut a row's keys
(or logical pages) in splits (``ops.split_plan``); each split's block keeps
a partial (m, l, acc) and the blocks of a row merge them in split order.
The kernels run only on the card (``tests/test_torch_gpu.py``); here a
plain-torch mirror of that arithmetic is held against the port's
``decode_attn_ref`` and the JAX package's ``decode_attn_ref`` on the same
numpy inputs.  Tolerance 2e-5, float32 decode attention's in
tests/test_kernels.py (the splits sum in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn.ref import decode_attn_ref as jax_attn_ref  # noqa: E402
from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    MAX_SPLITS, PAGED_MIN_PAGES, RING_ALIGN, RING_MIN_KEYS, SMS, split_plan)
from repro_torch.kernels.decode_attn.ref import decode_attn_ref  # noqa: E402

T = torch.from_numpy


def split_merge(q, k, v, pos, cur, per, window=0):
    """The kernels' arithmetic: split ``i`` attends keys ``[i * per, (i +
    1) * per)`` to a partial (m, l, acc) (m = -inf, l = acc = 0 where it
    has no valid key), then the partials merge in split order with
    weights exp(m_i - max m); a row with no valid key gives 0."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    parts = []
    for lo in range(0, s, per):
        ks, vs, ps = k[:, lo:lo + per], v[:, lo:lo + per], pos[:, lo:lo + per]
        logits = torch.einsum("bkgd,bskd->bkgs", qg, ks) / math.sqrt(d)
        valid = (ps >= 0) & (ps <= cur[:, None])
        if window:
            valid &= (cur[:, None] - ps) < window
        valid = valid[:, None, None, :]
        m = logits.masked_fill(~valid, -math.inf).amax(-1)
        e = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
        parts.append((m, e.sum(-1), torch.einsum("bkgs,bskd->bkgd", e, vs)))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
        den += l * w
        num += acc * w[..., None]
    out = torch.where(mx[..., None] == -math.inf, 0.0,
                      num / den.clamp_min(1e-30)[..., None])
    return out.reshape(b, h, d)


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------
PLAN_SHAPES = [
    # ring keys: ee-llm-7b's 552-key ring at 1, 4 and 8 rows, S = 1, small
    # models' rings (GQA 4/2, 2 kv heads), S below one split
    (552, 32, RING_ALIGN, RING_MIN_KEYS), (552, 128, RING_ALIGN, RING_MIN_KEYS),
    (552, 256, RING_ALIGN, RING_MIN_KEYS), (1, 32, RING_ALIGN, RING_MIN_KEYS),
    (300, 6, RING_ALIGN, RING_MIN_KEYS), (97, 4, RING_ALIGN, RING_MIN_KEYS),
    (40, 2, RING_ALIGN, RING_MIN_KEYS), (4096, 1, RING_ALIGN, RING_MIN_KEYS),
    # logical pages: 35 of 16 keys at 1 and 8 slots, small pools
    (35, 32, 1, PAGED_MIN_PAGES), (35, 256, 1, PAGED_MIN_PAGES),
    (9, 6, 1, PAGED_MIN_PAGES), (12, 4, 1, PAGED_MIN_PAGES),
    (1, 2, 1, PAGED_MIN_PAGES), (40, 4, 1, PAGED_MIN_PAGES),
]


@pytest.mark.parametrize("n,pairs,align,min_per", PLAN_SHAPES)
def test_split_plan_covers_every_unit_once(n, pairs, align, min_per):
    splits, per = split_plan(n, pairs, align=align, min_per=min_per)
    ranges = [range(i * per, min(n, (i + 1) * per)) for i in range(splits)]
    assert [u for r in ranges for u in r] == list(range(n))
    assert all(len(r) > 0 for r in ranges)          # no split is empty
    assert 1 <= splits <= MAX_SPLITS
    assert per == n or per % align == 0
    assert per >= min(min_per, n)
    if pairs >= SMS:                                # the card is full
        assert splits == 1
    elif splits < MAX_SPLITS and per > min_per:
        assert pairs * splits >= SMS                # one block per SM


def test_split_plan_rejects_empty_shapes():
    for n, pairs in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            split_plan(n, pairs)


# ---------------------------------------------------------------------------
# split-then-merge against both references
# ---------------------------------------------------------------------------
def _inputs(seed, b=4, h=8, kvh=2, d=32, s=70):
    """Row 0 is a full ring with a hole of never-written keys 10-19 (with 7
    splits, split 1 has no valid key); row 1 holds no valid key; rows 2 and
    3 sit at other positions (row 3 early: later splits are all future
    keys)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[0, 10:20] = -1
    if b > 1:
        pos[1] = -1
    cur = np.array([s - 1, s - 1, s // 2, 5][:b], np.int32)
    return q, k, v, pos, cur


@pytest.mark.parametrize("splits", [1, 2, 7, 70])
@pytest.mark.parametrize("window", [0, 9, 30])
def test_split_merge_matches_both_references(splits, window):
    """S = 70 keys in 1, 2, 7 and S splits.  window 9 leaves only the last
    split of row 0 valid at 7 splits and masks whole splits at every count;
    window 30 cuts through a split."""
    q, k, v, pos, cur = _inputs(seed=splits + window)
    s = k.shape[1]
    per = -(-s // splits)
    assert -(-s // per) == splits
    got = split_merge(T(q), T(k), T(v), T(pos), T(cur), per, window)
    assert torch.all(got[1] == 0)                   # no valid key: exactly 0
    want = decode_attn_ref(T(q), T(k), T(v), T(pos), T(cur), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    jax_want = jax_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), jnp.asarray(cur), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want, np.float32),
                               atol=2e-5)


@pytest.mark.parametrize("b,kvh,s", [(1, 2, 552), (2, 2, 300), (3, 1, 400)])
def test_split_merge_at_the_planned_split(b, kvh, s):
    """The plan the ring wrapper takes for these shapes, through the mirror:
    equal to the one-pass reference."""
    splits, per = split_plan(s, b * kvh, align=RING_ALIGN,
                             min_per=RING_MIN_KEYS)
    assert splits > 1
    q, k, v, pos, _ = _inputs(seed=s, b=b, h=4 * kvh, kvh=kvh, s=s)
    cur = np.full((b,), s - 1, np.int32)
    got = split_merge(T(q), T(k), T(v), T(pos), T(cur), per)
    want = decode_attn_ref(T(q), T(k), T(v), T(pos), T(cur))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
