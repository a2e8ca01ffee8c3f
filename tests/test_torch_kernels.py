"""PyTorch port, kernel level: each kernel's plain PyTorch version (what the
port's wrappers run on CPU tensors) against the JAX package's Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: 2e-5 for decode attention
(3e-2 in bfloat16), 1e-5 for confidences, 1e-4 for logsumexp, exact tokens,
exact int8 codes with scale rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn.kernel import decode_attn_pallas  # noqa: E402
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_attn_ref  # noqa: E402
from repro.kernels.exit_head.kernel import exit_head_pallas  # noqa: E402
from repro.kernels.exit_head.ref import exit_head_ref as jax_exit_ref  # noqa: E402
from repro.kernels.exit_quant.kernel import exit_quant_pallas  # noqa: E402
from repro.kernels.exit_quant.ref import exit_quant_ref as jax_eq_ref  # noqa: E402
from repro.kernels.quantize.kernel import quantize_int8_pallas  # noqa: E402
from repro_torch.kernels.decode_attn.ops import decode_attn  # noqa: E402
from repro_torch.kernels.exit_head.ops import exit_head  # noqa: E402
from repro_torch.kernels.exit_quant.ops import exit_quant  # noqa: E402
from repro_torch.kernels.quantize.ops import quantize_int8  # noqa: E402

T = torch.from_numpy


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# decode_attn
# ---------------------------------------------------------------------------
def _attn_inputs(b, h, kv, d, s, fill, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[pos >= fill] = -1
    return q, k, v, pos


@pytest.mark.parametrize("b,h,kv,d,s,bs,fill,window", [
    (2, 8, 2, 64, 512, 128, 300, 0),       # GQA, part-filled ring
    (1, 4, 4, 128, 256, 128, 256, 0),      # MHA at ee-llm-7b's head_dim
    (2, 8, 8, 64, 512, 256, 512, 64),      # sliding window
])
def test_decode_attn_matches_pallas(b, h, kv, d, s, bs, fill, window):
    q, k, v, pos = _attn_inputs(b, h, kv, d, s, fill, seed=s + fill)
    cur = fill - 1
    want = decode_attn_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(cur, jnp.int32),
                              block_s=bs, window=window, interpret=True)
    got = decode_attn(T(q), T(k), T(v), T(pos),
                      torch.full((b,), cur, dtype=torch.int32), window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


def test_decode_attn_fully_masked_row_is_zero():
    """A row whose ring holds no valid key gives 0 (Pallas: l clamped),
    not NaN, in both frameworks."""
    q, k, v, pos = _attn_inputs(2, 4, 2, 64, 256, 200, seed=3)
    pos[1] = -1
    want = decode_attn_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(199, jnp.int32),
                              block_s=128, interpret=True)
    got = decode_attn(T(q), T(k), T(v), T(pos),
                      torch.full((2,), 199, dtype=torch.int32))
    assert np.all(got[1].numpy() == 0.0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


@pytest.mark.parametrize("s,window", [(300, 0), (300, 48), (552, 0)])
def test_decode_attn_per_row_cur_ragged_s(s, window):
    """Per-row cur and an S that is no multiple of any tile: the Pallas
    kernel takes neither (scalar cur, S % block_s == 0), so the JAX side is
    its oracle ``decode_attn_ref``, which the Pallas kernel is tested
    against in tests/test_kernels.py."""
    q, k, v, pos = _attn_inputs(3, 8, 2, 64, s, s, seed=s)
    cur = np.array([s - 1, s // 2, 7], np.int32)
    want = jax_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos), jnp.asarray(cur), window=window)
    got = decode_attn(T(q), T(k), T(v), T(pos), T(cur), window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


def test_decode_attn_bf16_matches_pallas():
    q, k, v, pos = _attn_inputs(2, 4, 2, 64, 256, 256, seed=5)
    as_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = decode_attn_pallas(as_bf16(q), as_bf16(k), as_bf16(v),
                              jnp.asarray(pos), jnp.asarray(255, jnp.int32),
                              block_s=128, interpret=True)
    tb = lambda a: T(a).to(torch.bfloat16)  # noqa: E731
    got = decode_attn(tb(q), tb(k), tb(v), T(pos),
                      torch.full((2,), 255, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=3e-2)


# ---------------------------------------------------------------------------
# exit_head / exit_quant
# ---------------------------------------------------------------------------
def _exit_inputs(b, d, v, seed, tie=None):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.05).astype(np.float32)
    ns = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    if tie is not None:
        # two identical read-out rows in different V tiles, both aligned
        # with every row's normalized hidden: the argmax is a tie
        lo, hi = tie
        w[lo] = w[hi] = np.sign(h[0] * (1 + ns)) * 0.5
    return h, w, ns


def _check_exit(got, want):
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=1e-5)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), _np(want[2]), atol=1e-4)


@pytest.mark.parametrize("b,d,v,bb,bv,tie", [
    (8, 64, 512, 8, 128, None),
    (4, 128, 1024, 4, 256, None),
    (1, 128, 512, 1, 128, (40, 300)),      # cross-tile tie -> lowest index
])
def test_exit_head_matches_pallas(b, d, v, bb, bv, tie):
    h, w, ns = _exit_inputs(b, d, v, seed=b * v, tie=tie)
    want = exit_head_pallas(jnp.asarray(h), jnp.asarray(w), jnp.asarray(ns),
                            block_b=bb, block_v=bv, interpret=True)
    got = exit_head(T(h), T(w), T(ns))
    _check_exit(got, want)
    if tie is not None:
        assert int(got[1][0]) == tie[0]


def test_exit_head_ragged_v_matches_oracle():
    """V = 300 is no multiple of the Pallas tile (ee-llm-7b's 32000 is not
    a multiple of 512 either): JAX's wrapper falls back to its oracle."""
    h, w, ns = _exit_inputs(5, 64, 300, seed=11, tie=(7, 290))
    want = jax_exit_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(ns))
    got = exit_head(T(h), T(w), T(ns))
    _check_exit(got, want)
    assert int(got[1][0]) == 7


@pytest.mark.parametrize("b,d,v,bb,bv,tie", [
    (8, 64, 512, 8, 256, None),
    (4, 32, 256, 4, 128, (3, 200)),
])
def test_exit_quant_matches_pallas(b, d, v, bb, bv, tie):
    h, w, ns = _exit_inputs(b, d, v, seed=v + b, tie=tie)
    want = exit_quant_pallas(jnp.asarray(h), jnp.asarray(w), jnp.asarray(ns),
                             block_b=bb, block_v=bv, interpret=True)
    got = exit_quant(T(h), T(w), T(ns))
    _check_exit(got, want)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[4].numpy(), _np(want[4]), rtol=1e-6)


def test_exit_quant_ragged_v_matches_oracle():
    h, w, ns = _exit_inputs(3, 64, 300, seed=12)
    want = jax_eq_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(ns))
    got = exit_quant(T(h), T(w), T(ns))
    _check_exit(got, want)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[4].numpy(), _np(want[4]), rtol=1e-6)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------
def _half_ties(n, d):
    """Rows with absmax 127 (scale exactly 1), so x / scale lands on exact
    .5 ties that round half to even; plus an all-zero row (scale 1e-12)."""
    rng = np.random.default_rng(0)
    x = (rng.integers(-126, 126, size=(n, d)) + 0.5).astype(np.float32)
    x[:, 0] = 127.0
    x[-1] = 0.0
    return x


@pytest.mark.parametrize("n,d,bn,kind", [
    (256, 128, 64, "normal"), (8, 4096, 8, "normal"), (4, 256, 4, "ties"),
])
def test_quantize_matches_pallas(n, d, bn, kind):
    x = (_half_ties(n, d) if kind == "ties" else
         (np.random.default_rng(n).normal(size=(n, d)) * 5).astype(np.float32))
    qa, sa = quantize_int8_pallas(jnp.asarray(x), block_n=bn, interpret=True)
    qb, sb = quantize_int8(T(x))
    assert qb.dtype == torch.int8 and sb.shape == (n, 1)
    assert np.array_equal(qb.numpy(), np.asarray(qa))
    np.testing.assert_allclose(sb.numpy(), _np(sa), rtol=1e-6)
    if kind == "ties":
        assert np.all(sb[-1].numpy() == np.float32(1e-12))
        assert np.all(qb[-1].numpy() == 0)
        # half to even: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0
        assert quantize_int8(T(np.array([[127, 2.5, 3.5, -0.5]],
                                        np.float32)))[0].tolist() == \
            [[127, 2, 4, 0]]


# ---------------------------------------------------------------------------
# wrappers: plain version only for CPU tensors, never a silent fallback
# ---------------------------------------------------------------------------
def test_wrappers_count_only_kernel_launches_and_raise_off_cpu():
    ops = (decode_attn, exit_head, quantize_int8, exit_quant)
    before = [op.launches for op in ops]
    h, w, ns = _exit_inputs(2, 64, 128, seed=1)
    exit_head(T(h), T(w), T(ns))
    exit_quant(T(h), T(w), T(ns))
    quantize_int8(T(h))
    q, k, v, pos = _attn_inputs(1, 4, 2, 64, 32, 32, seed=2)
    decode_attn(T(q), T(k), T(v), T(pos), torch.zeros(1, dtype=torch.int32))
    assert [op.launches for op in ops] == before     # CPU: plain versions
    meta = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8(meta)
    with pytest.raises(ValueError, match="CUDA"):
        exit_head(meta, torch.empty((128, 64), device="meta"),
                  torch.empty((64,), device="meta"))
    assert [op.launches for op in ops] == before
