"""PyTorch port: the gated linear attention core (``repro_torch.models.gla``)
against the JAX package's ``repro.models.gla`` on the same inputs (numpy
seeds), in float32 on the CPU: the cases of ``tests/test_gla.py`` (the
chunked form and the decode chain against the recurrent oracle for both
gate families, state continuation, extreme mLSTM input gates, chunk
invariance) and prompts whose length is no multiple of the chunk, where
the JAX package falls back to chunks of gcd(S, chunk) tokens (one token
at a prime length) and the port runs full chunks and a short last one.
Tolerances are those of ``tests/test_gla.py``: 5e-4, and 5e-3 with input
gates at 20 times their scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import gla as jgla  # noqa: E402
from repro_torch.models import gla as tgla  # noqa: E402

ATOL = 5e-4


def _inputs(seed, b=2, h=2, s=32, dk=8, dv=4, mlstm=True):
    """q, k, v, lf, li as numpy float32 (the distributions of
    ``tests/test_gla.py``)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, dk)) for _ in range(2))
    v = rng.standard_normal((b, h, s, dv))
    lf = -np.logaddexp(0.0, -(rng.standard_normal((b, h, s)) + 1.0))
    li = rng.standard_normal((b, h, s)) * (3.0 if mlstm else 1.0)
    if not mlstm:
        li = np.minimum(li, 0.0)
    return [a.astype(np.float32) for a in (q, k, v, lf, li)]


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_matches_jax_recurrent_and_chunked(normalize):
    """Chunks of 4, 8, 16 and 32 (and 5, which does not divide 32): the
    port's chunked form equals JAX's recurrent oracle and JAX's chunked
    form, outputs and final state."""
    arrays = _inputs(0, mlstm=normalize)
    y1, s1 = jgla.recurrent_gla(*_j(arrays), normalize=normalize)
    for chunk in (4, 5, 8, 16, 32):
        y, st = tgla.chunked_gla(*_t(arrays), normalize=normalize,
                                 chunk=chunk)
        _close(y, y1)
        for key in ("S", "n", "m"):
            _close(st[key], s1[key])
        if chunk != 5:
            y2, _ = jgla.chunked_gla(*_j(arrays), normalize=normalize,
                                     chunk=chunk)
            _close(y, y2)


def test_decode_chain_and_recurrent_match_jax():
    """The port's decode step chained over the sequence, and its recurrent
    form, equal JAX's recurrent oracle, for both gate families."""
    for normalize in (True, False):
        arrays = _inputs(1, mlstm=normalize)
        q, k, v, lf, li = _t(arrays)
        st = tgla.init_gla_state(2, 2, 8, 4)
        ys = []
        for t in range(q.shape[2]):
            y, st = tgla.gla_decode_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                         lf[:, :, t], li[:, :, t], st,
                                         normalize=normalize)
            ys.append(y)
        want, wst = jgla.recurrent_gla(*_j(arrays), normalize=normalize)
        _close(torch.stack(ys, 2), want)
        _close(st["S"], wst["S"])
        y_rec, rst = tgla.recurrent_gla(q, k, v, lf, li, normalize=normalize)
        _close(y_rec, want)
        _close(rst["S"], wst["S"])


def test_streaming_state_continuation():
    """Two halves with the state carried across equal the whole sequence,
    and JAX's whole sequence (what an edge->cloud state upload relies
    on)."""
    arrays = _inputs(2, s=32)
    a, b = ([x[:, :, :16] for x in arrays], [x[:, :, 16:] for x in arrays])
    y_full, s_full = jgla.chunked_gla(*_j(arrays), normalize=True, chunk=8)
    y_a, s_a = tgla.chunked_gla(*_t(a), normalize=True, chunk=8)
    y_b, s_b = tgla.chunked_gla(*_t(b), normalize=True, chunk=8, state=s_a)
    _close(torch.cat([y_a, y_b], 2), y_full)
    _close(s_b["S"], s_full["S"])
    _close(s_b["m"], s_full["m"])


@pytest.mark.parametrize("s", [37, 509])
def test_ragged_lengths_match_jax(s):
    """Prime lengths at chunk 32: the JAX package's chunked form runs
    chunks of one token, the port's full chunks and a ragged last one;
    both gate families equal JAX's chunked and recurrent forms.  The
    unnormalised state sums up to 509 updates (it and the outputs reach
    the hundreds), so they are held to 1e-4 relative besides 5e-4
    absolute."""
    for normalize in (True, False):
        arrays = _inputs(4, b=1, s=s, mlstm=normalize)
        want, wst = jgla.chunked_gla(*_j(arrays), normalize=normalize,
                                     chunk=32)
        y, st = tgla.chunked_gla(*_t(arrays), normalize=normalize, chunk=32)
        _close(y, want, rtol=1e-4)
        _close(st["S"], wst["S"], rtol=1e-4)
        y1, _ = jgla.recurrent_gla(*_j(arrays), normalize=normalize)
        _close(y, y1, rtol=1e-4)


def test_mlstm_extreme_gates_stay_finite():
    """Input gates at 20 times their scale: the stabiliser keeps the port's
    chunked output finite and equal to JAX's recurrent form (5e-3: the
    forms add the huge exponents in different orders)."""
    q, k, v, lf, li = _inputs(3)
    li = li * 20.0
    y, _ = tgla.chunked_gla(*_t([q, k, v, lf, li]), normalize=True, chunk=8)
    assert bool(torch.isfinite(y).all())
    want, _ = jgla.recurrent_gla(*_j([q, k, v, lf, li]), normalize=True)
    _close(y, want, atol=5e-3)
