"""PyTorch port, module level: the long-sequence and sliding-window prefill
paths of ``repro_torch.models.attention`` against the JAX package's, in
float32 on the CPU, on the same numpy inputs and weights.

* ``_chunked_attention`` and ``_banded_attention`` with
  ``tests/test_attention.py``'s cases, at its 2e-5 tolerance; the port
  batches whole query chunks into one pass (``tile``) and skips kv chunks
  that the mask hides from a whole pass, so each case also runs with a
  tile of one chunk (many passes, skipped chunks).
* ``attention_forward``'s dispatch: banded at S > window, chunked at
  S = 2304 (S*S > 2**22), narrow heads; the ring caches it writes.
* A windowed ring decode after a long prefill (the ring has wrapped), as
  ``test_window_ring_cache_decode`` does it, step for step against JAX.
* With a window: the paged prefill scatter of a wrapped ring, the chunk
  attention of chunked prefill and the paged decode, pool and outputs.
* A right-padded prefill keeps its real tail in a windowed ring (the JAX
  package keeps the pads there: ROADMAP §C).
* Cross-attention over an encoder's output, direct and chunked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ATOL = 2e-5


def _cfg(**kw):
    base = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64)
    base.update(kw)
    return ModelConfig(**base).validate(), TModelConfig(**base).validate()


def _qkv(seed, b=2, s=64, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _layer(cfg, tcfg, seed):
    """One attention layer's weights, JAX's and the same in the port."""
    jp = jattn.init_attention(jax.random.PRNGKey(seed), cfg)
    tp = tattn.Attention(tcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, w in jp.items():
            getattr(tp, name).copy_(torch.from_numpy(np.array(w)))
    return jp, tp


@pytest.mark.parametrize("tile", [tattn._TILE_ELEMS, 2 * 4 * 16 * 16])
@pytest.mark.parametrize("window,prefix", [(0, 0), (16, 0), (0, 8)])
def test_chunked_matches_jax(window, prefix, tile):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0))
    kw = dict(causal=True, window=window, prefix_len=prefix, scale=0.25,
              q_chunk=16, kv_chunk=16)
    want = jattn._chunked_attention(jq, jk, jv, jnp.arange(64),
                                    jnp.arange(64), **kw)
    got = tattn._chunked_attention(tq, tk, tv, torch.arange(64),
                                   torch.arange(64), tile=tile, **kw)
    _close(got, want)
    direct = tattn._direct_attention(tq, tk, tv, torch.arange(64),
                                     torch.arange(64), causal=True,
                                     window=window, prefix_len=prefix,
                                     scale=0.25)
    _close(got, direct.numpy())


def test_chunked_skips_hidden_blocks():
    """Causal with a window: of 4 x 4 (pass, kv chunk) blocks, the ones
    above the diagonal and those below the window are hidden."""
    pos = torch.arange(64)
    hidden = tattn._hidden_blocks(pos, pos, 16, 16, causal=True, window=20,
                                  prefix_len=0)
    assert hidden == [[j > i or i - j >= 3 for j in range(4)]
                      for i in range(4)]
    prefix = tattn._hidden_blocks(pos, pos, 16, 16, causal=True, window=0,
                                  prefix_len=8)
    assert [row[0] for row in prefix] == [False] * 4


@pytest.mark.parametrize("tile", [tattn._TILE_ELEMS, 2 * 4 * 32 * 64])
def test_banded_matches_jax(tile):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, s=128))
    want = jattn._banded_attention(jq, jk, jv, jnp.arange(128),
                                   jnp.arange(128), window=32, scale=0.25,
                                   q_chunk=32)
    got = tattn._banded_attention(tq, tk, tv, torch.arange(128),
                                  torch.arange(128), window=32, scale=0.25,
                                  q_chunk=32, tile=tile)
    _close(got, want)


@pytest.mark.parametrize("s,window,ring", [
    (96, 32, 0),        # banded (S > window), a ring of the window
    (2304, 0, 2304),    # chunked (S*S > 2**22), a full ring
    (2304, 512, 0),     # banded at the long length
])
@torch.no_grad()
def test_attention_forward_dispatch_matches_jax(s, window, ring):
    """``attention_forward`` at the lengths where JAX leaves the direct
    path, narrow heads (GQA 2/1, d = 16), with the ring cache it fills."""
    cfg, tcfg = _cfg(d_model=32, n_heads=2, n_kv_heads=1, qkv_bias=True,
                     sliding_window=window)
    jp, tp = _layer(cfg, tcfg, seed=s + window)
    x = np.random.default_rng(s).normal(size=(1, s, 32)).astype(np.float32)
    jc = jattn.init_attn_cache(cfg, 1, ring or s, window=window)
    tc = tattn.init_attn_cache(tcfg, 1, ring or s, window=window)
    jy, jc = jattn.attention_forward(jp, cfg, jnp.asarray(x), window=window,
                                     cache=jc)
    ty, tc = tattn.attention_forward(tp, tcfg, torch.from_numpy(x),
                                     window=window, cache=tc)
    _close(ty, jy, atol=1e-4)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        _close(tc[key], jc[key], atol=1e-5)


@pytest.mark.parametrize("sq,sk", [(12, 64), (2048, 2304)])
def test_cross_attention_matches_jax(sq, sk):
    """Cross-attention over an encoder's output: the direct path, and the
    chunked one at Sq*Sk > 2**22 (JAX's gcd chunks of 512 queries and 256
    keys), with qkv biases and no rotation of the keys."""
    cfg, tcfg = _cfg(d_model=32, n_heads=2, n_kv_heads=1, qkv_bias=True)
    jp, tp = _layer(cfg, tcfg, seed=sq)
    rng = np.random.default_rng(sk)
    for b in ("bq", "bk", "bv"):
        jp[b] = jnp.asarray(rng.normal(size=jp[b].shape), jnp.float32)
        with torch.no_grad():
            getattr(tp, b).copy_(torch.from_numpy(np.asarray(jp[b])))
    x = rng.normal(size=(1, sq, 32)).astype(np.float32)
    enc = rng.normal(size=(1, sk, 32)).astype(np.float32)
    want, _ = jattn.attention_forward(jp, cfg, jnp.asarray(x),
                                      enc_out=jnp.asarray(enc),
                                      causal=False, use_rope=False)
    got, _ = tattn.attention_forward(tp, tcfg, torch.from_numpy(x),
                                     enc_out=torch.from_numpy(enc),
                                     causal=False, use_rope=False)
    _close(got, want, atol=1e-4)


@torch.no_grad()
def test_window_ring_decode_after_long_prefill_matches_jax():
    """A 40-token banded prefill into a 16-slot ring (it wraps), then 8
    decode steps through the ring: every output equals JAX's, and the
    teacher-forced banded forward over all 48 tokens."""
    cfg, tcfg = _cfg(sliding_window=16)
    jp, tp = _layer(cfg, tcfg, seed=2)
    x = np.random.default_rng(3).normal(size=(1, 48, 64)).astype(np.float32)
    full, _ = tattn.attention_forward(tp, tcfg, torch.from_numpy(x),
                                      window=16)
    jc = jattn.init_attn_cache(cfg, 1, 48, window=16)
    tc = tattn.init_attn_cache(tcfg, 1, 48, window=16)
    jy, jc = jattn.attention_forward(jp, cfg, jnp.asarray(x[:, :40]),
                                     window=16, cache=jc)
    ty, tc = tattn.attention_forward(tp, tcfg, torch.from_numpy(x[:, :40]),
                                     window=16, cache=tc)
    _close(ty, jy)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for t in range(40, 48):
        jo, jc = jattn.decode_attention(jp, cfg, jnp.asarray(x[:, t:t + 1]),
                                        jc, jnp.asarray(t, jnp.int32),
                                        window=16)
        to, tc = tattn.decode_attention(tp, tcfg,
                                        torch.from_numpy(x[:, t:t + 1]), tc,
                                        torch.tensor([t], dtype=torch.int32),
                                        window=16)
        _close(to, jo, atol=2e-4)
        _close(to[:, 0], full[:, t].numpy(), atol=2e-4)


@torch.no_grad()
def test_padded_prefill_keeps_real_tail_in_a_window_ring():
    """A 40-token prompt right-padded to 64 into a 16-slot windowed ring:
    with ``valid_len`` the ring holds positions 24..39, as an unpadded
    prefill's does (the JAX package's ring holds the pads 48..63)."""
    cfg, tcfg = _cfg(sliding_window=16)
    jp, tp = _layer(cfg, tcfg, seed=5)
    x = np.random.default_rng(6).normal(size=(1, 64, 64)).astype(np.float32)
    padded = tattn.init_attn_cache(tcfg, 1, 64, window=16)
    tattn.attention_forward(tp, tcfg, torch.from_numpy(x), window=16,
                            cache=padded, valid_len=40)
    plain = tattn.init_attn_cache(tcfg, 1, 64, window=16)
    tattn.attention_forward(tp, tcfg, torch.from_numpy(x[:, :40]), window=16,
                            cache=plain)
    for key in ("k", "v", "pos"):
        assert torch.equal(padded[key], plain[key]), key
    assert sorted(padded["pos"][0].tolist()) == list(range(24, 40))
    jc = jattn.init_attn_cache(cfg, 1, 64, window=16)
    _, jc = jattn.attention_forward(jp, cfg, jnp.asarray(x), window=16,
                                    cache=jc)
    assert sorted(np.asarray(jc["pos"])[0].tolist()) == list(range(48, 64))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@torch.no_grad()
def test_windowed_paged_paths_match_jax(kv_dtype):
    """With a 16-token window: a 40-token prefill's wrapped ring scattered
    into pages, two 8-token chunks of chunk attention, then 6 paged decode
    steps; outputs and every page but the trash page equal JAX's."""
    cfg, tcfg = _cfg(sliding_window=16)
    jp, tp = _layer(cfg, tcfg, seed=7)
    ps, num_pages = 8, 12
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 40, 64)).astype(np.float32)
    jrow = jattn.init_attn_cache(cfg, 1, 64, window=16)
    trow = tattn.init_attn_cache(tcfg, 1, 64, window=16)
    _, jrow = jattn.attention_forward(jp, cfg, jnp.asarray(x), window=16,
                                      cache=jrow)
    _, trow = tattn.attention_forward(tp, tcfg, torch.from_numpy(x),
                                      window=16, cache=trow)
    j = jattn.init_paged_attn_cache(cfg, num_pages, ps, kv_dtype=kv_dtype)
    t = tattn.init_paged_attn_cache(tcfg, num_pages, ps, device="cpu",
                                    kv_dtype=kv_dtype)
    pages = np.array([4, 2], np.int32)
    j = jattn.paged_scatter_prefill(j, jrow, jnp.asarray(pages))
    t = tattn.paged_scatter_prefill(t, trow, pages)

    def same_pool():
        for k in t:
            got, want = t[k][1:].numpy(), np.asarray(j[k])[1:]
            if k == "pos":
                assert np.array_equal(got, want), k
            elif t[k].dtype == torch.int8:
                assert np.abs(got.astype(np.int32) - want).max() <= 1, k
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    same_pool()
    # the prompt's ring in logical pages 0-1 (positions 24..39 placed by
    # ring slot), nothing at 2-4, chunks and decode steps from 40 on
    tbl = np.array([[4, 2, -1, -1, -1, 9, 6, 1]], np.int32)
    jt, tt = jnp.asarray(tbl), torch.from_numpy(tbl)
    for p0 in (40, 48):
        xc = rng.normal(size=(1, ps, 64)).astype(np.float32)
        pos = np.array([p0], np.int32)
        jy, j = jattn.chunk_attention_paged(jp, cfg, jnp.asarray(xc), j,
                                            jnp.asarray(pos), jt, window=16)
        ty, t = tattn.chunk_attention_paged(tp, tcfg, torch.from_numpy(xc),
                                            t, torch.from_numpy(pos), tt,
                                            window=16)
        _close(ty, jy, atol=1e-4)
        same_pool()
    for p in range(56, 62):
        xd = rng.normal(size=(1, 1, 64)).astype(np.float32)
        pos = np.array([p], np.int32)
        jy, j = jattn.decode_attention_paged(jp, cfg, jnp.asarray(xd), j,
                                             jnp.asarray(pos), jt, window=16)
        ty, t = tattn.decode_attention_paged(tp, tcfg, torch.from_numpy(xd),
                                             t, torch.from_numpy(pos), tt,
                                             window=16)
        _close(ty, jy, atol=1e-4)
        same_pool()
