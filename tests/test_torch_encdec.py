"""PyTorch port, slice level: the encoder-decoder whisper-medium at reduced
width (4 decoder layers with exits (1, 2), 2 encoder layers, 64 frames;
``tests/_encdec_parity.py``) with weights carried across from JAX by
``repro_torch.bridge``, in float32 on the CPU.

* Layer norms, sinusoidal positions (an int, a scalar offset, per-row
  offsets), the encoder, cross-attention in prefill, the cross cache and
  cross decode through the plain ``decode_attn`` at B = 1 and 3 equal
  JAX's.
* Prefill logits and a decode step equal JAX's ``forward_train`` (the
  teacher-forcing gate of ``tests/test_archs_smoke.py``, 2e-4).
* ``edge_prefill`` + ``cloud_prefill`` with the encoder's output equal
  JAX's, and the cross entries are left alone by every cache walk.
* Greedy streams of 16 tokens in the cloud, split-θ float16, θ=0 int8
  and standalone modes equal JAX's, exits, requests and bytes included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _encdec_parity import MAX_SEQ, arch_of, stream_test  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

NAME = "whisper-medium"
TOL = 1e-4


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _jax_ops(p, cfg, jm, x, toks, offs, frames, h, encs, hxs):
    """The JAX side of the op-level comparison, traced once."""
    cross = {k: v[0] for k, v in p["segments"][0]["cross"].items()}
    seg = p["segments"][0]
    enc = jm.encode(p, frames)
    out = dict(
        ln=jcommon.layer_norm(x, seg["ln1_scale"][0], seg["ln1_bias"][0]),
        sin=jcommon.sinusoidal_positions(40, cfg.d_model),
        sin_rows=jcommon.sinusoidal_positions(offs, cfg.d_model),
        embed=[jm.embed_tokens(p, toks, off) for off in (0, 9, offs)],
        enc=enc,
        xattn=jattn.attention_forward(cross, cfg, h, enc_out=enc,
                                      causal=False, use_rope=False)[0],
        caches=[], decodes=[])
    for e, hx in zip(encs, hxs):
        c = jattn.build_cross_cache(cross, cfg, e)
        out["caches"].append(c)
        out["decodes"].append(jattn.decode_attention(
            cross, cfg, hx, c, jnp.asarray(7), cross=True,
            use_rope=False)[0])
    return out


@torch.no_grad()
def test_norms_positions_encoder_and_cross_attention_match_jax():
    a = arch_of(NAME)
    cfg, tm = a.jcfg, a.tm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, cfg.d_model)).astype(np.float32) * 2 + 0.5
    offs = np.array([0, 5, 31], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (3, 4))
    h = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32)
    encs = [rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) for b in (1, 3)]
    hxs = [rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
           for b in (1, 3)]
    frames = a.batch["frames"]
    want = jax.jit(_jax_ops, static_argnums=(1, 2))(
        a.params, cfg, a.jm, x, toks, offs, frames, h, encs, hxs)

    block = tm.layers[0]
    _close(tcommon.layer_norm(torch.from_numpy(x), block.ln1_scale,
                              block.ln1_bias), want["ln"], atol=1e-5)
    _close(tcommon.sinusoidal_positions(40, cfg.d_model), want["sin"],
           atol=1e-5)
    _close(tcommon.sinusoidal_positions(torch.from_numpy(offs), cfg.d_model),
           want["sin_rows"], atol=1e-5)
    for off, w in zip((0, 9, offs), want["embed"]):
        _close(tm.embed_tokens(torch.as_tensor(toks),
                               pos_offset=torch.as_tensor(off)), w,
               atol=1e-5)
    enc = tm.encode(torch.from_numpy(frames))
    _close(enc, want["enc"])
    # layer 0's cross-attention: prefill over the encoder's output, the
    # cross cache, and cross decode through the plain ring kernel
    got, _ = tattn.attention_forward(block.cross, a.tcfg,
                                     torch.from_numpy(h), enc_out=enc,
                                     causal=False, use_rope=False)
    _close(got, want["xattn"])
    for e, hx, jc, jy in zip(encs, hxs, want["caches"], want["decodes"]):
        b = e.shape[0]
        cache = tattn.init_attn_cache(a.tcfg, b, cfg.encoder_seq,
                                      kv_len=cfg.encoder_seq)
        tattn.build_cross_cache(block.cross, a.tcfg, torch.from_numpy(e),
                                cache)
        for key in ("k", "v"):
            _close(cache[key], jc[key])
        assert np.array_equal(cache["pos"].numpy(), np.asarray(jc["pos"]))
        cur = torch.full((b,), cfg.encoder_seq - 1, dtype=torch.int32)
        before = {k: v.clone() for k, v in cache.items()}
        got = tattn.cross_decode_attention(block.cross, a.tcfg,
                                           torch.from_numpy(hx), cache, cur)
        _close(got, jy)
        assert all(torch.equal(before[k], cache[k]) for k in cache)


@torch.no_grad()
def test_decode_matches_teacher_forcing():
    """Prefill logits at every position equal JAX's ``forward_train``; so
    does one decode step after a prefill of all but the last token (two
    rows, their own frames)."""
    a = arch_of(NAME)
    batch = a.inputs(np.random.default_rng(7), 2, 12)
    want = np.asarray(jax.jit(a.jm.forward_train)(
        a.params, {k: jnp.asarray(v) for k, v in batch.items()})["logits"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    caches = a.tm.init_cache(2, 32)
    x, _, _, _ = a.tm.prefill(tb, caches)
    _close(a.tm.logits(x), want)
    caches = a.tm.init_cache(2, 32)
    a.tm.prefill(dict(tb, tokens=tb["tokens"][:, :-1]), caches)
    xh, _, _ = a.tm.decode_step(tb["tokens"][:, -1:], caches, 11)
    assert float((a.tm.logits(xh)[:, 0] - torch.tensor(
        want[:, -1])).abs().max()) < 2e-4


@torch.no_grad()
def test_split_prefill_matches_jax():
    """``edge_prefill`` + ``cloud_prefill`` with the encoder's output:
    the exit decisions, the l_ee1 upload, the cloud's logits and its
    cross caches equal JAX's (and its logits the undivided model's).  The
    cross entries stay as they are under ``invalidate_cache_after``,
    ``invalidate_rows_after`` and ``reset_state``, and the paged layout
    keeps them dense per row."""
    a = arch_of(NAME)
    tb = {k: torch.as_tensor(v) for k, v in a.batch.items()}
    jb = {k: jnp.asarray(v) for k, v in a.batch.items()}
    collm = CoLLM(a.tm, CollmConfig())
    f = a.jax_fns("float16")            # CollmConfig's default wire
    jcollm, n = f["collm"], MAX_SEQ
    dec, h1, _ = collm.edge_prefill(tb, collm.init_edge_cache(1, n))
    jdec, jh1, _ = f["edge_prefill"](a.params, jb,
                                     jcollm.init_edge_cache(1, n))
    _close(h1, jh1)
    for l, d in dec.items():
        assert int(d.token[0]) == int(jdec[l].token[0])
        _close(d.confidence, jdec[l].confidence, atol=1e-6)
    logits, caches = collm.cloud_prefill(h1, collm.init_cloud_cache(1, n),
                                         enc_out=a.tm.encode(tb["frames"]))
    jlogits, jcaches = f["cloud_prefill"](
        a.params, jh1, jcollm.init_cloud_cache(1, n),
        enc_out=f["encode"](a.params, jb["frames"]))
    _close(logits, jlogits)
    x, _, _ = f["prefill"](a.params, jb, a.jm.init_cache(1, n))
    _close(logits, f["logits"](a.params, x[:, -1:]))
    for si, layers in caches.items():
        for j, c in enumerate(layers):
            for key in ("k", "v"):
                _close(c["cross"][key], jcaches[si]["cross"][key][j])
    cross = [{k: v.clone() for k, v in c["cross"].items()}
             for layers in caches.values() for c in layers]
    a.tm.invalidate_cache_after(caches, 3)
    collm.invalidate_rows_after(caches, torch.tensor([2]))
    a.tm.reset_state(caches)
    for before, c in zip(cross, [c for layers in caches.values()
                                 for c in layers]):
        assert all(torch.equal(before[k], c["cross"][k]) for k in before)
        assert int(c["self"]["pos"].max()) == 1
    paged = collm.init_cloud_cache_paged(2, 8, 16)
    c = next(iter(paged.values()))[0]
    assert "kp" in c["self"]
    assert c["cross"]["k"].shape == (2, a.jcfg.encoder_seq,
                                     a.jcfg.n_kv_heads, 64)


test_streams_match_jax = stream_test(NAME)
