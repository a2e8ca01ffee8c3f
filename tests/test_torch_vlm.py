"""PyTorch port, slice level: the vision-prefix paligemma-3b at reduced
width (4 layers with exits (1, 2), 16 patches, 4 heads over 1 KV head;
``tests/_encdec_parity.py``) with weights carried across from JAX by
``repro_torch.bridge``, in float32 on the CPU.

* The patches through ``vis_proj`` and the prefix-LM mask, in the direct
  and the chunked attention (JAX's ``_chunked_attention`` called
  directly), equal JAX's.
* Prefill logits and a decode step from position P + S - 1 equal JAX's
  ``forward_train`` (the teacher-forcing gate of
  ``tests/test_archs_smoke.py``, 2e-4).
* The JAX package's ``CoLLM.cloud_prefill`` leaves the prefix mask out,
  so its split prefill is off the undivided model; the port's is not.
* Greedy streams of 16 tokens in the cloud, split-θ float16, θ=0 int8
  and standalone modes equal JAX's, exits, requests and bytes included;
  JAX's cloud caches there come from its undivided ``Model.prefill``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _encdec_parity import MAX_SEQ, arch_of, stream_test  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

NAME = "paligemma-3b"
TOL = 1e-4


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _jax_masks(q, k, v, prefix):
    """JAX's direct and chunked attention under the prefix-LM mask."""
    pos = jnp.arange(q.shape[1])
    kw = dict(causal=True, window=0, prefix_len=prefix, scale=0.125)
    return (jattn._direct_attention(q, k, v, pos, pos, **kw),
            jattn._chunked_attention(q, k, v, pos, pos, q_chunk=16,
                                     kv_chunk=16, **kw))


@torch.no_grad()
def test_patches_and_prefix_mask_match_jax():
    """``embed_inputs`` with patches (``vis_proj``, then the tokens), and
    the prefix-LM mask over 16 and 24 of 64 positions in the direct and
    the chunked attention (16-position chunks: whole chunks and one cut
    by the boundary)."""
    a = arch_of(NAME)
    tb = {k: torch.as_tensor(v) for k, v in a.batch.items()}
    x, ctx = a.tm.embed_inputs(tb)
    jx = jax.jit(lambda p, b: a.jm.embed_inputs(p, b)[0])(
        a.params, {k: jnp.asarray(v) for k, v in a.batch.items()})
    _close(x, jx, atol=1e-6)
    assert ctx.prefix_len == a.jcfg.vision_tokens == 16
    assert torch.equal(ctx.positions, torch.arange(x.shape[1]))
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 64, h, 64)).astype(np.float32)
               for h in (4, 1, 1))
    for prefix in (16, 24):
        want = jax.jit(_jax_masks, static_argnums=3)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), prefix)
        tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
        pos = torch.arange(64)
        kw = dict(causal=True, window=0, prefix_len=prefix, scale=0.125)
        _close(tattn._direct_attention(tq, tk, tv, pos, pos, **kw), want[0],
               atol=2e-5)
        for tile in (tattn._TILE_ELEMS, 2 * 4 * 16 * 16):
            _close(tattn._chunked_attention(tq, tk, tv, pos, pos,
                                            q_chunk=16, kv_chunk=16,
                                            tile=tile, **kw),
                   want[1], atol=2e-5)
        # the mask matters: a causal pass differs inside the prefix
        causal = tattn._direct_attention(tq, tk, tv, pos, pos,
                                         **dict(kw, prefix_len=0))
        assert float((causal - torch.tensor(np.asarray(want[0]))
                      ).abs()[:, :prefix].max()) > 1e-2


@torch.no_grad()
def test_decode_matches_teacher_forcing():
    """Prefill logits at every position (patches first) equal JAX's
    ``forward_train``; so does one decode step at position P + S - 1
    after a prefill of all but the last token (two rows, their own
    patches)."""
    a = arch_of(NAME)
    batch = a.inputs(np.random.default_rng(7), 2, 12)
    want = np.asarray(jax.jit(a.jm.forward_train)(
        a.params, {k: jnp.asarray(v) for k, v in batch.items()})["logits"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    caches = a.tm.init_cache(2, 40)
    x, _, _, _ = a.tm.prefill(tb, caches)
    assert x.shape[1] == 16 + 12
    _close(a.tm.logits(x), want)
    caches = a.tm.init_cache(2, 40)
    a.tm.prefill(dict(tb, tokens=tb["tokens"][:, :-1]), caches)
    xh, _, _ = a.tm.decode_step(tb["tokens"][:, -1:], caches, 16 + 11)
    assert float((a.tm.logits(xh)[:, 0] - torch.tensor(
        want[:, -1])).abs().max()) < 2e-4


@torch.no_grad()
def test_jax_cloud_prefill_drops_the_prefix_mask():
    """JAX's ``CoLLM.cloud_prefill`` builds its context without
    ``prefix_len``: its cloud layers attend causally over the patches, so
    the last position's logits leave its undivided model's by far more
    than rounding.  The port's cloud prefill keeps the mask: its logits
    and its cloud caches equal JAX's undivided model's, and its edge's
    decisions and upload equal JAX's edge's."""
    a = arch_of(NAME)
    f = a.jax_fns("float16")            # CollmConfig's default wire
    jcollm, p, n = f["collm"], a.params, MAX_SEQ
    jb = {k: jnp.asarray(v) for k, v in a.batch.items()}
    jdec, jh1, _ = f["edge_prefill"](p, jb, jcollm.init_edge_cache(1, n))
    jlogits, _ = f["cloud_prefill"](p, jh1, jcollm.init_cloud_cache(1, n))
    x, _, full = f["prefill"](p, jb, a.jm.init_cache(1, n))
    want = np.asarray(f["logits"](p, x[:, -1:]))
    assert float(np.abs(np.asarray(jlogits) - want).max()) > 1e-2

    collm = CoLLM(a.tm, CollmConfig())
    tb = {k: torch.as_tensor(v) for k, v in a.batch.items()}
    dec, h1, _ = collm.edge_prefill(tb, collm.init_edge_cache(1, n))
    _close(h1, jh1)
    for l, d in dec.items():
        assert int(d.token[0]) == int(jdec[l].token[0])
        _close(d.confidence, jdec[l].confidence, atol=1e-6)
    logits, caches = collm.cloud_prefill(h1, collm.init_cloud_cache(1, n))
    _close(logits, want)
    for si, layers in caches.items():
        for j, c in enumerate(layers):
            for key in ("k", "v", "pos"):
                _close(c["self"][key], full[si]["self"][key][j])


test_streams_match_jax = stream_test(NAME)
