"""PyTorch port, slice level: the two-tier runtime (``repro_torch.core.
disagg``) on the CPU against the JAX package's ``TwoTierRuntime``, on the
briefly trained tiny model (``tiny_trained``, weights carried across by
``repro_torch.bridge``).

The scenarios of ``tests/test_disagg.py``: at θ = 1.1 (nothing exits)
with a float32 wire the stream equals the full-model greedy stream, and
with float16 the JAX runtime's stream; at θ = 0.5 with float16 every
generated step uploads its packet (11 * d * 2 bytes after the prompt).
Also an int8 wire, and the prompt upload streamed in slices
(``upload_chunk``): the same streams as JAX's, and the same wire bytes,
per slice, as JAX bills them.  The same scenarios with the tiers as two
partition models: ``tests/test_torch_disagg_tiers.py``; ``lower_tiers``:
``tests/test_torch_lower_tiers.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.disagg import TwoTierRuntime as JTwoTierRuntime  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.disagg import (DeviceTransferChannel,  # noqa: E402
                                     TwoTierRuntime)
from repro_torch.models.transformer import Model  # noqa: E402


@pytest.fixture(scope="module")
def tiers(tiny_trained):
    jm, params = tiny_trained["model"], tiny_trained["params"]
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg))
    prompt = tiny_trained["data"].sample_tokens(10)
    return jm, params, tm, prompt, make_debug_mesh(1), {}


def _runs(tiers, theta, wire, max_new, chunk=0):
    """(JAX's stream and info, the port's), each computed once."""
    jm, params, tm, prompt, mesh, memo = tiers
    key = (theta, wire, max_new, chunk)
    if key not in memo:
        jrt = JTwoTierRuntime(jm, JCollmConfig(theta=theta,
                                               wire_format=wire), mesh, mesh)
        jrt.build(params, params)
        want = jrt.decode(jnp.asarray(prompt[None, :]), max_new, max_seq=64,
                          upload_chunk=chunk)
        rt = TwoTierRuntime(tm, CollmConfig(theta=theta, wire_format=wire),
                            "cpu", "cpu")
        rt.build()
        got = rt.decode(prompt, max_new, max_seq=64, upload_chunk=chunk)
        memo[key] = (want, got)
    return memo[key]


@pytest.mark.parametrize("wire", ["float32", "float16"])
def test_two_tier_decode_matches_jax_and_full_model(tiers, wire):
    (jtoks, jinfo), (toks, info) = _runs(tiers, 1.1, wire, 10)
    assert toks == jtoks
    assert info["wire_bytes"] == jinfo["wire_bytes"] > 0
    assert info["channel"] == jinfo["channel"]
    # the full-model greedy reference, as tests/test_disagg.py builds it
    _, _, tm, prompt, _, _ = tiers
    co = CoLLM(tm, CollmConfig())
    caches = tm.init_cache(1, 64)
    with torch.no_grad():
        x, _, caches, _ = tm.prefill(
            {"tokens": torch.as_tensor(prompt[None, :])}, caches)
        tok = tm.logits(x[:, -1:])[:, 0].argmax(-1)
        ref = [int(tok[0])]
        for t in range(9):
            tok, _, caches = co.full_step(tok[:, None], caches, 10 + t)
            ref.append(int(tok[0]))
    if wire == "float32":
        assert toks == ref                       # exact at theta>1 + fp32


@pytest.mark.parametrize("wire,chunk", [("float16", 0), ("float16", 4),
                                        ("int8", 0), ("int8", 4)])
def test_two_tier_adaptive_matches_jax(tiers, wire, chunk):
    """θ = 0.5: exits skip the cloud step but still upload; the wire bytes
    after the prompt are one packet per generated step.  A streamed
    prompt upload bills the same per-slice bytes as JAX (int8 slices
    carry their own scales)."""
    (jtoks, jinfo), (toks, info) = _runs(tiers, 0.5, wire, 12, chunk)
    d = tiers[2].cfg.d_model
    assert len(toks) == 12 and toks == jtoks
    assert info["wire_bytes"] == jinfo["wire_bytes"]
    assert info["channel"] == jinfo["channel"]
    per_token = d * 2 if wire == "float16" else d + 4
    assert info["wire_bytes"] == 11 * per_token
    assert len(info["tick_s"]) == 11


def test_channel_bills_each_packet():
    """``submit_packet`` bills the request's bytes and hands the cloud
    step's reply back through ``poll``; on the CPU a transfer is a copy."""
    calls = []

    def cloud(pkt, caches, pos):
        calls.append(pos)
        return pkt["data"].sum(-1), caches

    chan = DeviceTransferChannel(cloud, "cpu")
    pkt = {"data": torch.ones((1, 1, 8), dtype=torch.float16)}
    moved = chan.put(pkt)
    assert moved["data"] is not pkt["data"]
    h = chan.submit_packet(pkt, 7)
    (rep,) = chan.poll()
    assert rep.handle == h and calls == [7] and float(rep.reply) == 8.0
    assert chan.stats.bytes_up == 16 and chan.stats.requests == 1
