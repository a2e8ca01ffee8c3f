"""PyTorch port, slice level: the JAX package's two mixture-of-experts
decoders (olmoe-1b-7b, granite-moe-3b-a800m) at reduced width
(``tests/_moe_parity.py``), with weights carried across from JAX by
``repro_torch.bridge``, in float32 on the CPU.

* The MoE layer: ``moe_forward_local`` (output, and the auxiliary loss)
  at the configs' capacity factor and at a tight one where the test
  counts dropped (token, slot) pairs, and ``moe_forward_decode``, equal
  JAX's within 1e-5.
* The bridge carries every ``moe.*`` leaf, and the router stays float32
  in a bfloat16 model; prefill logits equal JAX's (1e-4).
* Decode after a prefill equals the full forward's last logits at
  capacity factor 8 (no drops), as
  ``tests/test_archs_smoke.py::test_smoke_decode_matches_teacher_forcing``
  holds JAX's model.

The greedy streams of both engines are in
``tests/test_torch_moe_streams_olmoe.py`` and
``tests/test_torch_moe_streams_granite.py``: the files stay small so that
a ``pytest -n 6 --dist loadfile`` run (largest files first) keeps its
queue order ahead of them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _moe_parity import (SHAPES, arch_of, jax_config,  # noqa: E402
                         jax_drops, torch_config)
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402


@pytest.fixture(scope="module", params=list(SHAPES))
def arch(request):
    return arch_of(request.param)


@torch.no_grad()
def test_moe_layer_matches_jax(arch):
    """Layer 0's MoE on random (2, 48, d) inputs: the capacity form at the
    config's factor and at 0.5 (pairs dropped), with its auxiliary loss,
    and the decode form, against JAX within 1e-5."""
    name = arch.tcfg.name.replace("-smoke", "")
    mp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      arch.np_params["segments"][0]["moe"])
    layer = arch.tm.layers[0].moe
    x = np.random.default_rng(2).normal(
        size=(2, 48, arch.tcfg.d_model)).astype(np.float32)
    tx = torch.as_tensor(x)
    drops = {}
    for cf in (arch.tcfg.moe.capacity_factor, 0.5):
        jcfg = jax_config(name, cf)
        want, want_aux = jmoe._moe_forward_local(mp, jcfg, jnp.asarray(x))
        got, aux = tmoe.moe_forward_local(layer, torch_config(jcfg), tx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        assert abs(float(aux) - float(want_aux)) < 1e-5
        drops[cf] = jax_drops(mp, jcfg, jnp.asarray(x))
    assert drops[0.5] > 0
    want = jmoe.moe_forward_decode(mp, jax_config(name), jnp.asarray(x))
    got = tmoe.moe_forward_decode(layer, arch.tcfg, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@torch.no_grad()
def test_bridge_and_prefill_logits_match_jax(arch):
    """Every JAX leaf lands on a parameter of the port's MoE model (the
    router float32 even in a bfloat16 model); prefill logits at every
    position of both prompt lengths equal JAX's."""
    state = params_from_jax(arch.np_params, arch.tcfg)
    names = dict(arch.tm.named_parameters())
    assert sorted(state) == sorted(names)
    assert {n.split(".", 2)[2] for n in names if ".moe." in n} == {
        "moe.router", "moe.w_gate", "moe.w_up", "moe.w_down"}
    bf16 = Model(arch.tcfg, device="cpu", dtype=torch.bfloat16)
    bf16.load_state_dict(state)
    for n, p in bf16.named_parameters():
        assert p.dtype == (torch.float32 if n.endswith("moe.router")
                           else torch.bfloat16), n
    for prompt in arch.prompts[:2]:
        jc = arch.jm.init_cache(1, len(prompt))
        jx, _, _, _ = arch.jm.prefill(arch.params,
                                      {"tokens": prompt[None]}, jc)
        want = np.asarray(arch.jm.logits(arch.params, jx))
        tc = arch.tm.init_cache(1, len(prompt))
        tx, _, _, _ = arch.tm.prefill(
            {"tokens": torch.as_tensor(prompt[None])}, tc)
        np.testing.assert_allclose(arch.tm.logits(tx).numpy(), want,
                                   atol=1e-4, rtol=0)


@torch.no_grad()
def test_decode_matches_teacher_forcing(arch):
    """At capacity factor 8: prefill 11 tokens of two rows, decode the
    12th; its logits equal the full 12-token forward's last ones (2e-4),
    and the full forward's equal JAX's (1e-4)."""
    name = arch.tcfg.name.replace("-smoke", "")
    jcfg = jax_config(name, 8.0)
    jm = jbuild(jcfg)
    tm = Model(torch_config(jcfg), device="cpu")
    tm.load_state_dict(params_from_jax(arch.np_params, tm.cfg))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12))
    jx, _, _, _ = jm.prefill(arch.params, {"tokens": tokens},
                             jm.init_cache(2, 12))
    ref = np.asarray(jm.logits(arch.params, jx))[:, -1]
    tx, _, _, _ = tm.prefill({"tokens": torch.as_tensor(tokens)},
                             tm.init_cache(2, 12))
    full = tm.logits(tx)[:, -1]
    np.testing.assert_allclose(full.numpy(), ref, atol=1e-4, rtol=0)
    caches = tm.init_cache(2, 64)
    tm.prefill({"tokens": torch.as_tensor(tokens[:, :-1])}, caches)
    xh, _, _ = tm.decode_step(torch.as_tensor(tokens[:, -1:]), caches, 11)
    got = tm.logits(xh)[:, 0]
    assert float((got - full).abs().max()) < 2e-4
