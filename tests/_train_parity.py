"""Shared parts of the training parity tests (``tests/test_torch_train*.py``
and ``tests/test_torch_training.py``): a JAX model and the port's on the
same weights (through ``repro_torch.bridge.params_from_jax``), numpy
batches, the JAX package's loss and gradient, and the comparisons.

Tolerances (float32 on the CPU): losses and gradient norms 2e-5 relative;
logits 1e-4 absolute; a gradient leaf 1e-4 of that leaf's largest |g|
plus 1e-8 (a gradient's rounding follows its summation order, so it is
held relative to the leaf's scale; whisper's key biases have a gradient
of zero up to rounding); the optimizer's moments and parameters 1e-6
relative to the leaf's largest value.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.training.loss import multi_exit_loss_fused as jloss_fused  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoEConfig  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSMConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

LOSS_RTOL = 2e-5
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-8


def torch_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = TMoEConfig(**fields["moe"])
    if fields["ssm"] is not None:
        fields["ssm"] = TSSMConfig(**fields["ssm"])
    return TModelConfig(**fields)


class Pair:
    """A JAX model and params and the port's model on the same weights."""

    def __init__(self, jcfg, seed=0):
        self.jcfg = jcfg
        self.jm = jbuild(jcfg)
        self.params = self.jm.init(jax.random.PRNGKey(seed))
        self.np_params = jax.tree.map(np.asarray, self.params)
        self.tcfg = torch_config(jcfg)
        self.tm = Model(self.tcfg, device="cpu")
        self.tm.load_state_dict(params_from_jax(self.np_params, self.tcfg))

    def batch(self, b=2, s=16, seed=1):
        """(JAX batch, port batch) of the same numpy draws."""
        cfg = self.jcfg
        rng = np.random.default_rng(seed)
        nb = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
              "labels": rng.integers(0, cfg.vocab_size, (b, s)),
              "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
        if cfg.is_encdec:
            nb["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                            * 0.1).astype(np.float32)
        if cfg.vision_tokens:
            nb["patches"] = (rng.normal(size=(b, cfg.vision_tokens,
                                              cfg.d_model))
                             * 0.1).astype(np.float32)
        jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                             else v) for k, v in nb.items()}
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        return jb, tb


def smoke_pair(arch):
    return Pair(get_smoke_config(arch))


def jax_value_and_grad(pair, jb, exit_weight=0.3):
    """The JAX package's fused multi-exit loss and its gradient (the
    loss function of its ``make_train_step``), jitted."""
    jm = pair.jm

    def loss_fn(params, batch):
        hiddens = jm.forward_train_hiddens(params, batch)
        losses = jloss_fused(jm, params, hiddens, batch["labels"],
                             batch["mask"], exit_weight=exit_weight)
        return losses["loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        pair.params, jb)
    return losses, grads


def grads_as_jax(model):
    """The port's ``.grad`` in the JAX pytree's layout (numpy)."""
    def grad(leaf):
        ts = leaf if isinstance(leaf, bridge.Stacked) else (leaf,)
        gs = [t.grad.numpy() for t in ts]
        return np.stack(gs) if isinstance(leaf, bridge.Stacked) else gs[0]
    return bridge.map_leaves(bridge.jax_layout(model), grad)


def assert_losses_close(got, want, rtol=LOSS_RTOL):
    assert set(got) >= set(want) - {"lr"}, (sorted(got), sorted(want))
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(w),
                                   rtol=rtol,
                                   atol=1e-7, err_msg=k)


def assert_grads_close(got_tree, want_tree, rtol=GRAD_RTOL):
    """Each gradient leaf within ``rtol`` of the leaf's largest |g|."""
    got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rtol * scale + GRAD_ATOL, (jax.tree_util.keystr(path),
                                                 err, scale)


def assert_tree_equal(got, want):
    assert str(jax.tree.structure(got)) == str(jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def check_family(arch, tmp_path):
    """One reduced family against the JAX package: the pytree's structure
    and the bridge both ways, ``forward_train``'s logits, exit logits and
    aux loss, the fused loss and its gradient, one train step's metrics,
    and the JAX-format checkpoint written by each package read by the
    other."""
    from repro.training.checkpoint import load_checkpoint as jload
    from repro.training.checkpoint import save_checkpoint as jsave
    from repro.training.optim import AdamWConfig as JAdamWConfig
    from repro.training.optim import adamw_update as jadamw_update
    from repro.training.optim import init_adamw as jinit_adamw
    from repro_torch.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.loss import multi_exit_loss_fused
    from repro_torch.training.optim import AdamWConfig, init_adamw
    from repro_torch.training.train_step import make_train_step

    pair = smoke_pair(arch)
    tm = pair.tm
    # the pytree, character for character, and the bridge both ways
    assert bridge.treedef_str(bridge.jax_layout(tm)) == str(
        jax.tree.structure(pair.params))
    assert_tree_equal(bridge.params_to_jax(tm, pair.tcfg), pair.np_params)

    jb, tb = pair.batch()
    jout = jax.jit(pair.jm.forward_train)(pair.params, jb)
    with torch.no_grad():
        tout = tm.forward_train(tb)
    assert tout["prefix_len"] == jout["prefix_len"]
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), atol=LOGIT_ATOL,
                               rtol=0)
    assert sorted(tout["exit_logits"]) == sorted(jout["exit_logits"])
    for l, xl in jout["exit_logits"].items():
        np.testing.assert_allclose(tout["exit_logits"][l].numpy(),
                                   np.asarray(xl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(tout["aux_loss"]),
                               float(jout["aux_loss"]), rtol=LOSS_RTOL,
                               atol=1e-9)
    if pair.jcfg.moe:
        assert float(tout["aux_loss"]) > 0

    jlosses, jgrads = jax_value_and_grad(pair, jb)
    tm.zero_grad(set_to_none=True)
    losses = multi_exit_loss_fused(tm, tm.forward_train_hiddens(tb),
                                   tb["labels"], tb["mask"])
    losses["loss"].backward()
    assert_losses_close(losses, jlosses)
    assert_grads_close(grads_as_jax(tm), jgrads)

    # one step: JAX's train_step is this gradient through adamw_update
    jcfg_opt = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    _, _, jinfo = jax.jit(jadamw_update, static_argnums=0)(
        jcfg_opt, jgrads, jinit_adamw(pair.params), pair.params)
    step = make_train_step(tm, AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=10))
    _, mets = step(init_adamw(tm), tb)
    assert_losses_close(mets, {**jlosses, **jinfo})
    assert float(mets["lr"]) == float(jinfo["lr"])

    # the port's checkpoint read by the JAX package, and the other way
    path = str(tmp_path / f"{arch}-port")
    save_checkpoint(path, tm, pair.tcfg, extra={"step": 1})
    loaded, extra = jload(path, pair.params)
    assert extra == {"step": 1}
    assert_tree_equal(loaded, bridge.params_to_jax(tm))
    path = str(tmp_path / f"{arch}-jax")
    jsave(path, pair.params, extra={"arch": arch})
    fresh = Model(pair.tcfg, device="cpu")
    assert load_checkpoint(path, fresh, pair.tcfg) == {"arch": arch}
    assert_tree_equal(bridge.params_to_jax(fresh), pair.np_params)
