"""PyTorch port, the train step against the JAX package on the CPU, on
the same weights and numpy batches: ``forward_train``'s logits and the
fused loss's gradient, one train step with and without microbatches,
the eval step, activation checkpointing (which changes no number), and
the launchers: ``launch.train --ckpt`` then ``launch.serve --ckpt``
(tolerances in ``tests/_train_parity.py``, and where stated).

Configs: ``tiny_ee_cfg`` (GQA 4/2, tied) and an ee-llm-7b-shaped small
config (MHA, untied ``lm_head``, exits (1, 2), V = 500)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_parity import (LOGIT_ATOL, Pair, assert_grads_close,  # noqa: E402
                           assert_losses_close, assert_tree_equal,
                           grads_as_jax, jax_value_and_grad)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.training.train_step import make_eval_step as jmake_eval  # noqa: E402
from repro.training.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models.blocks import block_forward  # noqa: E402
from repro_torch.training import optim  # noqa: E402
from repro_torch.training.loss import multi_exit_loss_fused  # noqa: E402
from repro_torch.training.train_step import (make_eval_step,  # noqa: E402
                                             make_train_step)

EE7B_SMALL = ModelConfig(name="ee-llm-7b-small", arch_type="dense",
                         n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                         head_dim=32, d_ff=344, vocab_size=500,
                         exit_layers=(1, 2)).validate()


@pytest.fixture(params=["tiny-ee", "ee-llm-7b-small"])
def pair(request, tiny_ee_cfg):
    return Pair({"tiny-ee": tiny_ee_cfg,
                 "ee-llm-7b-small": EE7B_SMALL}[request.param])


def test_forward_train_and_gradients_match_jax(pair):
    """Every head's logits and ``forward_train_hiddens``' hidden states,
    then the fused multi-exit loss and its gradient (port autograd
    against ``jax.grad``)."""
    jb, tb = pair.batch(b=2, s=24)
    jout = pair.jm.forward_train(pair.params, jb)
    with torch.no_grad():
        tout = pair.tm.forward_train(tb)
        hid = pair.tm.forward_train_hiddens(tb)
    jhid = pair.jm.forward_train_hiddens(pair.params, jb)
    for got, want in ([tout["logits"], jout["logits"]],
                      [hid["final"], jhid["final"]],
                      *([tout["exit_logits"][l], jout["exit_logits"][l]]
                        for l in pair.jcfg.exit_layers),
                      *([hid["exits"][l], jhid["exits"][l]]
                        for l in pair.jcfg.exit_layers)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    assert float(tout["aux_loss"]) == float(jout["aux_loss"]) == 0.0

    jlosses, jgrads = jax_value_and_grad(pair, jb)
    losses = multi_exit_loss_fused(pair.tm, pair.tm.forward_train_hiddens(
        tb), tb["labels"], tb["mask"])
    losses["loss"].backward()
    assert_losses_close(losses, jlosses)
    assert_grads_close(grads_as_jax(pair.tm), jgrads)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """Two steps of ee-llm-7b-small: the losses, gradient norm and
    learning rate within 2e-5; then the parameters.  Adam's first step
    moves a parameter by about lr * sign(g), so a gradient near zero
    whose sign follows the summation order can move it by up to 2 lr the
    other way: every element within 2 lr, and all but 1% within 1e-6 of
    the leaf's scale."""
    pair = Pair(EE7B_SMALL)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(pair.tm, ocfg, microbatches=microbatches)
    jstep = jax.jit(jmake_step(pair.jm, joptim.AdamWConfig(
        **dataclasses.asdict(ocfg)), microbatches=microbatches))
    state, jparams = optim.init_adamw(pair.tm), pair.params
    jstate = joptim.init_adamw(jparams)
    for seed in (1, 2):
        jb, tb = pair.batch(b=4, s=16, seed=seed)
        state, mets = step(state, tb)
        jparams, jstate, jmets = jstep(jparams, jstate, jb)
        assert_losses_close(mets, jmets)
        assert float(mets["lr"]) == pytest.approx(float(jmets["lr"]),
                                                  rel=1e-6)
    assert all(int(s["step"]) == 2 for s in state.state.values())
    for got, want in zip(jax.tree.leaves(bridge.params_to_jax(pair.tm)),
                         jax.tree.leaves(jparams)):
        diff = np.abs(got - np.asarray(want))
        assert diff.max() <= 2 * ocfg.lr * 1.01
        assert np.mean(diff > 1e-6 * max(np.abs(want).max(), 1.0)) < 0.01


def test_eval_step_and_remat(tiny_ee_cfg):
    """``make_eval_step`` equals the JAX package's on the same batch
    (full logits through ``multi_exit_loss``, equal to the fused loss);
    activation checkpointing changes no number: ``run_segments`` under
    autograd (each block checkpointed) and the same blocks through
    ``block_forward`` directly give the same hidden states and
    gradients, bit for bit."""
    pair = Pair(tiny_ee_cfg)
    jb, tb = pair.batch(b=2, s=32, seed=7)
    got = make_eval_step(pair.tm)(tb)
    want = jmake_eval(pair.jm)(pair.params, jb)
    assert_losses_close(got, want)
    fused = multi_exit_loss_fused(pair.tm, pair.tm.forward_train_hiddens(
        tb), tb["labels"], tb["mask"])
    assert_losses_close(fused, got)

    tm = pair.tm

    def direct(x, ctx):
        for si, seg in enumerate(tm.segments):
            sctx = dataclasses.replace(ctx, window=seg.window)
            for j in range(seg.length):
                x, _, _ = block_forward(tm.block(si, j), tm.cfg, x, sctx)
        return x

    grads, finals = [], []
    for remat in (True, False):
        tm.zero_grad(set_to_none=True)
        x, ctx = tm.embed_inputs(tb)
        if remat:
            x = tm.run_segments(x, ctx, tm.all_segments())[0]
        else:
            x = direct(x, ctx)
        x.square().mean().backward()
        finals.append(x.detach())
        grads.append([p.grad for p in tm.parameters()])
    assert torch.equal(*finals)
    assert sum(g is not None for g in grads[0]) > 10
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(*grads))


def test_train_then_serve_launchers_on_cpu(tmp_path, capsys):
    """``launch.train --smoke --device cpu --ckpt`` writes a JAX-format
    checkpoint (the JAX package's ``load_checkpoint`` reads it into its
    smoke model), and ``launch.serve --ckpt`` serves those weights; the
    trainer also draws whisper's frames."""
    from repro_torch.launch import serve, train
    path = str(tmp_path / "ee")
    model, mets = train.main(["--arch", "ee-llm-7b", "--smoke", "--device",
                              "cpu", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--ckpt", path])
    assert np.isfinite(float(mets["loss"]))
    with open(path + ".json") as f:
        assert json.load(f)["extra"] == {"arch": "ee-llm-7b-smoke",
                                         "steps": 3}
    jcfg = get_smoke_config("ee-llm-7b")
    loaded, _ = jload(path, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    assert_tree_equal(loaded, bridge.params_to_jax(model))
    r = serve.main(["--smoke", "--device", "cpu", "--ckpt", path,
                    "--clients", "2", "--max-new", "4", "--kv-layout",
                    "paged", "--kv-dtype", "int8", "--wire", "int8"])
    out = capsys.readouterr().out
    assert f"loaded checkpoint {path}" in out
    assert "agreement vs cloud" in out and r["stats"].tokens == 8
    _, mets = train.main(["--arch", "whisper-medium", "--smoke", "--device",
                          "cpu", "--steps", "2", "--batch", "2", "--seq",
                          "8"])
    assert np.isfinite(float(mets["loss"]))
