"""PyTorch port, training substrate against the JAX package on the CPU:
the losses (plain and fused), the schedule and the global norm, AdamW on
the same numpy gradients, the weight-decay rule, the synthetic batches,
an 80-step tiny-ee run and the JAX-format checkpoint both ways
(tolerances in ``tests/_train_parity.py``, and where stated)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_parity import LOSS_RTOL, Pair, assert_tree_equal  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.training import loss as jloss  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.training.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.training.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.training import loss, optim  # noqa: E402
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa: E402
                                             save_checkpoint)
from repro_torch.training.train_step import make_train_step  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def test_losses_schedule_and_norm_match_jax():
    """cross_entropy (masked), the multi-exit sum with a trimmed prefix,
    fused_unembed_ce over several chunks against the plain CE (value and
    gradient) and against the JAX package's; the schedule at every step
    and the global norm."""
    rng = np.random.default_rng(0)
    b, s, v, d = 2, 48, 40, 16
    logits = rng.normal(size=(b, s, v)).astype(np.float32) * 3
    labels = rng.integers(0, v, (b, s))
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    jl, jm = jnp.asarray(labels, jnp.int32), jnp.asarray(mask)
    np.testing.assert_allclose(
        float(loss.cross_entropy(_t(logits), _t(labels), _t(mask))),
        float(jloss.cross_entropy(jnp.asarray(logits), jl, jm)),
        rtol=LOSS_RTOL)
    # the JAX package's own cases: masked positions do not count
    z, zl = torch.zeros((1, 4, 8)), torch.zeros((1, 4), dtype=torch.long)
    half = loss.cross_entropy(z, zl, torch.tensor([[1.0, 1.0, 0.0, 0.0]]))
    assert float(half) == pytest.approx(np.log(8), rel=1e-6)

    outs = {"logits": logits, "exit_logits": {2: logits * 0.5, 1: -logits},
            "aux_loss": np.float32(0.25), "prefix_len": 3}
    lab3, m3 = labels[:, 3:], mask[:, 3:]
    jouts = {"logits": jnp.asarray(logits), "prefix_len": 3,
             "exit_logits": {l: jnp.asarray(x)
                             for l, x in outs["exit_logits"].items()},
             "aux_loss": jnp.asarray(outs["aux_loss"])}
    want = jloss.multi_exit_loss(jouts, jnp.asarray(lab3, jnp.int32),
                                 jnp.asarray(m3), exit_weight=0.3)
    got = loss.multi_exit_loss(
        {"logits": _t(logits), "prefix_len": 3, "aux_loss": _t(outs[
            "aux_loss"]), "exit_logits": {l: _t(x) for l, x in outs[
                "exit_logits"].items()}}, _t(lab3), _t(m3), exit_weight=0.3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)

    hid = rng.normal(size=(b, s, d)).astype(np.float32)
    scale = rng.normal(size=d).astype(np.float32) * 0.1
    w = rng.normal(size=(v, d)).astype(np.float32) * 0.3
    ins = [_t(a).requires_grad_() for a in (hid, scale, w)]
    fused = loss.fused_unembed_ce(*ins, _t(labels), _t(mask), chunk=16)
    g_fused = torch.autograd.grad(fused, ins)
    plain = loss.cross_entropy(rms_norm(ins[0], ins[1]) @ ins[2].T,
                               _t(labels), _t(mask))
    g_plain = torch.autograd.grad(plain, ins)
    jf = jloss.fused_unembed_ce(jnp.asarray(hid), jnp.asarray(scale),
                                jnp.asarray(w), jl, jm, chunk=16)
    for want_v in (float(plain.detach()), float(jf)):
        np.testing.assert_allclose(float(fused.detach()), want_v,
                                   rtol=LOSS_RTOL)
    for a, c in zip(g_fused, g_plain):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                   atol=1e-6 * float(c.abs().max()))

    cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    jcfg = joptim.AdamWConfig(**dataclasses.asdict(cfg))
    lrs = [optim.schedule(cfg, st) for st in range(0, 121)]
    np.testing.assert_allclose(
        lrs, [float(joptim.schedule(jcfg, jnp.asarray(st)))
              for st in range(0, 121)], rtol=1e-6, atol=0)
    assert lrs[0] == 0.0 and abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[100] == pytest.approx(1e-4, rel=1e-3)
    tree = [rng.normal(size=sh).astype(np.float32)
            for sh in ((3,), (4, 5), (2, 3, 4))]
    np.testing.assert_allclose(
        float(optim.global_norm(_t(a) for a in tree)),
        float(joptim.global_norm([jnp.asarray(a) for a in tree])),
        rtol=1e-6)
    assert float(optim.global_norm([torch.tensor([3.0]),
                                    torch.tensor([4.0])])) == 5.0


def _stacked(path):
    """A JAX leaf with a leading layer axis (segments, encoder layers)."""
    return path[0].key == "segments" or (path[0].key == "encoder"
                                         and path[1].key == "layers")


def _step_both(pair, cfg, grads, opt, jstate, jparams):
    """One AdamW step of both packages on the same numpy gradients."""
    for leaf, g in zip(bridge.flatten(bridge.jax_layout(pair.tm)), grads):
        ts = leaf if isinstance(leaf, bridge.Stacked) else (leaf,)
        gs = g if isinstance(leaf, bridge.Stacked) else (g,)
        for t, gi in zip(ts, gs):
            t.grad = torch.from_numpy(np.array(gi))
    info = optim.adamw_update(cfg, opt)
    jg = jax.tree.unflatten(jax.tree.structure(jparams),
                            [jnp.asarray(g) for g in grads])
    jparams, jstate, jinfo = jax.jit(joptim.adamw_update, static_argnums=0)(
        joptim.AdamWConfig(**dataclasses.asdict(cfg)), jg, jstate, jparams)
    return info, jstate, jparams, jinfo


def test_adamw_matches_jax_on_the_same_gradients(tiny_ee_cfg):
    """Three steps on the same numpy gradients (the second clipped):
    moments, learning rate and gradient norm, and the parameters: every
    leaf without weight decay; with it, the leaves both packages decay
    and the top-level 1-D ones (the JAX package also decays stacked
    per-layer norms: ``test_jax_adamw_decays_stacked_norms``)."""
    for wd in (0.0, 0.01):
        pair = Pair(tiny_ee_cfg)
        cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                                weight_decay=wd)
        opt = optim.init_adamw(pair.tm)
        jparams = pair.params
        jstate = joptim.init_adamw(jparams)
        rng = np.random.default_rng(3)
        for i in range(3):
            grads = [(rng.normal(size=a.shape) * (50.0 if i == 1 else 0.01)
                      ).astype(np.float32)
                     for a in jax.tree.leaves(pair.np_params)]
            info, jstate, jparams, jinfo = _step_both(
                pair, cfg, grads, opt, jstate, jparams)
            assert float(info["lr"]) == pytest.approx(float(jinfo["lr"]),
                                                      rel=1e-6)
            np.testing.assert_allclose(float(info["grad_norm"]),
                                       float(jinfo["grad_norm"]), rtol=1e-6)
        assert int(jstate.step) == 3
        assert all(int(s["step"]) == 3 for s in opt.state.values())
        layout = bridge.jax_layout(pair.tm)
        for name, theirs in (("exp_avg", jstate.mu),
                             ("exp_avg_sq", jstate.nu)):
            by_param = bridge.map_leaves(layout, lambda leaf: (
                np.stack([opt.state[t][name].numpy() for t in leaf])
                if isinstance(leaf, bridge.Stacked)
                else opt.state[leaf][name].numpy()))
            for a, c in zip(jax.tree.leaves(by_param),
                            jax.tree.leaves(theirs)):
                c = np.asarray(c)
                np.testing.assert_allclose(a, c, rtol=0,
                                           atol=1e-6 * np.abs(c).max(),
                                           err_msg=name)
        got = bridge.params_to_jax(pair.tm)
        paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
        checked = 0
        for (path, want), have in zip(paths, jax.tree.leaves(got)):
            want = np.asarray(want)
            if wd and _stacked(path) and want.ndim < 3:
                continue            # a per-layer vector: JAX decays it

            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=jax.tree_util.keystr(path))
            checked += 1
        assert checked >= (len(paths) if not wd else 10)


def test_jax_adamw_decays_stacked_norms(tiny_ee_cfg):
    """A fault of the JAX package that the port does not copy: its AdamW
    decays a leaf with ``ndim >= 2`` (``repro/training/optim.py``), meant
    for matrices, but a segment's leaves carry a leading layer axis, so a
    per-layer norm gain (tiny-ee's ``ln1_scale``: (L, 128)) decays while
    the unstacked ``final_norm`` and ``exit_norms`` do not.  The port
    decides on each layer's own parameter: on zero gradients it decays
    the matrices alone."""
    pair = Pair(tiny_ee_cfg)
    with torch.no_grad():
        for n, p in pair.tm.named_parameters():
            if p.dim() == 1:
                p.fill_(0.5)               # norm gains away from zero
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_jax(pair.tm))
    cfg = optim.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    zeros = [np.zeros(a.shape, np.float32)
             for a in jax.tree.leaves(jparams)]
    _, _, after, _ = _step_both(pair, cfg, zeros, optim.init_adamw(
        pair.tm), joptim.init_adamw(jparams), jparams)
    ln1 = np.asarray(after["segments"][0]["ln1_scale"])
    assert ln1.shape == (1, tiny_ee_cfg.d_model)
    assert np.all(ln1 < 0.5)                            # JAX: decayed
    np.testing.assert_array_equal(np.asarray(after["final_norm"]), 0.5)
    np.testing.assert_array_equal(np.asarray(after["exit_norms"]["1"]), 0.5)
    assert torch.all(pair.tm.layers[0].ln1_scale == 0.5)  # port: not
    wq = pair.tm.layers[0].attn.wq
    np.testing.assert_allclose(wq.detach().numpy(), np.asarray(
        after["segments"][0]["attn"]["wq"])[0], rtol=1e-6)


def test_synthetic_batches_match_jax():
    """``batches`` and ``sample_tokens`` draw what the JAX package's
    ``SyntheticCorpus`` draws at V = 256 for every corpus kind; the markov
    table is built at the first markov draw, and never for ``copy``."""
    for kind in ("markov", "copy", "mixed"):
        dc = dict(vocab_size=256, seq_len=24, batch_size=3, kind=kind,
                  seed=5)
        mine, theirs = SyntheticCorpus(DataConfig(**dc)), JCorpus(
            JDataConfig(**dc))
        assert mine._table is None
        for a, c in zip(mine.batches(3), theirs.batches(3)):
            assert sorted(a) == sorted(c)
            for k in a:
                assert a[k].dtype == c[k].dtype
                np.testing.assert_array_equal(a[k], c[k])
        np.testing.assert_array_equal(mine.sample_tokens(9),
                                      theirs.sample_tokens(9))
        assert (mine._table is None) == (kind == "copy")
    np.testing.assert_array_equal(mine.table, theirs.table)


def test_tiny_ee_trains_like_jax(tiny_ee_cfg):
    """tiny-ee from the same weights through 80 steps of the markov corpus
    (batch 8 x 64, AdamW lr 1e-3, warmup 10 of 300: the JAX package's
    ``tiny_trained``): step 1's loss and gradient norm within 1e-5, the
    last loss within 1e-2, and the loss falls below 0.85 x the first
    (``test_loss_decreases``' bar)."""
    pair = Pair(tiny_ee_cfg)
    dc = dict(vocab_size=256, seq_len=64, batch_size=8, kind="markov")
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=300)
    step = make_train_step(pair.tm, ocfg)
    jstep = jax.jit(jmake_step(pair.jm, joptim.AdamWConfig(
        **dataclasses.asdict(ocfg))))
    state, jparams = optim.init_adamw(pair.tm), pair.params
    jstate = joptim.init_adamw(jparams)
    mine, theirs = [], []
    for b in SyntheticCorpus(DataConfig(**dc)).batches(80):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb["tokens"] = tb["tokens"].long()
        state, mets = step(state, tb)
        jparams, jstate, jmets = jstep(jparams, jstate,
                                       jax.tree.map(jnp.asarray, b))
        mine.append((float(mets["loss"]), float(mets["grad_norm"])))
        theirs.append((float(jmets["loss"]), float(jmets["grad_norm"])))
    np.testing.assert_allclose(mine[0], theirs[0], rtol=1e-5)
    np.testing.assert_allclose(mine[-1][0], theirs[-1][0], rtol=1e-2)
    assert mine[-1][0] < 0.85 * mine[0][0]


def test_checkpoint_both_ways(tiny_ee_cfg, tmp_path):
    """The port's checkpoint is the JAX package's format: the JAX
    package's ``load_checkpoint`` reads it (treedef and ``extra``
    included) and the port reads the JAX package's, in the model's dtype;
    a checkpoint of another model is refused."""
    pair = Pair(tiny_ee_cfg, seed=4)
    path = str(tmp_path / "port")
    save_checkpoint(path, pair.tm, pair.tcfg, extra={"step": 80})
    loaded, extra = jload(path, pair.params)
    assert extra == {"step": 80}
    assert_tree_equal(loaded, pair.np_params)
    with open(path + ".json") as f:
        import json
        manifest = json.load(f)
    assert manifest["treedef"] == str(jax.tree.structure(pair.params))
    assert manifest["n_leaves"] == len(jax.tree.leaves(pair.params))

    jpath = str(tmp_path / "jax")
    jsave(jpath, pair.params, extra={"arch": "tiny-ee"})
    fresh = Model(pair.tcfg, device="cpu")
    assert load_checkpoint(jpath, fresh) == {"arch": "tiny-ee"}
    assert_tree_equal(bridge.params_to_jax(fresh), pair.np_params)
    half = Model(pair.tcfg, device="cpu", dtype=torch.bfloat16)
    load_checkpoint(jpath, half, pair.tcfg)
    assert half.embed.dtype == torch.bfloat16
    assert torch.equal(half.embed, _t(pair.np_params["embed"]).bfloat16())

    other = Model(dataclasses.replace(pair.tcfg, exit_layers=(2,)),
                  device="cpu")
    with pytest.raises(ValueError, match="pytree"):
        load_checkpoint(path, other)
