"""Shared parts of the encoder-decoder and vision-prefix parity tests
(``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``): the
reduced whisper-medium and paligemma-3b configurations, one ``Arch`` per
configuration (the JAX model and params, the port's model on the same
weights through ``repro_torch.bridge``, a prompt with its frames or
patches, a split θ, JAX runs computed once per process) and greedy
streams composed from each package's ``Model`` and ``CoLLM`` calls, since
neither package's engines take frames or patches.

Both configurations keep 4 decoder layers with exits (1, 2) (``reduced``:
d_model 256, 4 heads of d = 64); whisper keeps 2 encoder layers over 64
frames, paligemma 16 patches in front of its tokens (G = 4: 4 heads over
its 1 KV head).  The biases, layer-norm gains and biases are drawn at
random, so the bridge carries them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.exits import \
    first_confident_exit as jfirst_confident_exit  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from _cloud_tp_family_ranks import compose_stream  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

MAX_NEW = 16
PROMPT_LEN = 12
MAX_SEQ = 16 + PROMPT_LEN + MAX_NEW + 8     # every cache: the patches fit
# name: (θ, wire) of each collm mode; "split" is the Arch's split θ
MODES = {"cloud": None, "collm-float16": ("split", "float16"),
         "collm-int8": (0.0, "int8"), "standalone": ("split", "float16")}


def jax_config(name, vocab=None):
    cfg = jreduced(jget_config(name), n_layers=4)
    return dataclasses.replace(
        cfg, exit_layers=(1, 2), encoder_layers=min(2, cfg.encoder_layers),
        vocab_size=vocab or cfg.vocab_size).validate()


def _randomize(tree, rng):
    """Biases and norm leaves drawn at random (gains around 1), so that
    each of them matters in the comparison."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize(val, rng)
        elif key in ("bq", "bk", "bv", "b1", "b2") or key.endswith("bias"):
            out[key] = (rng.normal(size=val.shape) * 0.1).astype(val.dtype)
        elif key.endswith("scale") and val.ndim and np.all(val == 1):
            out[key] = (1 + rng.normal(size=val.shape) * 0.1).astype(
                val.dtype)
        else:
            out[key] = val
    return out


class Arch:
    """One architecture: JAX model and params, the port's model on the
    same weights, a prompt with its frames or patches, the split θ, and
    JAX runs computed once."""

    def __init__(self, name, vocab=None):
        self.jcfg = jax_config(name, vocab)
        self.jm = jbuild(self.jcfg)
        rng = np.random.default_rng(1)
        self.np_params = _randomize(
            jax.tree.map(np.asarray, self.jm.init(jax.random.PRNGKey(0))),
            rng)
        self.params = jax.tree.map(jnp.asarray, self.np_params)
        self.tcfg = TModelConfig(**dataclasses.asdict(self.jcfg))
        self.tm = Model(self.tcfg, device="cpu")
        self.tm.load_state_dict(params_from_jax(self.np_params, self.tcfg))
        self.batch = self.inputs(rng, 1, PROMPT_LEN)
        self._jax = {}
        self._runs = {}
        # between the middle larger-exit confidences of a θ = 1 run: about
        # half the ticks go to the cloud, the others exit at l_ee1 or l_ee2
        full = port_stream(self, "collm-float32", theta=1.0, wire="float32")
        c = sorted(max(c12) for c12 in full["confs"])
        self.theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2

    def inputs(self, rng, b, s):
        """Numpy batch: tokens (b, s) and frames or patches (x 0.1)."""
        cfg = self.jcfg
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
        if cfg.is_encdec:
            batch["frames"] = (rng.normal(
                size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(
                np.float32)
        if cfg.vision_tokens:
            batch["patches"] = (rng.normal(
                size=(b, cfg.vision_tokens, cfg.d_model)) * 0.1).astype(
                np.float32)
        return batch

    def jax_fns(self, wire):
        """Jitted JAX calls of a CoLLM with ``wire`` (θ is applied on the
        host, so one trace serves every θ)."""
        if wire not in self._jax:
            collm = JCoLLM(self.jm, JCollmConfig(wire_format=wire))
            m = self.jm
            self._jax[wire] = dict(
                collm=collm,
                prefill=jax.jit(lambda p, b, c: m.prefill(p, b, c)[:3]),
                logits=jax.jit(m.logits),
                encode=jax.jit(m.encode),
                edge_prefill=jax.jit(collm.edge_prefill),
                cloud_prefill=jax.jit(collm.cloud_prefill),
                edge_step=jax.jit(collm.edge_step),
                cloud_step=jax.jit(collm.cloud_step),
                full_step=jax.jit(collm.full_step))
        return self._jax[wire]

    def jax_run(self, mode):
        if mode not in self._runs:
            self._runs[mode] = jax_stream(self, mode)
        return self._runs[mode]


_ARCHS = {}


def arch_of(name) -> Arch:
    if name not in _ARCHS:
        _ARCHS[name] = Arch(name)
    return _ARCHS[name]


def _mode(arch, mode):
    theta, wire = MODES[mode] or (1.0, "float32")
    return (arch.theta if theta == "split" else theta), wire


def _stats():
    return dict(tokens=[], exits_l1=0, exits_l2=0, cloud_requests=0,
                upload_bytes=0, enc_bytes=0, confs=[])


def _tick(st, decisions, l_ee1, l_ee2, theta, exited):
    """Count one edge tick: its (l_ee1, l_ee2) confidences and its exit."""
    c12 = tuple(float(decisions[l].confidence[0]) for l in (l_ee1, l_ee2))
    st["confs"].append(c12)
    if exited:
        st["exits_l1" if c12[0] >= theta else "exits_l2"] += 1


def port_stream(arch, mode, theta=None, wire=None):
    """One greedy stream of ``MAX_NEW`` tokens of ``arch.batch`` through
    the port's calls (``_cloud_tp_family_ranks.compose_stream``): the
    tokens, exits, cloud requests, upload and ``enc_out`` bytes, and each
    edge tick's exit confidences."""
    if theta is None:
        theta, wire = _mode(arch, mode)
    return compose_stream(arch.tm, arch.batch, mode, theta, wire, MAX_NEW,
                          MAX_SEQ)


def jax_stream(arch, mode):
    """``port_stream`` through the JAX package's calls (jitted).  For a
    vision prefix the cloud's caches and first logits come from JAX's
    undivided ``Model.prefill`` (the cloud segments' entries): JAX's
    ``cloud_prefill`` drops the prefix-LM mask
    (``test_jax_cloud_prefill_drops_the_prefix_mask``)."""
    theta, wire = _mode(arch, mode)
    f = arch.jax_fns(wire)
    collm, m, p, cfg = f["collm"], arch.jm, arch.params, arch.jcfg
    batch = {k: jnp.asarray(v) for k, v in arch.batch.items()}
    max_seq = MAX_SEQ
    st = _stats()

    def i32(x):
        return jnp.asarray(x, jnp.int32)

    if mode == "cloud":
        x, _, caches = f["prefill"](p, batch, m.init_cache(1, max_seq))
        tok = jnp.argmax(f["logits"](p, x[:, -1:])[:, 0], -1).astype(
            jnp.int32)
        pos = x.shape[1]
        st["tokens"].append(int(tok[0]))
        for _ in range(MAX_NEW - 1):
            tok, _, caches = f["full_step"](p, tok[:, None], caches, i32(pos))
            st["tokens"].append(int(tok[0]))
            pos += 1
        return st
    decisions, h1, ecache = f["edge_prefill"](p, batch,
                                              collm.init_edge_cache(1,
                                                                    max_seq))
    pos = h1.shape[1]
    tok, exited, _ = jfirst_confident_exit(decisions, theta)
    if mode == "standalone":
        tok = decisions[collm.l_ee2].token
        for _ in range(MAX_NEW - 1):
            st["tokens"].append(int(tok[0]))
            out = f["edge_step"](p, tok[:, None].astype(jnp.int32), ecache,
                                 i32(pos))
            ecache = out.caches
            tok = out.decisions[collm.l_ee2].token
            st["exits_l2"] += 1
            pos += 1
        st["tokens"].append(int(tok[0]))
        return st
    if cfg.vision_tokens:
        x, _, full = f["prefill"](p, batch, m.init_cache(1, max_seq))
        ccache = {si: full[si] for si in collm.cloud_segs}
        plogits = f["logits"](p, x[:, -1:])
    else:
        enc = f["encode"](p, batch["frames"])
        plogits, ccache = f["cloud_prefill"](
            p, h1, collm.init_cloud_cache(1, max_seq), enc_out=enc)
        st["enc_bytes"] = jtransport.hidden_wire_bytes(cfg.d_model, wire,
                                                       seq=enc.shape[1])
    st["upload_bytes"] += jtransport.hidden_wire_bytes(cfg.d_model, wire,
                                                       seq=h1.shape[1])
    if not bool(exited[0]):
        st["cloud_requests"] += 1
        tok = jnp.argmax(plogits[:, 0], -1)
    st["tokens"].append(int(tok[0]))
    for _ in range(MAX_NEW - 1):
        out = f["edge_step"](p, jnp.asarray(tok, jnp.int32)[:, None], ecache,
                             i32(pos))
        ecache = out.caches
        tok, exited, _ = jfirst_confident_exit(out.decisions, theta)
        _tick(st, out.decisions, collm.l_ee1, collm.l_ee2, theta,
              bool(exited[0]))
        st["upload_bytes"] += jtransport.StatePacket(
            hidden=out.upload, pos=i32(pos)).nbytes()
        if not bool(exited[0]):
            logits, ccache = f["cloud_step"](p, out.upload, ccache, i32(pos))
            st["cloud_requests"] += 1
            tok = jnp.argmax(logits, -1)
        st["tokens"].append(int(tok[0]))
        pos += 1
    return st


def stream_test(name):
    """Greedy streams of every mode equal JAX's: tokens, exits, cloud
    requests, upload and ``enc_out`` bytes."""

    @pytest.mark.parametrize("mode", list(MODES))
    def test_streams_match_jax(mode):
        arch = arch_of(name)
        got, want = port_stream(arch, mode), dict(arch.jax_run(mode))
        assert len(got["tokens"]) == MAX_NEW
        np.testing.assert_allclose(np.asarray(got.pop("confs")).reshape(-1),
                                   np.asarray(want.pop("confs")).reshape(-1),
                                   atol=1e-5, rtol=0)
        assert got == want
        if mode == "collm-float16":
            assert got["exits_l1"] + got["exits_l2"] > 0
            assert got["cloud_requests"] > 0
        if mode == "collm-int8":
            assert got["exits_l1"] == MAX_NEW - 1
            assert got["cloud_requests"] == 0

    return test_streams_match_jax
