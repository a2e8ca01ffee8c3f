"""Shared parts of the recurrent and hybrid parity tests
(``tests/test_torch_recurrent*.py``): the reduced xlstm-350m and
zamba2-1.2b configurations, one ``Arch`` per configuration (the JAX model
and params, the port's model on the same weights through
``repro_torch.bridge``, prompts, a split θ, JAX runs computed once per
process) and the comparison of two runs.

Both configurations keep 4 layers with exits (1, 2) (``reduced``: d_model
256, state 16, chunk 32).  xlstm's layer 3 is its sLSTM block (layers 0-2
mLSTM, 4 heads of d = 128); zamba2 alternates Mamba2 layers with its
shared attention block (period 2: layers 1 and 3, 4 heads over 4 of
d = 64).  The prompts are 37 and 50 tokens long: neither a multiple of
the chunk, so both packages' chunked GLA runs a short last chunk (the
JAX package one of gcd(S, 32) tokens).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro.serving.mesh_exec import mesh_context  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSMConfig  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import GenStats  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402

MAX_NEW = 6
NAMES = ("xlstm-350m", "zamba2-1.2b")
PROMPT_LENS = (37, 50, 50)
COUNTERS = [f.name for f in dataclasses.fields(GenStats)
            if f.type in (int, "int")]


def jax_config(name):
    cfg = jreduced(jget_config(name), n_layers=4)
    return dataclasses.replace(cfg, exit_layers=(1, 2)).validate()


def torch_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["ssm"] = TSSMConfig(**fields["ssm"])
    return TModelConfig(**fields)


class Arch:
    """One architecture: JAX model and params, the port's model on the
    same weights, the prompts, θ, and JAX runs computed once."""

    def __init__(self, name):
        self.jcfg = jax_config(name)
        self.jm = jbuild(self.jcfg)
        self.np_params = jax.tree.map(np.asarray,
                                      self.jm.init(jax.random.PRNGKey(0)))
        self.params = jax.tree.map(jnp.asarray, self.np_params)
        self.tcfg = torch_config(self.jcfg)
        self.tm = Model(self.tcfg, device="cpu")
        self.tm.load_state_dict(params_from_jax(self.np_params, self.tcfg))
        rng = np.random.default_rng(1)
        self.prompts = [rng.integers(0, self.tcfg.vocab_size, n)
                        for n in PROMPT_LENS]
        full = ServingSystem(self.tm, CollmConfig(theta=1.0))
        c = sorted(max(c12) for c12 in full.generate_sequential(
            self.prompts, MAX_NEW)["stats"].confidences)
        self.theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
        self._steps = {}
        self._runs = {}

    def systems(self, **kw):
        """(port, JAX) serving systems at the split θ."""
        jsys = JServingSystem(self.jm, self.params,
                              JCollmConfig(theta=self.theta, **kw))
        jsys.collm._mesh_ctx = self._steps.setdefault(
            "ctx", mesh_context(jsys.collm))
        return ServingSystem(self.tm, CollmConfig(theta=self.theta, **kw)), \
            jsys

    def jax_run(self, key, fn):
        """``fn(system)`` on a JAX system at the split θ, once per
        ``key``."""
        if key not in self._runs:
            self._runs[key] = fn(self.systems()[1])
        return self._runs[key]


_ARCHS = {}


def arch_of(name) -> Arch:
    """The ``Arch`` of ``name``, built once per process."""
    if name not in _ARCHS:
        _ARCHS[name] = Arch(name)
    return _ARCHS[name]


def assert_same_run(got, want):
    """Streams and every integer counter, per client and summed."""
    assert got["tokens"] == want["tokens"]
    per = [(got["stats"], want["stats"])]
    if "per_client" in want:
        per += list(zip(got["per_client"], want["per_client"]))
    for g, w in per:
        for name in COUNTERS:
            assert getattr(g, name) == getattr(w, name), name


def sequential_test(name):
    """``generate_sequential`` in the cloud (one prompt: JAX's cloud loop
    runs ``full_step`` without jit), collm at the split θ (exits and cloud
    requests both happen) and standalone modes, equal to JAX's."""

    @pytest.mark.parametrize("mode", ["cloud", "collm", "standalone"])
    def test_sequential_streams_match_jax(mode):
        arch = arch_of(name)
        n = 1 if mode == "cloud" else len(arch.prompts)
        ps = arch.prompts[-n:]
        want = arch.jax_run(("sequential", mode),
                            lambda s: s.generate_sequential(ps, MAX_NEW,
                                                            mode=mode))
        got = arch.systems()[0].generate_sequential(ps, MAX_NEW, mode=mode)
        assert_same_run(got, want)
        if mode == "collm":
            st = got["stats"]
            assert st.exits_l1 + st.exits_l2 > 0 and st.cloud_requests > 0

    return test_sequential_streams_match_jax


def generate_both(arch, ccfg_kw, call_kw, multi=False):
    """The same ``generate`` (or ``generate_multi``) run through the port
    and JAX; returns (port result, JAX result, port system, JAX system)."""
    tsys, jsys = arch.systems(**ccfg_kw)
    fn = "generate_multi" if multi else "generate"
    want = getattr(jsys, fn)(arch.prompts, MAX_NEW, **call_kw)
    got = getattr(tsys, fn)(arch.prompts, MAX_NEW, **call_kw)
    return got, want, tsys, jsys


def kv_bytes(system):
    """``kv_cache_bytes`` of each scheduler of a system."""
    return [s.kv_cache_bytes() for s in system._schedulers.values()]
