"""Shared parts of the MoE parity tests (``tests/test_torch_moe*.py``):
the reduced olmoe-1b-7b and granite-moe-3b-a800m configurations, one
``Arch`` per configuration (the JAX model and params, the port's model on
the same weights through ``repro_torch.bridge``, prompts, a split θ, JAX
runs computed once per process) and the stream tests, which each stream
file instantiates for one configuration.

Both configurations keep 4 layers with exits (1, 2), 4 experts and top-2
routing (``reduced``).  olmoe keeps its 1:1 heads (4 over 4, d = 64);
granite keeps its group of 3 (6 heads over 2, d = 64, d_model 384).
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
from repro_torch.configs.base import MoEConfig as TMoEConfig  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402

MAX_NEW = 6
SHAPES = {"olmoe-1b-7b": dict(),
          "granite-moe-3b-a800m": dict(n_heads=6, d_model=384,
                                       n_kv_heads=2)}
LAYOUTS = {"dense": dict(kv_layout="dense"),
           "paged": dict(kv_layout="paged"),
           "paged-int8": dict(kv_layout="paged", kv_dtype="int8"),
           "chunked": dict(kv_layout="paged", chunked_prefill=True)}


def jax_config(name, capacity_factor=None):
    shape = dict(SHAPES[name])
    kv = shape.pop("n_kv_heads", None)
    cfg = jreduced(jget_config(name), n_layers=4, **shape)
    cfg = dataclasses.replace(cfg, exit_layers=(1, 2))
    if kv is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg.validate()


def torch_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["moe"] = TMoEConfig(**fields["moe"])
    return TModelConfig(**fields)


class Arch:
    """One architecture: JAX model and params, the port's model on the
    same weights, the prompts, θ, and JAX runs computed once."""

    def __init__(self, name):
        jcfg = jax_config(name)
        self.jm = jbuild(jcfg)
        self.np_params = jax.tree.map(np.asarray,
                                      self.jm.init(jax.random.PRNGKey(0)))
        self.params = jax.tree.map(jnp.asarray, self.np_params)
        self.tcfg = torch_config(jcfg)
        self.tm = Model(self.tcfg, device="cpu")
        self.tm.load_state_dict(params_from_jax(self.np_params, self.tcfg))
        rng = np.random.default_rng(1)
        # two lengths (one JAX prefill trace each), three prompts for two
        # slots (one refill)
        self.prompts = [rng.integers(0, self.tcfg.vocab_size, n)
                        for n in (41, 80, 80)]
        full = ServingSystem(self.tm, CollmConfig(theta=1.0))
        c = sorted(max(c12) for c12 in full.generate_sequential(
            self.prompts, MAX_NEW)["stats"].confidences)
        self.theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
        self._steps = {}
        self._runs = {}

    def jax_system(self, **kw):
        system = JServingSystem(self.jm, self.params,
                                JCollmConfig(theta=self.theta, **kw))
        system.collm._mesh_ctx = self._steps.setdefault(
            "ctx", mesh_context(system.collm))
        return system

    def jax_run(self, key):
        if key not in self._runs:
            kind, arg = key
            if kind == "sequential":
                # JAX's cloud loop runs ``full_step`` without jit: one prompt
                n = 1 if arg == "cloud" else len(self.prompts)
                self._runs[key] = self.jax_system().generate_sequential(
                    self.prompts[-n:], MAX_NEW, mode=arg)["tokens"]
            else:
                self._runs[key] = self.jax_system(**LAYOUTS[arg]).generate(
                    self.prompts, MAX_NEW, mode="collm",
                    num_slots=2)["tokens"]
        return self._runs[key]


_ARCHS = {}


def arch_of(name) -> Arch:
    """The ``Arch`` of ``name``, built once per process."""
    if name not in _ARCHS:
        _ARCHS[name] = Arch(name)
    return _ARCHS[name]


def jax_drops(mp, jcfg, x) -> int:
    """(token, slot) pairs that JAX's capacity drops in ``x`` (B, S, d)."""
    moe = jcfg.moe
    b, s, _ = x.shape
    cap = max(int(np.ceil(s * moe.top_k / moe.num_experts
                          * moe.capacity_factor)), moe.top_k)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, mp["router"]), -1)
    _, top_e = jax.lax.top_k(probs, moe.top_k)
    flat = np.asarray(top_e).reshape(b, s * moe.top_k)
    dropped = 0
    for row in flat:
        counts = np.bincount(row, minlength=moe.num_experts)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped


def stream_tests(name):
    """The greedy-stream tests of configuration ``name``: through
    ``generate_sequential`` (cloud, collm at a θ that sends about half the
    ticks to the cloud, standalone) and through ``generate`` (dense, paged
    float32, paged int8, chunked prefill), each equal to JAX's.
    ``generate`` right-pads each admission to its bucket and routes the
    pads too, with the capacity of the padded length, as the JAX package
    does; chunked prefill routes its chunks without a capacity in both
    packages."""

    @pytest.mark.parametrize("mode", ["cloud", "collm", "standalone"])
    def test_sequential_streams_match_jax(mode):
        arch = arch_of(name)
        n = 1 if mode == "cloud" else len(arch.prompts)
        got = ServingSystem(arch.tm, CollmConfig(theta=arch.theta)
                            ).generate_sequential(arch.prompts[-n:],
                                                  MAX_NEW, mode=mode)
        assert got["tokens"] == arch.jax_run(("sequential", mode))
        if mode == "collm":
            st = got["stats"]
            assert st.exits_l1 + st.exits_l2 > 0 and st.cloud_requests > 0

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_generate_streams_match_jax(layout):
        arch = arch_of(name)
        got = ServingSystem(arch.tm, CollmConfig(
            theta=arch.theta, **LAYOUTS[layout])).generate(
            arch.prompts, MAX_NEW, mode="collm", num_slots=2)["tokens"]
        assert got == arch.jax_run(("generate", layout))

    return test_sequential_streams_match_jax, test_generate_streams_match_jax
