"""PyTorch port, slice level: the JAX package's four dense decoders
(gemma3-12b, command-r-35b, qwen1.5-110b, stablelm-12b) at reduced width,
with weights carried across from JAX by ``repro_torch.bridge``, in
float32 on the CPU.

gemma3 keeps 8 layers with exits (3, 6), so that a global layer lies in
the edge and in the cloud, and a window of 32: prompts of 41 and 80 tokens
take the banded path in its local layers, and one of 2304 tokens the
chunked path in its global layers (``test_long_prompt_matches_jax``).
The other three keep 4 layers with exits (1, 2); qwen's qkv biases are
drawn at random, so the bridge carries them.

* Prefill logits equal JAX's (1e-4).
* Greedy streams equal JAX's through ``generate_sequential`` (cloud,
  collm at a θ that sends about half the ticks to the cloud,
  standalone) and through ``generate`` (dense, paged float32, paged
  int8, chunked prefill).  The JAX package's cloud loop runs without jit
  (~1.5 s a token here), so only gemma3's cloud stream is held to it; the
  other three are held to JAX's model by one JAX prefill over the prompt
  and the port's tokens, each of which must be the argmax of JAX's logits
  at the position before it.
* gemma3 through ``generate``: the JAX package's padded admission keeps
  the pads, not the prompt's tail, in its windowed rings (ROADMAP §C), so
  its dense and paged streams differ from its sequential ones.  The port
  keeps the tail: its dense and paged float32 streams equal JAX's
  sequential streams, its int8 pages JAX's chunked int8 run (chunks write
  pages, no ring), and one JAX dense stream is shown to differ.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro.serving.mesh_exec import mesh_context  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402

MAX_NEW = 6
LONG = 2304             # S*S > 2**22: the chunked prefill path
SHAPES = {"gemma3-12b": dict(n_layers=8, exit_layers=(3, 6)),
          "command-r-35b": dict(n_layers=4, exit_layers=(1, 2)),
          "qwen1.5-110b": dict(n_layers=4, exit_layers=(1, 2)),
          "stablelm-12b": dict(n_layers=4, exit_layers=(1, 2))}
LAYOUTS = {"dense": dict(kv_layout="dense"),
           "paged": dict(kv_layout="paged"),
           "paged-int8": dict(kv_layout="paged", kv_dtype="int8"),
           "chunked": dict(kv_layout="paged", chunked_prefill=True)}


def test_registry_serves_the_dense_decoders():
    assert sorted(ARCHS) == sorted(["ee-llm-7b", *SHAPES, "olmoe-1b-7b",
                                    "granite-moe-3b-a800m", "xlstm-350m",
                                    "zamba2-1.2b", "whisper-medium",
                                    "paligemma-3b"])
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(name)), name


def _jax_parameter_shapes(name):
    """Each leaf of ``name``'s full-size JAX pytree (``jax.eval_shape``,
    nothing allocated) under the port's parameter name: segments and the
    encoder's stacked layers unstacked per layer, as the bridge does."""
    from repro.models.transformer import build_segments as jsegments
    cfg = jget_config(name)
    shapes = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))

    def leaves(tree):
        return [(".".join(str(k.key) for k in path), leaf) for path, leaf
                in jax.tree_util.tree_flatten_with_path(tree)[0]]

    want = {}
    for key in ("embed", "final_norm", "lm_head", "exit_norms", "vis_proj"):
        for path, leaf in leaves({key: shapes[key]} if key in shapes else {}):
            want[path] = leaf.shape
    for seg, tree in zip(jsegments(cfg), shapes["segments"]):
        for path, leaf in leaves(tree):
            for j in range(seg.length):
                want[f"layers.{seg.start + j}.{path}"] = leaf.shape[1:]
    if "encoder" in shapes:
        for path, leaf in leaves({"norm": shapes["encoder"]["norm"]}):
            want[f"encoder.{path}"] = leaf.shape
        for path, leaf in leaves(shapes["encoder"]["layers"]):
            for j in range(cfg.encoder_layers):
                want[f"encoder.layers.{j}.{path}"] = leaf.shape[1:]
    return cfg, {n: tuple(s) for n, s in want.items()}


def _meta_model(cfg):
    """The port's bfloat16 model of ``cfg`` on the meta device."""
    from repro_torch.configs.base import MoEConfig
    fields = dataclasses.asdict(cfg)
    if fields["moe"]:
        fields["moe"] = MoEConfig(**fields["moe"])
    return Model(TModelConfig(**fields), device="meta", dtype=torch.bfloat16)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_parameters_match_the_jax_pytree(name):
    """At full size, without allocating (JAX's ``eval_shape``, the port on
    the meta device): each leaf of a MoE model's JAX pytree, unstacked
    per layer as the bridge does, is a parameter of the port's bfloat16
    model of the same shape, and the port has no other; the routers stay
    float32."""
    cfg, want = _jax_parameter_shapes(name)
    tm = _meta_model(cfg)
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    for n, p in tm.named_parameters():
        assert p.dtype == (torch.float32 if n.endswith("moe.router")
                           else torch.bfloat16), n


@pytest.mark.parametrize("name", ["whisper-medium", "paligemma-3b"])
def test_encdec_and_vlm_parameters_match_the_jax_pytree(name):
    """The same at full size for whisper-medium (its 24-layer encoder and
    norm, every decoder block's cross-attention with qkv biases and its
    layer norms' scales and biases, the GELU MLP's biases, the untied
    head, the dict-valued final norm) and paligemma-3b (``vis_proj``)."""
    cfg, want = _jax_parameter_shapes(name)
    got = {n: tuple(p.shape) for n, p in _meta_model(cfg).named_parameters()}
    assert got == want
    if cfg.is_encdec:
        assert "encoder.layers.23.attn.bq" in got
        assert "layers.0.cross.bv" in got and "final_norm.bias" in got
    else:
        assert got["vis_proj"] == (2048, 2048)


class Arch:
    """One architecture: JAX model and params, the port's model on the
    same weights, the prompts, θ, and JAX runs computed once."""

    def __init__(self, name):
        n_layers = SHAPES[name]["n_layers"]
        jcfg = dataclasses.replace(jreduced(jget_config(name),
                                            n_layers=n_layers),
                                   exit_layers=SHAPES[name]["exit_layers"])
        self.jm = jbuild(jcfg.validate())
        params = jax.tree.map(np.asarray,
                              self.jm.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for seg in params["segments"]:
            for b in ("bq", "bk", "bv"):
                if b in seg["attn"]:
                    seg["attn"][b] = rng.normal(
                        size=seg["attn"][b].shape).astype(np.float32)
        self.params = jax.tree.map(jax.numpy.asarray, params)
        tcfg = TModelConfig(**dataclasses.asdict(jcfg))
        self.tm = Model(tcfg, device="cpu")
        self.tm.load_state_dict(params_from_jax(params, tcfg))
        # two lengths (one JAX prefill trace each), three prompts for two
        # slots (one refill)
        self.prompts = [rng.integers(0, tcfg.vocab_size, n)
                        for n in (41, 80, 80)]
        self.long = rng.integers(0, tcfg.vocab_size, LONG)
        # between the middle larger-exit confidences of a θ = 1 run: about
        # half the ticks go to the cloud, the others exit at l_ee1 or l_ee2
        full = ServingSystem(self.tm, CollmConfig(theta=1.0))
        c = sorted(max(c12) for c12 in full.generate_sequential(
            self.prompts, MAX_NEW)["stats"].confidences)
        self.theta = (c[len(c) // 2 - 1] + c[len(c) // 2]) / 2
        self._steps = {}
        self._runs = {}

    def jax_system(self, **kw):
        """A JAX ``ServingSystem`` at this θ whose CoLLM shares the jitted
        steps of the earlier ones (they read only θ and the wire)."""
        system = JServingSystem(self.jm, self.params,
                                JCollmConfig(theta=self.theta, **kw))
        system.collm._mesh_ctx = self._steps.setdefault(
            "ctx", mesh_context(system.collm))
        return system

    def jax_greedy(self, prompt, toks):
        """The greedy continuation JAX's model gives ``prompt`` at every
        step of ``toks`` (teacher-forced: one prefill over both)."""
        seq = np.concatenate([prompt, np.asarray(toks[:-1], prompt.dtype)])
        jc = self.jm.init_cache(1, len(seq))
        jx, _, _, _ = self.jm.prefill(self.params, {"tokens": seq[None]}, jc)
        logits = np.asarray(self.jm.logits(self.params, jx))[0]
        return [int(t) for t in logits[len(prompt) - 1:].argmax(-1)]

    def jax_run(self, key):
        if key not in self._runs:
            kind, arg = key
            if kind == "sequential":
                n = 1 if arg == "cloud" else len(self.prompts)
                self._runs[key] = self.jax_system().generate_sequential(
                    self.prompts[-n:], MAX_NEW, mode=arg)["tokens"]
            else:
                self._runs[key] = self.jax_system(**LAYOUTS[arg]).generate(
                    self.prompts, MAX_NEW, mode="collm",
                    num_slots=2)["tokens"]
        return self._runs[key]


_ARCHS = {}


def _arch(name):
    if name not in _ARCHS:
        _ARCHS[name] = Arch(name)
    return _ARCHS[name]


@pytest.fixture(scope="module", params=list(SHAPES))
def arch(request):
    return _arch(request.param)


@torch.no_grad()
def test_prefill_logits_match_jax(arch):
    """Logits at every position of each prompt and, for gemma3, the
    2304-token one (chunked prefill in the global layers, banded in the
    local ones)."""
    longs = [arch.long] if arch.tm.cfg.sliding_window else []
    for prompt in arch.prompts[:2] + longs:
        jc = arch.jm.init_cache(1, len(prompt))
        jx, _, _, _ = arch.jm.prefill(arch.params,
                                      {"tokens": prompt[None]}, jc)
        want = np.asarray(arch.jm.logits(arch.params, jx))
        tc = arch.tm.init_cache(1, len(prompt))
        tx, _, _, _ = arch.tm.prefill(
            {"tokens": torch.as_tensor(prompt[None])}, tc)
        np.testing.assert_allclose(arch.tm.logits(tx).numpy(), want,
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["cloud", "collm", "standalone"])
def test_sequential_streams_match_jax(arch, mode):
    # the JAX package's cloud loop runs ``full_step`` without jit (a trace
    # of every scan per token, ~1.5 s here), so that mode takes one prompt
    # (80 tokens, past gemma3's window), and only gemma3 runs it
    n = 1 if mode == "cloud" else len(arch.prompts)
    got = ServingSystem(arch.tm, CollmConfig(theta=arch.theta)
                        ).generate_sequential(arch.prompts[-n:], MAX_NEW,
                                              mode=mode)
    if mode == "cloud" and not arch.tm.cfg.sliding_window:
        (toks,) = got["tokens"]
        assert len(toks) == MAX_NEW
        assert toks == arch.jax_greedy(arch.prompts[-1], toks)
    else:
        assert got["tokens"] == arch.jax_run(("sequential", mode))
    if mode == "collm":
        st = got["stats"]
        assert st.exits_l1 + st.exits_l2 > 0 and st.cloud_requests > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_streams_match_jax(arch, layout):
    got = ServingSystem(arch.tm, CollmConfig(theta=arch.theta,
                                             **LAYOUTS[layout])).generate(
        arch.prompts, MAX_NEW, mode="collm", num_slots=2)["tokens"]
    if not arch.tm.cfg.sliding_window or layout == "chunked":
        assert got == arch.jax_run(("generate", layout))
    elif layout == "paged-int8":
        assert got == arch.jax_system(
            chunked_prefill=True, **LAYOUTS[layout]).generate(
            arch.prompts, MAX_NEW, mode="collm", num_slots=2)["tokens"]
    else:
        assert got == arch.jax_run(("sequential", "collm"))


def test_long_prompt_matches_jax():
    """gemma3 with a 2304-token prompt: the chunked path in the global
    layers, banded in the local ones, against JAX's sequential collm
    stream, sequentially and through ``generate`` (dense and paged,
    padded to a 4096-token bucket)."""
    g = _arch("gemma3-12b")
    want = g.jax_system().generate_sequential([g.long], MAX_NEW,
                                              mode="collm")["tokens"]
    got = ServingSystem(g.tm, CollmConfig(theta=g.theta)
                        ).generate_sequential([g.long], MAX_NEW, mode="collm")
    assert got["tokens"] == want
    for layout in ("dense", "paged"):
        assert ServingSystem(g.tm, CollmConfig(
            theta=g.theta, **LAYOUTS[layout])).generate(
            [g.long], MAX_NEW, mode="collm", num_slots=1)["tokens"] == want


def test_jax_padded_window_rings_drop_the_prompt_tail():
    """The JAX package's dense admission of a prompt longer than gemma3's
    window, right-padded to its bucket, keeps the pads in the windowed
    rings: its streams leave its sequential ones; the port's do not."""
    g = _arch("gemma3-12b")
    want = g.jax_run(("sequential", "collm"))
    assert g.jax_run(("generate", "dense")) != want
    got = ServingSystem(g.tm, CollmConfig(theta=g.theta)).generate(
        g.prompts, MAX_NEW, mode="collm", num_slots=2)["tokens"]
    assert got == want
