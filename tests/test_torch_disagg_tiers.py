"""PyTorch port: the two-tier runtime with its tiers as two partition
models (``TwoTierRuntime(split=True)``: ``Model(tier="edge")`` and
``Model(tier="cloud")``, each loaded from the JAX parameters through
``bridge.params_from_jax(tier=)``), on the CPU against the JAX package's
``TwoTierRuntime.build(params_edge, params_cloud)``, on the briefly
trained tiny model (``tiny_trained``).

``tests/test_torch_disagg.py``'s scenarios with the tiers split: at θ =
1.1 with a float32 and a float16 wire, and at θ = 0.5 with a float16 and
an int8 wire, the prompt upload whole and in 4-token slices, the streams,
wire bytes and channel rows equal JAX's bit for bit (and at θ = 1.1 on a
float32 wire the full model's greedy stream).  Each tier's parameters are
the JAX leaves of its layers, norms and unembedding, by name and by
bytes, and neither reaches into the other's partition.
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
from repro_torch.core.disagg import TwoTierRuntime  # noqa: E402
from repro_torch.models.transformer import Model, OtherTierError  # noqa: E402

MAX_SEQ = 64
# (θ, wire, tokens, prompt upload slice)
CASES = [(1.1, "float32", 10, 0), (1.1, "float16", 10, 0),
         (0.5, "float16", 12, 0), (0.5, "float16", 12, 4),
         (0.5, "int8", 12, 0), (0.5, "int8", 12, 4)]


@pytest.fixture(scope="module")
def tiers(tiny_trained):
    jm, params = tiny_trained["model"], tiny_trained["params"]
    np_params = jax.tree.map(np.asarray, params)
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    parts = {t: params_from_jax(np_params, tcfg, tier=t)
             for t in ("edge", "cloud")}
    whole = Model(tcfg, device="cpu")
    whole.load_state_dict(params_from_jax(np_params, tcfg))
    prompt = tiny_trained["data"].sample_tokens(10)
    return {"jm": jm, "params": params, "np_params": np_params,
            "tcfg": tcfg, "parts": parts, "whole": whole, "prompt": prompt}


def _split(tiers, ccfg):
    """A split runtime built from the JAX parameters of each tier (its
    model only names the configuration: it lives on the meta device)."""
    rt = TwoTierRuntime(Model(tiers["tcfg"], device="meta"), ccfg, "cpu",
                        "cpu", split=True)
    rt.build(tiers["parts"]["edge"], tiers["parts"]["cloud"])
    return rt


def _full_greedy(model, prompt, n):
    """The undivided model's greedy stream, as ``tests/test_disagg.py``
    builds its reference."""
    co = CoLLM(model, CollmConfig())
    caches = model.init_cache(1, MAX_SEQ)
    with torch.no_grad():
        x, _, caches, _ = model.prefill(
            {"tokens": torch.as_tensor(prompt[None, :])}, caches)
        tok = model.logits(x[:, -1:])[:, 0].argmax(-1)
        ref = [int(tok[0])]
        for t in range(n - 1):
            tok, _, caches = co.full_step(tok[:, None], caches,
                                          len(prompt) + t)
            ref.append(int(tok[0]))
    return ref


@pytest.mark.parametrize("theta,wire,max_new,chunk", CASES)
def test_split_tiers_match_jax(tiers, theta, wire, max_new, chunk):
    """The split runtime's stream, wire bytes and channel row equal JAX's
    two-tier runtime built from its two tiers' parameters; below θ every
    generated step uploads its packet."""
    prompt, mesh = tiers["prompt"], make_debug_mesh(1)
    jrt = JTwoTierRuntime(tiers["jm"], JCollmConfig(theta=theta,
                                                    wire_format=wire),
                          mesh, mesh)
    jrt.build(tiers["params"], tiers["params"])
    jtoks, jinfo = jrt.decode(jnp.asarray(prompt[None, :]), max_new,
                              max_seq=MAX_SEQ, upload_chunk=chunk)
    rt = _split(tiers, CollmConfig(theta=theta, wire_format=wire))
    assert rt.edge_model.tier == "edge" and rt.cloud_model.tier == "cloud"
    assert rt.model is None                 # no whole model kept
    toks, info = rt.decode(prompt, max_new, max_seq=MAX_SEQ,
                           upload_chunk=chunk)
    assert len(toks) == max_new and toks == jtoks
    assert info["wire_bytes"] == jinfo["wire_bytes"] > 0
    assert info["channel"] == jinfo["channel"]
    assert info["bytes_down"] == 0          # one device: no downlink
    d = tiers["tcfg"].d_model
    if theta < 1:
        per_token = d * 2 if wire == "float16" else d + 4
        assert info["wire_bytes"] == (max_new - 1) * per_token
    if wire == "float32":
        assert toks == _full_greedy(tiers["whole"], prompt, max_new)


def _jax_tier_leaves(jm, params, tier):
    """{the port's name: bytes} of the JAX leaves a tier holds: the
    segments of its layers (a stacked leaf a layer at a time), its norms
    and the unembedding (with the embedding on the edge)."""
    cfg = jm.cfg
    l_ee1, l_ee2 = cfg.exit_layers[0], cfg.exit_layers[-1]
    out = {}

    def add(name, a):
        out[name] = int(np.asarray(a).nbytes)
    for si, seg in enumerate(jm.segments):
        held = seg.end <= l_ee2 if tier == "edge" else seg.start >= l_ee1
        if not held:
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                params["segments"][si])[0]:
            keys = ".".join(str(p.key) for p in path)
            for j in range(seg.length):
                add(f"layers.{seg.start + j}.{keys}", leaf[j])
    if tier == "edge" or cfg.tie_embeddings:
        add("embed", params["embed"])
    if not cfg.tie_embeddings:
        add("lm_head", params["lm_head"])
    if tier == "edge":
        for layer, w in params["exit_norms"].items():
            add(f"exit_norms.{layer}", w)
    else:
        add("final_norm", params["final_norm"])
    return out


def test_tier_parameters_are_their_jax_leaves(tiers):
    """Each tier holds exactly the JAX leaves of its partition, by name
    and bytes; neither holds a leaf of the other's layers or heads, and a
    call into the other partition raises.  A live tier on the meta device
    is refused."""
    rt = _split(tiers, CollmConfig())
    edge, cloud = rt.edge_model, rt.cloud_model
    for tier, model in (("edge", edge), ("cloud", cloud)):
        want = _jax_tier_leaves(tiers["jm"], tiers["np_params"], tier)
        got = {n: p.numel() * p.element_size()
               for n, p in model.named_parameters()}
        assert got == want, tier
    l_ee1, l_ee2 = tiers["tcfg"].exit_layers[0], tiers["tcfg"].exit_layers[-1]
    layer = lambda n: int(n.split(".")[1]) if n.startswith("layers.") \
        else None                                           # noqa: E731
    edge_names = [n for n, _ in edge.named_parameters()]
    cloud_names = [n for n, _ in cloud.named_parameters()]
    assert not any(n == "final_norm" or (layer(n) is not None
                                         and layer(n) >= l_ee2)
                   for n in edge_names)
    assert not any(n.startswith("exit_norms") or (layer(n) is not None
                                                  and layer(n) < l_ee1)
                   for n in cloud_names)
    # every shared name (the tied embedding, layers l_ee1+1..l_ee2) holds
    # the same weights in both tiers
    for name in set(edge_names) & set(cloud_names):
        assert torch.equal(edge.get_parameter(name),
                           cloud.get_parameter(name)), name
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(OtherTierError, match="cloud tier"):
        rt.edge_collm.cloud_step({"data": torch.zeros((1, 1, 128))},
                                 rt.edge_collm.init_edge_cache(1, 8), 0)
    with pytest.raises(OtherTierError, match="edge tier"):
        rt.cloud_collm.model.decode_step(tok, {}, 0, seg_indices=(0,))
    with pytest.raises(AttributeError):
        edge.logits(torch.zeros((1, 1, 128)))            # no final norm
    with pytest.raises(ValueError, match="meta"):
        TwoTierRuntime(tiers["whole"], CollmConfig(), "cpu", "meta")
    with pytest.raises(ValueError, match="draws no weights"):
        Model(tiers["tcfg"], device="cpu", tier="edge").init(
            torch.Generator())
