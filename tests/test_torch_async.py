"""PyTorch port, slice level: ``ServingSystem.generate`` under every cloud
channel option against the JAX package's, on the CPU, on the briefly
trained tiny model (``tiny_trained``, weights carried across by
``repro_torch.bridge.params_from_jax``), and the samplers.

Each scenario runs on dense and on paged KV at θ = 0.2 (exits and cloud
requests mixed): an ``AsyncSimChannel`` with an infinite deadline (the
streams of the blocking engine), ``ScriptedChannel`` deadline misses, a
reply that arrives after its deadline within one clock advance,
``fallback_after=2``, ``overlap=False``, a retired slot's late reply across
a refill, and the latency-trace property of ``tests/test_async_channel.py``
over 5 seeds.  Every case holds the tokens, every ``GenStats`` counter,
``stall_s`` / ``overlap_s`` / time to first token / inter-token gaps (to
1e-9), ``virtual_time`` (to 1e-9), ``late_drops`` and ``channel_stats``
equal to JAX's; each JAX result is computed once per module.

The samplers cannot match ``jax.random`` token for token, so they are held
by distribution: 20000 draws at V = 256 lie within total variation 0.02 of
softmax(logits / T); top-k draws stay inside the top k; ``top_k=1`` is
greedy (also through ``generate``, against JAX's greedy streams); one seed
gives one stream.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.netsim import NetworkParams as JNetworkParams  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.core.netsim import NetworkParams  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving import sampler as tsampler  # noqa: E402
from repro_torch.serving.engine import GenStats, ServingSystem  # noqa: E402

THETA = 0.2
WIFI = dict(up_bw=3.8e6, down_bw=8e6, rtt=0.003)
LAYOUTS = ("dense", "paged")
COUNTERS = [f.name for f in dataclasses.fields(GenStats)
            if f.type in (int, "int")]
TIMES = ("stall_s", "overlap_s", "ttft_s", "token_lat_s")


def _sim(mod, **kw):
    net = (JNetworkParams if mod is jtransport else NetworkParams)(**WIFI)
    return mod.AsyncSimChannel(net, **kw)


# name -> (channel factory over a transport module, prompt indices,
#          max_new, generate kwargs)
SCENARIOS = {
    "async-inf-deadline": (lambda m: _sim(m, service_s=0.004), (0, 1, 2, 3),
                           12, dict(num_slots=2, tick_time_s=0.01)),
    "scripted-misses": (lambda m: m.ScriptedChannel([0.5], deadline_s=0.02),
                        (0, 1, 2), 12, dict(num_slots=2, tick_time_s=0.005)),
    "late-reply": (lambda m: m.ScriptedChannel([0.008], deadline_s=0.005),
                   (0, 1), 10, dict(num_slots=2, tick_time_s=0.01)),
    "fallback": (lambda m: m.ScriptedChannel([0.5], deadline_s=0.01),
                 (0, 1), 14, dict(num_slots=2, tick_time_s=0.005,
                                  fallback_after=2)),
    "blocking": (lambda m: _sim(m, service_s=0.004), (0, 1, 2, 3), 12,
                 dict(num_slots=2, tick_time_s=0.01, overlap=False)),
    "refill-late-drop": (lambda m: m.ScriptedChannel([0.6], deadline_s=0.01),
                         (0, 1), 6, dict(num_slots=1, tick_time_s=0.01)),
}
SEEDS = range(5)


def _trace(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.08, size=16).tolist()


@pytest.fixture(scope="module")
def pair(tiny_trained):
    jm = tiny_trained["model"]
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, tiny_trained["params"]), tcfg))
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(n) for n in (10, 9, 11, 8)]
    return jm, tiny_trained["params"], tm, prompts


@pytest.fixture(scope="module")
def jax_runs(pair):
    """Every scenario's JAX result, computed once (one system per layout,
    so that each compiles once)."""
    jm, params, _, prompts = pair
    out = {}
    for layout in LAYOUTS:
        jsys = JServingSystem(jm, params, JCollmConfig(theta=THETA,
                                                       kv_layout=layout))
        out[layout, "sync"] = jsys.generate(
            [prompts[i] for i in SCENARIOS["async-inf-deadline"][1]], 12,
            num_slots=2)
        for name, (mk, idx, max_new, kw) in SCENARIOS.items():
            out[layout, name] = jsys.generate(
                [prompts[i] for i in idx], max_new, channel=mk(jtransport),
                **kw)
        if layout == "dense":
            for seed in SEEDS:
                out[layout, seed] = jsys.generate(
                    prompts[:3], 8, num_slots=2, tick_time_s=0.01,
                    channel=jtransport.ScriptedChannel(_trace(seed),
                                                       deadline_s=0.03))
    return out


def _assert_same(got, want):
    assert got["tokens"] == want["tokens"]
    for g, w in zip(got["per_client"] + [got["stats"]],
                    want["per_client"] + [want["stats"]]):
        for name in COUNTERS:
            assert getattr(g, name) == getattr(w, name), name
        for name in TIMES:
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       atol=1e-9, rtol=0, err_msg=name)
    assert got["virtual_time"] == pytest.approx(want["virtual_time"],
                                                abs=1e-9, rel=0)
    assert got["late_drops"] == want["late_drops"]
    assert got["channel_stats"] == want["channel_stats"]


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_generate_channel_matches_jax(pair, jax_runs, layout, name):
    mk, idx, max_new, kw = SCENARIOS[name]
    prompts = [pair[3][i] for i in idx]
    tsys = ServingSystem(pair[2], CollmConfig(theta=THETA, kv_layout=layout))
    got = tsys.generate(prompts, max_new, channel=mk(ttransport), **kw)
    _assert_same(got, jax_runs[layout, name])
    st = got["stats"]
    assert all(len(t) == max_new for t in got["tokens"])
    if name == "async-inf-deadline":
        # an infinite deadline only delays replies: the blocking streams
        sync = jax_runs[layout, "sync"]
        assert got["tokens"] == sync["tokens"]
        assert st.deadline_misses == 0 and st.stall_s > 0
        assert st.cloud_requests == sync["stats"].cloud_requests
    elif name == "scripted-misses":
        assert st.deadline_misses > 0
        assert got["late_drops"] == st.deadline_misses
    elif name == "late-reply":
        # every reply lands after its deadline, inside one tick
        assert st.deadline_misses > 0
        assert st.cloud_requests <= len(prompts)     # admission prefill only
    elif name == "fallback":
        assert st.fallbacks >= 1
        assert got["channel_stats"]["requests"] < (max_new - 1) * len(prompts)
    elif name == "blocking":
        # the same run overlapped is the infinite-deadline scenario: same
        # streams, and only there is stalled time hidden behind decoding
        over = tsys.generate(prompts, max_new, channel=mk(ttransport),
                             **dict(kw, overlap=True))
        assert over["tokens"] == got["tokens"]
        _assert_same(over, jax_runs[layout, "async-inf-deadline"])
        assert st.overlap_s < 1e-12 < over["stats"].overlap_s
    elif name == "refill-late-drop":
        alone = ServingSystem(pair[2], CollmConfig(
            theta=THETA, kv_layout=layout)).generate(
            prompts[1:], max_new, channel=mk(ttransport), **kw)
        assert got["tokens"][1] == alone["tokens"][0]
        assert got["late_drops"] >= st.deadline_misses > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_trace_property_matches_jax(pair, jax_runs, seed):
    """Random latency traces: streams complete, every emitted token is an
    exit, a reply that beat its deadline or a deadline miss, and every
    request resolves once; all of it equal to JAX's."""
    prompts = pair[3][:3]
    got = ServingSystem(pair[2], CollmConfig(theta=THETA)).generate(
        prompts, 8, num_slots=2, tick_time_s=0.01,
        channel=ttransport.ScriptedChannel(_trace(seed), deadline_s=0.03))
    _assert_same(got, jax_runs["dense", seed])
    agg = got["stats"]
    assert all(len(t) == 8 for t in got["tokens"])
    served = agg.exits_l1 + agg.exits_l2 + agg.cloud_requests
    assert agg.tokens - len(prompts) <= served <= agg.tokens
    submitted = got["channel_stats"]["requests"]
    assert (agg.cloud_requests - len(prompts) + agg.deadline_misses
            <= submitted <= agg.cloud_requests + agg.deadline_misses)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
def _logits(v=256, seed=0):
    return np.random.default_rng(seed).normal(size=v).astype(np.float32) * 5


def _tv(tokens, p):
    freq = np.bincount(np.asarray(tokens), minlength=p.size) / len(tokens)
    return 0.5 * float(np.abs(freq - p).sum())


@pytest.mark.parametrize("temperature", [0.8, 1.2])
def test_temperature_sampler_distribution(temperature):
    """20000 draws at V = 256 against softmax(logits / T), within total
    variation 0.02 (the JAX sampler's draws are held to the same target).
    The logits are N(0, 5²): the expected total variation of 20000 exact
    draws is 0.0025 at T = 0.8 and 0.0076 at T = 1.2."""
    n, lg = 20000, _logits()
    z = lg / temperature
    p = np.exp(z - z.max())
    p /= p.sum()
    gen = torch.Generator().manual_seed(0)
    got = tsampler.temperature_sample(
        gen, torch.from_numpy(lg).expand(n, -1), temperature)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert _tv(got.numpy(), p) <= 0.02
    want = jsampler.temperature_sample(
        jax.random.PRNGKey(0), jnp.broadcast_to(jnp.asarray(lg), (n, lg.size)),
        temperature)
    assert _tv(np.asarray(want), p) <= 0.02


def test_top_k_stays_in_top_k():
    n, k, lg = 5000, 5, _logits(seed=1)
    gen = torch.Generator().manual_seed(1)
    got = tsampler.sample(torch.from_numpy(lg).expand(n, -1),
                          method="temperature", gen=gen, temperature=2.0,
                          top_k=k).numpy()
    top = set(np.argsort(lg)[-k:].tolist())
    assert set(got.tolist()) == top           # all of the top k, nothing else


def test_top_k_one_is_greedy():
    lg = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 256)).astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    assert torch.equal(tsampler.temperature_sample(gen, lg, 0.7, top_k=1),
                       tsampler.greedy(lg))
    with pytest.raises(ValueError):
        tsampler.sample(lg, method="temperature")
    with pytest.raises(ValueError):
        tsampler.sample(lg, method="nucleus")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generate_top_k_one_equals_greedy(pair, jax_runs, layout):
    """``sampler="temperature"`` with ``top_k=1`` through the engine (exit
    logits, cloud logits, the first token) gives the JAX greedy streams."""
    prompts = [pair[3][i] for i in SCENARIOS["async-inf-deadline"][1]]
    got = ServingSystem(pair[2], CollmConfig(
        theta=THETA, kv_layout=layout)).generate(
        prompts, 12, num_slots=2, sampler="temperature", temperature=0.7,
        top_k=1)
    want = jax_runs[layout, "sync"]
    assert got["tokens"] == want["tokens"]
    for name in ("exits_l1", "exits_l2", "cloud_requests"):
        assert getattr(got["stats"], name) == getattr(want["stats"], name)


@pytest.mark.parametrize("mode", ["collm", "standalone", "cloud"])
def test_same_seed_same_stream(pair, mode):
    prompts = pair[3]
    kw = dict(mode=mode, num_slots=2, sampler="temperature",
              temperature=0.8, top_k=50)
    runs = [ServingSystem(pair[2], CollmConfig(theta=THETA)).generate(
        prompts, 12, seed=seed, **kw)["tokens"] for seed in (0, 0, 1)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(len(t) == 12 and 0 <= min(t) and max(t) < 256
               for t in runs[0])
    greedy = ServingSystem(pair[2], CollmConfig(theta=THETA)).generate(
        prompts, 12, mode=mode, num_slots=2)["tokens"]
    assert runs[0] != greedy


def test_deadline_accounting_identity(pair):
    """``tests/test_async_channel.py``'s identity under misses: every
    below-θ decode position is a cloud reply or a deadline miss."""
    prompts = pair[3][:3]
    got = ServingSystem(pair[2], CollmConfig(theta=0.8)).generate(
        prompts, 12, num_slots=2, tick_time_s=0.005,
        channel=ttransport.ScriptedChannel([0.5], deadline_s=0.02))
    st = got["stats"]
    assert st.cloud_requests <= len(prompts)
    assert st.deadline_misses + st.exits_l1 + st.exits_l2 >= 11 * len(prompts)
    assert got["late_drops"] == st.deadline_misses
    assert math.isfinite(got["virtual_time"])
