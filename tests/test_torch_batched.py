"""PyTorch port, slice level: the batched engine (``ServingSystem.generate``
over ``BatchScheduler``) on the CPU against the JAX package's, on the
briefly trained tiny model (``tiny_trained``, weights carried across by
``repro_torch.bridge.params_from_jax``).

Greedy token streams must be identical, and so must the per-client and
aggregate ``GenStats`` counters (tokens, exits at l_ee1 / l_ee2, cloud
requests, upload bytes), the content manager's stats and the page pool's,
over KV layouts dense / paged float32 / paged int8, modes collm /
standalone / cloud, θ in {0.2, 0.8, 1.0}, wire float16 / int8 and backfill
on / off, with more prompts than slots so that slots refill and freed
pages are reused.  Exit confidences agree to 1e-5.  The tiny model's
confidences stay below 0.6: θ = 0.8 sends every token to the cloud, θ = 0.2
mixes exits and cloud requests.

Also against JAX: a small pool back-pressures admission, EOS frees a
slot for the next request, and ``tick_time_s`` gives the same virtual
times.  The engine's own properties (paged equals dense, ``generate``
equals ``generate_sequential``, masked rows, refused options) are in
``tests/test_torch_batched_port.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402

MAX_NEW = 12
SLOTS = 3
LENS = (8, 11, 9, 12, 10)
COUNTERS = ("tokens", "exits_l1", "exits_l2", "cloud_requests",
            "upload_bytes")
LAYOUTS = {"dense": dict(kv_layout="dense"),
           "paged": dict(kv_layout="paged"),
           "paged-int8": dict(kv_layout="paged", kv_dtype="int8")}

CASES = [(layout, mode, theta, wire, backfill)
         for layout in LAYOUTS
         for mode, theta, wire, backfill in (
             ("collm", 0.2, "float16", False),
             ("collm", 0.2, "int8", True),
             ("collm", 0.8, "float16", True),
             ("collm", 1.0, "int8", False),
             ("standalone", 0.2, "float16", False),
             ("cloud", 1.0, "float16", False))]


@pytest.fixture(scope="module")
def pair(tiny_trained):
    jm = tiny_trained["model"]
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, tiny_trained["params"]), tcfg))
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(n) for n in LENS]
    return jm, tiny_trained["params"], tm, prompts


def _systems(pair, **ccfg):
    jm, params, tm, _ = pair
    return (JServingSystem(jm, params, JCollmConfig(**ccfg)),
            ServingSystem(tm, CollmConfig(**ccfg)))


def _assert_same(got, want):
    assert got["tokens"] == want["tokens"]
    for g, w in zip(got["per_client"], want["per_client"]):
        for name in COUNTERS:
            assert getattr(g, name) == getattr(w, name), name
    for name in COUNTERS:
        assert getattr(got["stats"], name) == getattr(want["stats"], name), \
            name
    assert got["cm_stats"] == want["cm_stats"]
    assert got["pool_stats"] == want["pool_stats"]
    assert got["num_slots"] == want["num_slots"]
    np.testing.assert_allclose(np.asarray(got["stats"].confidences),
                               np.asarray(want["stats"].confidences),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout,mode,theta,wire,backfill", CASES)
def test_generate_matches_jax(pair, layout, mode, theta, wire, backfill):
    prompts = pair[3]
    jsys, tsys = _systems(pair, theta=theta, wire_format=wire,
                          backfill=backfill, **LAYOUTS[layout])
    want = jsys.generate(prompts, MAX_NEW, mode=mode, num_slots=SLOTS)
    got = tsys.generate(prompts, MAX_NEW, mode=mode, num_slots=SLOTS)
    _assert_same(got, want)
    if (mode, theta) == ("collm", 0.2):
        # the grid points that exercise all three outcomes of a tick
        st = got["stats"]
        assert min(st.exits_l1, st.exits_l2, st.cloud_requests) > 0, st
    # the pooled KV bytes are the JAX engine's, layout for layout
    jsched = next(iter(jsys._schedulers.values()))
    tsched = next(iter(tsys._schedulers.values()))
    assert tsched.kv_cache_bytes() == jsched.kv_cache_bytes()
    if tsched.pool is not None:
        assert tsched.pool.free_pages == tsched.pool.num_pages  # all retired


@pytest.mark.parametrize("theta", [0.2, 1.0])
def test_backpressure_small_pool_matches_jax(pair, theta):
    """A pool far smaller than the request load delays admissions: every
    stream completes with the dense tokens, and the pool never
    oversubscribes (4 pages of 16 tokens, 2 pages a stream)."""
    prompts = [p[:8] for p in pair[3]] + [pair[3][0][:8]]
    kw = dict(num_slots=4, max_seq=40)
    jsys, tsys = _systems(pair, theta=theta, kv_layout="paged")
    want = jsys.generate(prompts, 24, num_pages=4, **kw)
    got = tsys.generate(prompts, 24, num_pages=4, **kw)
    _assert_same(got, want)
    dense = ServingSystem(pair[2], CollmConfig(theta=theta)).generate(
        prompts, 24, **kw)
    assert got["tokens"] == dense["tokens"]
    sched = next(iter(tsys._schedulers.values()))
    assert sched.pool.stats.high_water <= 4
    assert sched.pool.free_pages == 4


@pytest.mark.parametrize("layout", ["paged", "paged-int8"])
def test_eos_frees_slot_for_refill(pair, layout):
    prompts = pair[3][:3]
    tsys = ServingSystem(pair[2], CollmConfig(theta=0.2, **LAYOUTS[layout]))
    base = tsys.generate(prompts, MAX_NEW, num_slots=1)
    eos = base["tokens"][0][2]
    cut = ServingSystem(pair[2], CollmConfig(
        theta=0.2, **LAYOUTS[layout])).generate(prompts, MAX_NEW,
                                                num_slots=1, eos_id=eos)
    first = base["tokens"][0].index(eos)
    assert cut["tokens"][0] == base["tokens"][0][:first + 1]
    assert all(len(t) >= 1 for t in cut["tokens"])
    jsys = JServingSystem(pair[0], pair[1], JCollmConfig(
        theta=0.2, **LAYOUTS[layout]))
    assert cut["tokens"] == jsys.generate(prompts, MAX_NEW, num_slots=1,
                                          eos_id=eos)["tokens"]


def test_virtual_time_matches_jax(pair):
    """``tick_time_s`` prices each tick in virtual time: the run's virtual
    makespan and every stream's time to first token and inter-token gaps
    are the JAX engine's."""
    jsys, tsys = _systems(pair, theta=0.2, kv_layout="paged")
    want = jsys.generate(pair[3], MAX_NEW, num_slots=SLOTS, tick_time_s=0.01)
    got = tsys.generate(pair[3], MAX_NEW, num_slots=SLOTS, tick_time_s=0.01)
    assert got["tokens"] == want["tokens"]
    assert got["virtual_time"] == pytest.approx(want["virtual_time"])
    assert got["late_drops"] == want["late_drops"] == 0
    assert got["channel_stats"] == want["channel_stats"]
    for name in ("ttft_s", "token_lat_s"):
        np.testing.assert_allclose(getattr(got["stats"], name),
                                   getattr(want["stats"], name), atol=1e-9)
