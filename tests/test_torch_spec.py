"""PyTorch port, slice level: speculative edge drafting with cloud
verification and rewind (``CollmConfig.speculative`` / ``spec_k``), and the
fused adaptive step, against the JAX package's, on the CPU, on the briefly
trained tiny model (``tiny_trained``, weights carried across by
``repro_torch.bridge.params_from_jax``).

Scenarios, after the JAX package's tests:

  * ``tests/test_spec_draft.py`` (8): config validation, counter
    aggregation, k-token drafts (k = 1, 2, 4, 8 on dense and paged KV)
    equal to the blocking stream, k = 1 as the classic speculative path,
    backfill, the latency-trace equivalence and the deadline conservation
    properties (three fixed seeds each in place of Hypothesis' draws), and
    whole-draft commits on deadline misses;
  * a fault of the JAX package the port does not copy: stale uploads of
    rewound positions crowd the content manager's window and the JAX
    engine raises ``KeyError`` (``test_rewind_releases_stale_uploads``);
  * ``tests/test_async_channel.py::test_speculative_matches_blocking``:
    the k = 1 cases of ``test_spec_draft_matches_jax`` are that test's
    configuration (θ = 0.8, ``AsyncSimChannel(WIFI, service_s=0.004)``,
    tick 10 ms, 2 slots, 12 new tokens) on both layouts;
  * the speculative tests of ``tests/test_cloud_batcher.py``: drafts
    through one ``CloudBatcher`` for three engines, and the wire billing of
    k-token verification requests (with and without backfill, and across
    the cancels of a rewind-heavy run);
  * ``tests/test_collm_invariants.py`` (6) and
    ``tests/test_paged_kv.py::test_fused_step_paged_matches_dense``: the
    fused step, held to JAX's ``fused_step`` tick by tick (tokens,
    ``need_rows``, cloud logits to 1e-5, ring counts), and
    ``edge_step_masked``.

Every engine case holds the tokens, every ``GenStats`` counter, the accept
lengths, stall/overlap/time to first token/inter-token gaps (to 1e-9),
``virtual_time`` (to 1e-9), ``late_drops`` and ``channel_stats`` equal to
JAX's; each JAX result is computed once per module.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.netsim import NetworkParams as JNetworkParams  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro.serving.mesh_exec import mesh_context  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.exits import (ExitDecision,  # noqa: E402
                                    first_confident_exit)
from repro_torch.core.netsim import NetworkParams  # noqa: E402
from repro_torch.core.transport import (TOKEN_BYTES,  # noqa: E402
                                        draft_request_bytes,
                                        hidden_wire_bytes)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import (GenStats, ServingSystem,  # noqa: E402
                                        _aggregate)

WIFI = dict(up_bw=3.8e6, down_bw=8e6, rtt=0.003)
COUNTERS = [f.name for f in dataclasses.fields(GenStats)
            if f.type in (int, "int")]
TIMES = ("stall_s", "overlap_s", "ttft_s", "token_lat_s")
MAX_NEW = 12
PROMPT_LENS = (8, 11, 9)
SEEDS = (0, 1, 2)


def _sim(mod, **kw):
    net = (JNetworkParams if mod is jtransport else NetworkParams)(**WIFI)
    return mod.AsyncSimChannel(net, **kw)


def bridge(jm, params):
    """The port's model with the JAX params' weights."""
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg))
    return tm


_JAX_STEPS = {}


def jax_system(jm, params, **ccfg_kw):
    """A JAX ``ServingSystem`` whose CoLLM shares the jitted steps of every
    earlier one on the same model with the same θ and wire format.  The
    steps read only those two fields of their config (the engine reads the
    rest), so a config that differs in speculation, preemption, backfill
    or KV layout alone needs no new trace; jit still traces again for new
    cache shapes."""
    system = JServingSystem(jm, params, JCollmConfig(**ccfg_kw))
    ccfg = system.collm.ccfg
    key = (id(jm), ccfg.theta, ccfg.wire_format)
    system.collm._mesh_ctx = _JAX_STEPS.setdefault(
        key, mesh_context(system.collm))
    return system


def assert_same_run(got, want):
    """A port result equals a JAX result: streams, every counter and
    virtual-time list, the accept lengths, and the run-level results."""
    assert got["tokens"] == want["tokens"]
    for g, w in zip(got["per_client"] + [got["stats"]],
                    want["per_client"] + [want["stats"]]):
        for name in COUNTERS:
            assert getattr(g, name) == getattr(w, name), name
        assert g.accept_lens == w.accept_lens
        for name in TIMES:
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       atol=1e-9, rtol=0, err_msg=name)
    assert got["virtual_time"] == pytest.approx(want["virtual_time"],
                                                abs=1e-9, rel=0)
    for key in ("late_drops", "channel_stats", "pool_stats", "preemptions",
                "oops", "n_engines"):
        assert got.get(key) == want.get(key), key
    if "batcher" in want:
        drop = lambda row: {k: v for k, v in row.items()  # noqa: E731
                            if k != "cloud_time_s"}
        assert drop(got["batcher"]) == drop(want["batcher"])


def _check_accept_histogram(stats, k: int) -> None:
    assert all(0 <= a <= k for a in stats.accept_lens)
    assert stats.accepted_tokens == sum(stats.accept_lens)
    assert stats.accepted_tokens <= stats.draft_tokens


@pytest.fixture(scope="module")
def pair(tiny_trained):
    jm = tiny_trained["model"]
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(n) for n in PROMPT_LENS]
    return jm, tiny_trained["params"], bridge(jm, tiny_trained["params"]), \
        prompts


class _Runs:
    """Memoised runs of both packages, one system per (package, config) so
    that each JAX config compiles once."""

    def __init__(self, pair):
        self.jm, self.params, self.tm, self.prompts = pair
        self._systems, self._runs = {}, {}

    def system(self, jax_side: bool, ccfg_kw: dict):
        key = (jax_side, tuple(sorted(ccfg_kw.items())))
        if key not in self._systems:
            self._systems[key] = (
                jax_system(self.jm, self.params, **ccfg_kw) if jax_side
                else ServingSystem(self.tm, CollmConfig(**ccfg_kw)))
        return self._systems[key]

    def get(self, jax_side: bool, ccfg_kw: dict, channel=None, **kw):
        """``channel``: a factory over a transport module, named by
        ``kw["_ch"]`` in the memo key."""
        ch_name = kw.pop("_ch", None)
        key = (jax_side, tuple(sorted(ccfg_kw.items())), ch_name,
               tuple(sorted(kw.items())))
        if key not in self._runs:
            mod = jtransport if jax_side else ttransport
            if channel is not None:
                kw["channel"] = channel(mod)
            self._runs[key] = self.system(jax_side, ccfg_kw).generate(
                self.prompts, MAX_NEW, mode="collm", num_slots=2, **kw)
        return self._runs[key]

    def both(self, ccfg_kw, channel=None, **kw):
        return (self.get(False, ccfg_kw, channel, **dict(kw)),
                self.get(True, ccfg_kw, channel, **dict(kw)))


@pytest.fixture(scope="module")
def runs(pair):
    return _Runs(pair)


def _draft(runs, channel, ch_name, *, k, layout="dense", backfill=False,
           fallback_after=0):
    ccfg = dict(theta=0.8, kv_layout=layout, speculative=True, spec_k=k,
                backfill=backfill)
    got, want = runs.both(ccfg, channel, _ch=ch_name, tick_time_s=0.01,
                          fallback_after=fallback_after)
    assert_same_run(got, want)
    return got


def _trace(seed, hi):
    return np.random.default_rng(seed).uniform(0.0, hi, size=16).tolist()


# ---------------------------------------------------------------------------
# tests/test_spec_draft.py
# ---------------------------------------------------------------------------
def test_spec_k_config_validation(pair):
    tm = pair[2]
    assert CollmConfig().spec_k == 1               # default = classic path
    CoLLM(tm, CollmConfig(speculative=True, spec_k=8))
    for kw in (dict(speculative=True, spec_k=0), dict(spec_k=2)):
        with pytest.raises(ValueError):
            CoLLM(tm, CollmConfig(**kw))
        with pytest.raises(ValueError):
            JCoLLM(pair[0], JCollmConfig(**kw))


def test_draft_counters_aggregate():
    agg = _aggregate([GenStats(draft_tokens=4, accepted_tokens=3,
                               accept_lens=[2, 1]),
                      None,
                      GenStats(draft_tokens=2, accept_lens=[0, 0])])
    assert (agg.draft_tokens, agg.accepted_tokens) == (6, 3)
    assert agg.accept_lens == [2, 1, 0, 0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_spec_draft_matches_jax(runs, layout, k):
    """k-token drafts equal JAX's run and converge to the blocking stream
    with the blocking run's event mix; no stall, hidden flight time."""
    r = _draft(runs, lambda m: _sim(m, service_s=0.004), "sim", k=k,
               layout=layout)
    base = runs.get(False, dict(theta=0.8, kv_layout=layout))
    assert r["tokens"] == base["tokens"]
    bs, rs = base["stats"], r["stats"]
    assert (bs.tokens, bs.cloud_requests, bs.exits_l1, bs.exits_l2) == \
        (rs.tokens, rs.cloud_requests, rs.exits_l1, rs.exits_l2)
    assert rs.stall_s == 0.0 and rs.overlap_s > 0.0
    assert rs.draft_tokens > 0
    _check_accept_histogram(rs, k)


def test_spec_k1_is_the_classic_speculative_path(runs):
    """A config that never mentions spec_k runs as an explicit spec_k=1;
    every verification request carries one draft token."""
    explicit = _draft(runs, lambda m: _sim(m, service_s=0.004), "sim", k=1)
    default = ServingSystem(runs.tm, CollmConfig(
        theta=0.8, speculative=True)).generate(
        runs.prompts, MAX_NEW, num_slots=2, tick_time_s=0.01,
        channel=_sim(ttransport, service_s=0.004))
    assert_same_run(default, explicit)
    d = default["stats"]
    assert default["channel_stats"]["requests"] == d.draft_tokens
    assert len(d.accept_lens) + default["late_drops"] <= d.draft_tokens
    _check_accept_histogram(d, 1)


def test_spec_draft_backfill_matches_jax(runs):
    r = _draft(runs, lambda m: _sim(m, service_s=0.004), "sim", k=4,
               backfill=True)
    assert r["tokens"] == runs.get(False, dict(theta=0.8))["tokens"]
    _check_accept_histogram(r["stats"], 4)


@pytest.mark.parametrize("seed", SEEDS)
def test_draft_equivalence_over_latency_traces(runs, seed):
    """Whatever the latency trace, with no deadline the reconcile converges
    to the blocking stream; k, layout and backfill drawn from the seed."""
    rng = np.random.default_rng(100 + seed)
    k = int(rng.choice([1, 2, 4, 8]))
    layout = str(rng.choice(["dense", "paged"]))
    backfill = bool(rng.integers(2))
    lat = _trace(seed, 0.12)
    r = _draft(runs, lambda m: m.ScriptedChannel(lat, deadline_s=math.inf),
               f"trace{seed}", k=k, layout=layout, backfill=backfill)
    assert r["tokens"] == runs.get(False, dict(theta=0.8,
                                               kv_layout=layout))["tokens"]
    _check_accept_histogram(r["stats"], k)


@pytest.mark.parametrize("seed", SEEDS)
def test_draft_lifecycle_conservation_under_deadlines(runs, seed):
    """Finite deadlines: whole-draft misses, partial accepts, rewinds and
    fallback may all fire; streams complete and every token is accounted
    to exactly one serving event."""
    k = (1, 4, 8)[seed]
    lat = _trace(seed, 0.08)
    r = _draft(runs, lambda m: m.ScriptedChannel(lat, deadline_s=0.03),
               f"deadline{seed}", k=k, fallback_after=3)
    agg = r["stats"]
    assert all(len(t) == MAX_NEW for t in r["tokens"])
    _check_accept_histogram(agg, k)
    served = agg.exits_l1 + agg.exits_l2 + agg.cloud_requests
    assert agg.tokens - len(PROMPT_LENS) <= served <= agg.tokens
    assert agg.accepted_tokens <= agg.cloud_requests
    assert len(agg.accept_lens) <= agg.draft_tokens


def test_deadline_miss_commits_whole_draft(runs):
    r = _draft(runs, lambda m: m.ScriptedChannel([0.5], deadline_s=0.02),
               "miss", k=4)
    st_ = r["stats"]
    assert all(len(t) == MAX_NEW for t in r["tokens"])
    assert st_.deadline_misses > 0 and st_.draft_tokens > 0
    assert st_.accepted_tokens == 0 and st_.accept_lens == []
    assert st_.cloud_requests <= len(PROMPT_LENS)
    assert r["late_drops"] == st_.deadline_misses
    assert st_.exits_l2 >= st_.draft_tokens


@pytest.mark.parametrize("k", [1, 4])
def test_rewind_releases_stale_uploads(runs, k):
    """A fault of the JAX package the port does not copy.  After a rewind,
    the uploads of discarded confident ticks stay in the content manager's
    8-entry window in JAX; once eight of them sit above the rewound
    position, each new upload below them is released on arrival and the
    draft that takes it raises ``KeyError``.  The port releases them at the
    rewind: on untrained weights (rewinds everywhere) at a median θ with
    150 ms replies, JAX raises and the port's streams equal its blocking
    run, with no upload left pending."""
    jm = runs.jm
    params = jm.init(jax.random.PRNGKey(1))
    tm = bridge(jm, params)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, jm.cfg.vocab_size, size=n) for n in (8, 10, 9)]
    full = ServingSystem(tm, CollmConfig(theta=1.0)).generate(
        prompts, 32, num_slots=2)
    c = sorted(l1 for l1, _ in full["stats"].confidences)
    theta = c[len(c) // 2]
    base = ServingSystem(tm, CollmConfig(theta=theta)).generate(
        prompts, 32, num_slots=2)
    ccfg = dict(theta=theta, speculative=True, spec_k=k)
    kw = dict(num_slots=2, tick_time_s=0.01)
    with pytest.raises(KeyError, match="no uploaded state"):
        jax_system(jm, params, **ccfg).generate(
            prompts, 32, channel=jtransport.ScriptedChannel(
                [0.15], deadline_s=math.inf), **kw)
    r = ServingSystem(tm, CollmConfig(**ccfg)).generate(
        prompts, 32, channel=ttransport.ScriptedChannel(
            [0.15], deadline_s=math.inf), **kw)
    assert r["tokens"] == base["tokens"]
    assert r["stats"].spec_rewinds > 0
    assert all(c["pending"] == 0 for c in r["cm_stats"].values())


# ---------------------------------------------------------------------------
# tests/test_cloud_batcher.py: drafts through the batcher, wire billing
# ---------------------------------------------------------------------------
def test_speculative_multi_client_reconciles(runs):
    """Speculative decode through the batcher (queued-request cancels and
    pooled-cache invalidation on rewind) equals JAX and converges to the
    independent blocking streams."""
    out = []
    for jax_side, mod in ((False, ttransport), (True, jtransport)):
        svc = mod.CloudServicePoint(0.004, batch_window_s=0.002,
                                    max_batch=3)
        chans = [_sim(mod, service=svc) for _ in runs.prompts]
        out.append(runs.system(jax_side, dict(
            theta=0.8, speculative=True)).generate_multi(
            runs.prompts, 8, cloud_batch=True, channels=chans,
            tick_time_s=0.01))
    got, want = out
    assert_same_run(got, want)
    ref = [ServingSystem(runs.tm, CollmConfig(theta=0.8)).generate(
        [p], 8, num_slots=1)["tokens"][0] for p in runs.prompts]
    assert got["tokens"] == ref
    assert got["stats"].stall_s == 0.0


def test_draft_request_bytes_unit():
    assert draft_request_bytes(1) == TOKEN_BYTES
    for k in (2, 4, 8):
        assert draft_request_bytes(k) == k * TOKEN_BYTES
        assert draft_request_bytes(k) == jtransport.draft_request_bytes(k)


def _billing(r, ch, d_model, prompts):
    st = r["stats"]
    prompt_bytes = sum(hidden_wire_bytes(d_model, "float16", seq=len(p))
                       for p in prompts)
    assert ch.stats.bytes_up == (st.upload_bytes - prompt_bytes
                                 + TOKEN_BYTES * st.draft_tokens)
    assert ch.stats.bytes_down == TOKEN_BYTES * st.draft_tokens
    cm_bytes = sum(c["bytes_received"] for c in r["cm_stats"].values())
    assert cm_bytes == st.upload_bytes - prompt_bytes


@pytest.mark.parametrize("backfill", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_draft_request_bills_k_tokens_once(runs, backfill, k):
    """Uploaded hidden rows are billed once at upload, each verification
    request adds its k token ids up and k verified ids down."""
    out = []
    for jax_side, mod in ((False, ttransport), (True, jtransport)):
        ch = mod.SyncChannel()
        r = runs.system(jax_side, dict(
            theta=0.8, speculative=True, spec_k=k, backfill=backfill)
        ).generate(runs.prompts[:2], 10, num_slots=2, channel=ch)
        out.append((r, ch))
    (got, ch), (want, _) = out
    assert_same_run(got, want)
    assert got["stats"].draft_tokens > 0
    _billing(got, ch, runs.jm.cfg.d_model, runs.prompts[:2])


def test_draft_resubmit_after_cancel_not_double_billed(runs):
    """Untrained weights: the exit heads disagree with the cloud almost
    everywhere, so the run is rewind-heavy; the billing identity holds
    through every cancel and resubmit, and the run equals JAX's."""
    jm = runs.jm
    params = jm.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, jm.cfg.vocab_size, size=n) for n in (8, 10, 9)]
    ccfg = dict(theta=0.8, speculative=True, spec_k=4)
    ch = _sim(ttransport, service_s=0.004)
    got = ServingSystem(bridge(jm, params), CollmConfig(**ccfg)).generate(
        prompts, 12, num_slots=2, channel=ch, tick_time_s=0.01)
    want = jax_system(jm, params, **ccfg).generate(
        prompts, 12, num_slots=2, channel=_sim(jtransport, service_s=0.004),
        tick_time_s=0.01)
    assert_same_run(got, want)
    assert got["stats"].spec_rewinds > 0
    _billing(got, ch, jm.cfg.d_model, prompts)


# ---------------------------------------------------------------------------
# the fused step (tests/test_collm_invariants.py, tests/test_paged_kv.py)
# ---------------------------------------------------------------------------
def _fused_port(tm, prompt, steps, prefill=True, **kw):
    """Decode ``steps`` fused steps of the port from a prompt (prefilled)
    or from its first token (``prefill=False``, pos 0); returns the
    per-tick (tokens, info), the first entry the prompt's token."""
    co = CoLLM(tm, CollmConfig(**kw))
    st = co.init_fused_state(prompt.shape[0], 64)
    with torch.no_grad():
        if prefill:
            _, h1, st["edge"] = co.edge_prefill(
                {"tokens": torch.as_tensor(prompt, dtype=torch.long)},
                st["edge"])
            logits, st["cloud"] = co.cloud_prefill(h1, st["cloud"])
            tok, s = logits[:, 0].argmax(-1).to(torch.int32), prompt.shape[1]
        else:
            tok, s = torch.as_tensor(prompt[:, 0]), 0
        out = [(tok.numpy(), None)]
        for t in range(steps):
            tok, info, st = co.fused_step(tok[:, None].long(), st, s + t)
            out.append((tok.numpy(), dict(info, count=st["count"])))
    return out


def _fused_jax(jm, params, prompt, steps, prefill=True, **kw):
    """``_fused_port`` for JAX's ``fused_step`` (jitted)."""
    co = JCoLLM(jm, JCollmConfig(**kw))
    st = co.init_fused_state(prompt.shape[0], 64)
    if prefill:
        _, h1, st["edge"] = co.edge_prefill(
            params, {"tokens": jnp.asarray(prompt)}, st["edge"])
        logits, st["cloud"] = co.cloud_prefill(params, h1, st["cloud"])
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        s = prompt.shape[1]
    else:
        tok, s = jnp.asarray(prompt[:, 0]), 0
    out = [(np.asarray(tok), None)]
    step = jax.jit(co.fused_step)
    for t in range(steps):
        tok, info, st = step(params, tok[:, None], st,
                             jnp.asarray(s + t, jnp.int32))
        out.append((np.asarray(tok), dict(info, count=st["count"])))
    return out


def _fused_pair(pair, prompt, steps, prefill=True, **kw):
    jm, params, tm, _ = pair
    return (_fused_jax(jm, params, prompt, steps, prefill, **kw),
            _fused_port(tm, prompt, steps, prefill, **kw))


# a float32 wire: a float16 or int8 wire rounds the uploaded hidden, and
# where the two packages' hiddens straddle a rounding boundary (they agree
# to ~1e-6) the cloud logits differ by up to ~3e-5
# (the JAX package prefills no paged fused state: the paged case starts
# from one token at position 0, as tests/test_paged_kv.py does)
FUSED = {
    "release": dict(theta=0.5),
    "backfill": dict(theta=0.5, backfill=True, max_pending=3),
    "speculative": dict(theta=0.5, speculative=True),
    "paged-backfill": dict(theta=0.5, backfill=True, kv_layout="paged",
                           prefill=False),
}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_step_matches_jax(pair, name):
    """Tick by tick, over a float32 wire: tokens, exits, ``need_rows``, the
    cloud logits (to 1e-5) and the ring counts equal JAX's
    ``fused_step``."""
    prompt = np.asarray(SyntheticCorpus(DataConfig(
        vocab_size=pair[0].cfg.vocab_size, seq_len=64, batch_size=1,
        seed=3)).prompts(3, 10))
    jout, tout = _fused_pair(pair, prompt, 12, wire_format="float32",
                             **FUSED[name])
    assert np.array_equal(jout[0][0], tout[0][0])
    for (jt, ji), (tt, ti) in zip(jout[1:], tout[1:]):
        assert np.array_equal(jt, tt)
        for key in ("exited", "need_rows", "count"):
            assert np.array_equal(np.asarray(ji[key]), ti[key].numpy()), key
        assert bool(ji["need_cloud"]) == bool(ti["need_cloud"])
        np.testing.assert_allclose(ti["cloud_logits"].numpy(),
                                   np.asarray(ji["cloud_logits"]),
                                   atol=1e-5, rtol=0)
    need = [int(ti["need_rows"].sum()) for _, ti in tout[1:]]
    exits = [int(ti["exited"].sum()) for _, ti in tout[1:]]
    if name == "speculative":
        assert all(n == 3 for n in need)
    elif not FUSED[name].get("backfill"):
        assert need == [3 - e for e in exits]


@pytest.mark.parametrize("backfill", [False, True])
def test_theta1_exact_equivalence(pair, backfill):
    """θ above 1: every row needs the cloud, and the fused step with a
    float32 wire reproduces the undivided model's greedy stream."""
    jm, _, tm, _ = pair
    prompt = np.asarray(SyntheticCorpus(DataConfig(
        vocab_size=jm.cfg.vocab_size, seq_len=64, batch_size=1)).prompts(
        2, 10))
    tout = _fused_port(tm, prompt, 12, theta=1.1, wire_format="float32",
                       backfill=backfill)
    co = CoLLM(tm, CollmConfig(theta=1.1))
    with torch.no_grad():
        caches = tm.init_cache(2, 64)
        x, _, caches, _ = tm.prefill(
            {"tokens": torch.as_tensor(prompt, dtype=torch.long)}, caches)
        tok = tm.logits(x[:, -1:])[:, 0].argmax(-1).to(torch.int32)
        full = [tok.numpy()]
        for t in range(12):
            tok, _, caches = co.full_step(tok[:, None].long(), caches,
                                          10 + t)
            full.append(tok.numpy())
    assert np.array_equal(np.stack([t for t, _ in tout]), np.stack(full))
    assert all(bool(i["need_cloud"]) for _, i in tout[1:])


def test_fp16_wire_close(pair):
    prompt = np.asarray(SyntheticCorpus(DataConfig(
        vocab_size=pair[0].cfg.vocab_size, seq_len=64,
        batch_size=1)).prompts(2, 10))
    a = _fused_port(pair[2], prompt, 12, theta=1.1, wire_format="float32")
    b = _fused_port(pair[2], prompt, 12, theta=1.1, wire_format="float16")
    a, b = np.stack([t for t, _ in a]), np.stack([t for t, _ in b])
    assert float((a == b).mean()) > 0.9


def test_adaptive_exits_reduce_cloud(pair):
    """Cloud compute is gated per row: in release mode a row needs the
    cloud exactly when it did not exit."""
    prompt = np.asarray(SyntheticCorpus(DataConfig(
        vocab_size=pair[0].cfg.vocab_size, seq_len=64,
        batch_size=1)).prompts(2, 10))
    tout = _fused_port(pair[2], prompt, 16, theta=0.5)
    infos = [i for _, i in tout[1:]]
    n_cloud = sum(int(i["need_rows"].sum()) for i in infos)
    n_exits = sum(int(i["exited"].sum()) for i in infos)
    assert n_exits > 0
    assert n_cloud < 2 * len(infos) and n_cloud + n_exits == 2 * len(infos)


@pytest.mark.parametrize("theta", [0.8, 1.0])
def test_fused_step_paged_matches_dense(pair, theta):
    """The fused step through identity-mapped pages emits the dense
    layout's tokens and JAX's paged tokens."""
    tok0 = np.stack([SyntheticCorpus(DataConfig(
        vocab_size=pair[0].cfg.vocab_size, seq_len=64, batch_size=1,
        seed=s)).sample_tokens(1) for s in (0, 1)])
    kw = dict(prefill=False, theta=theta, backfill=True)
    dense = _fused_port(pair[2], tok0, 6, **kw)
    jout, paged = _fused_pair(pair, tok0, 6, kv_layout="paged", **kw)
    for toks in (dense, jout):
        np.testing.assert_array_equal(np.stack([t for t, _ in paged]),
                                      np.stack([t for t, _ in toks]))


def test_standalone_is_last_exit_greedy(pair):
    jm, params, tm, _ = pair
    prompt = np.asarray(SyntheticCorpus(DataConfig(
        vocab_size=jm.cfg.vocab_size, seq_len=64, batch_size=1)).prompts(
        1, 10))
    co, jco = CoLLM(tm, CollmConfig()), JCoLLM(jm, JCollmConfig())
    with torch.no_grad():
        caches = co.init_edge_cache(1, 64)
        _, _, caches = co.edge_prefill(
            {"tokens": torch.as_tensor(prompt, dtype=torch.long)}, caches)
        tok, d, _ = co.standalone_step(
            torch.as_tensor(prompt[:, -1:], dtype=torch.long), caches, 10)
    jc = jco.init_edge_cache(1, 64)
    _, _, jc = jco.edge_prefill(params, {"tokens": jnp.asarray(prompt)}, jc)
    jtok, jd, _ = jco.standalone_step(params, jnp.asarray(prompt[:, -1:]),
                                      jc, jnp.asarray(10, jnp.int32))
    assert tok.shape == (1,) and bool((d.confidence > 0).all())
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(d.confidence.numpy(),
                               np.asarray(jd.confidence), atol=1e-5)


def test_exit_selection_logic():
    def dec(logits):
        lg = torch.tensor(logits)
        p = torch.softmax(lg, -1)
        return ExitDecision(token=lg.argmax(-1).to(torch.int32),
                            confidence=p.max(-1).values)
    d1 = dec([[0.0, 5.0, 0.0], [1.0, 1.0, 1.0]])
    d2 = dec([[9.0, 0.0, 0.0], [9.0, 0.0, 0.0]])
    tok, exited, idx = first_confident_exit({1: d1, 2: d2}, theta=0.9)
    assert int(tok[0]) == 1 and bool(exited[0]) and int(idx[0]) == 0
    assert int(tok[1]) == 0 and bool(exited[1]) and int(idx[1]) == 1
    _, exited2, idx2 = first_confident_exit({1: d1, 2: d2}, theta=1.01)
    assert not bool(exited2.any()) and bool((idx2 == 2).all())


def test_edge_cloud_partition_covers_model(pair):
    jm, _, tm, _ = pair
    co, jco = CoLLM(tm, CollmConfig()), JCoLLM(jm, JCollmConfig())
    assert (co.edge_segs, co.cloud_segs) == (jco.edge_segs, jco.cloud_segs)
    layers = lambda segs: {l for si in segs  # noqa: E731
                           for l in range(tm.segments[si].start,
                                          tm.segments[si].end)}
    n = tm.cfg.n_layers
    assert layers(co.edge_segs) == set(range(co.l_ee2))
    assert layers(co.cloud_segs) == set(range(co.l_ee1, n))
    assert layers(co.edge_segs) & layers(co.cloud_segs) == \
        set(range(co.l_ee1, co.l_ee2))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_edge_step_masked_matches_jax(pair, layout):
    """Rows masked out of an edge step keep every cache leaf bit for bit;
    the masked-in rows' exits and upload equal JAX's masked step."""
    jm, params, tm, _ = pair
    kw = dict(theta=0.5, kv_layout=layout)
    co, jco = CoLLM(tm, CollmConfig(**kw)), JCoLLM(jm, JCollmConfig(**kw))
    b, tbl, jtbl = 3, None, None
    if layout == "dense":
        caches, jc = co.init_edge_cache(b, 32), jco.init_edge_cache(b, 32)
    else:
        caches = co.init_edge_cache_paged(b, 6, 16)
        jc = jco.init_edge_cache_paged(b, 6, 16)
        t = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
        tbl, jtbl = torch.as_tensor(t), jnp.asarray(t)
    rng = np.random.default_rng(0)
    pos = np.array([5, 17, 30], np.int32)
    with torch.no_grad():
        for p0 in range(3):                  # some history, every row
            toks = rng.integers(0, 256, (b, 1)).astype(np.int32)
            co.edge_step(torch.as_tensor(toks, dtype=torch.long), caches,
                         torch.as_tensor(pos - 3 + p0), tbl)
            jc = jco.edge_step(params, jnp.asarray(toks), jc,
                               jnp.asarray(pos - 3 + p0), jtbl).caches
        before = [v.clone() for layers in caches.values() for c in layers
                  for v in c["self"].values()]
        toks = rng.integers(0, 256, (b, 1)).astype(np.int32)
        mask = np.array([True, False, True])
        out = co.edge_step_masked(torch.as_tensor(toks, dtype=torch.long),
                                  caches, torch.as_tensor(pos),
                                  torch.as_tensor(mask), tbl)
    jout = jco.edge_step_masked(params, jnp.asarray(toks), jc,
                                jnp.asarray(pos), jnp.asarray(mask), jtbl)
    rows = [0, 2]
    assert np.array_equal(out.token.numpy()[rows],
                          np.asarray(jout.token)[rows])
    np.testing.assert_allclose(out.upload["data"].float().numpy()[rows],
                               np.asarray(jout.upload["data"],
                                          np.float32)[rows], atol=1e-2)
    after = [v for layers in out.caches.values() for c in layers
             for v in c["self"].values()]
    for a, w in zip(before, after):
        if layout == "dense":
            assert torch.equal(a[1], w[1])           # masked-out row
        else:
            assert torch.equal(a[3:5], w[3:5])       # its pages
