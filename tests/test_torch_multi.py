"""PyTorch port, slice level: ``ServingSystem.generate_multi`` (N
single-slot edge engines sharing one cloud, ``run_multi``) against the JAX
package's, on the CPU, on the briefly trained tiny model
(``tiny_trained``, weights carried across by
``repro_torch.bridge.params_from_jax``).

Cases: ``cloud_batch`` True (one ``CloudBatcher`` computes every engine's
below-θ rows in masked waves) and False (each engine its own cloud), on
dense and paged KV, over ``SyncChannel``s and over ``AsyncSimChannel``s
sharing one FIFO or one batching ``CloudServicePoint``; the standalone and
cloud modes; more clients than engines (cloud rows released and
reassigned); deadline misses that cancel queued batcher entries.  Each
case holds the tokens, every ``GenStats`` counter and virtual-time list,
``virtual_time``, ``late_drops``, ``channel_stats``, the shared service
point's ``batches`` / ``busy_s`` and the ``batcher`` row (all but its host
``cloud_time_s``) equal to JAX's.  The batcher's methods that serve
features not ported yet raise, naming their ROADMAP item; those of draft
verification and preemption run (``tests/test_torch_spec.py`` and
``tests/test_torch_preemption.py`` hold them against JAX).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import transport as jtransport  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.netsim import NetworkParams as JNetworkParams  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.core.netsim import NetworkParams  # noqa: E402
from repro_torch.core.paging import pages_needed  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.cloud_batcher import CloudBatcher  # noqa: E402
from repro_torch.serving.engine import GenStats, ServingSystem  # noqa: E402

WIFI = dict(up_bw=3.8e6, down_bw=8e6, rtt=0.003)
COUNTERS = [f.name for f in dataclasses.fields(GenStats)
            if f.type in (int, "int")]
TIMES = ("stall_s", "overlap_s", "ttft_s", "token_lat_s")
MAX_NEW = 8


def _channels(mod, kind, n):
    """n channels of ``kind`` over a transport module, and the service
    point they share (None for SyncChannels)."""
    if kind == "sync":
        return None, None
    net = (JNetworkParams if mod is jtransport else NetworkParams)(**WIFI)
    if kind == "scripted":
        return [mod.ScriptedChannel([0.5], deadline_s=0.02)
                for _ in range(n)], None
    svc = (mod.CloudServicePoint(0.008) if kind == "fifo" else
           mod.CloudServicePoint(0.008, batch_window_s=0.004, max_batch=n))
    return [mod.AsyncSimChannel(net, service=svc) for _ in range(n)], svc


# name -> (ccfg kwargs, prompt indices, generate_multi kwargs, channel kind)
CASES = {
    f"{layout}-{'batched' if cb else 'fifo'}-{kind}": (
        dict(theta=0.2, kv_layout=layout), (0, 1, 2, 3),
        dict(cloud_batch=cb, tick_time_s=0.01), kind)
    for layout in ("dense", "paged") for cb in (True, False)
    for kind in ("sync", "fifo", "batched")}
CASES.update({
    "standalone": (dict(theta=0.2), (0, 1), dict(mode="standalone"), "sync"),
    "cloud": (dict(theta=0.2), (0, 1), dict(mode="cloud"), "sync"),
    "more-clients-than-engines": (dict(theta=0.2, kv_layout="paged"),
                                  (0, 1, 2, 3, 4), dict(n_engines=2),
                                  "sync"),
    "more-clients-backfill": (dict(theta=0.2, backfill=True),
                              (0, 1, 2, 3, 4),
                              dict(n_engines=2, tick_time_s=0.01), "batched"),
    "deadline-misses-cancel": (dict(theta=0.8), (0, 1),
                               dict(tick_time_s=0.005), "scripted"),
})


@pytest.fixture(scope="module")
def pair(tiny_trained):
    jm = tiny_trained["model"]
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, tiny_trained["params"]), tcfg))
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(n) for n in (9, 10, 8, 11, 9)]
    return jm, tiny_trained["params"], tm, prompts


def _run(system, tmod, case, prompts):
    ckw, idx, kw, kind = CASES[case]
    ps = [prompts[i] for i in idx]
    n = kw.get("n_engines", len(ps))
    chans, svc = _channels(tmod, kind, n)
    r = system.generate_multi(ps, MAX_NEW, channels=chans, **kw)
    return r, (None if svc is None else (svc.batches, svc.requests,
                                         svc.busy_s))


@pytest.fixture(scope="module")
def jax_runs(pair):
    """Every case's JAX result, computed once; one system per config."""
    jm, params, _, prompts = pair
    systems, out = {}, {}
    for case, (ckw, _, _, _) in CASES.items():
        key = tuple(sorted(ckw.items()))
        if key not in systems:
            systems[key] = JServingSystem(jm, params, JCollmConfig(**ckw))
        out[case] = _run(systems[key], jtransport, case, prompts)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_generate_multi_matches_jax(pair, jax_runs, case):
    tsys = ServingSystem(pair[2], CollmConfig(**CASES[case][0]))
    got, svc = _run(tsys, ttransport, case, pair[3])
    want, want_svc = jax_runs[case]
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
    assert got["n_engines"] == want["n_engines"]
    assert got["late_drops"] == want["late_drops"]
    assert got["channel_stats"] == want["channel_stats"]
    if svc is not None:
        assert svc[:2] == want_svc[:2]
        assert svc[2] == pytest.approx(want_svc[2], abs=1e-9, rel=0)
    assert ("batcher" in got) == ("batcher" in want)
    if "batcher" in got:
        drop = lambda row: {k: v for k, v in row.items()  # noqa: E731
                            if k != "cloud_time_s"}
        assert drop(got["batcher"]) == drop(want["batcher"])
    if case.endswith("batched-batched"):
        assert got["batcher"]["mean_batch"] > 1.0
    if case == "deadline-misses-cancel":
        assert all(len(t) == MAX_NEW for t in got["tokens"])
        assert got["stats"].deadline_misses > 0
        assert got["batcher"]["cancelled"] > 0


def test_batched_equals_fifo_and_beats_it_in_virtual_time(pair, jax_runs):
    """The same streams with and without the batcher, and the batched
    cloud's makespan and busy time below the FIFO cloud's (the knee)."""
    for layout in ("dense", "paged"):
        b, b_svc = jax_runs[f"{layout}-batched-batched"]
        f, f_svc = jax_runs[f"{layout}-fifo-fifo"]
        tsys = ServingSystem(pair[2], CollmConfig(theta=0.2,
                                                  kv_layout=layout))
        got_b, got_b_svc = _run(tsys, ttransport, f"{layout}-batched-batched",
                                pair[3])
        got_f, got_f_svc = _run(tsys, ttransport, f"{layout}-fifo-fifo",
                                pair[3])
        assert got_b["tokens"] == got_f["tokens"] == b["tokens"]
        assert got_b["virtual_time"] < got_f["virtual_time"]
        assert got_b_svc[2] < got_f_svc[2]
        assert (b["virtual_time"] < f["virtual_time"]
                and b_svc[2] < f_svc[2])


UNPORTED = {"prefix_hit": "A.5", "admit_begin": "A.5", "admit_chunk": "A.5",
            "pages_filled": "A.5"}


@pytest.mark.parametrize("method", sorted(UNPORTED))
def test_unported_batcher_methods_raise(pair, method):
    tsys = ServingSystem(pair[2], CollmConfig(kv_layout="paged"))
    batcher = CloudBatcher(tsys.collm, tsys.cloud.cm, 2, 32)
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP {UNPORTED[method]}")):
        getattr(batcher, method)("edge-0", 0)


@pytest.mark.parametrize("name,kw,item", [
    ("arrivals", dict(arrivals=[0.0, 0.1]), "A.6"),
    ("slo", dict(slo_tpot_s=0.05), "A.6")])
def test_generate_multi_refuses_unported_options(pair, name, kw, item):
    tsys = ServingSystem(pair[2], CollmConfig())
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"{name}: ROADMAP {item}")):
        tsys.generate_multi(pair[3][:2], 4, **kw)


@pytest.mark.parametrize("method", ["submit_draft", "invalidate", "restore",
                                    "swap_out", "swap_in"])
@torch.no_grad()
def test_batcher_draft_and_swap_methods_run(pair, method):
    """The five batcher methods refused before drafting and preemption
    were ported now run on a paged pool, each moving its counter."""
    tsys = ServingSystem(pair[2], CollmConfig(kv_layout="paged"))
    cm, collm = tsys.cloud.cm, tsys.collm
    batcher = CloudBatcher(collm, cm, 2, 32)
    prompt = torch.as_tensor(pair[3][0][None, :], dtype=torch.long)
    p_len = prompt.shape[1]
    _, h1, _ = collm.edge_prefill({"tokens": prompt},
                                  collm.init_edge_cache(1, p_len))
    batcher.admit("edge-0", h1, p_len, p_len + 8)
    pkts = [(p, ttransport.StatePacket(hidden=ttransport.quantize(
        h1[:, i:i + 1], "float16"))) for i, p in enumerate(
        (p_len, p_len + 1))]
    slot = cm.cloud_slot("edge-0")
    valid = lambda: sum(int((c["self"]["pos"] >= 0).sum())  # noqa: E731
                        for layers in batcher.caches.values()
                        for c in layers)
    if method == "submit_draft":
        group, row, packets = batcher.submit_draft("edge-0", pkts)
        assert (row, packets) == (slot, pkts)
        assert batcher.stats.requests == 1
        batcher.flush()
        assert group["all"].shape[:2] == (2, 2)       # (depth, rows)
        assert batcher.stats.steps == 1
    elif method == "invalidate":
        before = valid()
        batcher.invalidate("edge-0", 4)
        # 4 of the prompt's positions stay valid, in every cloud layer
        n_layers = sum(len(layers) for layers in batcher.caches.values())
        assert valid() == 4 * n_layers < before
    elif method == "restore":
        batcher.restore("edge-0", pkts)
        assert batcher.stats.restores == 1
        assert batcher.pool.owned_pages(slot) == pages_needed(p_len + 2, 16)
    else:
        snap = batcher.swap_out("edge-0")
        assert batcher.stats.swaps == 1
        assert cm.cloud_slot("edge-0") is None
        assert batcher.pool.free_pages == batcher.pool.num_pages
        if method == "swap_in":
            before = valid()
            batcher.swap_in("edge-0", snap)
            assert batcher.pool.owned_pages(cm.cloud_slot("edge-0")) == \
                len(snap["logical"])
            assert valid() > before == 0


def test_generate_multi_preempt_schedules_run(pair):
    """``preempt_schedules`` (refused before preemption was ported) runs:
    the scheduled engine is preempted once and resumes to the same
    streams."""
    ccfg = CollmConfig(theta=0.2, kv_layout="paged", preemption="recompute")
    base = ServingSystem(pair[2], ccfg).generate_multi(pair[3][:2], 6)
    r = ServingSystem(pair[2], ccfg).generate_multi(
        pair[3][:2], 6, preempt_schedules=[[(2, 0)], None])
    assert r["stats"].preemptions == 1 and base["stats"].preemptions == 0
    assert r["tokens"] == base["tokens"]
