"""PyTorch port, slice level: properties of the batched engine
(``ServingSystem.generate`` over ``BatchScheduler``) within the port, on
the CPU, on the briefly trained tiny model of ``tests/test_torch_batched.py``
(which holds the engine to the JAX package's streams and counters).

float32 pages give the dense layout's streams; ``generate`` gives
``generate_sequential``'s streams and counters; a second run through one
scheduler reuses the freed pages; an impossible request raises; a masked
cloud step leaves the masked-out rows' caches bit for bit; every option
that is not ported raises ``NotImplementedError`` naming its ROADMAP item,
the four that this port's async-channel slice accepted now run, and so do
the five of speculative drafting and preemption.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batched import (COUNTERS, LAYOUTS, LENS, MAX_NEW,  # noqa: E402
                                SLOTS, pair)
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.transport import CloudChannel, quantize  # noqa: E402
from repro_torch.serving.cloud_batcher import CloudBatcher  # noqa: E402
from repro_torch.serving.engine import (BatchScheduler, Request,  # noqa: E402
                                        ServingSystem)

__all__ = ["pair"]          # the shared module-scoped fixture


@pytest.mark.parametrize("mode,theta,backfill", [
    ("collm", 0.2, False), ("collm", 0.8, True), ("collm", 1.0, False),
    ("standalone", 0.2, False), ("cloud", 1.0, False)])
def test_paged_equals_dense_in_port(pair, mode, theta, backfill):
    """float32 pages hold what a dense ring holds: the same streams."""
    prompts = pair[3]
    d = ServingSystem(pair[2], CollmConfig(theta=theta, backfill=backfill)
                      ).generate(prompts, MAX_NEW, mode=mode,
                                 num_slots=SLOTS)
    p = ServingSystem(pair[2], CollmConfig(theta=theta, backfill=backfill,
                                           kv_layout="paged")
                      ).generate(prompts, MAX_NEW, mode=mode,
                                 num_slots=SLOTS)
    assert p["tokens"] == d["tokens"]
    for name in COUNTERS:
        assert getattr(p["stats"], name) == getattr(d["stats"], name), name


@pytest.mark.parametrize("layout,theta,wire,backfill", [
    ("dense", 0.2, "float16", False), ("dense", 0.8, "int8", True),
    ("paged", 0.2, "int8", True), ("paged", 1.0, "float16", False)])
def test_generate_equals_generate_sequential(pair, layout, theta, wire,
                                             backfill):
    """Continuous batching emits the per-client loop's streams and
    counters (refill and per-row positions exercised)."""
    prompts = pair[3]
    ccfg = CollmConfig(theta=theta, wire_format=wire, backfill=backfill,
                       **LAYOUTS[layout])
    seq = ServingSystem(pair[2], ccfg).generate_sequential(prompts, MAX_NEW)
    bat = ServingSystem(pair[2], ccfg).generate(prompts, MAX_NEW,
                                                num_slots=SLOTS)
    assert bat["tokens"] == seq["tokens"]
    for name in COUNTERS:
        assert getattr(bat["stats"], name) == getattr(seq["stats"], name), \
            name


def test_page_reuse_engine_deterministic(pair):
    """A second run through the same scheduler reuses the pages the first
    freed (and reset); its streams are the same."""
    tsys = ServingSystem(pair[2], CollmConfig(theta=0.2, kv_layout="paged",
                                              kv_dtype="int8"))
    r1 = tsys.generate(pair[3], MAX_NEW, num_slots=2)
    r2 = tsys.generate(pair[3], MAX_NEW, num_slots=2)
    assert r1["tokens"] == r2["tokens"]
    assert r2["pool_stats"]["allocs"] == 2 * r1["pool_stats"]["allocs"]


def test_impossible_request_raises(pair):
    tsys = ServingSystem(pair[2], CollmConfig(theta=0.8, kv_layout="paged"))
    with pytest.raises(ValueError, match="pages"):
        # needs more pages than the whole pool ever has
        tsys.generate(pair[3][:1], 60, num_slots=2, max_seq=16, max_ctx=80,
                      num_pages=2)
    with pytest.raises(ValueError, match="max context"):
        tsys.generate(pair[3][:1], 60, num_slots=2, max_seq=16)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@torch.no_grad()
def test_masked_cloud_step_keeps_masked_rows(pair, layout):
    """Rows masked out of a cloud step keep every cache leaf bit for bit;
    the masked-in rows get what an unmasked step writes."""
    tm = pair[2]
    collm = CoLLM(tm, CollmConfig(**LAYOUTS[layout]))
    b, ps = 3, 16
    rng = np.random.default_rng(0)
    tbl = None
    if layout == "dense":
        caches = collm.init_cloud_cache(b, 32)
    else:
        caches = collm.init_cloud_cache_paged(b, 6, ps)
        tbl = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    hidden = torch.from_numpy(rng.normal(size=(b, 1, tm.cfg.d_model)
                                         ).astype(np.float32))
    pos = torch.tensor([5, 17, 30], dtype=torch.int32)
    # fill some history first, every row
    for p0 in range(3):
        collm.cloud_step(quantize(hidden * (p0 + 1), "float32"), caches,
                         pos - 3 + p0, block_tbl=tbl)
    before = _clone(caches)
    mask = torch.tensor([True, False, True])
    collm.cloud_step(quantize(hidden, "float32"), caches, pos,
                     block_tbl=tbl, write_mask=mask)
    ref = _clone(before)
    collm.cloud_step(quantize(hidden, "float32"), ref, pos, block_tbl=tbl)
    for (_, a), (_, w), (_, r) in zip(_leaves(before), _leaves(caches),
                                      _leaves(ref)):
        if layout == "dense":
            assert torch.equal(w[1], a[1])           # masked-out row
            assert torch.equal(w[[0, 2]], r[[0, 2]])
        else:
            # the masked-out row's pages, and every other page but the
            # trash page, hold what they held
            assert torch.equal(w[3:5], a[3:5])
            assert torch.equal(w[[1, 2, 5, 6]], r[[1, 2, 5, 6]])


def _clone(caches):
    return {si: [{"self": {k: v.clone() for k, v in c["self"].items()}}
                 for c in layers] for si, layers in caches.items()}


def _leaves(caches):
    return [(k, v) for layers in caches.values() for c in layers
            for k, v in c["self"].items()]


class _OtherChannel(CloudChannel):
    pass


# still refused: option -> (generate kwargs, ROADMAP item that ports it)
REFUSED_GENERATE = {
    "adaptive": (dict(adaptive=object()), "A.6"),
    "resume_cost": (dict(resume_cost=object()), "A.6"),
    "arrivals": (dict(arrivals=[0.0] * len(LENS)), "A.6"),
    "slo": (dict(slo_ttft_s=1.0), "A.6"),
}
REFUSED_CONFIG = {
    "chunked_prefill": (dict(kv_layout="paged", chunked_prefill=True),
                        "A.5"),
    "prefix_share": (dict(kv_layout="paged", chunked_prefill=True,
                          prefix_share=True), "A.5"),
    "cloud_mesh": (dict(cloud_mesh=(1, 1)), "A.11"),
}


@pytest.mark.parametrize("name", sorted(REFUSED_GENERATE) + sorted(
    REFUSED_CONFIG))
def test_refused_options_raise(pair, name):
    """Every option not ported yet raises, naming its ROADMAP item."""
    tm, prompts = pair[2], pair[3]
    if name in REFUSED_CONFIG:
        kw, item = REFUSED_CONFIG[name]
        with pytest.raises(NotImplementedError,
                           match=f"{name}: ROADMAP {re.escape(item)}"):
            ServingSystem(tm, CollmConfig(**kw))
        return
    kw, item = REFUSED_GENERATE[name]
    tsys = ServingSystem(tm, CollmConfig(kv_layout="paged"))
    with pytest.raises(NotImplementedError,
                       match=f"{name}: ROADMAP {re.escape(item)}"):
        tsys.generate(prompts, 4, **kw)


@pytest.mark.parametrize("name", ["sampler", "channel", "fallback_after",
                                  "cloud_batcher"])
def test_formerly_refused_options_run(pair, name):
    """The four options refused before the async channel and the cloud
    batcher were ported now run: a sampler other than greedy, a channel
    other than ``SyncChannel``, ``fallback_after`` and a shared
    ``CloudBatcher`` (the last three give the default greedy streams here:
    an immediate channel never misses a deadline)."""
    tm, prompts = pair[2], pair[3]
    ccfg = CollmConfig(theta=0.2, kv_layout="paged")
    base = ServingSystem(tm, ccfg).generate(prompts, 6, num_slots=2)
    tsys = ServingSystem(tm, ccfg)
    if name == "sampler":
        r = tsys.generate(prompts, 6, num_slots=2, sampler="temperature")
        assert all(len(t) == 6 and 0 <= min(t) and max(t) < 256
                   for t in r["tokens"])
        return
    if name == "cloud_batcher":
        batcher = CloudBatcher(tsys.collm, tsys.cloud.cm, 2, 32)
        sched = BatchScheduler(tsys.collm, tsys.cloud.cm, 2, 32,
                               cloud_batcher=batcher)
        reqs = [Request(device_id=f"edge-{i}", prompt=np.asarray(p),
                        max_new=6) for i, p in enumerate(prompts)]
        with torch.no_grad():
            tokens, _ = sched.run(reqs)
        assert batcher.stats.requests > 0 and batcher.stats.steps > 0
        assert batcher.pool.free_pages == batcher.pool.num_pages
    else:
        kw = ({"channel": _OtherChannel()} if name == "channel"
              else {"fallback_after": 2})
        r = tsys.generate(prompts, 6, num_slots=2, **kw)
        tokens = r["tokens"]
        assert r["stats"].fallbacks == r["stats"].deadline_misses == 0
    assert tokens == base["tokens"]


def test_kv_dtype_checks(pair):
    tm = pair[2]
    with pytest.raises(ValueError, match="paged"):
        CoLLM(tm, CollmConfig(kv_dtype="int8"))           # dense ring
    with pytest.raises(ValueError, match="kv_dtype"):
        CoLLM(tm, CollmConfig(kv_dtype="int4", kv_layout="paged"))


@pytest.mark.parametrize("name", ["preempt_schedule", "watermark",
                                  "speculative", "spec_k", "preemption"])
def test_drafting_and_preemption_options_run(pair, name):
    """The five options refused before speculative drafting and preemption
    were ported now run, keep the default greedy streams, and move the
    counter they exist for."""
    tm, prompts = pair[2], pair[3]
    base = ServingSystem(tm, CollmConfig(theta=0.2)).generate(
        prompts, 6, num_slots=2)
    paged = dict(theta=0.2, kv_layout="paged", preemption="recompute")
    if name == "preempt_schedule":
        r = ServingSystem(tm, CollmConfig(**paged)).generate(
            prompts, 6, num_slots=2, preempt_schedule=[(2, 0)])
        assert r["preemptions"] == r["stats"].preemptions == 1
    elif name == "watermark":
        # 2 pages: without headroom the second stream is admitted and one
        # of the two is preempted; one held-back page admits one at a time
        runs = [ServingSystem(tm, CollmConfig(**paged)).generate(
            prompts, 6, num_slots=2, num_pages=2, watermark=w)
            for w in (0, 1)]
        assert [r["preemptions"] for r in runs] == [1, 0]
        assert runs[0]["tokens"] == base["tokens"]
        r = runs[1]
    elif name == "preemption":
        r = ServingSystem(tm, CollmConfig(**paged)).generate(
            prompts, 6, num_slots=2, num_pages=2)
        assert r["preemptions"] == r["stats"].preemptions > 0
    else:
        k = 4 if name == "spec_k" else 1
        r = ServingSystem(tm, CollmConfig(
            theta=0.2, speculative=True, spec_k=k)).generate(
            prompts, 6, num_slots=2)
        drafts, requests = (r["stats"].draft_tokens,
                            r["channel_stats"]["requests"])
        assert drafts > 0
        # a k-token draft ships several provisional tokens a request
        assert (requests < drafts) if k > 1 else (requests == drafts)
    assert r["tokens"] == base["tokens"]
