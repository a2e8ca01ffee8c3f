"""PyTorch port, slice level: optimistic paged-KV admission with recompute
and swap preemption, the admission watermark and forced preemption
schedules, against the JAX package's, on the CPU.

The 18 scenarios of ``tests/test_preemption.py``, on the same untrained
tiny model (``tiny``: 4 layers, d 64, vocab 128, JAX seed 0, weights
carried across by ``repro_torch.bridge.params_from_jax``) and, for the
trained-model pass, ``tiny_trained``.  The Hypothesis properties run on
fixed seeds.  Every engine case holds the port's run equal to JAX's: the
streams, every ``GenStats`` counter (``preemptions``, ``draft_tokens``,
``accepted_tokens``, ``spec_rewinds`` included), stall/overlap/time to
first token/inter-token gaps and ``virtual_time`` (to 1e-9),
``late_drops``, ``channel_stats``, the schedulers' ``PagePoolStats`` and
``SwapPoolStats``, and the ``CloudBatcher`` row; and it holds the port's
preempted streams equal to its own unpreempted ones (preemption is
invisible in output space).  The allocator, victim policy and swap-store
cases hold the port's ``core/paging.py`` and page-tree helpers op for op
against JAX's.
"""
import dataclasses
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_spec import assert_same_run, bridge, jax_system  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.content_manager import \
    ContentManager as JContentManager  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serving import cloud_batcher as jcb  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.content_manager import ContentManager  # noqa: E402
from repro_torch.core.paging import (PREEMPT_POLICIES,  # noqa: E402
                                     OutOfPages, PagePool, SwapPool,
                                     VictimCandidate, pages_needed,
                                     select_victim)
from repro_torch.models.attention import (init_paged_attn_cache,  # noqa: E402
                                          paged_gather, paged_reset_pages,
                                          paged_scatter_prefill)
from repro_torch.serving.cloud_batcher import (CloudBatcher,  # noqa: E402
                                               _gather_pages_tree,
                                               _pad_pages,
                                               _write_pages_tree)
from repro_torch.serving.engine import ServingSystem  # noqa: E402

PS = 16                               # CollmConfig.page_size default


@pytest.fixture(scope="module")
def tiny():
    cfg = JModelConfig(name="tiny-ee", arch_type="dense", n_layers=4,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=128, tie_embeddings=True,
                       exit_layers=(1, 2)).validate()
    jm = build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return {"jm": jm, "params": params, "tm": bridge(jm, params)}


def _systems(tiny, **ccfg_kw):
    """Fresh port and JAX systems for one config (JAX steps shared)."""
    return (ServingSystem(tiny["tm"], CollmConfig(**ccfg_kw)),
            jax_system(tiny["jm"], tiny["params"], **ccfg_kw))


def _prompts(seed: int, n: int, lo: int = 6, hi: int = 14):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, size=rng.randint(lo, hi + 1))
            for _ in range(n)]


def _pool_rows(system):
    """Each scheduler's pool and swap-pool statistics, and whether its
    pool drained and nothing stays preempted."""
    rows = []
    for sched in system._schedulers.values():
        row = {"preempted": len(sched._preempted)}
        if sched.pool is not None:
            row["pool"] = dataclasses.asdict(sched.pool.stats)
            row["free"] = sched.pool.free_pages == sched.pool.num_pages
        if sched.swap is not None:
            row["swap"] = dataclasses.asdict(sched.swap.stats)
            row["held"] = len(sched.swap)
        rows.append(row)
    return rows


def _both(tiny, ccfg_kw, prompts, max_new, *, channel=None, multi=False,
          **kw):
    """The same run through the port and JAX, held equal; returns the
    port's result and system."""
    out = []
    for system, mod in zip(_systems(tiny, **ccfg_kw),
                           (ttransport, jtransport)):
        call = dict(kw)
        if channel is not None:
            call["channels" if multi else "channel"] = channel(mod)
        fn = system.generate_multi if multi else system.generate
        out.append((fn(prompts, max_new, **call), system))
    (got, tsys), (want, jsys) = out
    assert_same_run(got, want)
    assert _pool_rows(tsys) == _pool_rows(jsys)
    assert got["cm_stats"] == want["cm_stats"]
    return got, tsys


def _assert_drained(system):
    for row in _pool_rows(system):
        assert row.get("free", True) and row["preempted"] == 0
        assert row.get("held", 0) == 0


# ---------------------------------------------------------------------------
# the tentpole property: oversubscription x policy x forced schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,policy,pre,mode", [
    (0, "youngest", "recompute", "collm"),
    (1, "fewest-pages", "swap", "collm"),
    (2, "lru", "swap", "standalone"),
    (3, "lru", "recompute", "collm"),
])
def test_preempted_streams_token_identical(tiny, seed, policy, pre, mode):
    """Oversubscription levels x victim policies x forced schedules drawn
    from the seed as the JAX property draws them: streams equal the
    unpreempted run's, and the pool drains."""
    rng = random.Random(seed)
    n_streams = rng.randint(3, 5)
    max_new = rng.randint(6, 14)
    prompts = _prompts(seed, n_streams)
    worst = max(pages_needed(len(p) + max_new, PS) for p in prompts)
    num_pages = rng.choice([worst, worst + 1, 2 * worst])
    schedule = [(rng.randint(1, 3 * max_new), rng.randrange(2))
                for _ in range(rng.randint(0, 4))]
    ref = ServingSystem(tiny["tm"], CollmConfig(
        theta=0.8, kv_layout="paged")).generate(
        prompts, max_new, mode=mode, num_slots=2, max_seq=40)
    r, tsys = _both(tiny, dict(theta=0.8, kv_layout="paged", preemption=pre,
                               preempt_policy=policy),
                    prompts, max_new, mode=mode, num_slots=2, max_seq=40,
                    num_pages=num_pages, preempt_schedule=schedule)
    assert r["tokens"] == ref["tokens"]
    assert r["stats"].tokens == ref["stats"].tokens
    _assert_drained(tsys)


@pytest.mark.parametrize("seed", [0, 1])
def test_forced_preemption_dense_layout(tiny, seed):
    """Recompute preemption on dense rings re-prefills into the slot's
    ring and stays invisible."""
    rng = random.Random(seed)
    max_new = rng.randint(6, 12)
    prompts = _prompts(seed, 4)
    schedule = [(rng.randint(1, 2 * max_new), rng.randrange(2))
                for _ in range(rng.randint(1, 4))]
    ref = ServingSystem(tiny["tm"], CollmConfig(theta=0.8)).generate(
        prompts, max_new, mode="collm", num_slots=2, max_seq=40)
    r, _ = _both(tiny, dict(theta=0.8, preemption="recompute"), prompts,
                 max_new, mode="collm", num_slots=2, max_seq=40,
                 preempt_schedule=schedule)
    assert r["tokens"] == ref["tokens"]
    assert r["preemptions"] >= 1


@pytest.mark.parametrize("kw,mode,pre", [
    (dict(theta=0.8), "collm", "recompute"),
    (dict(theta=0.8), "collm", "swap"),
    (dict(theta=0.8, backfill=True), "collm", "recompute"),
    (dict(theta=1.0), "collm", "swap"),   # every token cloud-served
    (dict(theta=0.8), "standalone", "recompute"),
    (dict(theta=0.8), "cloud", "swap"),   # undivided-model baseline rows
])
def test_natural_preemption_all_modes(tiny, kw, mode, pre):
    """A pool at about half the worst-case demand forces real preemptions
    in every serving mode; streams stay equal and the pool drains."""
    prompts = _prompts(7, 3, lo=8, hi=12)
    rb = ServingSystem(tiny["tm"], CollmConfig(
        kv_layout="paged", **kw)).generate(prompts, 12, mode=mode,
                                           num_slots=2, max_seq=40)
    r, tsys = _both(tiny, dict(kv_layout="paged", preemption=pre, **kw),
                    prompts, 12, mode=mode, num_slots=2, max_seq=40,
                    num_pages=3)
    assert r["tokens"] == rb["tokens"]
    sched = next(iter(tsys._schedulers.values()))
    assert sched.preemptions > 0
    assert r["stats"].preemptions == sched.preemptions
    _assert_drained(tsys)
    if pre == "swap":
        assert sched.swap.stats.swapped_out == sched.preemptions


def test_speculative_preemption(tiny):
    """Forced preemption with speculative decode: provisional tokens past
    the earliest unvalidated position are cut from the checkpoint and
    speculated again after the resume."""
    prompts = _prompts(11, 3, lo=8, hi=12)
    ref = ServingSystem(tiny["tm"], CollmConfig(
        theta=0.8, speculative=True)).generate(prompts, 10, mode="collm",
                                               num_slots=2, max_seq=40)
    r, _ = _both(tiny, dict(theta=0.8, speculative=True,
                            preemption="recompute"), prompts, 10,
                 mode="collm", num_slots=2, max_seq=40,
                 preempt_schedule=[(3, 0), (6, 1)])
    assert r["tokens"] == ref["tokens"]
    assert r["stats"].preemptions == 2


def test_watermark_holds_back_admission(tiny):
    """A watermark leaves headroom pages out of admission; the streams
    still finish equal (JAX's case: 4 pages), and on 3 pages it spares
    preemptions."""
    prompts = _prompts(5, 4, lo=8, hi=12)
    rb = ServingSystem(tiny["tm"], CollmConfig(
        theta=0.8, kv_layout="paged")).generate(prompts, 10, mode="collm",
                                                num_slots=2, max_seq=40)
    ccfg = dict(theta=0.8, kv_layout="paged", preemption="recompute")
    runs = {(n, w): _both(tiny, ccfg, prompts, 10, mode="collm",
                          num_slots=2, max_seq=40, num_pages=n,
                          watermark=w)[0]
            for n, w in ((4, 1), (3, 0), (3, 1))}
    assert all(r["tokens"] == rb["tokens"] for r in runs.values())
    assert runs[3, 1]["preemptions"] < runs[3, 0]["preemptions"]


def test_preemption_config_validation(tiny):
    tm = tiny["tm"]
    prompts = _prompts(0, 1)
    with pytest.raises(ValueError, match="paged"):
        ServingSystem(tm, CollmConfig(theta=0.8, preemption="swap")
                      ).generate(prompts, 4, mode="collm")
    with pytest.raises(ValueError, match="greedy"):
        ServingSystem(tm, CollmConfig(
            theta=0.8, kv_layout="paged", preemption="recompute")
        ).generate(prompts, 4, mode="collm", sampler="temperature",
                   top_k=4)
    with pytest.raises(ValueError, match="preempt_policy"):
        ServingSystem(tm, CollmConfig(
            theta=0.8, kv_layout="paged", preemption="recompute",
            preempt_policy="nope")).generate(prompts, 4, mode="collm")
    with pytest.raises(ValueError, match="preemption enabled"):
        ServingSystem(tm, CollmConfig(theta=0.8, kv_layout="paged")
                      ).generate(prompts, 4, mode="collm",
                                 preempt_schedule=[(1, 0)])


# ---------------------------------------------------------------------------
# preemption x cloud batcher (multi-engine, in-flight requests)
# ---------------------------------------------------------------------------
def _scripted(lat, n):
    return lambda mod: [mod.ScriptedChannel([lat], deadline_s=math.inf)
                        for _ in range(n)]


@pytest.mark.parametrize("pre,backfill", [
    ("recompute", False), ("swap", False),
    # backfill x swap: a queued backfill entry holds the only copy of ring
    # positions the rerun never uploads again, so swap_out flushes first
    ("recompute", True), ("swap", True),
])
def test_preempted_inflight_cloud_request(tiny, pre, backfill):
    """A stream preempted with a cloud reply in flight: the late reply
    drops, the batcher row is released and taken again on resume, no
    pooled row leaks, and the streams equal independent runs."""
    prompts = _prompts(3, 3, lo=8, hi=12)
    ref = [ServingSystem(tiny["tm"], CollmConfig(
        theta=0.8, backfill=backfill)).generate(
        [p], 12, mode="collm", num_slots=1)["tokens"][0] for p in prompts]
    r, tsys = _both(tiny, dict(theta=0.8, kv_layout="paged", preemption=pre,
                               backfill=backfill), prompts, 12,
                    channel=_scripted(0.05, 3), multi=True,
                    cloud_batch=True, tick_time_s=0.01,
                    preempt_schedules=[[(4, 0)], None, [(6, 0)]])
    assert r["tokens"] == ref
    assert r["late_drops"] >= 1
    assert tsys.cloud.cm.cloud_slots_free() == 3
    assert r["batcher"]["swaps" if pre == "swap" else "restores"] >= 1


def test_swap_out_flushes_queued_backfill_entries(tiny):
    """A queued backfill entry has consumed uploads without writing their
    KV: ``swap_out`` flushes before its snapshot, which carries the ring
    positions' markers; the snapshot equals JAX's, and ``swap_in`` binds
    its pages again."""
    jm, params, tm = tiny["jm"], tiny["params"], tiny["tm"]
    kw = dict(theta=0.8, kv_layout="paged", backfill=True, preemption="swap")
    prompt = _prompts(1, 1, lo=8, hi=8)[0][None, :]
    p_len = prompt.shape[1]
    hid = np.random.RandomState(0).randn(2, 1, 1, jm.cfg.d_model).astype(
        np.float32)
    # the port
    collm, cm = CoLLM(tm, CollmConfig(**kw)), ContentManager()
    batcher = CloudBatcher(collm, cm, num_slots=2, max_seq=40)
    with torch.no_grad():
        _, h1, _ = collm.edge_prefill(
            {"tokens": torch.as_tensor(prompt, dtype=torch.long)},
            collm.init_edge_cache(1, p_len))
        batcher.admit("edge-0", h1, p_len, p_len + 8)
        for i, p in enumerate((p_len, p_len + 1)):
            cm.upload("edge-0", p, ttransport.StatePacket(
                hidden=ttransport.quantize(torch.from_numpy(hid[i]),
                                           "float16")))
        _, _, consumed = batcher.submit("edge-0", p_len + 1, backfill=True)
        assert len(consumed) == 2 and batcher._pending
        snap = batcher.swap_out("edge-0")
    assert not batcher._pending and batcher.stats.steps >= 1
    # JAX, the same steps
    jco, jcm = JCoLLM(jm, JCollmConfig(**kw)), JContentManager()
    jb = jcb.CloudBatcher(jco, params, jcm, num_slots=2, max_seq=40)
    _, jh1, _ = jco.edge_prefill(params, {"tokens": jnp.asarray(prompt)},
                                 jco.init_edge_cache(1, p_len))
    jb.admit("edge-0", jh1, p_len, p_len + 8)
    for i, p in enumerate((p_len, p_len + 1)):
        jcm.upload("edge-0", p, jtransport.StatePacket(
            hidden=jtransport.quantize(jnp.asarray(hid[i]), "float16")))
    jb.submit("edge-0", p_len + 1, backfill=True)
    jsnap = jb.swap_out("edge-0")
    assert np.array_equal(snap["logical"], jsnap["logical"])
    markers = set()
    for si, layers in snap["pages"].items():
        for j, c in enumerate(layers):
            node = c["self"]
            jnode = {k: np.asarray(v)[j] for k, v in
                     jsnap["pages"][si]["self"].items()}
            assert np.array_equal(node["pos"].numpy(), jnode["pos"])
            for key in ("kp", "vp"):
                np.testing.assert_allclose(node[key].numpy(), jnode[key],
                                           atol=1e-5, rtol=0)
            markers.update(node["pos"].numpy().ravel().tolist())
    assert {p_len, p_len + 1} <= markers
    batcher.swap_in("edge-0", snap)
    tbl = batcher.pool.block_table[cm.cloud_slot("edge-0")]
    assert (tbl >= 0).sum() == len(snap["logical"])


def test_preempted_batcher_rows_not_leaked_across_runs(tiny):
    """Two preempting multi-engine runs back to back on one system: the
    second takes rows and pages again cleanly and repeats the first."""
    prompts = _prompts(9, 3, lo=8, hi=12)
    ccfg = dict(theta=0.8, kv_layout="paged", preemption="recompute")
    tsys, jsys = _systems(tiny, **ccfg)
    outs = []
    for _ in range(2):
        runs = [s.generate_multi(prompts, 10, cloud_batch=True,
                                 channels=_scripted(0.03, 3)(mod),
                                 tick_time_s=0.01,
                                 preempt_schedules=[[(3, 0)], [(5, 0)],
                                                    None])
                for s, mod in ((tsys, ttransport), (jsys, jtransport))]
        assert_same_run(*runs)
        outs.append(runs[0]["tokens"])
        assert tsys.cloud.cm.cloud_slots_free() == 3
        assert runs[0]["stats"].preemptions >= 1
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# PagePool allocator, victim policies, swap store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pagepool_random_ops_invariants(seed):
    """Random alloc/free sequences on the port's pool and JAX's, op for
    op: the same pages and errors, no page allocated twice, conservation
    after every op, the trash page never handed out."""
    rng = random.Random(seed)
    num_pages = rng.randint(2, 12)
    ps = rng.choice([4, 8, 16])
    num_slots = rng.randint(1, 4)
    max_logical = rng.randint(2, 8)
    wm = rng.randint(0, num_pages - 1)
    pool = PagePool(num_pages, ps, num_slots, max_logical, watermark=wm)
    jpool = jpaging.PagePool(num_pages, ps, num_slots, max_logical,
                             watermark=wm)
    owned = {s: set() for s in range(num_slots)}
    for _ in range(rng.randint(10, 60)):
        slot = rng.randrange(num_slots)
        if rng.random() < 0.6:
            lp = rng.randrange(max_logical)
            before = pool.block_table[slot, lp]
            try:
                page = pool.alloc(slot, lp)
            except OutOfPages:
                assert pool.free_pages == 0
                with pytest.raises(jpaging.OutOfPages):
                    jpool.alloc(slot, lp)
                continue
            assert page == jpool.alloc(slot, lp) != jpaging.TRASH_PAGE
            if before == -1:
                assert all(page not in o for o in owned.values())
                owned[slot].add(page)
            else:
                assert page == before
        else:
            freed = pool.free_slot(slot)
            assert freed == jpool.free_slot(slot)
            assert set(freed) == owned[slot]
            owned[slot] = set()
        in_use = sum(len(o) for o in owned.values())
        assert pool.free_pages + in_use == pool.num_pages
        assert pool.pages_in_use() == in_use
        assert pool.available_pages == jpool.available_pages
        assert np.array_equal(pool.block_table, jpool.block_table)
        for s in range(num_slots):
            assert pool.owned_pages(s) == len(owned[s])
    assert dataclasses.asdict(pool.stats) == dataclasses.asdict(jpool.stats)


def test_select_victim_policies():
    cands = [VictimCandidate(slot=0, admit_seq=5, owned_pages=3),
             VictimCandidate(slot=1, admit_seq=2, owned_pages=1),
             VictimCandidate(slot=2, admit_seq=9, owned_pages=2)]
    assert select_victim(cands, "youngest") == 2
    assert select_victim(cands, "fewest-pages") == 1
    assert select_victim(cands, "lru") == 1
    with pytest.raises(OutOfPages):
        select_victim([VictimCandidate(0, 1, 0)], "youngest")
    with pytest.raises(ValueError, match="policy"):
        select_victim(cands, "coinflip")
    assert PREEMPT_POLICIES == jpaging.PREEMPT_POLICIES
    rng = random.Random(0)
    for _ in range(50):           # ties included: the same choice as JAX
        raw = [(s, rng.randint(0, 4), rng.randint(0, 3), 0)
               for s in range(rng.randint(1, 5))]
        if not any(o for _, _, o, _ in raw):
            continue
        for policy in PREEMPT_POLICIES:
            assert select_victim([VictimCandidate(*c) for c in raw],
                                 policy) == jpaging.select_victim(
                [jpaging.VictimCandidate(*c) for c in raw], policy)


def test_swap_pool_roundtrip_accounting():
    sp = SwapPool()
    snap = {"a": torch.zeros((4, 2)), "b": [torch.ones(3, dtype=torch.int32)],
            "logical": np.zeros(2, np.int32)}
    sp.put(0, snap)
    assert len(sp) == 1 and 0 in sp
    assert sp.stats.bytes_out == 4 * 2 * 4 + 3 * 4 + 2 * 4
    with pytest.raises(KeyError):
        sp.put(0, snap)                    # keys are single-use
    got = sp.take(0)
    assert got is snap and len(sp) == 0
    assert sp.stats.held == 0 and sp.stats.bytes_in == sp.stats.bytes_out


def _row(rng, n, kvh, hd):
    return {"k": rng.randn(1, n, kvh, hd).astype(np.float32) * 2,
            "v": rng.randn(1, n, kvh, hd).astype(np.float32) * 2,
            "pos": np.arange(n, dtype=np.int32)[None]}


def _t(row):
    return {k: torch.from_numpy(v) for k, v in row.items()}


def test_swapped_slot_cannot_read_stale_pages(tiny_ee_cfg):
    """Preempt stream A (swap out), give its pages to stream B, resume A
    into other pages: each gather sees exactly its own K/V and
    positions."""
    rng = np.random.RandomState(0)
    cfg = TModelConfig(**dataclasses.asdict(tiny_ee_cfg))
    ps, num_pages = 8, 4
    pool = PagePool(num_pages, ps, 2, 4)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = {0: [{"self": init_paged_attn_cache(cfg, num_pages, ps)}]}
    node = cache[0][0]["self"]
    len_a = 2 * ps
    row_a = _row(rng, len_a, kvh, hd)
    pages_a = [pool.alloc(0, lp) for lp in range(2)]
    paged_scatter_prefill(node, _t(row_a), pages_a)
    phys = _pad_pages(np.asarray(pages_a, np.int32))
    snap = _gather_pages_tree(cache, phys)
    paged_reset_pages(node, pool.free_slot(0))
    len_b = ps + 3
    row_b = _row(rng, len_b, kvh, hd)
    pages_b = [pool.alloc(1, lp) for lp in range(2)]
    assert set(pages_b) == set(pages_a)
    paged_scatter_prefill(node, _t(row_b), pages_b)
    pages_a2 = [pool.alloc(0, lp) for lp in range(2)]
    assert not set(pages_a2) & set(pages_b)
    _write_pages_tree(cache, _pad_pages(np.asarray(pages_a2, np.int32)),
                      snap)
    for slot, rw, ln in ((0, row_a, len_a), (1, row_b, len_b)):
        tbl = torch.as_tensor(pool.block_table[slot:slot + 1, :2])
        k, _, kpos = paged_gather(node, tbl)
        kpos = kpos[0].numpy()
        valid = kpos >= 0
        assert valid.sum() == ln
        assert np.array_equal(np.sort(kpos[valid]), np.arange(ln))
        np.testing.assert_array_equal(k[0].numpy()[valid], rw["k"][0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_swap_roundtrip_exact(seed, tiny_ee_cfg):
    """An int8 slot swapped out and back reproduces the pre-preemption
    quantized pages bit for bit (int8 data, float32 scales, positions);
    the snapshot equals JAX's and is billed at the quantized size."""
    rng = np.random.RandomState(seed)
    cfg = TModelConfig(**dataclasses.asdict(tiny_ee_cfg))
    ps, num_pages, n_lp = 8, 6, 3
    pool = PagePool(num_pages, ps, 2, n_lp)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = {0: [{"self": init_paged_attn_cache(cfg, num_pages, ps,
                                                kv_dtype="int8")}]}
    node = cache[0][0]["self"]
    n = int(rng.randint(ps + 1, n_lp * ps))
    pages = [pool.alloc(0, lp) for lp in range(pages_needed(n, ps))]
    row = _row(rng, n, kvh, hd)
    paged_scatter_prefill(node, _t(row), pages)
    phys = _pad_pages(np.asarray(pages, np.int32))
    before = _gather_pages_tree(cache, phys)
    bnode = before[0][0]["self"]
    assert bnode["kp"].dtype == torch.int8
    assert bnode["ks"].dtype == torch.float32
    # JAX's snapshot of the same row
    jcache = jattn.paged_scatter_prefill(
        jattn.init_paged_attn_cache(tiny_ee_cfg, num_pages, ps,
                                    kv_dtype="int8"),
        {k: jnp.asarray(v) for k, v in row.items()}, jnp.asarray(pages))
    jsnap = jax.device_get(jcb.GATHER_PAGES({0: jcache}, jnp.asarray(phys)))
    for key in ("kp", "vp", "ks", "vs", "pos"):
        np.testing.assert_array_equal(bnode[key].numpy(), jsnap[0][key])
    swap = SwapPool()
    swap.put("slot0", before)
    assert swap.stats.bytes_out == jpaging.SwapPool._nbytes(jsnap)
    paged_reset_pages(node, pool.free_slot(0))
    cleared = _gather_pages_tree(cache, phys)[0][0]["self"]
    assert (cleared["pos"] == -1).all()
    got = swap.take("slot0")
    pages2 = [pool.alloc(0, lp) for lp in range(pages_needed(n, ps))]
    phys2 = _pad_pages(np.asarray(pages2, np.int32))
    _write_pages_tree(cache, phys2, got)
    after = _gather_pages_tree(cache, phys2)[0][0]["self"]
    for key in ("kp", "vp", "ks", "vs", "pos"):
        assert torch.equal(after[key], got[0][0]["self"][key])
    f32 = {0: [{"self": init_paged_attn_cache(cfg, num_pages, ps)}]}
    assert swap.stats.bytes_out < 0.5 * SwapPool._nbytes(
        _gather_pages_tree(f32, phys))


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_swap_preemption_token_identical(tiny, seed):
    """int8 paged streams under forced swap preemption equal the
    unpreempted int8 run (the swap stores quantized pages verbatim)."""
    rng = random.Random(seed)
    max_new = rng.randint(6, 12)
    prompts = _prompts(seed, 4)
    worst = max(pages_needed(len(p) + max_new, PS) for p in prompts)
    schedule = [(rng.randint(1, 2 * max_new), rng.randrange(2))
                for _ in range(rng.randint(1, 4))]
    ref = ServingSystem(tiny["tm"], CollmConfig(
        theta=0.8, kv_layout="paged", kv_dtype="int8")).generate(
        prompts, max_new, mode="collm", num_slots=2, max_seq=40)
    r, tsys = _both(tiny, dict(theta=0.8, kv_layout="paged",
                               kv_dtype="int8", preemption="swap"),
                    prompts, max_new, mode="collm", num_slots=2, max_seq=40,
                    num_pages=2 * worst, preempt_schedule=schedule)
    assert r["tokens"] == ref["tokens"]
    _assert_drained(tsys)


# ---------------------------------------------------------------------------
# preemption x multi-token drafting (spec_k > 1, draft in flight)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre,kv_kw", [
    ("recompute", {}),
    ("recompute", {"kv_layout": "paged"}),
    ("swap", {"kv_layout": "paged"}),
    ("swap", {"kv_layout": "paged", "kv_dtype": "int8"}),
])
def test_draft_inflight_preemption(tiny, pre, kv_kw):
    """Preempt slots with a k-token draft outstanding (buffered and
    dispatched): the checkpoint cuts back to the validated prefix, the
    resumed stream drafts again identically, every page and upload
    drains."""
    prompts = _prompts(13, 3, lo=8, hi=12)
    ref = ServingSystem(tiny["tm"], CollmConfig(theta=0.8, **kv_kw)
                        ).generate(prompts, 10, mode="collm", num_slots=2,
                                   max_seq=40)
    r, tsys = _both(tiny, dict(theta=0.8, speculative=True, spec_k=4,
                               preemption=pre, **kv_kw), prompts, 10,
                    channel=lambda m: m.ScriptedChannel(
                        [0.05], deadline_s=math.inf),
                    mode="collm", num_slots=2, max_seq=40,
                    preempt_schedule=[(4, 0), (7, 1)], tick_time_s=0.01)
    assert r["tokens"] == ref["tokens"]
    st_ = r["stats"]
    assert st_.preemptions >= 1 and st_.draft_tokens > 0
    assert all(0 <= a <= 4 for a in st_.accept_lens)
    assert st_.accepted_tokens == sum(st_.accept_lens)
    _assert_drained(tsys)
    assert all(c["pending"] == 0 for c in r["cm_stats"].values())


@pytest.mark.parametrize("pre", ["recompute", "swap"])
def test_draft_inflight_preemption_batcher(tiny, pre):
    """Draft-in-flight preemption across the shared CloudBatcher: the
    preempted engine's verification reply late-drops, its pooled row is
    released and taken again, and no cloud slot leaks."""
    prompts = _prompts(17, 3, lo=8, hi=12)
    ref = [ServingSystem(tiny["tm"], CollmConfig(theta=0.8)).generate(
        [p], 10, mode="collm", num_slots=1)["tokens"][0] for p in prompts]
    r, tsys = _both(tiny, dict(theta=0.8, kv_layout="paged",
                               speculative=True, spec_k=4, preemption=pre),
                    prompts, 10, channel=_scripted(0.05, 3), multi=True,
                    cloud_batch=True, tick_time_s=0.01,
                    preempt_schedules=[[(5, 0)], None, [(7, 0)]])
    assert r["tokens"] == ref
    st_ = r["stats"]
    assert st_.preemptions >= 1 and st_.draft_tokens > 0
    assert st_.accepted_tokens == sum(st_.accept_lens)
    assert tsys.cloud.cm.cloud_slots_free() == 3
    assert all(c["pending"] == 0 for c in r["cm_stats"].values())
    if pre == "swap":
        assert r["batcher"]["swaps"] >= 1


# ---------------------------------------------------------------------------
# trained-model pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre", ["recompute", "swap"])
def test_preemption_trained_model_equivalence(tiny_trained, pre):
    jm, params = tiny_trained["model"], tiny_trained["params"]
    trained = {"jm": jm, "params": params, "tm": bridge(jm, params)}
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(n) for n in (8, 11, 9, 12, 10)]
    d = ServingSystem(trained["tm"], CollmConfig(
        theta=0.8, kv_layout="paged")).generate(prompts, 14, mode="collm",
                                                num_slots=3)
    p, tsys = _both(trained, dict(theta=0.8, kv_layout="paged",
                                  preemption=pre), prompts, 14,
                    mode="collm", num_slots=3, num_pages=4)
    assert p["tokens"] == d["tokens"]
    assert p["preemptions"] > 0
    _assert_drained(tsys)
