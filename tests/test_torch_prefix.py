"""PyTorch port, slice level: chunked prefill, the radix prefix cache with
copy-on-write pages, and prefix sharing through the engine and the
``CloudBatcher``, against the JAX package's, on the CPU.

* Op level: ``chunk_attention_paged`` on float32 and int8 pools (a padded
  final chunk, a per-row write mask, a row with no page mapped) and
  ``CoLLM.edge_prefill_chunk`` / ``cloud_prefill_chunk`` against JAX's on
  the same weights: outputs within the attention tolerance of
  ``tests/test_torch_paged.py`` (atol 1e-5 in float32), position markers
  exactly, float pages within 1e-5 and int8 codes within one step (a K/V
  row projected by two frameworks differs in its last bits).  The
  copy-on-write device copy (``_copy_pages_tree``) against JAX's
  ``COPY_PAGES``, byte for byte.
* The 9 scenarios of ``tests/test_prefix_share.py``, with fixed seeds in
  place of Hypothesis draws.  The pool cases drive the port's
  ``PagePool`` and JAX's through the same operations and hold their block
  tables, free lists, refcounts and statistics equal after every one.
  The engine cases hold each port run equal to JAX's (streams, every
  ``GenStats`` counter with ``prefix_hit_tokens``, ``cow_copies`` and
  ``prefill_chunks``, virtual times to 1e-9, ``PagePoolStats`` with
  ``prefix_evictions``, the batcher's row and the content manager's
  ledger) and then check JAX's own assertions on the port's run.
"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_spec import assert_same_run, bridge, jax_system  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serving.cloud_batcher import COPY_PAGES  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.paging import (OutOfPages, PagePool,  # noqa: E402
                                     pages_needed)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving.cloud_batcher import _copy_pages_tree  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402

ATOL = 1e-5                           # float32 attention, as test_torch_paged
PS = 4                                # pool-level cases: tiny pages
VOCAB = 6                             # tiny vocabulary: frequent collisions
EPS = 8                               # engine cases: page size
GKW = dict(num_slots=4, max_seq=64, max_ctx=64, num_pages=48)


@pytest.fixture(scope="module")
def tiny():
    cfg = JModelConfig(name="tiny-ee", arch_type="dense", n_layers=4,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=128, tie_embeddings=True,
                       exit_layers=(1, 2)).validate()
    jm = build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return {"jm": jm, "params": params, "tm": bridge(jm, params)}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _same_pool(t, j):
    """Markers exactly; float pages within ATOL; int8 codes within one step
    and scales within ATOL relative."""
    assert sorted(t) == sorted(j)
    for k in t:
        got, want = t[k].numpy(), np.asarray(j[k])
        if k == "pos":
            assert np.array_equal(got, want), k
        elif t[k].dtype == torch.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, k
        elif k in ("ks", "vs"):
            np.testing.assert_allclose(got, want, rtol=ATOL, atol=0)
        else:
            _close(t[k], j[k])


def _pages_read(c):
    """Every page but the trash page (write-only: masked and unmapped
    tokens land there in no fixed order)."""
    return {k: v[1:] for k, v in c.items()}


# ---------------------------------------------------------------------------
# op level
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mask_kind", ["tokens", "rows"])
@torch.no_grad()
def test_chunk_attention_paged_matches_jax(tiny, kv_dtype, mask_kind):
    """Chunks over a paged pool: row 0 fills pages 3 and 5 with a full
    chunk and then a padded one (5 of 8 tokens), row 1 has no page
    mapped, row 2 is written by a per-row mask (masked out on the second
    chunk).  Outputs and every page the table maps equal JAX's."""
    jm, tm = tiny["jm"], tiny["tm"]
    cfg = jm.cfg
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                      tiny["params"]["segments"][0])["attn"]
    tp = tm.layers[0].attn
    ps, num_pages = 8, 9
    j = jattn.init_paged_attn_cache(cfg, num_pages, ps, kv_dtype=kv_dtype)
    t = tattn.init_paged_attn_cache(tm.cfg, num_pages, ps, device="cpu",
                                    kv_dtype=kv_dtype)
    tbl = np.array([[3, 5, -1], [-1, -1, -1], [1, 2, 7]], np.int32)
    rng = np.random.default_rng(4)
    for step, clen in enumerate((ps, 5)):
        pos = np.array([step * ps, 0, step * ps], np.int32)
        x = rng.normal(size=(3, ps, cfg.d_model)).astype(np.float32)
        if mask_kind == "tokens":
            wm = np.tile(np.arange(ps) < clen, (3, 1))
        else:
            wm = np.array([True, True, step == 0])
        jy, j = jattn.chunk_attention_paged(
            jp, cfg, jnp.asarray(x), j, jnp.asarray(pos), jnp.asarray(tbl),
            write_mask=jnp.asarray(wm))
        ty, t = tattn.chunk_attention_paged(
            tp, tm.cfg, torch.from_numpy(x), t, torch.from_numpy(pos),
            torch.from_numpy(tbl), write_mask=torch.from_numpy(wm))
        _close(ty, jy)
        _same_pool(_pages_read(t), _pages_read(j))
    # row 0's pad tokens (positions 13..15) stayed invisible
    if mask_kind == "tokens":
        assert np.all(t["pos"][5].numpy()[5:] == -1)
        assert np.array_equal(t["pos"][3].numpy(), np.arange(8))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@torch.no_grad()
def test_prefill_chunks_match_jax(tiny, kv_dtype):
    """A 13-token prompt in two page-sized chunks through the edge and the
    cloud partitions: exit decisions at each chunk's true last position,
    the l_ee1 hidden chunk, the cloud logits and both pools equal JAX's."""
    jm, tm, params = tiny["jm"], tiny["tm"], tiny["params"]
    kw = dict(kv_layout="paged", page_size=EPS, kv_dtype=kv_dtype,
              chunked_prefill=True)
    jc, tc = JCoLLM(jm, JCollmConfig(**kw)), CoLLM(tm, CollmConfig(**kw))
    je, te = jc.init_edge_cache_paged(1, 6, EPS), \
        tc.init_edge_cache_paged(1, 6, EPS)
    jcl, tcl = jc.init_cloud_cache_paged(1, 6, EPS), \
        tc.init_cloud_cache_paged(1, 6, EPS)
    prompt = np.random.RandomState(3).randint(0, 128, size=13)
    tbl = np.array([[4, 2, -1]], np.int32)
    for pos0 in (0, EPS):
        clen = min(EPS, len(prompt) - pos0)
        chunk = np.zeros((1, EPS), np.int32)
        chunk[0, :clen] = prompt[pos0:pos0 + clen]
        jd, jh, je = jc.edge_prefill_chunk(params, jnp.asarray(chunk),
                                           jnp.int32(pos0), clen, je,
                                           jnp.asarray(tbl))
        td, th, te = tc.edge_prefill_chunk(
            torch.from_numpy(chunk).long(), pos0, clen, te,
            torch.from_numpy(tbl))
        for l in jd:
            assert int(td[l].token[0]) == int(jd[l].token[0])
            np.testing.assert_allclose(float(td[l].confidence[0]),
                                       float(jd[l].confidence[0]),
                                       atol=ATOL, rtol=0)
        _close(th, jh)
        jl, jcl = jc.cloud_prefill_chunk(params, jh, jnp.int32(pos0), clen,
                                         jcl, jnp.asarray(tbl))
        tl, tcl = tc.cloud_prefill_chunk(th, pos0, clen, tcl,
                                         torch.from_numpy(tbl))
        assert tuple(tl.shape) == jl.shape
        _close(tl, jl, atol=1e-4)          # logits: vocab-wide read-out
    for tt, jt in ((te, je), (tcl, jcl)):
        for si in jt:
            for tlay, jlay in zip(tt[si], [jax.tree.map(lambda a, i=i: a[i],
                                                        jt[si])
                                           for i in range(len(tt[si]))]):
                _same_pool(_pages_read(tlay["self"]),
                           _pages_read(jlay["self"]))


@pytest.mark.parametrize("int8", [False, True])
def test_copy_pages_duplicates_all_leaves(int8):
    """The device half of a copy-on-write split copies every leaf of a
    paged node (K/V, the int8 scale rows, the markers) into the target
    page, byte for byte as JAX's ``COPY_PAGES``, touching no other page."""
    pages, heads, dim = 4, 2, 3
    n = pages * PS * heads * dim
    rng = np.random.RandomState(1)
    if int8:
        node = {"kp": rng.randint(-127, 128, n).astype(np.int8)
                .reshape(pages, PS, heads, dim),
                "vp": rng.randint(-127, 128, n).astype(np.int8)
                .reshape(pages, PS, heads, dim),
                "ks": rng.rand(pages, PS, heads).astype(np.float32),
                "vs": rng.rand(pages, PS, heads).astype(np.float32),
                "pos": np.arange(pages * PS, dtype=np.int32
                                 ).reshape(pages, PS)}
    else:
        node = {"kp": np.arange(n, dtype=np.float32
                                ).reshape(pages, PS, heads, dim),
                "vp": -np.arange(n, dtype=np.float32
                                 ).reshape(pages, PS, heads, dim),
                "scale": np.arange(pages * PS, dtype=np.float32
                                   ).reshape(pages, PS),
                "pos": np.arange(pages * PS, dtype=np.int32
                                 ).reshape(pages, PS)}
    want = COPY_PAGES({"0": {k: jnp.asarray(v) for k, v in node.items()}},
                      jnp.int32(1), jnp.int32(3))["0"]
    tree = {0: [{"self": {k: torch.from_numpy(v.copy())
                          for k, v in node.items()}}]}
    got = _copy_pages_tree(tree, 1, 3)[0][0]["self"]
    for name, leaf in node.items():
        g = got[name].numpy()
        assert g.tobytes() == np.asarray(want[name]).tobytes(), name
        assert np.array_equal(g[3], leaf[1]), name
        assert np.array_equal(g[:3], leaf[:3]), name


# ---------------------------------------------------------------------------
# pool level: the port's PagePool in lockstep with JAX's
# ---------------------------------------------------------------------------
def _state(pool):
    return (pool.block_table.tolist(), list(pool._free), dict(pool._ref),
            sorted(pool._cached), sorted(pool._unfilled),
            [list(o) for o in pool._owned], dataclasses.astuple(pool.stats),
            pool.reclaimable_pages, pool.available_pages)


def _check_accounting(pool):
    """Every page is free xor referenced; refcounts == mappings + cache."""
    free = set(pool._free)
    assert len(free) == len(pool._free), "free list holds duplicates"
    assert 0 not in free and 0 not in pool._ref, "trash page entered play"
    mapcount = {}
    for slot in range(pool.num_slots):
        row = [int(p) for p in pool.block_table[slot] if p > 0]
        assert sorted(row) == sorted(pool._owned[slot])
        for p in row:
            mapcount[p] = mapcount.get(p, 0) + 1
    for page in range(1, pool.num_pages + 1):
        ref = pool.refcount(page)
        expect = mapcount.get(page, 0) + (1 if page in pool._cached else 0)
        assert ref == expect, f"page {page}: ref {ref} != {expect}"
        assert (page in free) == (ref == 0)


def _plain(value):
    """A call's result with dataclasses (``PrefixHit``) as tuples."""
    if dataclasses.is_dataclass(value):
        return dataclasses.astuple(value)
    return value


class _Both:
    """The port's pool and JAX's, driven by the same calls; every result
    and the whole state must agree after each call."""

    def __init__(self, **kw):
        self.t, self.j = PagePool(**kw), jpaging.PagePool(**kw)

    def __getattr__(self, name):
        def call(*args):
            out = []
            for pool, exc in ((self.t, OutOfPages),
                              (self.j, jpaging.OutOfPages)):
                try:
                    out.append(("ok", getattr(pool, name)(*args)))
                except exc:
                    out.append(("oop", None))
                except ValueError:
                    out.append(("value", None))
            assert [_plain(o) for o in out[0]] == \
                [_plain(o) for o in out[1]], name
            assert _state(self.t) == _state(self.j), name
            _check_accounting(self.t)
            if out[0][0] == "oop":
                raise OutOfPages(name)
            if out[0][0] == "value":
                raise ValueError(name)
            return out[0][1]
        return call

    def prop(self, name):
        got, want = getattr(self.t, name), getattr(self.j, name)
        assert got == want, name
        return got


def _admit(pool, rng, slot, prompt):
    """Engine-shaped admission: map capped prefix hits, allocate the rest,
    insert the prompt into the trie, mark computed pages filled."""
    p_len = len(prompt)
    hit = pool.match_prefix(prompt)
    cap = max(0, (p_len - 1) // PS)
    shared = list(hit.pages[:cap])
    for lp, page in enumerate(shared):
        pool.share_page(slot, lp, page)
    for lp in range(len(shared), pages_needed(p_len, PS)):
        try:
            pool.alloc(slot, lp)
        except OutOfPages:
            if not pool.evict_prefix(1):
                pool.free_slot(slot)
                return None
            pool.alloc(slot, lp)
    pool.insert_prefix(slot, prompt)
    for lp in range(len(shared), p_len // PS):
        pool.mark_filled(int(pool.t.block_table[slot, lp]))
    pool.insert_terminal(slot, prompt, rng.randrange(VOCAB))
    return p_len


def _decode_write(pool, slot, pos):
    """Engine-shaped decode write: alloc-on-write or a CoW split."""
    lp = pos // PS
    if lp >= pool.prop("max_logical"):
        return False
    page = int(pool.t.block_table[slot, lp])
    if page == -1:
        try:
            pool.alloc(slot, lp)
        except OutOfPages:
            if not pool.evict_prefix(1):
                return False
            pool.alloc(slot, lp)
    elif pool.is_shared(page):
        try:
            src, dst = pool.cow_page(slot, lp)
        except OutOfPages:
            if not pool.evict_prefix(1):
                return False
            src, dst = pool.cow_page(slot, lp)
        assert src != dst and not pool.is_shared(dst)
    return True


@pytest.mark.parametrize("seed", [0, 1, 17, 4242, 99991])
def test_pool_schedule_invariants(seed):
    """Random schedules of admission, decode writes, retirement and
    eviction: the port's pool equals JAX's after every call, accounting
    stays exact, and the pool drains to fully free."""
    rng = random.Random(seed)
    pool = _Both(num_pages=rng.randint(6, 24), page_size=PS,
                 num_slots=rng.randint(2, 4), max_logical=8,
                 prefix_cache=True)
    state = {}
    for _ in range(60):
        op = rng.random()
        idle = [s for s in range(pool.prop("num_slots")) if s not in state]
        if op < 0.4 and idle:
            slot = rng.choice(idle)
            prompt = [rng.randrange(VOCAB)
                      for _ in range(rng.randint(1, 3 * PS + 2))]
            p_len = _admit(pool, rng, slot, prompt)
            if p_len is not None:
                state[slot] = p_len
        elif op < 0.75 and state:
            slot = rng.choice(list(state))
            if _decode_write(pool, slot, state[slot]):
                state[slot] += 1
        elif op < 0.9 and state:
            slot = rng.choice(list(state))
            pool.free_slot(slot)
            del state[slot]
        else:
            pool.evict_prefix(rng.randint(1, 3))
    for slot in list(state):
        pool.free_slot(slot)
    pool.evict_prefix(pool.prop("num_pages"))
    assert pool.prop("free_pages") == pool.prop("num_pages")


@pytest.mark.parametrize("seed", [0, 5, 23, 777])
def test_match_prefix_returns_inserted_pages(seed):
    """A filled, terminated prompt matches itself: full-page hits point at
    the inserter's pages, the terminal memoizes the whole prompt and its
    first token; a diverging prompt hits only the common span.  Every
    ``PrefixHit`` equals JAX's."""
    rng = random.Random(seed)
    pool = _Both(num_pages=16, page_size=PS, num_slots=2, max_logical=8,
                 prefix_cache=True)
    p_len = rng.randint(1, 3 * PS + 3)
    prompt = [rng.randrange(VOCAB) for _ in range(p_len)]
    tok = rng.randrange(VOCAB)
    for lp in range(pages_needed(p_len, PS)):
        pool.alloc(0, lp)
    pool.insert_prefix(0, prompt)
    for lp in range(p_len // PS):
        pool.mark_filled(int(pool.t.block_table[0, lp]))
    pool.insert_terminal(0, prompt, tok)
    hit = pool.match_prefix(prompt)
    assert list(hit.pages) == \
        [int(pool.t.block_table[0, lp]) for lp in range(p_len // PS)]
    assert hit.terminal is not None and hit.terminal[1] == tok
    assert hit.hit_tokens == p_len
    other = list(prompt)
    other[-1] = (other[-1] + 1) % VOCAB
    h2 = pool.match_prefix(other)
    assert h2.terminal is None
    assert h2.hit_tokens == ((p_len - 1) // PS) * PS == len(h2.pages) * PS


def test_cow_split_bookkeeping():
    """CoW repoints exactly the writer; a second write needs no copy."""
    pool = _Both(num_pages=8, page_size=PS, num_slots=2, max_logical=4,
                 prefix_cache=True)
    page = pool.alloc(0, 0)
    pool.share_page(1, 0, page)
    assert pool.is_shared(page) and pool.refcount(page) == 2
    src, dst = pool.cow_page(1, 0)
    assert (src, int(pool.t.block_table[1, 0])) == (page, dst)
    assert pool.refcount(src) == 1 and pool.refcount(dst) == 1
    assert int(pool.t.block_table[0, 0]) == src
    with pytest.raises(ValueError):
        pool.cow_page(1, 0)                  # already private


# ---------------------------------------------------------------------------
# engine level: sharing is invisible in output space, and equals JAX
# ---------------------------------------------------------------------------
def _shared_prompts(seed: int, n: int = 6):
    """n prompts behind a common 2.5-page system prefix + 2 duplicates."""
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, 128, size=2 * EPS + 3)
    prompts = [np.concatenate([pre, rng.randint(0, 128, size=3 + i)]
                              ).astype(np.int32) for i in range(n)]
    return prompts + [prompts[0].copy(), prompts[1].copy()]


def _pools(system):
    rows = []
    for sched in system._schedulers.values():
        row = {"preempted": len(sched._preempted)}
        if sched.pool is not None:
            row["pool"] = dataclasses.asdict(sched.pool.stats)
            row["free"] = sched.pool.free_pages
            row["reclaimable"] = sched.pool.reclaimable_pages
        if sched.swap is not None:
            row["swap"] = dataclasses.asdict(sched.swap.stats)
        rows.append(row)
    return rows


class _Pair:
    """Port and JAX systems per config, kept across calls (the second-wave
    case reuses a system); JAX systems share their traces."""

    def __init__(self, tiny):
        self.tiny, self.cache = tiny, {}

    def systems(self, **kw):
        ck = dict(theta=0.8, kv_layout="paged", page_size=EPS, **kw)
        key = tuple(sorted(ck.items()))
        if key not in self.cache:
            t = self.tiny
            self.cache[key] = (ServingSystem(t["tm"], CollmConfig(**ck)),
                               jax_system(t["jm"], t["params"], **ck))
        return self.cache[key]

    def run(self, prompts, max_new, multi=False, **kw):
        ccfg = {k: kw.pop(k) for k in list(kw)
                if k in ("kv_dtype", "chunked_prefill", "prefix_share",
                         "preemption")}
        tsys, jsys = self.systems(**ccfg)
        fn = "generate_multi" if multi else "generate"
        got = getattr(tsys, fn)(prompts, max_new, **kw)
        want = getattr(jsys, fn)(prompts, max_new, **kw)
        assert_same_run(got, want)
        assert got["cm_stats"] == want["cm_stats"]
        assert _pools(tsys) == _pools(jsys)
        return got


@pytest.fixture(scope="module")
def pair(tiny):
    return _Pair(tiny)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mode", ["collm", "standalone"])
def test_shared_streams_token_identical(pair, mode, kv_dtype):
    """Shared == unshared chunked == monolithic streams, with real prefix
    hits and at least one CoW split on the partial tail page; each run
    equals JAX's."""
    prompts = _shared_prompts(0)
    mono = pair.run(prompts, 10, mode=mode, kv_dtype=kv_dtype, **GKW)
    un = pair.run(prompts, 10, mode=mode, kv_dtype=kv_dtype,
                  chunked_prefill=True, **GKW)
    sh = pair.run(prompts, 10, mode=mode, kv_dtype=kv_dtype,
                  chunked_prefill=True, prefix_share=True, **GKW)
    assert un["tokens"] == mono["tokens"], "chunked diverges from monolithic"
    assert sh["tokens"] == un["tokens"], "sharing changed the output"
    assert sh["stats"].prefix_hit_tokens > 0
    assert sh["stats"].cow_copies >= 1
    assert sh["stats"].prefill_chunks < un["stats"].prefill_chunks
    assert sh["pool_stats"]["allocs"] < un["pool_stats"]["allocs"]
    if mode == "collm":
        assert sh["stats"].upload_bytes < un["stats"].upload_bytes


def test_second_wave_is_all_terminal(pair):
    """Prompts sent again hit cached terminals: no prefill compute, the
    same streams (the memoized first token equals the computed one)."""
    prompts = _shared_prompts(1)
    kw = dict(mode="collm", chunked_prefill=True, prefix_share=True, **GKW)
    r1 = pair.run(prompts, 10, **kw)
    r2 = pair.run(prompts[:3], 10, **kw)
    assert r2["tokens"] == r1["tokens"][:3]
    assert r2["stats"].prefill_chunks == 0
    assert r2["stats"].prefix_hit_tokens == sum(len(p) for p in prompts[:3])


def test_batched_cloud_dedupes_uploads(pair):
    """generate_multi: the engines' sharing and the batcher's agree (the
    smaller hit), streams equal the unshared batched run."""
    prompts = _shared_prompts(2)
    r_un = pair.run(prompts, 10, multi=True, chunked_prefill=True,
                    n_engines=4, max_seq=64)
    r_sh = pair.run(prompts, 10, multi=True, chunked_prefill=True,
                    prefix_share=True, n_engines=4, max_seq=64)
    assert r_sh["tokens"] == r_un["tokens"]
    assert r_sh["stats"].prefix_hit_tokens > 0
    assert r_sh["batcher"]["prefix_hit_tokens"] > 0
    assert r_sh["stats"].prefill_chunks < r_un["stats"].prefill_chunks


def test_prefix_share_survives_page_pressure(pair):
    """A pool too small for the load forces preemption AND prefix-cache
    eviction (evicted pages reset on the device); streams equal an
    unconstrained shared run."""
    prompts = _shared_prompts(3)
    ref = pair.run(prompts, 12, mode="collm", chunked_prefill=True,
                   prefix_share=True, **GKW)
    for pre in ("recompute", "swap"):
        r = pair.run(prompts, 12, mode="collm", chunked_prefill=True,
                     prefix_share=True, preemption=pre, num_slots=4,
                     max_seq=64, max_ctx=64, num_pages=12)
        assert r["tokens"] == ref["tokens"], f"{pre}: tokens diverge"
        assert r["pool_stats"]["prefix_evictions"] >= 1
        assert r["preemptions"] >= 1


def test_config_validation(pair, tiny):
    """The JAX package's refusals: chunked prefill needs paged KV, prefix
    sharing needs chunked prefill, greedy sampling and an edge-resident
    mode."""
    tm = tiny["tm"]
    with pytest.raises(ValueError):
        ServingSystem(tm, CollmConfig(chunked_prefill=True))
    with pytest.raises(ValueError):
        ServingSystem(tm, CollmConfig(prefix_share=True, kv_layout="paged"))
    sys_sh = pair.systems(chunked_prefill=True, prefix_share=True)[0]
    with pytest.raises(ValueError):
        sys_sh.generate(_shared_prompts(4)[:2], 4, mode="cloud", **GKW)
    with pytest.raises(ValueError, match="greedy"):
        sys_sh.generate(_shared_prompts(4)[:2], 4, sampler="temperature",
                        **GKW)


def test_chunked_prefill_samples(pair):
    """Chunked prefill under a sampler other than greedy (allowed without
    prefix sharing): the first token comes from the final chunk's exit
    logits and the decode ticks' masked edge step returns logits too;
    top-k 1 sampling gives the greedy chunked streams."""
    prompts = _shared_prompts(5)[:4]
    tsys = pair.systems(chunked_prefill=True)[0]
    greedy = tsys.generate(prompts, 6, **GKW)
    sampled = tsys.generate(prompts, 6, sampler="temperature", top_k=1,
                            temperature=0.7, **GKW)
    assert sampled["tokens"] == greedy["tokens"]
    assert sampled["stats"].prefill_chunks == greedy["stats"].prefill_chunks
