"""PyTorch port, module level: block-paged KV against the JAX package.

* The plain paged decode attention (``decode_attn_paged_ref``, which the
  ``decode_attn_paged`` wrapper runs for CPU tensors) against JAX's paged
  Pallas kernel in interpret mode (``flash_decode_paged(interpret=True)``)
  on the sweeps and the gapped page fixture of ``tests/test_kernels.py``,
  rebuilt here from the same numpy seeds: atol 2e-5 in float32, and int8
  pools whose codes and scales equal JAX's exactly.
* The paged attention module (``decode_attention_paged``, its write mask,
  ``paged_scatter_prefill``, ``paged_reset_pages``, ``paged_gather``)
  against JAX's on the same weights, float32 (atol 1e-5) and int8 (exact
  codes and scales where both quantize the same rows; a decode step's K/V
  rows come out of two frameworks' projections, see ``_same_pool``).
* ``PagePool`` accounting, and page reuse never leaking a retired stream's
  K/V.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.kernels.decode_attn.ops import flash_decode_paged  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.paging import (OutOfPages, PagePool,  # noqa: E402
                                     pages_needed)
from repro_torch.kernels.decode_attn.ops import decode_attn_paged  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_paged_ref, decode_attn_ref)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ATOL = 2e-5
SWEEP = [(2, 8, 2, 64, 33, 16, 8, 0), (3, 4, 4, 32, 17, 8, 4, 0),
         (2, 16, 2, 64, 65, 32, 8, 48), (1, 6, 2, 128, 9, 16, 8, 0)]


def _paged_fixture(b, kvh, d, num_pages, ps, n_lp, seed, *, gaps=False):
    """Random page pool with per-row fills (``tests/test_kernels.py``'s
    fixture, same draws); numpy arrays kp, vp, pos, tbl, cur."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(num_pages, ps, kvh, d).astype(np.float32)
    vp = rng.randn(num_pages, ps, kvh, d).astype(np.float32)
    pos = np.full((num_pages, ps), -1, np.int32)
    tbl = np.full((b, n_lp), -1, np.int32)
    cur = np.zeros((b,), np.int32)
    free = list(range(1, num_pages))
    for bi in range(b):
        fill = rng.randint(2, n_lp * ps)
        cur[bi] = fill - 1
        for lp in range(-(-fill // ps)):
            pg = free.pop()
            tbl[bi, lp] = pg
            n = min(ps, fill - lp * ps)
            pos[pg, :n] = np.arange(lp * ps, lp * ps + n)
            if gaps:      # release-mode: some positions were never written
                drop = rng.rand(n) < 0.3
                pos[pg, :n][drop] = -1
    return kp, vp, pos, tbl, cur


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jq(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _quantize_pool(kp, vp):
    """int8 pages from both packages' ``quantize_kv_rows``; codes and
    scales must agree exactly."""
    jqk, jsk = jattn.quantize_kv_rows(jnp.asarray(kp))
    jqv, jsv = jattn.quantize_kv_rows(jnp.asarray(vp))
    tqk, tsk = tattn.quantize_kv_rows(torch.from_numpy(kp))
    tqv, tsv = tattn.quantize_kv_rows(torch.from_numpy(vp))
    for t, j in ((tqk, jqk), (tsk, jsk), (tqv, jqv), (tsv, jsv)):
        assert t.dtype == {jnp.int8: torch.int8,
                           jnp.float32: torch.float32}[j.dtype.type]
        assert np.array_equal(t.numpy(), np.asarray(j))
    return (tqk, tqv, tsk, tsv), (jqk, jqv, jsk, jsv)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the kernel's function: plain paged decode attention vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kv,d,pages,ps,n_lp,window", SWEEP)
def test_paged_ref_matches_pallas_sweep(b, h, kv, d, pages, ps, n_lp,
                                        window):
    q = np.random.RandomState(7).randn(b, h, d).astype(np.float32)
    arrs = _paged_fixture(b, kv, d, pages, ps, n_lp, seed=pages)
    want = flash_decode_paged(*_jq(q, *arrs[:4]), jnp.asarray(arrs[4]),
                              window=window, interpret=True)
    tq, tk, tv, tp, tt, tc = _t(q, *arrs)
    _close(decode_attn_paged_ref(tq, tk, tv, tp, tt, tc, window=window),
           want)
    # the wrapper takes the plain version for CPU tensors
    _close(decode_attn_paged(tq, tk, tv, tp, tt, tc, window=window), want)


@pytest.mark.parametrize("seed", [0, 1, 17, 2024, 40000, 65535])
@pytest.mark.parametrize("gaps", [False, True])
def test_paged_ref_matches_pallas_random_pools(seed, gaps):
    """Random allocations, with release-mode gaps (pos = -1 holes inside
    mapped pages)."""
    b, h, kv, d, pages, ps, n_lp = 2, 4, 2, 32, 17, 8, 6
    q = np.random.RandomState(seed).randn(b, h, d).astype(np.float32)
    arrs = _paged_fixture(b, kv, d, pages, ps, n_lp, seed=seed, gaps=gaps)
    want = flash_decode_paged(*_jq(q, *arrs), interpret=True)
    _close(decode_attn_paged_ref(*_t(q, *arrs)), want)


def test_paged_ref_matches_dense_gather():
    """An identity-mapped page pool reproduces the ring version."""
    b, h, kv, d, ps, n_lp = 2, 8, 2, 64, 16, 4
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    s = n_lp * ps
    k = torch.from_numpy(rng.randn(b, s, kv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, kv, d).astype(np.float32))
    fill = 50
    pos = torch.where(torch.arange(s)[None] < fill, torch.arange(s)[None],
                      -1).to(torch.int32).repeat(b, 1)
    cur = torch.full((b,), fill - 1, dtype=torch.int32)
    tbl = (1 + torch.arange(b * n_lp, dtype=torch.int32)).reshape(b, n_lp)
    kp = torch.cat([torch.zeros(1, ps, kv, d), k.reshape(b * n_lp, ps, kv, d)])
    vp = torch.cat([torch.zeros(1, ps, kv, d), v.reshape(b * n_lp, ps, kv, d)])
    posp = torch.cat([torch.full((1, ps), -1, dtype=torch.int32),
                      pos.reshape(b * n_lp, ps)])
    torch.testing.assert_close(
        decode_attn_paged_ref(q, kp, vp, posp, tbl, cur),
        decode_attn_ref(q, k, v, pos, cur), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,kv,d,pages,ps,n_lp,window", SWEEP[:3])
def test_paged_int8_ref_matches_pallas_sweep(b, h, kv, d, pages, ps, n_lp,
                                             window):
    """int8 pages + dequant after the load == JAX's in-kernel dequant."""
    q = np.random.RandomState(11).randn(b, h, d).astype(np.float32)
    kp, vp, pos, tbl, cur = _paged_fixture(b, kv, d, pages, ps, n_lp,
                                           seed=pages + 1)
    (tqk, tqv, tsk, tsv), (jqk, jqv, jsk, jsv) = _quantize_pool(kp, vp)
    want = flash_decode_paged(jnp.asarray(q), jqk, jqv, *_jq(pos, tbl, cur),
                              k_scale=jsk, v_scale=jsv, window=window,
                              interpret=True)
    tq, tp, tt, tc = _t(q, pos, tbl, cur)
    got = decode_attn_paged(tq, tqk, tqv, tp, tt, tc, k_scale=tsk,
                            v_scale=tsv, window=window)
    _close(got, want)


@pytest.mark.parametrize("seed", [3, 99, 31337])
@pytest.mark.parametrize("gaps", [False, True])
def test_paged_int8_ref_matches_pallas_random_pools(seed, gaps):
    b, h, kv, d, pages, ps, n_lp = 2, 4, 2, 32, 17, 8, 6
    q = np.random.RandomState(seed).randn(b, h, d).astype(np.float32)
    kp, vp, pos, tbl, cur = _paged_fixture(b, kv, d, pages, ps, n_lp,
                                           seed=seed, gaps=gaps)
    (tqk, tqv, tsk, tsv), (jqk, jqv, jsk, jsv) = _quantize_pool(kp, vp)
    want = flash_decode_paged(jnp.asarray(q), jqk, jqv, *_jq(pos, tbl, cur),
                              k_scale=jsk, v_scale=jsv, interpret=True)
    got = decode_attn_paged_ref(*_t(q), tqk, tqv, *_t(pos, tbl, cur),
                                k_scale=tsk, v_scale=tsv)
    _close(got, want)


@pytest.mark.parametrize("int8", [False, True])
def test_row_with_nothing_mapped_gives_zero(int8):
    b, h, kv, d, pages, ps, n_lp = 3, 8, 2, 64, 33, 16, 8
    q = np.random.RandomState(5).randn(b, h, d).astype(np.float32)
    kp, vp, pos, tbl, cur = _paged_fixture(b, kv, d, pages, ps, n_lp, seed=9)
    tbl[1] = -1                                   # row 1: no page at all
    scales = {}
    if int8:
        (kp, vp, sk, sv), _ = _quantize_pool(kp, vp)
        scales = dict(k_scale=sk, v_scale=sv)
    else:
        kp, vp = _t(kp, vp)
    out = decode_attn_paged(*_t(q), kp, vp, *_t(pos, tbl, cur), **scales)
    assert torch.all(out[1] == 0)
    assert torch.all(out[[0, 2]].abs().sum(-1) > 0)


# ---------------------------------------------------------------------------
# the paged attention module
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layer(tiny_ee_cfg):
    """One attention layer of the tiny config, same weights in both
    packages."""
    tcfg = TModelConfig(**dataclasses.asdict(tiny_ee_cfg))
    jm = jbuild(tiny_ee_cfg)
    np_params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(np_params, tcfg))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["segments"][0])["attn"]
    return tiny_ee_cfg, tcfg, jp, tm.layers[0].attn, jm, np_params, tm


def _pools(cfg, tcfg, num_pages, ps, kv_dtype):
    j = jattn.init_paged_attn_cache(cfg, num_pages, ps, kv_dtype=kv_dtype)
    t = tattn.init_paged_attn_cache(tcfg, num_pages, ps, device="cpu",
                                    kv_dtype=kv_dtype)
    return j, t


def _same_pool(t, j, atol=1e-5, exact_int8=True):
    """Position markers exactly; float pages within ``atol``; int8 codes
    and scales exactly when both packages quantized the same inputs
    (``exact_int8``), else codes within one step and scales within
    ``atol`` relative: a K/V row projected by the two frameworks differs
    in the last float bits, which may move its absmax scale and a code
    sitting on a rounding boundary."""
    assert sorted(t) == sorted(j)
    for k in t:
        got, want = t[k].numpy(), np.asarray(j[k])
        if k == "pos" or (exact_int8 and k in ("kp", "vp", "ks", "vs")
                          and "ks" in t):
            assert np.array_equal(got, want), k
        elif t[k].dtype == torch.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, k
        elif k in ("ks", "vs"):
            np.testing.assert_allclose(got, want, rtol=atol, atol=0)
        else:
            _close(t[k], j[k], atol=atol)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_init_paged_attn_cache_layout(layer, kv_dtype):
    cfg, tcfg = layer[:2]
    j, t = _pools(cfg, tcfg, 6, 8, kv_dtype)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), k
    _same_pool(t, j)
    bf = tattn.init_paged_attn_cache(tcfg, 6, 8, dtype=torch.bfloat16)
    assert bf["kp"].dtype == torch.bfloat16 and bf["pos"].dtype == torch.int32


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@torch.no_grad()
def test_scatter_reset_gather_match_jax(layer, kv_dtype):
    """Admission scatter of a prefilled row (with a trash-page entry for
    bucket padding), page invalidation and the logical gather give JAX's
    pool and views."""
    cfg, tcfg = layer[:2]
    ps, num_pages = 8, 6
    rng = np.random.RandomState(0)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    n, seq = 13, 24                     # 13 real tokens, a 24-slot row
    pos = np.where(np.arange(seq) < n, np.arange(seq), -1).astype(np.int32)
    row = {"k": rng.randn(1, seq, kvh, hd).astype(np.float32) * 3,
           "v": rng.randn(1, seq, kvh, hd).astype(np.float32) * 3,
           "pos": pos[None]}
    pages = np.array([4, 2, -1], np.int32)
    j, t = _pools(cfg, tcfg, num_pages, ps, kv_dtype)
    j = jattn.paged_scatter_prefill(j, {k: jnp.asarray(v)
                                        for k, v in row.items()},
                                    jnp.asarray(pages))
    t = tattn.paged_scatter_prefill(t, {k: torch.from_numpy(v)
                                        for k, v in row.items()}, pages)
    _same_pool(t, j)
    tbl = np.array([[4, 2, -1], [-1, -1, -1]], np.int32)
    for got, want in zip(tattn.paged_gather(t, torch.from_numpy(tbl)),
                         jattn.paged_gather(j, jnp.asarray(tbl))):
        _close(got, want)
    j = jattn.paged_reset_pages(j, jnp.asarray([2, -1]))
    t = tattn.paged_reset_pages(t, [2, -1])
    _same_pool(t, j)
    assert np.all(t["pos"][2].numpy() == -1)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("masked", [False, True])
@torch.no_grad()
def test_decode_attention_paged_matches_jax(layer, kv_dtype, masked):
    """Several decode steps over a paged pool: the same outputs, and the
    same pool after every step; rows without a page and rows masked out of
    ``write_mask`` write only to the trash page."""
    cfg, tcfg, jp, tp = layer[:4]
    ps, num_pages = 8, 9
    j, t = _pools(cfg, tcfg, num_pages, ps, kv_dtype)
    # row 0 spans pages 3, 5; row 1 has nothing mapped; row 2 pages 1, 2
    tbl = np.array([[3, 5, -1], [-1, -1, -1], [1, 2, 7]], np.int32)
    mask = np.array([True, True, False]) if masked else None
    rng = np.random.default_rng(4)
    for step in range(10):
        pos = np.array([5 + step, 0, 12 + step], np.int32)
        x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jy, j = jattn.decode_attention_paged(
            jp, cfg, jnp.asarray(x), j, jnp.asarray(pos), jnp.asarray(tbl),
            write_mask=None if mask is None else jnp.asarray(mask))
        ty, t = tattn.decode_attention_paged(
            tp, tcfg, torch.from_numpy(x), t, torch.from_numpy(pos),
            torch.from_numpy(tbl),
            write_mask=None if mask is None else torch.from_numpy(mask))
        _close(ty[[0, 1]], jy[np.array([0, 1])], atol=1e-5)
        if not masked:
            _close(ty, jy, atol=1e-5)
        # the trash page is write-only: compare the pages rows read
        _same_pool({k: v[1:] for k, v in t.items()},
                   {k: v[1:] for k, v in j.items()}, exact_int8=False)
    if masked:
        # row 2 was masked out of every step: its pages were never written
        assert np.all(t["pos"][[1, 2, 7]].numpy() == -1)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@torch.no_grad()
def test_invalidate_rows_after_matches_jax(layer, layout):
    cfg, tcfg, _, _, jm, np_params, tm = layer
    kw = dict(kv_layout=layout)
    jc, tc = JCoLLM(jm, JCollmConfig(**kw)), CoLLM(tm, CollmConfig(**kw))
    b, ps = 2, 8
    tbl = None
    if layout == "paged":
        jcache = jc.init_cloud_cache_paged(b, 6, ps)
        tcache = tc.init_cloud_cache_paged(b, 6, ps)
        tbl = np.array([[2, 4, -1], [1, 3, 5]], np.int32)
    else:
        jcache = jc.init_cloud_cache(b, 24)
        tcache = tc.init_cloud_cache(b, 24)
    params = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(2)
    for p in range(14):
        h = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([p, p + 3], np.int32)
        jt = None if tbl is None else jnp.asarray(tbl)
        tt = None if tbl is None else torch.from_numpy(tbl)
        _, jcache = jc.cloud_step(params, {"data": jnp.asarray(h)}, jcache,
                                  jnp.asarray(pos), block_tbl=jt)
        _, tcache = tc.cloud_step({"data": torch.from_numpy(h)}, tcache,
                                  torch.from_numpy(pos), block_tbl=tt)
    cut = np.array([9, np.iinfo(np.int32).max], np.int32)
    jcache = jc.invalidate_rows_after(jcache, jnp.asarray(cut), jt)
    tcache = tc.invalidate_rows_after(tcache, torch.from_numpy(cut), tt)
    for si, layers in tcache.items():
        for li, c in enumerate(layers):
            want = np.asarray(jcache[si]["self"]["pos"][li])
            assert np.array_equal(c["self"]["pos"].numpy(), want)


# ---------------------------------------------------------------------------
# PagePool accounting (tests/test_paged_kv.py's, on the copy)
# ---------------------------------------------------------------------------
def test_page_pool_accounting():
    pool = PagePool(6, 4, 2, 8)
    assert pool.can_admit(24) and not pool.can_admit(25)
    p0 = pool.alloc(0, 0)
    assert p0 != 0                                   # trash page never handed out
    assert pool.alloc(0, 0) == p0                    # idempotent re-map
    assert pool.free_pages == 5 and pool.owned_pages(0) == 1
    for lp in range(1, 6):
        pool.alloc(0, lp)
    assert pool.free_pages == 0 and not pool.can_admit(1)
    with pytest.raises(OutOfPages):
        pool.alloc(1, 0)                             # empty free list
    freed = pool.free_slot(0)
    assert len(freed) == 6 and pool.free_pages == 6
    assert np.all(pool.block_table[0] == -1)
    assert pool.stats.allocs == 6 and pool.stats.frees == 6
    assert pool.stats.high_water == 6


def test_page_pool_watermark():
    """The watermark holds pages back from admission but never from
    alloc-on-write."""
    pool = PagePool(6, 4, 2, 8, watermark=2)
    assert pool.available_pages == 4
    assert pool.can_admit(16) and not pool.can_admit(17)
    for lp in range(6):                              # decode ignores watermark
        pool.alloc(0, lp)
    assert pool.free_pages == 0
    with pytest.raises(ValueError, match="watermark"):
        PagePool(6, 4, 2, 8, watermark=6)


def test_page_pool_allocates_like_jax():
    """Same calls, same physical ids and block tables as the JAX pool."""
    from repro.core.paging import PagePool as JPagePool
    pools = (PagePool(7, 4, 3, 5), JPagePool(7, 4, 3, 5))
    for pool in pools:
        for slot, lp in ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1)):
            pool.alloc(slot, lp)
        pool.free_slot(1)
        pool.alloc(2, 1)
        pool.alloc(0, 2)
    assert np.array_equal(pools[0].block_table, pools[1].block_table)
    assert dataclasses.asdict(pools[0].stats) == \
        dataclasses.asdict(pools[1].stats)


def test_prefix_cache_pool_shares_pages():
    """The radix prefix cache, refused before prefix sharing was ported,
    now runs: a second slot maps the first one's filled full pages of a
    common prompt prefix, and the hit and the copy-on-write split move
    their counters (``tests/test_torch_prefix.py`` holds the pool against
    JAX's op for op)."""
    pool = PagePool(6, 4, 2, 8, prefix_cache=True)
    prompt = list(range(10))                  # 2 full pages + 2 tokens
    for lp in range(3):
        pool.alloc(0, lp)
    pool.insert_prefix(0, prompt)
    for lp in range(2):
        pool.mark_filled(int(pool.block_table[0, lp]))
    hit = pool.match_prefix(prompt[:8] + [42])
    assert list(hit.pages) == list(pool.block_table[0, :2])
    for lp, page in enumerate(hit.pages):
        pool.share_page(1, lp, page)
    pool.stats.prefix_hit_tokens += hit.hit_tokens
    src, dst = pool.cow_page(1, 1)
    assert src == pool.block_table[0, 1] and dst == pool.block_table[1, 1]
    assert pool.stats.prefix_hit_tokens == 8 and pool.stats.cow_copies == 1
    assert pool.reclaimable_pages == 0            # slot 0 still maps them
    pool.free_slot(0)
    assert pool.reclaimable_pages == 1            # only the cache holds it


@pytest.mark.parametrize("seed", [0, 7, 123, 4242, 65535])
@torch.no_grad()
def test_page_reuse_no_stale_leak(seed, tiny_ee_cfg):
    """Free + reallocate a retired stream's pages: the new stream's gather
    sees only its own positions, so stream A's K/V never appears in stream
    B's attention window."""
    tcfg = TModelConfig(**dataclasses.asdict(tiny_ee_cfg))
    rng = np.random.RandomState(seed)
    ps, num_pages, n_lp = 8, 6, 3
    pool = PagePool(num_pages, ps, 2, n_lp)
    cache = tattn.init_paged_attn_cache(tcfg, num_pages, ps)
    kvh, hd = tcfg.n_kv_heads, tcfg.resolved_head_dim

    def row(n):
        return {"k": torch.from_numpy(rng.randn(1, n, kvh, hd)).float(),
                "v": torch.from_numpy(rng.randn(1, n, kvh, hd)).float(),
                "pos": torch.arange(n, dtype=torch.int32)[None]}

    len_a = int(rng.randint(ps + 1, n_lp * ps))      # stream A spans pages
    pages_a = [pool.alloc(0, lp) for lp in range(pages_needed(len_a, ps))]
    tattn.paged_scatter_prefill(cache, row(len_a), np.asarray(pages_a))
    freed = pool.free_slot(0)
    assert sorted(freed) == sorted(pages_a)
    tattn.paged_reset_pages(cache, freed)

    len_b = int(rng.randint(1, len_a))               # B shorter than A
    pages_b = [pool.alloc(1, lp) for lp in range(pages_needed(len_b, ps))]
    assert set(pages_b) <= set(freed)                # genuinely reused
    row_b = row(len_b)
    tattn.paged_scatter_prefill(cache, row_b, np.asarray(pages_b))
    k, _, kpos = tattn.paged_gather(
        cache, torch.from_numpy(pool.block_table[1:2]))
    valid = kpos[0] >= 0
    assert int(valid.sum()) == len_b
    assert torch.equal(kpos[0][valid].sort().values,
                       torch.arange(len_b, dtype=torch.int32))
    assert torch.equal(k[0][valid], row_b["k"][0])
