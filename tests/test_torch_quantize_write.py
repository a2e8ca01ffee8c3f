"""PyTorch port, the int8 K/V page writes: the plain versions of the
``quantize_kv_write`` and ``quantize_kv_scatter`` wrappers (what they run
for CPU tensors) against the JAX package, exactly.

* A decode step's write against JAX's sequence of
  ``repro/models/attention.py`` (``decode_attention_paged``: the page
  lookup, the trash-page redirect, ``.at[dest, slot].set``) with
  ``jattn.quantize_kv_rows``; rows whose table entry is unmapped, rows
  masked out of ``write_mask``, a position past the table (the last entry)
  and a negative position (an entry counted from the end of the row).
* A prefilled row's scatter against ``jattn.paged_scatter_prefill``: a
  ring shorter than the pages (padding fills), a ring longer (trimmed) and
  negative page ids (the trash page).

int8 codes, scales and position markers are compared exactly.  Page 0 is
the trash page: several rows may land on one of its slots, so its codes
and scales are not compared; its markers are (every row written there
carries -1, or one row only).  Inputs come from fixed numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.quantize.ops import (  # noqa: E402
    quantize_kv_scatter, quantize_kv_write)
from repro_torch.kernels.quantize.ref import (  # noqa: E402
    quantize_kv_scatter_ref, quantize_kv_write_ref)

PS = 8


def _pool(rng, num_pages, kvh, d):
    """A pool with stale random contents, so an entry not written shows."""
    return {
        "kp": rng.integers(-127, 128, (num_pages, PS, kvh, d), np.int8),
        "vp": rng.integers(-127, 128, (num_pages, PS, kvh, d), np.int8),
        "ks": rng.random((num_pages, PS, kvh), np.float32),
        "vs": rng.random((num_pages, PS, kvh), np.float32),
        "pos": rng.integers(-1, 50, (num_pages, PS), np.int32),
    }


def _torch(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _same_pool(got, want):
    """Every marker exactly; codes and scales exactly outside page 0."""
    for k in ("kp", "vp", "ks", "vs", "pos"):
        g, w = got[k].numpy(), np.asarray(want[k])
        if k != "pos":
            g, w = g[1:], w[1:]
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def _jax_write(pool, knew, vnew, pos, tbl, mask):
    """JAX's int8 decode-step write (``repro/models/attention.py``,
    ``decode_attention_paged``), on numpy inputs."""
    pool = {k: jnp.asarray(v) for k, v in pool.items()}
    pos, tbl = jnp.asarray(pos), jnp.asarray(tbl)
    page = tbl[jnp.arange(pos.shape[0]), pos // PS]
    ok = page >= 0
    if mask is not None:
        ok &= jnp.asarray(mask)
    dest = jnp.where(ok, page, 0)
    slot = (pos % PS).astype(jnp.int32)
    qk, sk = jattn.quantize_kv_rows(jnp.asarray(knew))
    qv, sv = jattn.quantize_kv_rows(jnp.asarray(vnew))
    return {"pos": pool["pos"].at[dest, slot].set(jnp.where(ok, pos, -1)),
            "kp": pool["kp"].at[dest, slot].set(qk),
            "vp": pool["vp"].at[dest, slot].set(qv),
            "ks": pool["ks"].at[dest, slot].set(sk),
            "vs": pool["vs"].at[dest, slot].set(sv)}


def _write_case(b, kvh, d, masked, seed):
    """Rows with their own pages: row 1 finds its table entry unmapped,
    row 2 writes past its table (clamped to the last entry), row 7 writes
    at a negative position (the last entry, counted from the end); with
    ``masked``, some rows are masked out (row 0 never)."""
    rng = np.random.default_rng(seed)
    n_lp = 3
    num_pages = 1 + b * n_lp
    pool = _pool(rng, num_pages, kvh, d)
    tbl = (1 + rng.permutation(b * n_lp)).reshape(b, n_lp).astype(np.int32)
    pos = rng.integers(0, n_lp * PS, b).astype(np.int32)
    if b > 1:
        tbl[1, pos[1] // PS] = -1
    if b > 2:
        pos[2] = n_lp * PS + 3
    if b > 7:
        pos[7] = -3
    mask = None
    if masked:
        mask = rng.random(b) < 0.5
        mask[0] = True
    scale = np.float32(rng.choice([0.1, 3.0, 40.0]))
    knew = (rng.normal(size=(b, kvh, d)) * scale).astype(np.float32)
    vnew = (rng.normal(size=(b, kvh, d)) * scale).astype(np.float32)
    vnew[0, 0] = 0.0                          # an all-zero row: scale 1e-12
    return pool, knew, vnew, pos, tbl, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kvh", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_kv_write_ref_matches_jax(b, kvh, d, masked):
    pool, knew, vnew, pos, tbl, mask = _write_case(
        b, kvh, d, masked, seed=b * 1000 + kvh * 100 + d + masked)
    want = _jax_write(pool, knew, vnew, pos, tbl, mask)
    args = (torch.from_numpy(knew), torch.from_numpy(vnew),
            torch.from_numpy(pos), torch.from_numpy(tbl),
            None if mask is None else torch.from_numpy(mask))
    got = quantize_kv_write_ref(_torch(pool), *args)
    _same_pool(got, want)
    before = quantize_kv_write.launches
    wrapped = quantize_kv_write(_torch(pool), *args)
    assert quantize_kv_write.launches == before   # CPU: the plain version
    for k in got:
        assert torch.equal(wrapped[k], got[k]), k
    if b > 1:                  # the unmapped row went to the trash page
        assert int(got["pos"][0, pos[1] % PS]) == -1


def _scatter_case(kvh, d, case, seed):
    """(pool, row, pages): ``short`` a 20-token ring over 4 pages (13 real
    positions, then -1; page 3 holds tokens 16-23, the last page is
    unmapped); ``long`` a 40-token ring over 4 pages (trimmed); ``first``
    an unmapped first page."""
    rng = np.random.default_rng(seed)
    length, n_real, pages = {"short": (20, 13, [5, 2, 3, -1]),
                             "long": (40, 40, [3, 1, 4, 6]),
                             "first": (24, 24, [-1, 2, 5])}[case]
    pool = _pool(rng, 7, kvh, d)
    pos = np.where(np.arange(length) < n_real, np.arange(length), -1)
    row = {"k": (rng.normal(size=(1, length, kvh, d)) * 3).astype(np.float32),
           "v": (rng.normal(size=(1, length, kvh, d)) * 3).astype(np.float32),
           "pos": pos[None].astype(np.int32)}
    row["k"][0, 1, 0] = 0.0                   # an all-zero row: scale 1e-12
    return pool, row, np.array(pages, np.int32)


@pytest.mark.parametrize("case", ["short", "long", "first"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kvh", [2, 4])
def test_kv_scatter_ref_matches_jax(kvh, d, case):
    pool, row, pages = _scatter_case(kvh, d, case, seed=kvh * 100 + d)
    want = jattn.paged_scatter_prefill(
        {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in row.items()}, jnp.asarray(pages))
    trow = {k: torch.from_numpy(v) for k, v in row.items()}
    got = quantize_kv_scatter_ref(_torch(pool), trow,
                                  torch.from_numpy(pages))
    _same_pool(got, want)
    before = quantize_kv_scatter.launches
    wrapped = quantize_kv_scatter(_torch(pool), trow, torch.from_numpy(pages))
    assert quantize_kv_scatter.launches == before  # CPU: the plain version
    for k in got:
        assert torch.equal(wrapped[k], got[k]), k
    if case == "short":        # tokens 20-23, past the ring: the fills
        assert np.all(got["ks"][3, 4:].numpy() == 0.0)
        assert np.all(got["vs"][3, 4:].numpy() == 0.0)
        assert not got["kp"][3, 4:].any() and not got["vp"][3, 4:].any()
        assert np.all(got["pos"][3].numpy() == -1)


def test_kv_write_entries_raise_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card reaches no
    plain version and no kernel: the wrappers raise, naming CUDA."""
    meta = dict(device="meta")
    pool = {"kp": torch.empty((3, PS, 2, 64), dtype=torch.int8, **meta),
            "vp": torch.empty((3, PS, 2, 64), dtype=torch.int8, **meta),
            "ks": torch.empty((3, PS, 2), **meta),
            "vs": torch.empty((3, PS, 2), **meta),
            "pos": torch.empty((3, PS), dtype=torch.int32, **meta)}
    kv = torch.empty((2, 2, 64), **meta)
    before = (quantize_kv_write.launches, quantize_kv_scatter.launches)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_kv_write(pool, kv, kv,
                          torch.empty((2,), dtype=torch.int32, **meta),
                          torch.empty((2, 2), dtype=torch.int32, **meta))
    row = {"k": torch.empty((1, 16, 2, 64), **meta),
           "v": torch.empty((1, 16, 2, 64), **meta),
           "pos": torch.empty((1, 16), dtype=torch.int32, **meta)}
    with pytest.raises(ValueError, match="CUDA"):
        quantize_kv_scatter(pool, row,
                            torch.empty((2,), dtype=torch.int32, **meta))
    assert (quantize_kv_write.launches,
            quantize_kv_scatter.launches) == before
