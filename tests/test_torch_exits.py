"""PyTorch port: the exit heads of one edge tick in one launch, on the CPU.

``exit_heads`` (E exits of B slots, the int8 packet of one exit's raw rows
with ``quant_exit``) and ``CoLLM.exit_decisions`` against the JAX package's
``exit_head_pallas`` / ``exit_quant_pallas`` run once an exit in interpret
mode (its oracle where V is ragged), and JAX's ``quantize_int8``.  On the
card one launch of ``csrc/exit_common.cuh`` cuts V in ranges of 256-row
boxes, one range a block; every thread folds its W rows into a running
(max, sum-exp, argmax), the block merges its threads into one partial a
row, and the last block merges the partials.  The kernel runs only on the
card (``tests/test_torch_gpu.py``); here a plain-torch mirror of that
partition and merge is held against JAX's oracle, with the partials merged
in the kernel's fixed order and in shuffled orders.

Tolerances are those of tests/test_torch_kernels.py: 1e-5 for
confidences, 1e-4 for logsumexp, exact tokens, exact int8 codes with scale
rtol 1e-6.

Each test loops over its cases, so the file holds 7 items:
``pytest -n 6 --dist loadfile`` queues files by item count, and more than
7 would queue it ahead of ``tests/test_collm_invariants.py``, whose eager
``lax.cond`` compile crashes XLA after some sequences of earlier files in
one worker process (ROADMAP §C).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.exits import evaluate_exit as jevaluate_exit  # noqa: E402
from repro.kernels.exit_head.kernel import exit_head_pallas  # noqa: E402
from repro.kernels.exit_head.ref import exit_head_ref as jax_exit_ref  # noqa: E402
from repro.kernels.exit_quant.kernel import exit_quant_pallas  # noqa: E402
from repro.kernels.exit_quant.ref import exit_quant_ref as jax_eq_ref  # noqa: E402
from repro.kernels.quantize.ops import quantize_int8 as jquantize  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.exits import evaluate_exits  # noqa: E402
from repro_torch.core.transport import quantize  # noqa: E402
from repro_torch.kernels.exit_head.ops import exit_heads  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

T = torch.from_numpy
BOX_ROWS = 256          # W rows of one TMA box of csrc/exit_common.cuh


def exit_plan(v, blocks):
    """The kernel's split of V: the [lo, hi) W rows of each block when
    ``blocks`` fit on the card.  V is cut in boxes of ``BOX_ROWS`` rows
    and block b of G = min(boxes, blocks) takes boxes [b * boxes // G,
    (b + 1) * boxes // G), as ``exit_heads_kernel`` does."""
    nbox = -(-v // BOX_ROWS)
    g = min(nbox, blocks)
    return [(min(v, b * nbox // g * BOX_ROWS),
             min(v, (b + 1) * nbox // g * BOX_ROWS)) for b in range(g)]


def _np(x):
    return np.asarray(x, np.float32)


def _check_exit(got, want):
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=1e-5)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), _np(want[2]), atol=1e-4)


def _heads_inputs(e, b, d, v, seed, ties=()):
    """(E, B, d) hiddens, (V, d) weight, (E, d) norm scales, each exit with
    its own scale.  Row 0 of exit i tops out on the two equal one-hot rows
    ``ties[i]`` (on its largest normalized element, a column every other
    exit's row 0 holds at 0); a tie shared by every exit where ``ties``
    repeats one pair on rows that are equal across exits."""
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(e, b, d)) * 3).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.02).astype(np.float32)
    ns = (rng.normal(size=(e, d)) * 0.1).astype(np.float32)
    for i, tie in enumerate(ties):
        hn0 = h[i, 0] * (1 + ns[i])
        j = int(np.abs(hn0).argmax())
        h[[k for k in range(e) if k != i], 0, j] = 0.0
        w[list(tie)] = 0.0
        w[list(tie), j] = 4.0 * np.sign(hn0[j])
    return h, w, ns


def _jax_exit(h, w, ns, bv):
    """JAX's exit head of one exit: the Pallas kernel in interpret mode
    where its tiles cover V, else its oracle (as JAX's wrapper does)."""
    b, v = h.shape[0], w.shape[0]
    if bv and v % bv == 0:
        return exit_head_pallas(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(ns), block_b=min(8, b),
                                block_v=bv, interpret=True)
    return jax_exit_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(ns))


# ---------------------------------------------------------------------------
# exit_heads against the Pallas kernels, one exit at a time
# ---------------------------------------------------------------------------
PER_EXIT_CASES = [                       # b, d, v, Pallas block_v
    (1, 64, 512, 128),
    (3, 64, 1024, 256),
    (8, 128, 512, 128),
    (5, 64, 300, 0),                     # ragged V: JAX's oracle
]


def test_exit_heads_match_pallas_per_exit():
    for b, d, v, bv in PER_EXIT_CASES:
        ties = ((40, v - 20), (7, 9))    # across tiles; inside one tile
        h, w, ns = _heads_inputs(2, b, d, v, seed=b * v + d, ties=ties)
        got = exit_heads(T(h), T(w), T(ns))
        assert [x.shape for x in got] == [(2, b)] * 3
        for i in range(2):
            want = _jax_exit(h[i], w, ns[i], bv)
            _check_exit([x[i] for x in got], want)
            assert int(got[1][i, 0]) == ties[i][0]    # the lowest index


def test_exit_heads_tie_across_exits():
    """Both exits' row 0 on the same hidden and the same tie: each exit
    takes the lowest index, as JAX does for each exit alone."""
    h, w, ns = _heads_inputs(1, 2, 64, 512, seed=3, ties=((60, 400),))
    h2 = np.concatenate([h, h])
    ns2 = np.concatenate([ns, ns])
    got = exit_heads(T(h2), T(w), T(ns2))
    for i in range(2):
        _check_exit([x[i] for x in got], _jax_exit(h2[i], w, ns2[i], 128))
    assert got[1][:, 0].tolist() == [60, 60]


PACKET_CASES = [                         # b, d, v, Pallas block_v, exit
    (1, 64, 512, 256, 0),
    (3, 32, 256, 128, 1),
    (8, 64, 512, 256, 0),
    (3, 64, 300, 0, 1),                  # ragged V: JAX's oracle
]


def test_exit_heads_packet_matches_exit_quant_pallas():
    """With ``quant_exit`` the launch also writes exit qe's int8 packet:
    equal to JAX's ``quantize_int8`` of its raw rows, and with that exit's
    decision equal to ``exit_quant_pallas``; an exit that is not there
    raises."""
    for b, d, v, bv, qe in PACKET_CASES:
        h, w, ns = _heads_inputs(2, b, d, v, seed=v + b + qe,
                                 ties=((3, v - 56),))
        got = exit_heads(T(h), T(w), T(ns), quant_exit=qe)
        if bv:
            want = exit_quant_pallas(jnp.asarray(h[qe]), jnp.asarray(w),
                                     jnp.asarray(ns[qe]), block_b=min(8, b),
                                     block_v=bv, interpret=True)
        else:
            want = jax_eq_ref(jnp.asarray(h[qe]), jnp.asarray(w),
                              jnp.asarray(ns[qe]))
        _check_exit([x[qe] for x in got[:3]], want)
        jq, js = jquantize(jnp.asarray(h[qe]), interpret=True)
        assert got[3].dtype == torch.int8 and got[3].shape == (b, d)
        assert np.array_equal(got[3].numpy(), np.asarray(jq))
        assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[4].numpy(), _np(js), rtol=1e-6)
        assert got[4].shape == (b, 1)
    h, w, ns = _heads_inputs(2, 1, 32, 64, seed=0)
    with pytest.raises(ValueError):
        evaluate_exits([T(h[0])], T(w), T(ns[:1]), 1e-5, quant_exit=1)


# ---------------------------------------------------------------------------
# CoLLM.exit_decisions and the edge steps against JAX
# ---------------------------------------------------------------------------
SMALL = ModelConfig(name="ee-small", arch_type="dense", n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=300, exit_layers=(1, 2)).validate()


@pytest.fixture(scope="module")
def pair():
    tcfg = TModelConfig(**dataclasses.asdict(SMALL))
    jm = jbuild(SMALL)
    rng = np.random.default_rng(0)

    def perturb(path, a):
        # zero-initialised exit norms would give both exits one scale
        a = np.asarray(a)
        if "norm" in jax.tree_util.keystr(path):
            a = a + rng.normal(0, 0.1, a.shape)
        return a.astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        perturb, jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(np_params, tcfg))
    return jm, jax.tree.map(jnp.asarray, np_params), tm


@torch.no_grad()
def test_exit_decisions_match_jax(pair):
    """B = 1, 3 and 8 slots, with and without the exit logits."""
    jm, jparams, tm = pair
    tc = CoLLM(tm, CollmConfig())
    for b in (1, 3, 8):
        rng = np.random.default_rng(b)
        hid = {l: (rng.normal(size=(b, 1, SMALL.d_model)) * 2
                   ).astype(np.float32) for l in SMALL.exit_layers}
        for with_logits in (False, True):
            got = tc.exit_decisions({l: T(x) for l, x in hid.items()},
                                    with_logits)
            assert sorted(got) == list(SMALL.exit_layers)
            for l, x in hid.items():
                jd = jevaluate_exit(jm.exit_logits(jparams, l,
                                                   jnp.asarray(x)))
                np.testing.assert_allclose(got[l].confidence.numpy(),
                                           _np(jd.confidence), atol=1e-5)
                assert np.array_equal(got[l].token.numpy(),
                                      np.asarray(jd.token))
                if with_logits:
                    np.testing.assert_allclose(got[l].logits.numpy(),
                                               _np(jd.logits), atol=1e-5)
                else:
                    assert got[l].logits is None
                # the same decision as the single-exit path, bit for bit
                one = tc.exit_decision(l, T(x))
                assert torch.equal(one.token, got[l].token)
                assert torch.equal(one.confidence, got[l].confidence)


@torch.no_grad()
def test_int8_edge_step_packet_and_stream_match_jax(pair):
    """The edge step with an int8 wire takes its l_ee1 packet from the exit
    launch: bit-equal to ``transport.quantize``, and to JAX's packet (codes
    exact, scales within rtol 1e-6), with JAX's decisions and tokens, over
    a few decode ticks after the prefill; the masked step gives the same
    packet.  The float16 wire is a cast, as before."""
    for wire in ("int8", "float16"):
        _edge_ticks_match_jax(pair, wire)


def _edge_ticks_match_jax(pair, wire):
    jm, jparams, tm = pair
    jc = JCoLLM(jm, JCollmConfig(theta=0.4, wire_format=wire))
    tc = CoLLM(tm, CollmConfig(theta=0.4, wire_format=wire))
    tokens = np.random.default_rng(5).integers(0, SMALL.vocab_size, (2, 6))
    _, _, jedge = jc.edge_prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jc.init_edge_cache(2, 16))
    _, _, tedge = tc.edge_prefill({"tokens": T(tokens)},
                                  tc.init_edge_cache(2, 16))
    tok = tokens[:, -1:]
    for pos in range(6, 10):
        jout = jc.edge_step(jparams, jnp.asarray(tok), jedge,
                            jnp.asarray(pos, jnp.int32))
        # the exits' hiddens of this tick; edge_step then rewrites the
        # same cache slots with the same K/V
        _, exit_h, _ = tm.decode_step(T(tok), tedge, pos, tc.edge_segs)
        tout = tc.edge_step(T(tok), tedge, pos)
        jedge = jout.caches
        for l in SMALL.exit_layers:
            np.testing.assert_allclose(tout.decisions[l].confidence.numpy(),
                                       _np(jout.decisions[l].confidence),
                                       atol=1e-5)
            assert np.array_equal(tout.decisions[l].token.numpy(),
                                  np.asarray(jout.decisions[l].token))
        assert np.array_equal(tout.token.numpy(), np.asarray(jout.token))
        # against JAX as tests/test_torch_model.py holds packets: int8
        # codes exact, scales rtol 1e-6 (XLA's division), float16 1e-3
        assert tout.upload.keys() == jout.upload.keys()
        if wire == "int8":
            assert np.array_equal(tout.upload["data"].numpy(),
                                  np.asarray(jout.upload["data"]))
            np.testing.assert_allclose(tout.upload["scale"].numpy(),
                                       _np(jout.upload["scale"]), rtol=1e-6)
        else:
            np.testing.assert_allclose(tout.upload["data"].float().numpy(),
                                       _np(jout.upload["data"]), atol=1e-3)
        ref = quantize(exit_h[tc.l_ee1], wire)
        assert all(torch.equal(tout.upload[k], ref[k]) for k in ref)
        masked = tc.edge_step_masked(T(tok), tedge, pos,
                                     torch.ones(2, dtype=torch.bool))
        assert all(torch.equal(masked.upload[k], ref[k]) for k in ref)
        tok = np.asarray(jout.token)[:, None].astype(np.int64)


# ---------------------------------------------------------------------------
# the kernel's partition of V and its merge, mirrored in plain torch
# ---------------------------------------------------------------------------
def test_exit_plan_covers_v_in_box_ranges():
    for v, blocks in [(300, 132), (32000, 132), (262144, 132),
                      (262144, 264), (1024, 3), (257, 1)]:
        plan = exit_plan(v, blocks)
        nbox = -(-v // BOX_ROWS)
        assert len(plan) == min(nbox, blocks)
        assert plan[0][0] == 0 and plan[-1][1] == v
        for (lo, hi), (lo2, _) in zip(plan, plan[1:]):
            assert hi == lo2
        sizes = [-(-(hi - lo) // BOX_ROWS) for lo, hi in plan]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert all(lo % BOX_ROWS == 0 for lo, _ in plan)


def _merge(a, b):
    """The kernel's merge of two (m, l, arg) partials (elementwise): the
    larger max wins the argmax, equal maxima keep the lower index."""
    (m, l, arg), (m2, l2, arg2) = a, b
    take = (m2 > m) | ((m2 == m) & (arg2 < arg))
    mx = torch.maximum(m, m2)
    empty = mx == -math.inf
    safe = torch.where(empty, 0.0, mx)
    lsum = torch.where(empty, l, l * torch.exp(m - safe)
                       + l2 * torch.exp(m2 - safe))
    return mx, lsum, torch.where(take, arg2, arg)


def _block_partial(logits, lo, hi):
    """One block's partial per row: thread t folds rows lo + t, lo + t +
    256, ... in order into a running (max, sum-exp, argmax); the threads
    merge in warp butterflies (xor 16 .. 1), then the warps in order."""
    r = logits.shape[0]
    m = torch.full((r, BOX_ROWS), -math.inf)
    s = torch.zeros((r, BOX_ROWS))
    a = torch.full((r, BOX_ROWS), 2 ** 31 - 1, dtype=torch.int64)
    for start in range(lo, hi, BOX_ROWS):
        idx = torch.arange(start, start + BOX_ROWS)
        valid = idx < hi
        x = torch.full((r, BOX_ROWS), -math.inf)
        x[:, valid] = logits[:, idx[valid]]
        up = valid & (x > m)
        keep = valid & ~up
        s = torch.where(up, s * torch.exp(m - x) + 1.0,
                        torch.where(keep, s + torch.exp(x - m), s))
        a = torch.where(up, idx.expand(r, -1), a)
        m = torch.where(up, x, m)
    lane = torch.arange(BOX_ROWS)
    st = (m, s, a)
    for o in (16, 8, 4, 2, 1):
        st = _merge(st, tuple(t[:, lane ^ o] for t in st))
    out = tuple(t[:, 0] for t in st)
    for w in range(1, BOX_ROWS // 32):
        out = _merge(out, tuple(t[:, 32 * w] for t in st))
    return out


def split_merge(h, w, ns, blocks, order=None, eps=1e-5):
    """The kernel's arithmetic in plain torch: hn and its logits in
    float32, one partial a (row, block) over ``exit_plan``'s ranges, merged
    as the last block merges them (lane l takes blocks l, l + 32, ... in
    order, then a butterfly), or sequentially in ``order``."""
    hn = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps) * (1 + ns)
    logits = hn @ w.T
    parts = [_block_partial(logits, lo, hi)
             for lo, hi in exit_plan(w.shape[0], blocks)]
    if order is not None:
        out = parts[order[0]]
        for i in order[1:]:
            out = _merge(out, parts[i])
    else:
        r = logits.shape[0]
        empty = (torch.full((r,), -math.inf), torch.zeros(r),
                 torch.full((r,), 2 ** 31 - 1, dtype=torch.int64))
        lanes = []
        for lane in range(32):
            acc = empty
            for b in range(lane, len(parts), 32):
                acc = _merge(acc, parts[b])
            lanes.append(acc)
        st = tuple(torch.stack(t, 1) for t in zip(*lanes))
        idx = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            st = _merge(st, tuple(t[:, idx ^ o] for t in st))
        out = tuple(t[:, 0] for t in st)
    m, l, a = out
    lse = m + torch.log(l)
    return torch.exp(m - lse), a.to(torch.int32), lse


def test_split_merge_matches_jax_oracle_in_any_order():
    for b, d, v, blocks in [(1, 64, 3000, 7), (4, 32, 2048, 3),
                            (2, 64, 300, 132), (3, 32, 5000, 16)]:
        tie = (5, v - 3)                  # first and last block
        h, w, ns = _heads_inputs(1, b, d, v, seed=v + blocks, ties=(tie,))
        want = jax_exit_ref(jnp.asarray(h[0]), jnp.asarray(w),
                            jnp.asarray(ns[0]))
        fixed = split_merge(T(h[0]), T(w), T(ns[0]), blocks)
        _check_exit(fixed, want)
        assert int(fixed[1][0]) == tie[0]
        n = len(exit_plan(v, blocks))
        for seed in range(3):
            order = np.random.default_rng(seed).permutation(n).tolist()
            got = split_merge(T(h[0]), T(w), T(ns[0]), blocks, order=order)
            _check_exit(got, want)
            assert torch.equal(got[1], fixed[1])
            torch.testing.assert_close(got[0], fixed[0], atol=1e-6, rtol=0)
