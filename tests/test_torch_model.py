"""PyTorch port, module level: attention, block, Model and CoLLM steps
against the JAX package on the same weights (carried across by
``repro_torch.bridge.params_from_jax``) and the same numpy inputs, in
float32 on the CPU, atol 1e-5 (exact tokens and int8 codes).

Configs: ``tiny_ee_cfg`` (GQA 4/2, tied embeddings), an ee-llm-7b-shaped
small config (MHA, untied ``lm_head``, exits (1, 2), V = 500) and a GQA 4/1
config with a gelu MLP, qkv biases and a sliding window shorter than the
decode (the ring wraps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.exits import ExitDecision as JExitDecision  # noqa: E402
from repro.core.exits import evaluate_exit as jevaluate_exit  # noqa: E402
from repro.core.exits import select_exit_logits as jselect  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.transformer import build_segments  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.core.exits import ExitDecision, select_exit_logits  # noqa: E402
from repro_torch.core.transport import quantize  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ATOL = 1e-5
EE7B_SMALL = ModelConfig(name="ee-llm-7b-small", arch_type="dense",
                         n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                         head_dim=32, d_ff=344, vocab_size=500,
                         exit_layers=(1, 2)).validate()
GELU_WINDOW = ModelConfig(name="gqa-gelu-window", arch_type="dense",
                          n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
                          d_ff=128, vocab_size=300, qkv_bias=True,
                          mlp_kind="gelu", sliding_window=16,
                          tie_embeddings=True, exit_layers=(1, 2)).validate()


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=atol, rtol=0)


@pytest.fixture(params=["tiny-ee", "ee-llm-7b-small", "gqa-gelu-window"])
def pair(request, tiny_ee_cfg):
    jcfg = {"tiny-ee": tiny_ee_cfg, "ee-llm-7b-small": EE7B_SMALL,
            "gqa-gelu-window": GELU_WINDOW}[request.param]
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    jm = jbuild(jcfg)
    rng = np.random.default_rng(0)

    def perturb(path, a):
        # zero-initialised norm gains and biases would hide their paths
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "norm" in name or "_scale" in name or "'b" in name:
            a = a + rng.normal(0, 0.05, a.shape)
        return a.astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        perturb, jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(np_params, tcfg))
    return jcfg, tcfg, jm, jax.tree.map(jnp.asarray, np_params), tm


def _inputs(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)
                                              ).astype(np.float32)


def _layer(jcfg, jparams, i):
    """JAX params of 0-based layer ``i`` (segments stack their layers)."""
    for si, seg in enumerate(build_segments(jcfg)):
        if seg.start <= i < seg.end:
            return jax.tree.map(lambda a: a[i - seg.start],
                                jparams["segments"][si])
    raise IndexError(i)


def _check_ring(tcache, jcache):
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@torch.no_grad()
def test_attention_prefill_then_decode(pair):
    """attention_forward fills the ring; decode_attention then writes and
    attends at per-row positions (through the decode_attn op), past the
    window for the windowed config."""
    jcfg, tcfg, _, jparams, tm = pair
    w = jcfg.layer_windows()[0]
    jp = _layer(jcfg, jparams, 0)["attn"]
    x = _inputs(jcfg, 2, 12)
    jc = jattn.init_attn_cache(jcfg, 2, 32, window=w)
    tc = tattn.init_attn_cache(tcfg, 2, 32, window=w, device="cpu")
    jy, jc = jattn.attention_forward(jp, jcfg, jnp.asarray(x), window=w,
                                     cache=jc)
    ty, tc = tattn.attention_forward(tm.layers[0].attn, tcfg,
                                     torch.from_numpy(x), window=w, cache=tc)
    _close(ty, jy)
    _check_ring(tc, jc)
    for step in range(8):
        pos = np.array([12 + step, 13 + step], np.int32)
        xt = _inputs(jcfg, 2, 1, seed=10 + step)
        jy, jc = jattn.decode_attention(jp, jcfg, jnp.asarray(xt), jc,
                                        jnp.asarray(pos), window=w)
        ty, tc = tattn.decode_attention(tm.layers[0].attn, tcfg,
                                        torch.from_numpy(xt), tc,
                                        torch.from_numpy(pos), window=w)
        _close(ty, jy)
    _check_ring(tc, jc)


@torch.no_grad()
def test_block_forward_and_decode(pair):
    jcfg, tcfg, _, jparams, tm = pair
    w = jcfg.layer_windows()[1]
    jp = _layer(jcfg, jparams, 1)
    x = _inputs(jcfg, 1, 10, seed=2)
    jc = jblocks.init_block_cache(jcfg, "dense", 1, 24, w)
    tc = tblocks.init_block_cache(tcfg, 1, 24, w, device="cpu")
    jy, _, jc = jblocks.block_forward(
        jp, jcfg, "dense", jnp.asarray(x),
        jblocks.BlockCtx(positions=jnp.arange(10), window=w), cache=jc)
    ty, tc = tblocks.block_forward(
        tm.layers[1], tcfg, torch.from_numpy(x),
        tblocks.BlockCtx(positions=torch.arange(10), window=w), cache=tc)
    _close(ty, jy)
    for p in range(10, 13):
        xt = _inputs(jcfg, 1, 1, seed=p)
        jy, jc = jblocks.block_decode(jp, jcfg, "dense", jnp.asarray(xt), jc,
                                      jblocks.BlockCtx(pos=p, window=w))
        ty, tc = tblocks.block_decode(
            tm.layers[1], tcfg, torch.from_numpy(xt), tc,
            tblocks.BlockCtx(pos=torch.tensor([p], dtype=torch.int32),
                             window=w))
        _close(ty, jy)
    _check_ring(tc["self"], jc["self"])


@torch.no_grad()
def test_model_prefill_decode_and_exit_logits(pair):
    jcfg, _, jm, jparams, tm = pair
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9))
    jcaches = jm.init_cache(2, 24)
    tcaches = tm.init_cache(2, 24)
    jx, jex, jcaches, _ = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                     jcaches)
    tx, tex, tcaches, _ = tm.prefill({"tokens": torch.from_numpy(tokens)},
                                     tcaches)
    _close(tx, jx)
    assert sorted(tex) == sorted(jex) == list(jcfg.exit_layers)
    for l in jcfg.exit_layers:
        _close(tex[l], jex[l])
        _close(tm.exit_logits(l, tex[l]), jm.exit_logits(jparams, l, jex[l]))
    _close(tm.logits(tx), jm.logits(jparams, jx))
    tok = tokens[:, -1:]
    for step in range(3):
        pos = np.array([9 + step, 9 + 2 * step], np.int32)   # per-row
        jx, jex, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jcaches,
                                          jnp.asarray(pos))
        tx, tex, tcaches = tm.decode_step(torch.from_numpy(tok), tcaches,
                                          torch.from_numpy(pos))
        _close(tx, jx)
        for l in jcfg.exit_layers:
            _close(tex[l], jex[l])
        tok = np.array(jnp.argmax(jm.logits(jparams, jx)[:, 0], -1))[:, None]


@torch.no_grad()
def test_invalidate_cache_after_matches_jax(pair):
    """After a right-padded prefill, ring slots at and past the true length
    are marked empty (pos = -1) in both frameworks; K/V stay."""
    jcfg, _, jm, jparams, tm = pair
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, 9))
    _, _, jc, _ = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                             jm.init_cache(1, 16))
    _, _, tc, _ = tm.prefill({"tokens": torch.from_numpy(tokens)},
                             tm.init_cache(1, 16))
    jc = jm.invalidate_cache_after(jc, 6)
    tc = tm.invalidate_cache_after(tc, 6)
    for si, seg in enumerate(tm.segments):
        for j in range(seg.length):
            jring = jax.tree.map(lambda a: a[j], jc[si])["self"]
            _check_ring(tc[si][j]["self"], jring)
            assert (tc[si][j]["self"]["pos"][:, 6:] == -1).all()


def _check_decision(td, jd):
    _close(td.confidence, jd.confidence.reshape(-1))
    assert np.array_equal(td.token.numpy(), np.asarray(jd.token).reshape(-1))


def _check_packet(tpkt, jpkt):
    assert sorted(tpkt) == sorted(jpkt)
    if tpkt["data"].dtype == torch.int8:
        assert np.array_equal(tpkt["data"].numpy(), np.asarray(jpkt["data"]))
        np.testing.assert_allclose(tpkt["scale"].numpy(),
                                   _np(jpkt["scale"]), rtol=1e-6)
    else:
        _close(tpkt["data"], jpkt["data"], atol=1e-3)  # float16 rounding


@pytest.mark.parametrize("wire", ["float16", "int8"])
@torch.no_grad()
def test_collm_edge_cloud_steps(pair, wire):
    jcfg, _, jm, jparams, tm = pair
    jc = JCoLLM(jm, JCollmConfig(theta=0.5, wire_format=wire))
    tc = CoLLM(tm, CollmConfig(theta=0.5, wire_format=wire))
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 7))
    jdec, jh1, jedge = jc.edge_prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                       jc.init_edge_cache(1, 20))
    tdec, th1, tedge = tc.edge_prefill({"tokens": torch.from_numpy(tokens)},
                                       tc.init_edge_cache(1, 20))
    _close(th1, jh1)
    for l in jcfg.exit_layers:
        _check_decision(tdec[l], jdec[l])
    jlog, jcloud = jc.cloud_prefill(jparams, jh1, jc.init_cloud_cache(1, 20))
    tlog, tcloud = tc.cloud_prefill(th1, tc.init_cloud_cache(1, 20))
    _close(tlog, jlog)
    tok = tokens[:, -1:]
    jedge_step, jcloud_step = jax.jit(jc.edge_step), jax.jit(jc.cloud_step)
    for pos in range(7, 10):
        jpos = jnp.asarray(pos, jnp.int32)
        jout = jedge_step(jparams, jnp.asarray(tok), jedge, jpos)
        tout = tc.edge_step(torch.from_numpy(tok), tedge, pos)
        jedge, tedge = jout.caches, tout.caches
        for l in jcfg.exit_layers:
            _check_decision(tout.decisions[l], jout.decisions[l])
        assert np.array_equal(tout.exited.numpy(), np.asarray(jout.exited))
        assert np.array_equal(tout.token.numpy(), np.asarray(jout.token))
        _check_packet(tout.upload, jout.upload)
        # both clouds open the same packet: a float16 rounding flip of an
        # edge element would otherwise reach the cloud logits
        pkt = {k: torch.from_numpy(np.array(v))
               for k, v in jout.upload.items()}
        jlog, jcloud = jcloud_step(jparams, jout.upload, jcloud, jpos)
        tlog, tcloud = tc.cloud_step(pkt, tcloud, pos)
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, -1))[:, None].astype(np.int64)

    # standalone and undivided steps from the same caches
    jt, jd, _ = jc.standalone_step(jparams, jnp.asarray(tok), jedge, 10)
    tt, td, _ = tc.standalone_step(torch.from_numpy(tok), tedge, 10)
    _check_decision(td, jd)
    jfull = jm.init_cache(1, 20)
    tfull = tm.init_cache(1, 20)
    _, _, jfull, _ = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                jfull)
    tm.prefill({"tokens": torch.from_numpy(tokens)}, tfull)
    jt, jl, _ = jc.full_step(jparams, jnp.asarray(tok), jfull, 7)
    tt, tl, _ = tc.full_step(torch.from_numpy(tok), tfull, 7)
    _close(tl, jl)
    assert np.array_equal(tt.numpy(), np.asarray(jt))


@torch.no_grad()
def test_fused_exit_upload_matches_jax_and_edge_step(pair):
    """fused_exit_upload (one exit_quant launch) == JAX's fused path (Pallas
    interpret) == the port's own exit_head + quantize pair."""
    jcfg, _, jm, jparams, tm = pair
    jc = JCoLLM(jm, JCollmConfig(theta=0.8, wire_format="int8"))
    tc = CoLLM(tm, CollmConfig(theta=0.8, wire_format="int8"))
    hid = _inputs(jcfg, 3, 1, seed=5) * 4
    jconf, jtok, jpkt = jc.fused_exit_upload(jparams, jnp.asarray(hid),
                                             interpret=True)
    tconf, ttok, tpkt = tc.fused_exit_upload(torch.from_numpy(hid))
    _close(tconf, jconf)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _check_packet(tpkt, jpkt)
    dec = tc.exit_decision(tc.l_ee1, torch.from_numpy(hid))
    assert torch.equal(dec.token, ttok) and torch.equal(dec.confidence, tconf)
    ref = quantize(torch.from_numpy(hid), "int8")
    assert torch.equal(ref["data"], tpkt["data"])
    assert torch.equal(ref["scale"], tpkt["scale"])
    jd = jevaluate_exit(jm.exit_logits(jparams, jc.l_ee1, jnp.asarray(hid)))
    _check_decision(dec, jd)


def test_select_exit_logits_matches_jax():
    rng = np.random.default_rng(6)
    logits = {l: rng.normal(size=(4, 50)).astype(np.float32) for l in (2, 5)}
    conf = {2: np.array([0.9, 0.1, 0.5, 0.95], np.float32),
            5: np.array([0.2, 0.85, 0.3, 0.1], np.float32)}
    tok = {l: logits[l].argmax(-1).astype(np.int32) for l in logits}
    jdec = {l: JExitDecision(jnp.asarray(tok[l]), jnp.asarray(conf[l]),
                             jnp.asarray(logits[l])) for l in logits}
    tdec = {l: ExitDecision(torch.from_numpy(tok[l]),
                            torch.from_numpy(conf[l]),
                            torch.from_numpy(logits[l])) for l in logits}
    jsel, jex, jidx = jselect(jdec, 0.8)
    tsel, tex, tidx = select_exit_logits(tdec, 0.8)
    _close(tsel, jsel)
    assert np.array_equal(tex.numpy(), np.asarray(jex))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    with pytest.raises(ValueError):
        select_exit_logits({l: d._replace(logits=None)
                            for l, d in tdec.items()}, 0.8)


def test_collm_rejects_unported_features():
    cfg = TModelConfig(name="t", arch_type="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                       exit_layers=(1,))
    model = Model(cfg, device="cpu")
    # the paged layout is ported (tests/test_torch_batched.py); chunked
    # prefill on it is not
    CoLLM(model, CollmConfig(kv_layout="paged"))
    with pytest.raises(NotImplementedError, match="chunked_prefill"):
        CoLLM(model, CollmConfig(kv_layout="paged", chunked_prefill=True))
    with pytest.raises(ValueError):
        CoLLM(model, CollmConfig(wire_format="bfloat16"))
