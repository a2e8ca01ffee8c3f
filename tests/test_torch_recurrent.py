"""PyTorch port, module level: the recurrent and hybrid decoders'
blocks, models, state packets and engine gates against the JAX package,
at reduced xlstm-350m and zamba2-1.2b (``tests/_recurrent_parity.py``),
weights carried across by ``repro_torch.bridge``, float32 on the CPU.

* mLSTM, sLSTM and Mamba2 blocks: a forward that continues from a carried
  state, and a decode step, equal JAX's (2e-5); a row outside the decode
  write mask keeps its conv and recurrent state bit for bit.
* The bridge carries every JAX leaf (Zamba2's shared block into
  ``shared.*``), Mamba2's float32 leaves stay float32 in a bfloat16
  model; prefill logits equal JAX's (1e-4); decode after a prefill equals
  the full forward's last logits (2e-4, the bound of
  ``tests/test_archs_smoke.py::test_smoke_decode_matches_teacher_forcing``).
* ``quantize_tree``, ``dequantize_tree``, ``make_packet``, ``open_packet``
  and ``StatePacket.wire_breakdown`` on a recurrent state tree equal
  JAX's.
* Speculative decode, chunked prefill and swap preemption raise as the
  JAX package raises, with its messages.

The greedy streams are in ``tests/test_torch_recurrent_streams_xlstm.py``
and ``..._zamba2.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _recurrent_parity import NAMES, arch_of  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.transformer import build_segments  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.configs.registry import get_config as tget_config  # noqa: E402,E501
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

# kind -> (architecture, layer, JAX forward / decode / cache, port's)
BLOCKS = {
    "mlstm": ("xlstm-350m", 0,
              (jxlstm.mlstm_forward, jxlstm.mlstm_decode,
               jxlstm.init_mlstm_cache),
              (txlstm.mlstm_forward, txlstm.mlstm_decode)),
    "slstm": ("xlstm-350m", 3,
              (jxlstm.slstm_forward, jxlstm.slstm_decode,
               jxlstm.init_slstm_cache),
              (txlstm.slstm_forward, txlstm.slstm_decode)),
    "mamba2": ("zamba2-1.2b", 0,
               (jm2.mamba2_forward, jm2.mamba2_decode,
                jm2.init_mamba2_cache),
               (tm2.mamba2_forward, tm2.mamba2_decode)),
}
F32_LEAVES = ("a_log", "dt_bias", "d_skip")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _close_tree(got, want, atol, row=slice(None)):
    for path, w in _leaves(want):
        g = dict(_leaves(got))[path]
        np.testing.assert_allclose(g[row].numpy(), np.asarray(w)[row],
                                   atol=atol, rtol=0, err_msg=path)


@pytest.mark.parametrize("kind", list(BLOCKS))
@torch.no_grad()
def test_block_matches_jax(kind):
    """20 tokens from the zero state, 17 more from the carried state, then
    one decode step; the decode's write mask excludes row 1."""
    name, layer, (jfwd, jdec, jinit), (tfwd, tdec) = BLOCKS[kind]
    arch = arch_of(name)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      arch.np_params["segments"][layer])
    block = arch.tm.layers[layer]
    assert block.kind == kind
    x = np.random.default_rng(5).standard_normal(
        (2, 38, arch.tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    _, js = jfwd(jp, arch.jcfg, jx[:, :20], state=jinit(arch.jcfg, 2),
                 return_state=True)
    jy, js = jfwd(jp, arch.jcfg, jx[:, 20:37], state=js, return_state=True)
    jd, js_dec = jdec(jp, arch.jcfg, jx[:, 37:], js)
    _, ts = tfwd(block, arch.tcfg, tx[:, :20])
    ty, ts = tfwd(block, arch.tcfg, tx[:, 20:37], state=ts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=0)
    _close_tree(ts, js, 2e-5)
    cache, before = _clone(ts), _clone(ts)
    td, cache = tdec(block, arch.tcfg, tx[:, 37:], cache,
                     torch.tensor([True, False]))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd)[0], atol=2e-5,
                               rtol=0)
    _close_tree(cache, js_dec, 2e-5, row=0)
    for path, old in _leaves(before):
        assert torch.equal(dict(_leaves(cache))[path][1], old[1]), path


def _jax_names(arch):
    """The port's parameter names of every JAX leaf."""
    names = {"embed", "final_norm"} | {f"exit_norms.{l}" for l in
                                       arch.np_params["exit_norms"]}
    if "lm_head" in arch.np_params:
        names.add("lm_head")
    names |= {f"shared.{p}" for p, _ in
              _leaves(arch.np_params.get("shared", {}))}
    for seg, tree in zip(build_segments(arch.jcfg),
                         arch.np_params["segments"]):
        for path, _ in _leaves(tree):
            names |= {f"layers.{seg.start + j}.{path}"
                      for j in range(seg.length)}
    return names


@pytest.mark.parametrize("name", NAMES)
@torch.no_grad()
def test_model_matches_jax(name):
    """The port's configuration and its ``reduced`` equal JAX's (state 16,
    chunk 32, period 2); the bridge and a bfloat16 model's dtypes;
    prefill logits at both prompt lengths against JAX; decode against
    teacher forcing."""
    arch = arch_of(name)
    for cut in (lambda c: c, lambda c: treduced(c, n_layers=4)):
        assert dataclasses.asdict(cut(tget_config(name))) \
            == dataclasses.asdict(cut(jget_config(name)))
    state = params_from_jax(arch.np_params, arch.tcfg)
    assert set(state) == _jax_names(arch) == {
        n for n, _ in arch.tm.named_parameters()}
    bf16 = Model(arch.tcfg, device="cpu", dtype=torch.bfloat16)
    bf16.load_state_dict(state)
    for n, p in bf16.named_parameters():
        assert p.dtype == (torch.float32 if n.split(".")[-1] in F32_LEAVES
                           else torch.bfloat16), n
    jm, tm = arch.jm, arch.tm
    for prompt in arch.prompts[:2]:
        jx, _, _, _ = jm.prefill(arch.params, {"tokens": prompt[None]},
                                 jm.init_cache(1, len(prompt)))
        tx, _, _, _ = tm.prefill({"tokens": torch.as_tensor(prompt[None])},
                                 tm.init_cache(1, len(prompt)))
        np.testing.assert_allclose(tm.logits(tx).numpy(),
                                   np.asarray(jm.logits(arch.params, jx)),
                                   atol=1e-4, rtol=0)
    tokens = np.random.default_rng(3).integers(0, arch.tcfg.vocab_size,
                                               (2, 12))
    tx, _, _, _ = tm.prefill({"tokens": torch.as_tensor(tokens)},
                             tm.init_cache(2, 12))
    full = tm.logits(tx)[:, -1]
    caches = tm.init_cache(2, 64)
    tm.prefill({"tokens": torch.as_tensor(tokens[:, :-1])}, caches)
    xh, _, _ = tm.decode_step(torch.as_tensor(tokens[:, -1:]), caches, 11)
    assert float((tm.logits(xh)[:, 0] - full).abs().max()) < 2e-4


@torch.no_grad()
def test_state_packets_match_jax():
    """xlstm's mLSTM and sLSTM states after a prompt, as a state tree
    beside a (2, 1, d) hidden, in each wire format: the quantized tree,
    its round trip, ``make_packet`` / ``open_packet`` and the wire
    breakdown (one float32 scale per int8 leaf row) equal JAX's."""
    arch = arch_of("xlstm-350m")
    tm = arch.tm
    caches = tm.init_cache(2, 64)
    toks = np.random.default_rng(6).integers(0, arch.tcfg.vocab_size, (2, 9))
    tm.prefill({"tokens": torch.as_tensor(toks)}, caches)
    tree = {"mlstm": caches[0][0], "slstm": caches[3][0]}
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    hidden = np.random.default_rng(7).standard_normal(
        (2, 1, arch.tcfg.d_model)).astype(np.float32)
    pos = np.array([9, 9], np.int32)
    for fmt in ("float32", "float16", "int8"):
        got = ttransport.quantize_tree(tree, fmt)
        want = jtransport.quantize_tree(jtree, fmt)
        wl = dict(_leaves(want))
        for path, g in _leaves(got):
            w = np.asarray(wl[path])
            assert str(g.dtype) == f"torch.{w.dtype.name}", path
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32), path)
        _close_tree(ttransport.dequantize_tree(got),
                    jtransport.dequantize_tree(want), 0.0)
        tp = ttransport.make_packet(torch.as_tensor(hidden), fmt,
                                    states=tree, pos=pos)
        jp = jtransport.make_packet(jnp.asarray(hidden), fmt, states=jtree,
                                    pos=jnp.asarray(pos))
        assert tp.wire_breakdown() == jp.wire_breakdown()
        assert tp.nbytes() == jp.nbytes()
        th, ts = ttransport.open_packet(tp)
        jh, js = jtransport.open_packet(jp)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _close_tree(ts, js, 0.0)
    assert jp.wire_breakdown()["scale"] > 4 * 2      # a scale per leaf row


REFUSED = {
    "speculative": dict(speculative=True),
    "chunked": dict(kv_layout="paged", chunked_prefill=True),
    "swap": dict(kv_layout="paged", preemption="swap"),
}


def test_refused_paths_raise_as_jax():
    """Speculative decode (a rewind), chunked prefill (a mid-prompt
    resume) and swap preemption (a page-only snapshot) raise ValueError
    with the JAX package's message for both models."""
    for name in NAMES:
        arch = arch_of(name)
        for kw in REFUSED.values():
            tsys, jsys = arch.systems(**kw)
            msgs = []
            for system in (jsys, tsys):
                with pytest.raises(ValueError) as err:
                    system.generate(arch.prompts[:1], 2, num_slots=1)
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]
