"""PyTorch port: the cloud mesh (``CollmConfig.cloud_mesh``) on
``torch.distributed``, ranks on the CPU over gloo.

The JAX package's own sharded path cannot serve as the reference here (its
serving tests in ``tests/test_cloud_tp.py`` raise ``ShardingTypeError``
on the embedding gather under jax 0.9.0 when run on forced host devices,
and skip without them), so the port's mesh is held to that file's
acceptance bar: the sharded streams equal the single-device streams, of
the JAX package and of the port, token for token.

* The JAX file's matrix at ``(data, model) = (2, 4)`` on its untrained
  tiny GQA model (4 heads over 2 KV heads: ``wk`` / ``wv`` whole, one
  query and one KV head a rank): ``generate_multi`` on dense, paged and
  int8 pages with and without 4-token drafts, ``generate`` with prefix
  sharing and with a recompute preemption; prefix hits and preemptions
  counted alike.  The two-row pools of the last two are split over the
  data axis (a row a column).
* A reduced olmoe at ``(1, 2)`` at a θ where exits fire: the MoE layer in
  both forms within 2e-5 of JAX's ``_moe_forward_local`` and
  ``moe_forward_decode``, and its streams.
* Bookkeeping: each rank's parameter bytes equal the port's estimate and
  JAX's ``estimate_param_bytes_per_device``; a second fleet places
  nothing again; the single-device default is inert; the refusals.

Each test that needs ranks reads one spawn of them (``tests/
_cloud_tp_runs.py``), run once a test run by whichever xdist worker asks
first, each rank at one torch thread; the spawns run in the background
while the tests compute the JAX package's streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _cloud_tp_ranks import (SCENARIOS, SWAP, THETA,  # noqa: E402
                             TIE_TOKENS, TP_CFG, check_multi_swap,
                             check_swap, exit_probe, multi_swap_run,
                             run_scenario, swap_run, tie_probe)
from _cloud_tp_runs import (MESH, moe_inputs, moe_ranks,  # noqa: E402
                            tp_jax, tp_ranks)
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro_torch.bridge import param_leaves, params_from_jax  # noqa: E402
from repro_torch.core.collm import CoLLM, CollmConfig  # noqa: E402
from repro_torch.kernels.exit_head.ops import exit_heads  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402


def exit_logits_ref(h, w, eps):
    """The exit head's float32 logits of one row at a zero norm scale."""
    hn = h * torch.rsqrt(h.square().mean() + eps)
    return hn @ w.T


class FakeMesh:
    """The JAX tests' shape-only mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


@pytest.fixture(scope="module")
def tp():
    jm, jcfg, params, np_params = tp_jax()
    model = Model(TP_CFG, device="cpu")
    model.load_state_dict(params_from_jax(np_params, TP_CFG))
    return {"jm": jm, "jcfg": jcfg, "params": params,
            "np_params": np_params, "model": model}


@pytest.fixture(scope="module")
def tp_future(tp, tmp_path_factory):
    """The (2, 4) mesh's eight ranks on tiny-ee-tp, in the background."""
    return tp_ranks(tmp_path_factory, tp["np_params"])


@pytest.fixture(scope="module")
def tp_run(tp_future):
    return tp_future.result()


def test_tp_matrix_streams_equal_single_device(tp, tp_future,
                                               tmp_path_factory):
    """Every scenario of the JAX file's matrix: each of the eight ranks'
    streams equal the JAX package's single-device streams and the port's
    own, with prefix hits and preemptions counted alike.  The swap
    scenarios over (2, 4) and, on the olmoe spawn's two ranks, (2, 1):
    each stream swapped out and resumed in the other data column, on a
    pool split over the data axis (``check_swap``), and behind one
    ``CloudBatcher`` whose pool is split (``check_multi_swap``)."""
    wants, singles = {}, {}
    for name, (kind, ckw) in SCENARIOS.items():
        wants[name] = run_scenario(JServingSystem(
            tp["jm"], tp["params"], JCollmConfig(theta=THETA, **ckw)), kind)
        system = ServingSystem(tp["model"], CollmConfig(theta=THETA, **ckw))
        if name in SWAP:
            singles[name] = swap_run(system)
            own = singles[name][0]
        elif kind == "swap-multi":
            singles[name] = multi_swap_run(system)
            own = singles[name][0]
        else:
            own = run_scenario(system, kind)
        assert own == wants[name], name
    tp_run = tp_future.result()
    for name, want in wants.items():
        for rank, out in enumerate(tp_run):
            assert out["streams"][name] == want, (name, rank)
    moe_run = moe_ranks(tmp_path_factory, tp["np_params"]).result()
    for name in SWAP:
        check_swap([out["swap"][name] for out in tp_run], singles[name],
                   MESH)
        check_swap([out["swap"][name] for out in moe_run], singles[name],
                   (2, 1))
    for run, dims in ((tp_run, MESH), (moe_run, (2, 1))):
        check_multi_swap([out["swap"]["swap-multi"] for out in run],
                         singles["swap-multi"], dims)
    toks, hits, preempts = tp_run[0]["streams"]["prefix"]
    assert hits > 0
    assert tp_run[0]["streams"]["preempt"][2] == 1
    # rank r sits at (r // 4, r % 4); one query head and its KV head each
    for rank, out in enumerate(tp_run):
        assert out["coords"] == {"data": rank // 4, "model": rank % 4}
        assert out["backend"] == "gloo"
        assert (out["heads"], out["kv_heads"]) == (1, 1)
        lo = out["coords"]["data"]
        assert out["cloud_rows"] == (lo, lo + 1, 2)


def test_tp_param_bytes_match_the_estimates(tp, tp_run):
    """Each rank holds exactly its share: the port's estimate over its own
    parameters, and the JAX package's over its pytree."""
    mesh = FakeMesh(MESH, ("data", "model"))
    hd = TP_CFG.resolved_head_dim
    want = jsh.estimate_param_bytes_per_device(
        tp["jm"].param_specs(), mesh, fsdp=False, head_dim=hd)
    mine = tsh.estimate_param_bytes_per_device(
        param_leaves(TP_CFG), mesh, fsdp=False, head_dim=hd)
    total = sum(p.numel() * p.element_size()
                for p in tp["model"].parameters())
    for out in tp_run:
        assert out["param_bytes"] == pytest.approx(want, rel=1e-9)
        assert out["placed_bytes"] == out["param_bytes"]
    assert mine == pytest.approx(want, rel=1e-9)
    assert want < 0.6 * total


def test_tp_second_fleet_places_nothing(tp_run):
    """A whole model given to a mesh ServingSystem is placed once (its
    rank's slice copied; the whole model left as it is); two fleets of
    engines on it place nothing more and emit the same streams."""
    for out in tp_run:
        assert out["placements"] == 1
        assert out["fleets"][0] == out["fleets"][1]
        assert out["fleets"][0] == tp_run[0]["streams"]["dense"][0]
        assert out["whole_untouched"]


def test_tp_exit_heads_merge_to_the_whole_vocabulary(tp, tp_run):
    """The exit heads of each rank's quarter of the vocabulary, merged,
    give the single-device token and confidence of every row; also where
    two ranks' best logits lie one float32 step apart, closer than a step
    of the lse, in either order (``tie_probe``): the ranks merge on the
    kernel's raw max logit, as the single device compares its logits."""
    collm = CoLLM(tp["model"], CollmConfig())
    h = exit_probe(tp["model"])
    want = collm.exit_decisions({1: h[0], 2: h[1]})
    for out in tp_run:
        for layer, d in want.items():
            tok, conf = out["exits"][layer]
            assert torch.equal(tok, d.token)
            torch.testing.assert_close(conf, d.confidence, rtol=1e-5,
                                       atol=1e-7)
    h, w, ns = tie_probe(TP_CFG.norm_eps)
    single = exit_heads(h, w, ns, TP_CFG.norm_eps)
    logits = [exit_logits_ref(x, w, TP_CFG.norm_eps) for x in h[0]]
    lse = torch.logsumexp(logits[0], -1)
    for row, best in enumerate(TIE_TOKENS):
        tied = logits[row][list(TIE_TOKENS)]
        assert int(logits[row].argmax()) == best
        assert 0 < float(tied.max() - tied.min()) < float(
            np.spacing(np.float32(lse)))
    assert single[1].tolist() == [list(TIE_TOKENS)] * 2
    for out in tp_run:
        for e, (tok, conf) in enumerate(out["tie_exits"]):
            assert torch.equal(tok, single[1][e])
            torch.testing.assert_close(conf, single[0][e], rtol=1e-6,
                                       atol=0)


def test_tp_moe_layer_and_streams_match_jax(tp, tmp_path_factory):
    """Reduced olmoe over (1, 2): each rank's d_ff half of every expert,
    summed, gives JAX's MoE layer in both forms (2e-5), and the streams
    (paged ``generate``, sequential collm with exits) equal JAX's and the
    port's single-device ones."""
    arch, x = moe_inputs()
    future = moe_ranks(tmp_path_factory, tp["np_params"])
    name = "olmoe-1b-7b"
    from _moe_parity import jax_config
    mp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      arch.np_params["segments"][0]["moe"])
    want, want_aux = jmoe._moe_forward_local(mp, jax_config(name),
                                             jnp.asarray(x))
    want_dec = jmoe.moe_forward_decode(mp, jax_config(name), jnp.asarray(x))
    gen = arch.jax_run(("generate", "paged"))
    seq = arch.jax_run(("sequential", "collm"))
    own = ServingSystem(arch.tm, CollmConfig(
        theta=arch.theta, kv_layout="paged")).generate(
        arch.prompts, 6, mode="collm", num_slots=2)["tokens"]
    assert own == gen
    for out in future.result():
        assert out["d_ff"] == arch.tcfg.moe.expert_d_ff // 2
        np.testing.assert_allclose(out["local"], np.asarray(want),
                                   rtol=0, atol=2e-5)
        assert out["aux"] == pytest.approx(float(want_aux), abs=2e-5)
        np.testing.assert_allclose(out["decode"], np.asarray(want_dec),
                                   rtol=0, atol=2e-5)
        assert out["generate"] == gen
        assert out["sequential"] == seq
        assert out["exits"] > 0
        assert out["counts"]["reduce_model"] > 0
        assert out["counts"]["merge_exits"] > 0


def test_single_device_default_is_inert(tp):
    """Without a mesh nothing is placed or copied."""
    system = ServingSystem(tp["model"], CollmConfig(theta=THETA))
    mc = system.collm.mesh_ctx
    assert not mc.active and mc.placements == 0
    assert system.model is tp["model"]
    assert all(p is q for p, q in zip(system.model.parameters(),
                                      tp["model"].parameters()))


def test_cloud_mesh_refusals(tp, tp_run):
    """A bad pair, no process group and a world of the wrong size each
    raise (a recurrent model no longer does: ``tests/
    test_torch_cloud_tp_families.py``; nor swap preemption over a data
    axis: ``test_tp_matrix_streams_equal_single_device``)."""
    with pytest.raises(ValueError, match="pair"):
        ServingSystem(tp["model"], CollmConfig(cloud_mesh=(0, 4)))
    with pytest.raises(ValueError, match="process group"):
        ServingSystem(tp["model"], CollmConfig(cloud_mesh=MESH))
    for out in tp_run:
        assert "needs 2 ranks but the process group has 8" in \
            out["wrong_world"]
