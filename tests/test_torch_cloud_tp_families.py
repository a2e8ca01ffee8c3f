"""PyTorch port: the cloud mesh (``CollmConfig.cloud_mesh``) for the
recurrent, hybrid, encoder-decoder and vision-prefix models, ranks on the
CPU over gloo.

The models are the reduced float32 ones of the parity tests: xlstm-350m
and zamba2-1.2b as ``tests/_recurrent_parity.py`` builds them (4 layers,
exits (1, 2): an sLSTM block, and the shared attention block twice),
whisper-medium and paligemma-3b as ``tests/_encdec_parity.py`` does, and
a whisper whose vocabulary of 515 divides no model axis (its embedding and
head stay whole on every rank, and the exits' merge is the identity).
For each model one spawn of four ranks, one torch thread each, serves it
over the meshes (2, 2) and (1, 4) in turn (``_cloud_tp_family_ranks``),
while the single-device streams of both packages and the other
single-device references are computed; each model's ranks and references
are computed once a test run, by whichever xdist worker asks first
(``_shared_run.shared``), and every test reads them:

* in the modes ``cloud``, ``collm`` at the split θ on a float16 and an
  int8 wire, and ``standalone``, every rank's streams equal the port's
  single-device streams token for token (through ``generate`` over two
  slots, the pool split over the data axis, for the token-prompt models;
  composed from ``Model`` / ``CoLLM`` calls for the others), and with the
  float16 wire the JAX package's;
* each rank's parameter bytes equal ``sharding.rank_param_bytes``, the
  rules' estimate with the port's listed departures;
* a two-row cloud prefill's logits (each data column prefilling its
  row at (2, 2)) equal the single device's;
* a recurrent model's int8 state packet built from ``Model.whole_state``
  is the single device's: every row's scale (the whole row's absmax, not
  a rank's) within float32 rounding of it, each code within one step (the
  rank's sums round differently), and the same wire bytes.

The xlstm-350m spawn also serves ``tests/_cloud_tp_ranks.py``'s swap
scenarios on tiny-ee-tp over (2, 2): the paged pool split over the data
axis, both streams swapped out and resumed in the other column, on float
and int8 pages (``check_swap``), and behind one ``CloudBatcher``
(``check_multi_swap``).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _cloud_tp_family_ranks import (MAX_NEW, MESHES, MODES,  # noqa: E402
                                    cloud_prefill_rows, family_rank,
                                    family_stream, state_packet)
from _cloud_tp_ranks import (SCENARIOS, SWAP, THETA,  # noqa: E402
                             check_multi_swap, check_swap, multi_swap_run,
                             run_scenario, swap_run)
from _shared_run import shared  # noqa: E402
from repro_torch.bridge import port_leaves  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

RECURRENT = ("xlstm-350m", "zamba2-1.2b")
SWAP_FAMILY = "xlstm-350m"      # its spawn also serves the swap scenarios
PREFIXED = ("whisper-medium", "paligemma-3b", "whisper-515")
DEADLINE_S = 400


def _arch(name):
    if name in RECURRENT:
        from _recurrent_parity import arch_of
        return arch_of(name)
    from _encdec_parity import Arch, arch_of
    return Arch("whisper-medium", vocab=515) if name == "whisper-515" \
        else arch_of(name)


def _spec(name, arch):
    spec = {"name": name, "cfg": arch.tcfg, "np_params": arch.np_params,
            "theta": arch.theta}
    if name in RECURRENT:
        spec["prompts"] = arch.prompts
        if name == "zamba2-1.2b":       # the shared block's paged pool
            spec["ccfg"] = {"kv_layout": "paged"}
    else:
        from _encdec_parity import MAX_NEW as P_NEW
        from _encdec_parity import MAX_SEQ
        spec.update(batch=arch.batch, max_new=P_NEW, max_seq=MAX_SEQ)
    return spec


def _family(name):
    """One model's ranks and single-device references: the ranks' results
    (their spawn started before the references are computed), the port's
    streams in every mode, the JAX package's collm stream, the whole
    model's parameter bytes, the two-row cloud prefill's logits and, for a
    recurrent model, the state packet."""
    arch = _arch(name)
    spec = _spec(name, arch)
    swap = None
    if name == SWAP_FAMILY:
        from _cloud_tp_runs import tp_jax
        swap = tp_jax()
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(spawn, family_rank, 4, device="cpu",
                        timeout=DEADLINE_S,
                        args=([spec], swap and swap[3]), threads=1)
    pool.shutdown(wait=False)
    out = {"cfg": spec["cfg"],
           "want": {mode: family_stream(arch.tm, spec, mode)
                    for mode in MODES},
           "jax_want": _jax_collm(name, arch, spec),
           "whole_bytes": sum(p.numel() * p.element_size()
                              for p in arch.tm.parameters()),
           "prefill_rows": cloud_prefill_rows(arch.tm, spec)}
    if name in RECURRENT:
        out["packet"] = state_packet(arch.tm, spec)
    if swap is not None:
        out["swap"] = _swap_wants(swap)
    out["ranks"] = ranks.result()
    return out


def _swap_wants(swap):
    """tiny-ee-tp's single-device swap scenarios: {name: (the JAX
    package's streams, the port's ``swap_run`` or ``multi_swap_run``)}."""
    from repro.core.collm import CollmConfig as JCollmConfig
    from repro.serving.engine import ServingSystem as JServingSystem
    from repro_torch.bridge import params_from_jax
    from repro_torch.core.collm import CollmConfig
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import ServingSystem
    from _cloud_tp_ranks import TP_CFG
    jm, _, params, np_params = swap
    model = Model(TP_CFG, device="cpu")
    model.load_state_dict(params_from_jax(np_params, TP_CFG))
    out = {}
    for name in SWAP + ("swap-multi",):
        kind, ckw = SCENARIOS[name]
        run = swap_run if name in SWAP else multi_swap_run
        out[name] = (run_scenario(JServingSystem(
            jm, params, JCollmConfig(theta=THETA, **ckw)), kind),
            run(ServingSystem(model, CollmConfig(theta=THETA, **ckw))))
    return out


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """{name: a future of ``_family(name)``}, each computed once a test
    run; a test starts the ones it reads."""
    futures = {}

    def get(name):
        if name not in futures:
            futures[name] = shared(tmp_path_factory, f"family-{name}",
                                   lambda: _family(name))
        return futures[name]
    return get


def _jax_collm(name, arch, spec):
    """The JAX package's single-device streams at the split θ on a
    float16 wire, in the form ``family_stream`` gives."""
    if name in RECURRENT:
        _, jsys = arch.systems(**spec.get("ccfg", {}))
        r = jsys.generate(arch.prompts, MAX_NEW, mode="collm", num_slots=2)
        st = r["stats"]
        return (r["tokens"], int(st.cloud_requests),
                int(st.exits_l1 + st.exits_l2))
    want = dict(arch.jax_run("collm-float16"))
    want.pop("confs")
    return want


@pytest.mark.parametrize("name", RECURRENT + PREFIXED)
def test_mesh_streams_equal_single_device(families, name):
    """Every rank of (2, 2) and (1, 4), every mode: the port's
    single-device streams; collm on a float16 wire: the JAX package's."""
    fam = families(name).result()
    want = fam["want"]
    assert want["collm-float16"] == fam["jax_want"]
    outs = fam["ranks"]
    for rank, out in enumerate(outs):
        for dims in MESHES:
            got = out[(dims, name)]
            for mode in MODES:
                assert got["streams"][mode] == want[mode], (dims, rank, mode)
            counts = got["counts"]
            assert counts["reduce_model"] > 0
            if name in ("xlstm-350m", "paligemma-3b"):   # sLSTM, vis_proj
                assert counts["gather_heads"] > 0
            if name == "zamba2-1.2b":                    # gate_norm
                assert counts["sum_squares"] > 0
            # whisper-515's vocabulary is whole on every rank
            assert (counts["merge_exits"] == 0) == (name == "whisper-515")
    if name == SWAP_FAMILY:
        for sname, (jax_want, single) in fam["swap"].items():
            assert single[0] == jax_want, sname
            check = check_swap if sname in SWAP else check_multi_swap
            check([out["swap"][sname] for out in outs], single, (2, 2))
    collm = want["collm-float16"]
    if name in RECURRENT:
        assert collm[1] > 0 and collm[2] > 0
    else:
        assert collm["cloud_requests"] > 0
        assert collm["exits_l1"] + collm["exits_l2"] > 0


def test_mesh_param_bytes_match_the_estimate(families):
    """Each rank holds the rules' share of every parameter, and the
    port's listed departures (``sharding.param_share``) where it departs."""
    for name in RECURRENT + PREFIXED:
        families(name)
    for name in RECURRENT + PREFIXED:
        fam = families(name).result()
        for dims in MESHES:
            want = tsh.rank_param_bytes(port_leaves(fam["cfg"]),
                                        tsh.MeshShape(dims, tsh.AXES),
                                        fam["cfg"])
            for out in fam["ranks"]:
                assert out[(dims, name)]["param_bytes"] == want, (name, dims)
            assert want < fam["whole_bytes"]


def test_state_packets_and_prefill_rows_equal_single_device(families):
    """An int8 state packet of the cloud partition's recurrent state,
    built from ``Model.whole_state`` on a rank: the single device's wire
    bytes, its per-row scales to float32 rounding and its codes to one
    step.  A two-row ``cloud_prefill`` of every model (each data column
    prefilling its row at (2, 2)): the single device's logits."""
    for name in RECURRENT + PREFIXED:
        families(name)
    for name in RECURRENT + PREFIXED:
        fam = families(name).result()
        want = fam["prefill_rows"]
        for out in fam["ranks"]:
            for dims in MESHES:
                np.testing.assert_allclose(out[(dims, name)]["prefill_rows"],
                                           want, rtol=0, atol=2e-5)
    for name in RECURRENT:
        fam = families(name).result()
        leaves, nbytes = fam["packet"]
        for out in fam["ranks"]:
            for dims in MESHES:
                got, got_bytes = out[(dims, name)]["packet"]
                assert got_bytes == nbytes
                assert len(got) == len(leaves)
                for (gq, gs), (wq, ws) in zip(got, leaves):
                    assert gq.dtype == wq.dtype == np.int8
                    assert gq.shape == wq.shape and gs.shape == ws.shape
                    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=0)
                    assert np.abs(gq.astype(np.int32) - wq).max() <= 1
