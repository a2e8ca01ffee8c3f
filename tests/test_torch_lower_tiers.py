"""PyTorch port: ``TwoTierRuntime.lower_tiers`` (both tiers lowered ahead
of time on tensors without storage), ``launch/dryrun_collm.py`` and
``roofline/collectives.py``, against the JAX package.

* At tiny-ee with batch 2, each wire's bytes per decode step equal JAX's
  ``lower_tiers`` on ``make_debug_mesh(1)`` (1024, 512, 264); each tier's
  caches equal JAX's ``eval_shape`` caches, and its argument bytes JAX's
  compiled tier's (jit keeps only the parameters a tier reads); its FLOPs
  are the step's products counted by hand.
* ee-llm-7b at batch 128 and 32768 positions (arguments of over a
  terabyte, so nothing can have been allocated): each tier's parameter
  bytes are the JAX leaves of its partition in bf16, its FLOPs the
  products counted by hand.
* ``dryrun_collm``'s record has the JAX package's keys.
* ``wire_bytes`` applies the ring factors of JAX's
  ``parse_collectives`` (an all-reduce twice and an all-gather, with
  their replica groups).
* The recording axis records, for a tiny-ee-tp cloud step at (1, 2),
  exactly the calls the real gloo ranks make (``tests/_cloud_tp_runs``'
  olmoe spawn records them).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _cloud_tp_ranks import TP_CFG  # noqa: E402
from _cloud_tp_runs import MOE_MESH, moe_ranks, tp_jax  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.collm import CoLLM as JCoLLM  # noqa: E402
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.disagg import TwoTierRuntime as JTwoTierRuntime  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.roofline.collectives import parse_collectives  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.core.disagg import TwoTierRuntime  # noqa: E402
from repro_torch.launch import dryrun_collm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.roofline.collectives import (total_wire_bytes,  # noqa: E402
                                              wire_bytes)


def _lowered(cfg, wire, batch, seq, dtype=torch.float32, cloud_mesh=None):
    rt = TwoTierRuntime(Model(cfg, device="meta", dtype=dtype),
                        CollmConfig(wire_format=wire), "cpu", "cpu",
                        split=True)
    return rt.lower_tiers(batch, seq, cloud_mesh=cloud_mesh)


def _nbytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree.leaves(tree))


def _step_flops(cfg, tier, batch, seq) -> int:
    """The products of one decode step of a dense tier, by hand: each
    layer's projections and gated MLP, attention over ``seq`` keys, and
    the heads (both exits on the edge, the final head in the cloud)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    proj = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * cfg.d_ff
    layer = 2 * batch * proj + 4 * batch * h * hd * seq
    l_ee1, l_ee2 = cfg.exit_layers[0], cfg.exit_layers[-1]
    layers = l_ee2 if tier == "edge" else cfg.n_layers - l_ee1
    heads = len(cfg.exit_layers) if tier == "edge" else 1
    return layers * layer + heads * 2 * batch * cfg.vocab_size * d


def _jax_tier_bytes(jm, params, tier) -> int:
    """Bytes of the JAX leaves of a tier's partition: the segments of its
    layers, its norms and the unembedding (with the embedding on the
    edge)."""
    cfg = jm.cfg
    l_ee1, l_ee2 = cfg.exit_layers[0], cfg.exit_layers[-1]
    segs = [params["segments"][si] for si, seg in enumerate(jm.segments)
            if (seg.end <= l_ee2 if tier == "edge" else seg.start >= l_ee1)]
    leaves = segs + [params["exit_norms"] if tier == "edge"
                     else params["final_norm"]]
    if tier == "edge" or cfg.tie_embeddings:
        leaves.append(params["embed"])
    if not cfg.tie_embeddings:
        leaves.append(params["lm_head"])
    return _nbytes(leaves)


@pytest.mark.parametrize("wire,want", [("float32", 1024), ("float16", 512),
                                       ("int8", 264)])
def test_lower_tiers_match_jax(tiny_ee_cfg, wire, want):
    jm = jbuild(tiny_ee_cfg)
    mesh = make_debug_mesh(1)
    jrt = JTwoTierRuntime(jm, JCollmConfig(wire_format=wire), mesh, mesh)
    jedge, jcloud, jinfo = jrt.lower_tiers(2, 64)
    tcfg = TModelConfig(**dataclasses.asdict(tiny_ee_cfg))
    edge, cloud, info = _lowered(tcfg, wire, 2, 64)
    assert info == jinfo == {"wire_bytes_per_token": want}
    jco = JCoLLM(jm, JCollmConfig())
    for tier, jtier, init in ((edge, jedge, jco.init_edge_cache),
                              (cloud, jcloud, jco.init_cloud_cache)):
        caches = jax.eval_shape(lambda: init(2, 64, dtype=jm.compute_dtype))
        assert tier.cache_bytes == _nbytes(caches), tier.name
        ma = jtier.compile().memory_analysis()
        assert tier.argument_bytes == ma.argument_size_in_bytes, tier.name
        assert tier.memory_analysis()["argument_size_in_bytes"] == \
            ma.argument_size_in_bytes
        assert tier.cost_analysis()["flops"] == _step_flops(
            tcfg, tier.name, 2, 64)
        assert tier.collectives == []
        live = tier.materialize("cpu")
        assert live.tier == tier.name and live.dtype == torch.float32
        assert tuple(n for n, _ in live.named_parameters()) == \
            tier.param_names


def test_lower_tiers_allocates_nothing_at_full_size():
    """ee-llm-7b in bf16, 128 rows of 32768 positions: caches of over a
    terabyte, lowered without a byte of storage; each tier's parameters
    are the JAX leaves of its partition."""
    cfg = get_config("ee-llm-7b")
    edge, cloud, info = _lowered(cfg, "float16", 128, 32768,
                                 dtype=torch.bfloat16)
    assert info["wire_bytes_per_token"] == 128 * cfg.d_model * 2
    assert edge.cache_bytes > 1e12
    jm = jbuild(jget_config("ee-llm-7b"), param_dtype=jnp.bfloat16)
    specs = jm.param_specs()
    for tier in (edge, cloud):
        assert tier.param_bytes == _jax_tier_bytes(jm, specs, tier.name)
        assert tier.cost_analysis()["flops"] == _step_flops(
            cfg, tier.name, 128, 32768)
    # the edge keeps layers 1..16 and the exits, the cloud 9..32 and the
    # head: each its own copy of the untied 32000 x 4096 unembedding
    assert "lm_head" in edge.param_names and "lm_head" in cloud.param_names
    assert "embed" not in cloud.param_names


def test_dryrun_collm_record_has_jax_keys(tmp_path):
    """The record of ``python -m repro_torch.launch.dryrun_collm`` with a
    cloud mesh: JAX's keys, the wire bytes of ``lower_tiers`` and the
    cloud tier's collectives."""
    dryrun_collm.main(["--arch", "ee-llm-7b", "--batch", "2", "--seq",
                       "64", "--wire", "int8", "--cloud-tp", "2",
                       "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "collm_ee-llm-7b_2x64_int8_tp2dp1.json")
                     .read_text())
    jax_keys = {"arch", "batch", "seq", "wire", "l_ee1", "l_ee2",
                "edge_chips", "cloud_chips", "lower_s",
                "wire_bytes_per_token", "edge", "cloud", "status"}
    assert jax_keys <= set(rec) and rec["status"] == "ok"
    assert (rec["l_ee1"], rec["l_ee2"], rec["cloud_chips"]) == (8, 16, 2)
    assert rec["wire_bytes_per_token"] == 2 * (4096 + 4)
    for tier in ("edge", "cloud"):
        t = rec[tier]
        assert {"compile_s", "memory_analysis", "cost_analysis",
                "collectives"} <= set(t)
        assert set(t["memory_analysis"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"}
        assert t["cost_analysis"]["flops"] > 0
    assert rec["edge"]["collectives"] == {}
    coll = rec["cloud"]["collectives"]
    assert coll["all-reduce"]["count"] > 0
    assert total_wire_bytes(coll) == coll["all-reduce"]["wire_bytes"] > 0


def test_wire_bytes_ring_factors_match_jax_parser():
    hlo = "\n".join([
        "  %ar.1 = f32[2,128]{1,0} all-reduce(f32[2,128]{1,0} %x), "
        "replica_groups={{0,1}}, to_apply=%add",
        "  %ar.2 = f32[2,128]{1,0} all-reduce(f32[2,128]{1,0} %y), "
        "replica_groups={{0,1}}, to_apply=%add",
        "  %ag.1 = bf16[4,256]{1,0} all-gather(bf16[1,256]{1,0} %z), "
        "replica_groups={{0,1,2,3}}, dimensions={0}"])
    want = parse_collectives(hlo, 8)
    got = wire_bytes([
        {"op": "all-reduce", "group": 2, "bytes": 2 * 128 * 4, "count": 2},
        {"op": "all-gather", "group": 4, "bytes": 4 * 256 * 2, "count": 1}])
    assert got == want
    assert total_wire_bytes(got) == 2 * 1024 + 0.75 * 2048


def test_recording_axis_records_what_the_ranks_sum(tmp_path_factory):
    """A tiny-ee-tp cloud step of 2 rows at (1, 2): the recording mesh's
    records (``lower_tiers(cloud_mesh=)``) equal each gloo rank's."""
    _, _, _, np_params = tp_jax()
    future = moe_ranks(tmp_path_factory, np_params)
    _, cloud, _ = _lowered(TP_CFG, "float16", 2, 64, cloud_mesh=MOE_MESH)
    kinds = {r["kind"] for r in cloud.collectives}
    assert {"reduce_model", "gather_vocab"} <= kinds
    for out in future.result():
        assert out["tp_records"] == cloud.collectives
