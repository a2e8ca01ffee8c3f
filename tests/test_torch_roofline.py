"""PyTorch port: the roofline model (``repro_torch.roofline``) and its
H100 table, against the JAX package's ``repro.roofline.analyze``.

* ``kv_page_bytes``, ``kv_token_write_bytes`` and
  ``decode_kv_bytes_per_token`` of both packages' live paged caches of
  every registered configuration at a reduced size, float32 and int8
  pages (the port's cache holds one node a layer, the JAX package's one
  stacked node a segment);
* ``count_params`` and ``model_flops`` at every ``InputShape`` of every
  registered configuration, and the shapes themselves;
* ``RooflineTerms.finish`` and ``analyze`` under either table: the port's
  with the TPU table equal to the JAX package's, the JAX package's with
  the H100 table equal to the port's; ``hbm_roofline_fraction`` over each
  package's own table.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.roofline import analyze as jan  # noqa: E402
from repro.roofline import hw as jhw  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig  # noqa: E402,E501
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.roofline import analyze as tan  # noqa: E402
from repro_torch.roofline import hw as thw  # noqa: E402

PAGES, PAGE, ROWS = 12, 16, 3
CTXS = (1, 15, 16, 17, 100, 191)


def torch_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    if fields["ssm"] is not None:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    return ModelConfig(**fields)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_decode_kv_bytes_equal_jax(kv_dtype):
    """Every registered configuration, reduced to 4 layers with exits
    (1, 2): the bytes a decoded token reads a page, writes and sweeps at
    several contexts, over each package's live paged caches."""
    assert sorted(JARCHS) == sorted(ARCHS)
    paged = 0
    for arch in sorted(ARCHS):
        jcfg = dataclasses.replace(jreduced(JARCHS[arch], n_layers=4),
                                   exit_layers=(1, 2)).validate()
        jtree = jbuild(jcfg).init_paged_cache(ROWS, PAGES, PAGE,
                                              kv_dtype=kv_dtype)
        ttree = Model(torch_config(jcfg), device="cpu").init_paged_cache(
            PAGES, PAGE, kv_dtype=kv_dtype, batch=ROWS)
        want = jan.kv_page_bytes(jtree)
        assert tan.kv_page_bytes(ttree) == want, arch
        assert tan.kv_token_write_bytes(ttree) == \
            jan.kv_token_write_bytes(jtree), arch
        for ctx in CTXS:
            assert tan.decode_kv_bytes_per_token(ttree, ctx, PAGE) == \
                jan.decode_kv_bytes_per_token(jtree, ctx, PAGE), (arch, ctx)
        paged += want > 0
    assert paged >= 9          # every attention model; xlstm has no pages


def test_count_params_and_model_flops_equal_jax():
    """Every registered configuration at every input shape, and the shapes
    and their applicability rule."""
    assert [dataclasses.astuple(s) for s in tshapes.SHAPES] == \
        [dataclasses.astuple(s) for s in jshapes.SHAPES]
    for arch in sorted(ARCHS):
        cfg, jcfg = get_config(arch), JARCHS[arch]
        assert tan.count_params(cfg) == jan.count_params(jcfg), arch
        for ts, js in zip(tshapes.SHAPES, jshapes.SHAPES):
            assert tan.model_flops(cfg, ts) == jan.model_flops(jcfg, js)
            assert tshapes.shape_applicable(cfg, ts)[0] == \
                jshapes.shape_applicable(jcfg, js)[0]


def _terms(mod, rng):
    return mod.RooflineTerms(
        arch="a", shape="s", mesh="m", chips=int(rng.integers(1, 9)),
        flops_per_device=float(10 ** rng.uniform(9, 16)),
        bytes_per_device=float(10 ** rng.uniform(6, 13)),
        wire_bytes_per_device=float(10 ** rng.uniform(5, 12)),
        model_flops=float(10 ** rng.uniform(9, 16))).finish()


def _swap_tables(monkeypatch, to_h100: bool):
    """Give one package the other's table: the JAX package's module the
    H100's constants, or the port's module the TPU's."""
    if to_h100:
        monkeypatch.setattr(jhw, "PEAK_FLOPS_BF16", thw.PEAK_FLOPS_BF16)
        monkeypatch.setattr(jhw, "HBM_BW", thw.HBM_BW)
        monkeypatch.setattr(jhw, "ICI_LINK_BW", thw.NVLINK_BW)
    else:
        monkeypatch.setattr(thw, "PEAK_FLOPS_BF16", jhw.PEAK_FLOPS_BF16)
        monkeypatch.setattr(thw, "HBM_BW", jhw.HBM_BW)
        monkeypatch.setattr(thw, "NVLINK_BW", jhw.ICI_LINK_BW)


@pytest.mark.parametrize("to_h100", [True, False])
def test_finish_and_analyze_equal_jax_under_either_table(monkeypatch,
                                                         to_h100):
    """Given the same terms and the same table, both packages' ``finish``
    pick the same bottleneck with the same seconds and useful ratio, and
    ``analyze`` of a dry-run record gives the same row."""
    _swap_tables(monkeypatch, to_h100)
    rng = np.random.default_rng(int(to_h100))
    picked = set()
    for _ in range(200):
        state = rng.bit_generator.state
        t = _terms(tan, rng)
        rng.bit_generator.state = state
        j = _terms(jan, rng)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        picked.add(t.bottleneck)
    assert picked == {"compute", "memory", "collective"}
    record = {"arch": "ee-llm-7b", "shape": "decode_32k", "mesh": "16x16",
              "n_devices": 256,
              "cost_analysis": {"flops": 3.1e12, "bytes accessed": 7.7e10},
              "collectives": {"all-reduce": {"wire_bytes": 2.5e9},
                              "all-gather": {"wire_bytes": 1.0e8}}}
    for arch in ("ee-llm-7b", "olmoe-1b-7b"):
        got = tan.analyze(dict(record, arch=arch), get_config(arch),
                          tshapes.DECODE_32K)
        want = jan.analyze(dict(record, arch=arch), JARCHS[arch],
                           jshapes.DECODE_32K)
        assert got.row() == want.row()


def test_h100_table_and_roofline_fraction():
    """The card's constants, and the fraction of its HBM rate a KV sweep
    reaches, over each package's own table."""
    assert (thw.PEAK_FLOPS_BF16, thw.HBM_BW, thw.CARD_HBM_BYTES) == \
        (989e12, 3.35e12, 80e9)
    assert thw.HBM_BW != jhw.HBM_BW
    got = tan.hbm_roofline_fraction(2.0e6, 500.0)
    assert got == pytest.approx(1.0e9 / 3.35e12, rel=1e-12)
    assert got == pytest.approx(jan.hbm_roofline_fraction(2.0e6, 500.0)
                                * jhw.HBM_BW / thw.HBM_BW, rel=1e-12)
