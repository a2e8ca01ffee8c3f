"""PyTorch port: the cloud mesh's sharding rules and the mesh itself
(``repro_torch.launch.sharding`` / ``launch.mesh``).

* The rules equal the JAX package's leaf for leaf: ``param_pspec``
  (FSDP on and off, head-aligned and not), ``cache_pspec`` (dense and
  paged float / int8 caches), ``batch_axes``, ``input_pspec`` and
  ``estimate_param_bytes_per_device``, for every registered configuration
  on JAX's shape-only meshes ``(16, 16)``, ``(2, 16, 16)``, ``(2, 4)`` and
  ``(1, 2)``; a rank's sharded model holds exactly the estimate.
* The head-aligned rule on the tiny GQA model, the rank slices (and the
  slices a sharded ``Model`` keeps equal to them), the mesh's checks and
  subgroups over four gloo ranks, ``spawn``'s kill on a failing rank and
  at its deadline, and a whole checkpoint loaded into each rank's share.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _cloud_tp_ranks import (TP_CFG, ckpt_rank, fail_rank,  # noqa: E402
                             mesh_rank, stall_rank)
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.bridge import param_leaves, params_to_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import (make_cloud_mesh,  # noqa: E402
                                     make_debug_mesh, pod_submeshes, spawn)
from repro_torch.models.attention import head_split  # noqa: E402
from repro_torch.models.transformer import Model, mesh_ready  # noqa: E402
from repro_torch.training.checkpoint import save_checkpoint  # noqa: E402


class FakeMesh:
    """The JAX tests' shape-only stand-in."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


MESHES = [FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model")),
          FakeMesh((2, 4), ("data", "model")),
          FakeMesh((1, 2), ("data", "model"))]
_SPECS = {}


def _jax_specs(arch):
    if arch not in _SPECS:
        _SPECS[arch] = jbuild(jget_config(arch),
                              param_dtype=jnp.bfloat16).param_specs()
    return _SPECS[arch]


def _leaves(tree):
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, l: out.append((jsh._path_names(p), l)), tree)
    return out


def test_param_pspec_equals_jax():
    """Every leaf of every registered configuration, on every mesh, with
    FSDP on and off and the head-aligned rule on and off."""
    assert sorted(JARCHS) == sorted(ARCHS)
    n = 0
    for arch in sorted(ARCHS):
        hd = get_config(arch).resolved_head_dim
        for names, leaf in _leaves(_jax_specs(arch)):
            for mesh in MESHES:
                for fsdp in (False, True):
                    for head_dim in (0, hd):
                        want = jsh.param_pspec(_Path(names), leaf, mesh,
                                               fsdp=fsdp, head_dim=head_dim)
                        got = tsh.param_pspec(names, leaf.shape, mesh,
                                              fsdp=fsdp, head_dim=head_dim)
                        assert P(*got) == want, (arch, names, mesh.shape)
                        n += 1
    assert n > 10000


class _Key:
    def __init__(self, key):
        self.key = key


def _Path(names):
    """A JAX key path of ``names`` (what ``_path_names`` reads)."""
    return tuple(_Key(n) for n in names)


def test_cache_pspec_equals_jax():
    """Dense caches of every configuration at batches 1, 8 and 32, and the
    paged float32 and int8 pools of the attention decoders."""
    n = 0
    for arch in sorted(ARCHS):
        jm = jbuild(jget_config(arch), param_dtype=jnp.bfloat16)
        trees = [(b, jm.cache_specs(b, 4096)) for b in (1, 8, 32)]
        if get_config(arch).arch_type in ("dense", "moe"):
            for kv in ("float32", "int8"):
                trees.append((8, jax.eval_shape(
                    lambda: jm.init_paged_cache(8, 63, 16, kv_dtype=kv))))
        for batch, tree in trees:
            for names, leaf in _leaves(tree):
                for mesh in MESHES:
                    want = jsh.cache_pspec(_Path(names), leaf, mesh,
                                           batch=batch)
                    got = tsh.cache_pspec(names, leaf.shape, mesh,
                                          batch=batch)
                    assert P(*got) == want, (arch, names, batch)
                    n += 1
    assert n > 1000


def test_batch_axes_input_pspec_and_estimate_equal_jax():
    """``batch_axes`` and ``input_pspec`` at batches 1-512; the parameter
    bytes a device holds for every configuration, mesh and FSDP choice;
    and a rank's sharded model (on the meta device) holds exactly the
    estimate."""
    for mesh in MESHES:
        for b in (1, 2, 3, 4, 8, 16, 32, 64, 256, 512):
            assert tsh.batch_axes(mesh, b) == jsh.batch_axes(mesh, b)
            for shape in ((b, 7), (b,), (3, b), ()):
                leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
                assert P(*tsh.input_pspec(shape, mesh, b)) == \
                    jsh.input_pspec(leaf, mesh, b)
    for arch in sorted(ARCHS):
        hd = get_config(arch).resolved_head_dim
        leaves = param_leaves(get_config(arch), itemsize=2)
        for mesh in MESHES:
            for fsdp in (False, True):
                for head_dim in (0, hd):
                    assert tsh.estimate_param_bytes_per_device(
                        leaves, mesh, fsdp, head_dim) == \
                        jsh.estimate_param_bytes_per_device(
                            _jax_specs(arch), mesh, fsdp, head_dim)
    for arch, dims in (("ee-llm-7b", (1, 2)), ("command-r-35b", (1, 2)),
                       ("olmoe-1b-7b", (1, 2)), ("qwen1.5-110b", (1, 4))):
        cfg = get_config(arch)
        mesh = tsh.MeshShape(dims, tsh.AXES)
        want = tsh.estimate_param_bytes_per_device(
            param_leaves(cfg, itemsize=2), mesh, False,
            cfg.resolved_head_dim)
        for rank in range(dims[1]):
            m = Model(cfg, device="meta", dtype=torch.bfloat16,
                      axis=tsh.Axis(rank, dims[1]))
            assert sum(p.numel() * p.element_size()
                       for p in m.parameters()) == want, (arch, rank)


def test_head_aligned_rule_and_rank_slices():
    """tiny-ee-tp at model = 4: ``wq`` / ``wo`` split by heads, ``wk`` /
    ``wv`` whole (2 KV heads), each rank's query head reading one KV head;
    the ranks' slices of every parameter tile it exactly once; a split
    that leaves no whole GQA group a rank is refused."""
    mesh = FakeMesh((2, 4), ("data", "model"))
    hd = TP_CFG.resolved_head_dim
    specs = {}
    whole = Model(TP_CFG, device="meta")
    for name, p in whole.named_parameters():
        specs[name] = tsh.layer_pspec(name.split("."), p.shape, mesh,
                                      head_dim=hd)
    assert specs["layers.0.attn.wq"] == (None, "model")
    assert specs["layers.0.attn.wo"] == ("model", None)
    assert specs["layers.0.attn.wk"] == specs["layers.0.attn.wv"] == \
        (None, None)
    assert specs["embed"] == ("model", None)
    assert specs["layers.0.ln1_scale"] == ()
    for rank in range(4):
        s = head_split(TP_CFG, tsh.Axis(rank, 4))
        assert (s.heads, s.h0, s.kv_heads, s.k0, s.kv_split) == \
            (1, rank, 1, rank // 2, False)
    for name, p in whole.named_parameters():
        shape = tuple(p.shape)
        cover = np.zeros(shape, np.int32)
        for d in range(2):
            for m in range(4):
                sl = tsh.rank_slices(specs[name], shape, mesh,
                                     {"data": d, "model": m})
                if d == 0:
                    cover[sl] += 1
        assert (cover == 1).all() or (cover == 4).all(), name
    # the slices a sharded model keeps are the rules', leaf by leaf
    cfgs = [TP_CFG] + [get_config(a) for a in sorted(ARCHS)
                       if mesh_ready(get_config(a))]
    for cfg in cfgs:
        whole = dict(Model(cfg, device="meta").named_parameters())
        for size in (2, 4):
            mesh = tsh.MeshShape((1, size), tsh.AXES)
            for rank in (0, size - 1):
                m = Model(cfg, device="meta", axis=tsh.Axis(rank, size))
                for name, p in m.named_parameters():
                    shape = tuple(whole[name].shape)
                    sl = tsh.rank_slices(
                        tsh.layer_pspec(name.split("."), shape, mesh,
                                        head_dim=cfg.resolved_head_dim),
                        shape, mesh, {"data": 0, "model": rank})
                    local = tuple(len(range(*s.indices(n)))
                                  for s, n in zip(sl, shape))
                    assert tuple(p.shape) == local, (cfg.name, size, name)
                    if local == shape:
                        assert name not in m.shards, (cfg.name, name)
                    else:
                        assert m.shards[name] == (shape, sl), \
                            (cfg.name, size, name)
    odd = ModelConfig(name="odd", arch_type="dense", n_layers=2,
                      d_model=96, n_heads=6, n_kv_heads=3, d_ff=64,
                      vocab_size=64, exit_layers=(1,)).validate()
    with pytest.raises(ValueError, match="GQA group"):
        head_split(odd, tsh.Axis(0, 2))


def test_mesh_checks_over_gloo_ranks():
    """A bad pair and a missing process group raise here; over four gloo
    ranks a mesh larger than the group raises, (2, 2) puts rank r at
    (r // 2, r % 2) with its row's and column's subgroups, and is made
    once a process; the debug mesh and the pod split."""
    with pytest.raises(ValueError, match="pair"):
        make_cloud_mesh((0, 4))
    with pytest.raises(ValueError, match="pair"):
        make_cloud_mesh((2, 2, 2))
    with pytest.raises(ValueError, match="process group"):
        make_cloud_mesh((1, 2))
    outs = spawn(mesh_rank, 4, device="cpu", timeout=120, threads=1)
    for rank, out in enumerate(outs):
        assert "needs 8 ranks but the process group has 4" in out["too_big"]
        assert out["coords"] == {"data": rank // 2, "model": rank % 2}
        assert out["again"]
        assert out["describe"] == ("mesh=(2, 2) backend=gloo transport=host "
                                   "ranks/card=0")
        row = rank // 2
        assert out["row_sum"] == 2 * row + 2 * row + 1
        assert out["rows"] == [float(rank % 2), float(rank % 2 + 2)]
    assert make_debug_mesh(8, world=8).dims == (2, 4)
    assert make_debug_mesh(2, world=8).dims == (1, 2)
    assert make_debug_mesh(3, world=3).dims == (3, 1)
    edge, cloud = pod_submeshes((2, 2, 4))
    assert edge.shape == cloud.shape == (2, 4)
    assert edge[0, 0] == 0 and cloud[0, 0] == 8
    with pytest.raises(ValueError):
        pod_submeshes((1, 2, 4))


def test_spawn_kills_ranks_on_failure_and_deadline():
    """A rank that raises fails the call at once (its sleeping peer is
    killed), and ranks past the deadline are killed and the call raises
    ``TimeoutError``: a divergence never hangs."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 0 fails on purpose"):
        spawn(fail_rank, 2, device="cpu", timeout=60, threads=1)
    assert time.monotonic() - t0 < 50
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(stall_rank, 2, device="cpu", timeout=8, threads=1)
    assert time.monotonic() - t0 < 30


def test_checkpoint_loads_into_each_rank_share(tmp_path):
    """A whole tiny-ee-tp checkpoint (the JAX package's format) loaded
    into every rank's share at (1, 2), where the KV heads split, and at
    (1, 4), where ``wk`` / ``wv`` stay whole, equals ``params_from_jax``
    of the same leaves for that rank; saving a share is refused."""
    model = Model(TP_CFG, device="cpu").init(torch.Generator().manual_seed(3))
    path = str(tmp_path / "tp")
    save_checkpoint(path, model)
    np_params = params_to_jax(model)
    for dims in ((1, 2), (1, 4)):
        outs = spawn(ckpt_rank, dims[1], device="cpu", timeout=120,
                     args=(dims, path, np_params), threads=1)
        for out in outs:
            assert out["names"] and out["equal"], dims
            assert "layers.0.attn.wq" in out["split"]
            assert ("layers.0.attn.wk" in out["split"]) == (dims[1] == 2)
            assert "cloud-mesh rank's share" in out["refused"]
