"""The spawns of ranks that ``tests/test_torch_cloud_tp.py`` and
``tests/test_torch_lower_tiers.py`` read, each run once a test run
(``_shared_run.shared``), whichever xdist worker asks first, each rank at
one torch thread: the (2, 4) mesh's eight ranks on tiny-ee-tp
(``_cloud_tp_ranks.tp_rank``) and the (1, 2) mesh's two on the reduced
olmoe (``moe_rank``, which also records one tiny-ee-tp cloud step's
collectives)."""
import numpy as np
import jax

from _cloud_tp_ranks import TP_CFG, moe_rank, tp_rank
from _shared_run import shared
from repro.configs.base import ModelConfig as JModelConfig
from repro.models.registry import build_model as jbuild
from repro_torch.launch.mesh import spawn

MESH = (2, 4)
MOE_MESH = (1, 2)
DEADLINE_S = 240


def tp_jax():
    """The JAX file's untrained tiny GQA model: (model, config, params,
    params as numpy)."""
    jcfg = JModelConfig(name="tiny-ee-tp", arch_type="dense", n_layers=4,
                        d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                        vocab_size=256, tie_embeddings=True,
                        exit_layers=(1, 2)).validate()
    assert jcfg.name == TP_CFG.name
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, jcfg, params, jax.tree.map(np.asarray, params)


def moe_inputs():
    """The reduced olmoe's ``Arch`` and the MoE layer's input rows."""
    from _moe_parity import arch_of
    arch = arch_of("olmoe-1b-7b")
    x = np.random.default_rng(2).normal(
        size=(2, 48, arch.tcfg.d_model)).astype(np.float32)
    return arch, x


def tp_ranks(tmp_path_factory, np_params):
    """A future of the eight ranks' results over ``MESH``."""
    return shared(tmp_path_factory, "cloud-tp-2x4", lambda: spawn(
        tp_rank, MESH[0] * MESH[1], device="cpu", timeout=DEADLINE_S,
        args=(MESH, np_params), threads=1))


def moe_ranks(tmp_path_factory, tp_params):
    """A future of the two ranks' results over ``MOE_MESH``."""
    def run():
        arch, x = moe_inputs()
        return spawn(moe_rank, MOE_MESH[0] * MOE_MESH[1], device="cpu",
                     timeout=DEADLINE_S,
                     args=(MOE_MESH, arch.np_params, arch.tcfg, arch.theta,
                           arch.prompts, x, 6, tp_params), threads=1)
    return shared(tmp_path_factory, "cloud-tp-moe", run)
