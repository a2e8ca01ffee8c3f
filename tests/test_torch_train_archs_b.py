"""Training parity, families 6-10 of the JAX package's ten (``ASSIGNED``:
paligemma-3b, command-r-35b, zamba2-1.2b, whisper-medium,
stablelm-12b) at their reduced size (2 layers, d_model 256), on the same
weights and numpy batches as the JAX package: the pytree's structure
(character for character) and the bridge both ways, ``forward_train``'s
logits, exit logits and MoE aux loss, the fused multi-exit loss and its
gradient, one train step's losses, gradient norm and learning rate, and
the JAX-format checkpoint both ways (``tests/_train_parity.py`` states
the tolerances).  The port's counterpart of the train-step cases of
``tests/test_archs_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _train_parity import check_family  # noqa: E402

from repro.configs.registry import ASSIGNED  # noqa: E402


@pytest.mark.parametrize("arch", ASSIGNED[5:])
def test_family_trains_like_jax(arch, tmp_path):
    check_family(arch, tmp_path)
