"""PyTorch port: xlstm-350m at reduced width (``tests/_recurrent_parity.py``:
three mLSTM layers and one sLSTM), greedy streams and every counter equal
to the JAX package's on the same weights, in float32 on the CPU:
``generate_sequential`` (cloud, collm, standalone) and ``generate`` on
dense KV in each mode, whose admissions prefill the exact prompt (no
padding: the recurrent state would advance through pads) and whose collm
edge step is masked (a stalled row keeps its state).  ``kv_cache_bytes``
counts the recurrent state as the JAX package does.
"""
import pytest

pytest.importorskip("torch")

from _recurrent_parity import (arch_of, assert_same_run,  # noqa: E402
                               generate_both, kv_bytes, sequential_test)

NAME = "xlstm-350m"
test_sequential_streams_match_jax = sequential_test(NAME)


@pytest.mark.parametrize("mode", ["collm", "cloud", "standalone"])
def test_generate_streams_match_jax(mode):
    arch = arch_of(NAME)
    got, want, tsys, jsys = generate_both(
        arch, dict(kv_layout="dense"), dict(mode=mode, num_slots=2))
    assert_same_run(got, want)
    assert kv_bytes(tsys) == kv_bytes(jsys)
    sched = next(iter(tsys._schedulers.values()))
    assert sched._mask_edge == (mode == "collm") and not sched._pad_ok
