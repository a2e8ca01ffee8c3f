"""PyTorch port: granite-moe-3b-a800m at reduced width (``tests/_moe_parity.py``),
greedy streams through ``generate_sequential`` (cloud, collm, standalone)
and ``generate`` (dense, paged float32, paged int8, chunked prefill), each
equal to the JAX package's on the same weights, in float32 on the CPU.
"""
import pytest

pytest.importorskip("torch")

from _moe_parity import stream_tests  # noqa: E402

(test_sequential_streams_match_jax,
 test_generate_streams_match_jax) = stream_tests("granite-moe-3b-a800m")
