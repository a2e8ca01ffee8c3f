"""PyTorch port: zamba2-1.2b at reduced width (``tests/_recurrent_parity.py``:
Mamba2 layers and the shared attention block, which keeps one KV cache an
application), greedy streams and every counter equal to the JAX package's
on the same weights, in float32 on the CPU:

* ``generate_sequential`` in the cloud, collm and standalone modes;
* ``generate`` on dense KV, and on int8 pages under recompute preemption
  (two forced preemptions, each resumed by re-prefilling the exact
  prefix), the recurrent state dense per row beside the pages;
* ``generate_multi``: three single-slot engines on paged float32 KV
  behind one ``CloudBatcher`` with a paged pool of its own;
* the two-tier runtime (``core.disagg.TwoTierRuntime``), with the prompt
  upload whole and in slices.

``kv_cache_bytes`` (KV and recurrent state) equals JAX's in each layout.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _recurrent_parity import (MAX_NEW, arch_of,  # noqa: E402
                               assert_same_run, generate_both, kv_bytes,
                               sequential_test)
from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.core.disagg import TwoTierRuntime as JTwoTierRuntime  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.serving.cloud_batcher import CloudBatcher as JCloudBatcher  # noqa: E402,E501
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.core.disagg import TwoTierRuntime  # noqa: E402
from repro_torch.serving.cloud_batcher import CloudBatcher  # noqa: E402

NAME = "zamba2-1.2b"
test_sequential_streams_match_jax = sequential_test(NAME)

RUNS = {
    "dense": (dict(kv_layout="dense"), dict(num_slots=2), False),
    "paged-int8-recompute": (
        dict(kv_layout="paged", kv_dtype="int8", preemption="recompute"),
        dict(num_slots=2, preempt_schedule=[(2, 0), (4, 1)]), False),
    "paged-multi": (dict(kv_layout="paged"), dict(cloud_batch=True), True),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_generate_streams_match_jax(run):
    arch = arch_of(NAME)
    ccfg_kw, call_kw, multi = RUNS[run]
    got, want, tsys, jsys = generate_both(arch, ccfg_kw, call_kw, multi)
    assert_same_run(got, want)
    assert kv_bytes(tsys) == kv_bytes(jsys)
    if "recompute" in run:
        assert got["stats"].preemptions == 2
    if multi:
        # the engines are not kept: a batcher of the same pool, built anew
        assert got["batcher"]["steps"] > 0
        kw = dict(num_slots=3, max_seq=64)
        assert CloudBatcher(tsys.collm, tsys.cloud.cm, **kw).kv_cache_bytes() \
            == JCloudBatcher(jsys.collm, arch.params, jsys.cloud.cm,
                             **kw).kv_cache_bytes()


def test_two_tier_streams_match_jax():
    """The two-tier runtime at the split θ with a float16 wire, the prompt
    uploaded whole and in 16-token slices: streams, wire bytes and channel
    counters equal JAX's."""
    arch = arch_of(NAME)
    mesh = make_debug_mesh(1)
    prompt = arch.prompts[0]
    for chunk in (0, 16):
        jrt = JTwoTierRuntime(arch.jm, JCollmConfig(
            theta=arch.theta, wire_format="float16"), mesh, mesh)
        jrt.build(arch.params, arch.params)
        want, winfo = jrt.decode(jnp.asarray(prompt[None, :]), MAX_NEW,
                                 max_seq=64, upload_chunk=chunk)
        rt = TwoTierRuntime(arch.tm, CollmConfig(theta=arch.theta,
                                                 wire_format="float16"),
                            "cpu", "cpu")
        rt.build()
        got, info = rt.decode(prompt, MAX_NEW, max_seq=64,
                              upload_chunk=chunk)
        assert got == want
        assert info["wire_bytes"] == winfo["wire_bytes"]
        assert info["channel"] == winfo["channel"]
