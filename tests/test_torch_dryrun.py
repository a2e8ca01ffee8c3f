"""PyTorch port: the dry run of every (arch x input shape) on the
production meshes (``repro_torch.launch.specs`` and ``launch/dryrun.py``)
against the JAX package's ``repro.launch.dryrun``.

The JAX dry run fakes 512 host devices, so it runs as subprocesses, once
a test run (``_shared_run.shared``), over the combinations below: both
meshes, the three step kinds, a ``long_500k`` skip and an FSDP case.
Under jax 0.9.0 its lowering fails (ROADMAP §C), but its record still
holds what it computes from the shardings before lowering: ``n_devices``,
``fsdp`` and ``arg_bytes_per_device``.  The port's records must equal
them to the byte, and its skips JAX's reasons.  The port's own step pass
(``lower_step``, on tensors without storage) runs in a subprocess of its
CLI: ``ok`` with FLOPs, and no storage allocated (its peak resident
memory far below the parameters its step holds).
"""
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

from _shared_run import shared  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES_BY_NAME  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, shape, meshes): the JAX dry run's combinations, one process each
JAX_COMBOS = (("xlstm-350m", "decode_32k", "--both-meshes"),
              ("ee-llm-7b", "train_4k", "--multi-pod"),
              ("ee-llm-7b", "decode_32k", "--multi-pod"),
              ("qwen1.5-110b", "prefill_32k", "--both-meshes"),
              ("qwen1.5-110b", "train_4k", None),
              ("command-r-35b", "long_500k", None))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["TF_CPP_MIN_LOG_LEVEL"] = "2"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _jax_one(out_dir, combo):
    arch, shape, meshes = combo
    cmd = [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out_dir] + ([meshes] if meshes else [])
    return subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=300)


def _jax_records(out_dir):
    """Every JAX record of ``JAX_COMBOS`` ({(arch, shape, mesh): record})
    and JAX's ``--help`` text."""
    with ThreadPoolExecutor(3) as pool:
        runs = list(pool.map(lambda c: _jax_one(out_dir, c), JAX_COMBOS))
    for r in runs:
        assert "DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
    recs = {}
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    helptext = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--help"], env=_env(),
        capture_output=True, text=True, timeout=120).stdout
    return recs, helptext


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax-dryrun")
    return shared(tmp_path_factory, "jax-dryrun",
                  lambda: _jax_records(str(out))).result()


def _port_cli(tmp_path, *argv):
    """The port's dry run as a subprocess: (its records by file name, its
    peak resident bytes)."""
    # the peak of this process's own memory (VmHWM, in kB): ru_maxrss would
    # keep the forking test worker's peak across the exec
    code = ("import re, runpy, sys\n"
            "sys.argv = ['dryrun'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "hwm = re.search(r'VmHWM:\\s+(\\d+)', "
            "open('/proc/self/status').read()).group(1)\n"
            "print('MAXRSS', int(hwm) * 1024)\n")
    r = subprocess.run([sys.executable, "-c", code, "--out", str(tmp_path)]
                       + list(argv), env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    recs = {}
    for name in os.listdir(tmp_path):
        with open(os.path.join(tmp_path, name)) as f:
            recs[name] = json.load(f)
    return recs, int(re.search(r"MAXRSS (\d+)", r.stdout).group(1))


def test_arg_bytes_fsdp_and_devices_equal_jax(jax_run):
    """Every covered combination the JAX dry run did not skip: the port's
    ``n_devices``, ``fsdp`` and per-device argument bytes (parameters,
    AdamW moments, caches, inputs under the sharding rules) equal JAX's
    record, FSDP and both meshes included."""
    recs, _ = jax_run
    seen = set()
    for (arch, shape_name, mesh), want in recs.items():
        if want["status"] == "skipped":
            continue
        shape = SHAPES_BY_NAME[shape_name]
        dims, names = dryrun.MESHES[mesh == "2x16x16"]
        m = tsh.MeshShape(dims, names)
        args = specs.input_specs(get_config(arch), shape)
        fsdp = specs.choose_fsdp(args[0], m)
        got = specs.arg_bytes_per_device(
            args, specs.arg_shardings(shape, m, args, fsdp), m)
        assert (m.dims[0] * m.dims[1] * (m.dims[2] if len(dims) > 2
                                         else 1)) == want["n_devices"]
        assert fsdp == want["fsdp"], (arch, shape_name, mesh)
        assert got == want["arg_bytes_per_device"], (arch, shape_name, mesh)
        seen.add((arch, shape_name, mesh, fsdp))
    assert {("xlstm-350m", "decode_32k", "16x16", False),
            ("ee-llm-7b", "train_4k", "2x16x16", False),
            ("ee-llm-7b", "decode_32k", "2x16x16", False),
            ("qwen1.5-110b", "prefill_32k", "2x16x16", True),
            ("qwen1.5-110b", "train_4k", "16x16", True)} <= seen
    assert {m for _, _, m, _ in seen} == {"16x16", "2x16x16"}


def test_skips_and_flags_equal_jax(jax_run, tmp_path):
    """A ``long_500k`` combination on a full-attention decoder is skipped
    with JAX's reason, and the port's CLI takes JAX's twelve flags."""
    recs, helptext = jax_run
    want = recs[("command-r-35b", "long_500k", "16x16")]
    assert want["status"] == "skipped"
    got = dryrun.run_one("command-r-35b", "long_500k", False,
                         str(tmp_path))
    assert got == want
    flags = set(re.findall(r"--[a-z][a-z-]+", helptext)) - {"--help"}
    assert len(flags) == 12
    parser_flags = set()
    for action in dryrun_parser()._actions:
        parser_flags.update(o for o in action.option_strings
                            if o.startswith("--"))
    assert parser_flags - {"--help"} == flags


def dryrun_parser():
    """The port CLI's parser, as ``main`` builds it."""
    import argparse
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        dryrun.main([])
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


def test_input_specs_equal_jax():
    """The port's argument leaves are the JAX package's
    ``input_specs``' ``ShapeDtypeStruct``s, shape and dtype, in JAX's
    flatten order: ee-llm-7b's three step kinds, xlstm-350m's caches,
    whisper's frames."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jget
    from repro.launch import specs as jspecs
    from repro.models.registry import build_model
    for arch, shape_name in (("ee-llm-7b", "train_4k"),
                             ("ee-llm-7b", "prefill_32k"),
                             ("ee-llm-7b", "decode_32k"),
                             ("xlstm-350m", "decode_32k"),
                             ("whisper-medium", "prefill_32k")):
        shape = SHAPES_BY_NAME[shape_name]
        jm = build_model(jget(arch), param_dtype=jnp.bfloat16)
        jargs = jspecs.input_specs(jm, shape)
        targs = specs.input_specs(get_config(arch), shape)
        assert len(jargs) == len(targs)
        for j, t in zip(jargs, targs):
            jl = jax.tree.leaves(j)
            assert [(tuple(x.shape), str(x.dtype)) for x in jl] == [
                (p.shape, str(p.dtype).replace("torch.", ""))
                for p in t], (arch, shape_name)


def test_dryrun_single_combo(tmp_path):
    """JAX's ``test_dryrun_single_combo`` on the port: xlstm-350m at
    ``decode_32k`` on the 16x16 mesh lowers (``ok``), on 256 devices,
    with FLOPs, its collectives recorded."""
    recs, _ = _port_cli(tmp_path, "--arch", "xlstm-350m", "--shape",
                        "decode_32k")
    rec = recs["xlstm-350m_decode_32k_16x16.json"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["compile_s"] is None and rec["hlo_bytes"] is None
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        rec["arg_bytes_per_device"]


def test_step_pass_allocates_no_storage(tmp_path):
    """qwen1.5-110b at ``decode_32k``: the step holds rank 0's model-axis
    share, over 13 GB of bf16 parameters, yet the whole process peaks
    under 3 GB: nothing of the step had storage."""
    recs, peak = _port_cli(tmp_path, "--arch", "qwen1.5-110b", "--shape",
                           "decode_32k")
    rec = recs["qwen1.5-110b_decode_32k_16x16.json"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["step"]["param_bytes"] > 13e9
    assert rec["cost_analysis"]["flops"] > 0
    assert peak < 3e9, peak
