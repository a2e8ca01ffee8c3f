"""PyTorch port, slice level: ``ServingSystem.generate_sequential`` on the
CPU against the JAX package's, on the briefly trained tiny model
(``tiny_trained``, weights carried across by
``repro_torch.bridge.params_from_jax``).

Greedy token streams must be identical, and so must the ``GenStats``
counters (exits at l_ee1 / l_ee2, cloud requests, upload bytes) and the
content manager's stats, over modes collm / standalone / cloud, θ in
{0.8, 1.0}, wire float16 / int8 and backfill on / off.  The tiny model's
exit confidences stay below 0.6, so θ = 0.8 sends every token to the
cloud; θ = 0.2 is added to the grid for streams that mix exits at l_ee1,
exits at l_ee2 and cloud requests.  Exit confidences agree to 1e-5.

Also: the package imports neither JAX nor the JAX package, the launcher
runs on the CPU, and the entry points refuse to fall back to the CPU when
CUDA is asked for and absent.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# One intra-op torch thread in every test process.  The suite runs in
# several worker processes at once, and torch's default of one thread per
# core in each of them oversubscribes the cores: the port's CPU tests run
# several times slower that way than with one thread each, and a single
# process is no slower with one.  Every worker imports this module when it
# collects the suite, so this holds for the whole session.
torch.set_num_threads(1)

# One JAX compilation cache for every worker of the run, for the same
# reason: the workers compile the same reference programs over and over.
from _shared_run import share_jax_compiles  # noqa: E402

share_jax_compiles()

import jax  # noqa: E402

from repro.core.collm import CollmConfig as JCollmConfig  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.serving.engine import ServingSystem as JServingSystem  # noqa: E402
from repro.serving.engine import token_agreement as jagreement  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServingSystem, token_agreement  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 12
COUNTERS = ("tokens", "exits_l1", "exits_l2", "cloud_requests",
            "upload_bytes")

CASES = ([("cloud", 1.0, "float16", False)]
         + [("standalone", t, "float16", False) for t in (0.2, 0.8)]
         + [("collm", t, w, bf) for t in (0.2, 0.8, 1.0)
            for w in ("float16", "int8") for bf in (False, True)])


@pytest.fixture(scope="module")
def pair(tiny_trained):
    jm = tiny_trained["model"]
    tcfg = TModelConfig(**dataclasses.asdict(jm.cfg))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, tiny_trained["params"]), tcfg))
    # prompts from the training corpus' chain (a fresh instance, so the
    # draws do not depend on which other tests ran first)
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(n) for n in (10, 7)]
    return jm, tiny_trained["params"], tm, prompts


@pytest.mark.parametrize("mode,theta,wire,backfill", CASES)
def test_generate_sequential_matches_jax(pair, mode, theta, wire, backfill):
    jm, params, tm, prompts = pair
    want = JServingSystem(jm, params, JCollmConfig(
        theta=theta, wire_format=wire, backfill=backfill)
    ).generate_sequential(prompts, MAX_NEW, mode=mode)
    got = ServingSystem(tm, CollmConfig(
        theta=theta, wire_format=wire, backfill=backfill)
    ).generate_sequential(prompts, MAX_NEW, mode=mode)
    assert got["tokens"] == want["tokens"]
    for name in COUNTERS:
        assert getattr(got["stats"], name) == getattr(want["stats"], name), \
            name
    assert got["cm_stats"] == want["cm_stats"]
    np.testing.assert_allclose(np.asarray(got["stats"].confidences),
                               np.asarray(want["stats"].confidences),
                               atol=1e-5, rtol=0)
    if (mode, theta) == ("collm", 0.2):
        # the grid point that exercises all three outcomes of a tick
        st = got["stats"]
        assert min(st.exits_l1, st.exits_l2, st.cloud_requests) > 0, st
    for a, b in zip(got["tokens"], want["tokens"]):
        assert token_agreement(a, b) == jagreement(a, b) == 1.0


def test_collm_theta1_float32_equals_cloud(pair):
    """θ = 1 sends every token to the cloud; with a lossless wire the
    collaborative stream is the undivided model's, token for token."""
    _, _, tm, prompts = pair
    system = ServingSystem(tm, CollmConfig(theta=1.0, wire_format="float32"))
    collm = system.generate_sequential(prompts, MAX_NEW, mode="collm")
    cloud = system.generate_sequential(prompts, MAX_NEW, mode="cloud")
    assert collm["tokens"] == cloud["tokens"]
    assert collm["stats"].request_rate == 1.0


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    r = serve.main(["--smoke", "--device", "cpu", "--clients", "2",
                    "--prompt-len", "6", "--max-new", "5", "--wire", "int8",
                    "--theta", "0.5"])
    out = capsys.readouterr().out
    assert "agreement vs cloud" in out and "content manager" in out
    assert [len(t) for t in r["tokens"]] == [5, 5]


def test_serve_launcher_paged_int8_runs_on_cpu(capsys):
    """The launcher serves through the batched engine on a paged int8 pool,
    with more clients than slots."""
    from repro_torch.launch import serve
    r = serve.main(["--smoke", "--device", "cpu", "--clients", "3",
                    "--num-slots", "2", "--prompt-len", "6", "--max-new",
                    "5", "--kv-layout", "paged", "--kv-dtype", "int8",
                    "--theta", "0.5"])
    out = capsys.readouterr().out
    assert "kv=paged/int8 slots=2" in out and "agreement vs cloud" in out
    assert [len(t) for t in r["tokens"]] == [5, 5, 5]
    assert r["pool_stats"]["allocs"] == r["pool_stats"]["frees"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--kv-dtype", "int8"])


def test_serve_launcher_sim_channel_and_cloud_batch_run_on_cpu(capsys):
    """``--channel sim`` prices the run in virtual time, alone and with
    ``--cloud-batch`` (one engine per client, one batched cloud whose
    waves serve several clients' requests)."""
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--clients", "3", "--prompt-len",
            "6", "--max-new", "5", "--theta", "1.0", "--channel", "sim"]
    r = serve.main(base + ["--deadline", "0.5"])
    out = capsys.readouterr().out
    assert "channel=sim cloud_batch=False" in out and "virtual_t=" in out
    assert r["virtual_time"] > 0 and r["stats"].deadline_misses == 0
    m = serve.main(base + ["--cloud-batch", "--kv-layout", "paged"])
    out = capsys.readouterr().out
    assert "engines=3" in out and "cloud batcher:" in out
    assert m["batcher"]["mean_batch"] > 1 and m["tokens"] == r["tokens"]
    with pytest.raises(SystemExit):
        serve.main(base + ["--cloud-batch", "--num-slots", "2"])


def test_serve_launcher_chunked_prefix_share_runs_on_cpu(capsys):
    """``--chunked-prefill --prefix-share`` puts the clients behind one
    system prompt: its pages are mapped, not computed, after the first
    client, and the streams keep the cloud baseline's agreement."""
    from repro_torch.launch import serve
    args = ["--smoke", "--device", "cpu", "--clients", "4", "--num-slots",
            "2", "--prompt-len", "6", "--max-new", "5", "--kv-layout",
            "paged", "--chunked-prefill", "--prefix-share", "--theta", "1.0"]
    r = serve.main(args)
    out = capsys.readouterr().out
    assert "prefill_chunks=" in out and "cow_copies=" in out
    assert r["stats"].prefix_hit_tokens > 0
    assert [len(t) for t in r["tokens"]] == [5] * 4
    assert "[1.0, 1.0, 1.0, 1.0]" in out        # theta 1: all cloud
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--prefix-share",
                    "--kv-layout", "paged"])


def test_serve_launcher_fleet_replay_runs_on_cpu(capsys):
    """``--arrival-rate`` with SLO targets replays the clients open-loop
    in virtual time and prints the fleet line; ``--adaptive`` adds the
    controller's row and keeps the streams."""
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--clients", "4", "--prompt-len",
            "6", "--max-new", "5", "--theta", "1.0", "--channel", "sim",
            "--kv-layout", "paged", "--preemption", "swap"]
    fleet = ["--arrival-rate", "20", "--arrival-cv2", "4", "--slo-ttft",
             "0.5", "--slo-tpot", "0.05"]
    r = serve.main(base + fleet)
    out = capsys.readouterr().out
    assert "fleet: ttft_p50=" in out
    assert r["stats"].slo_total == 4 and len(r["stats"].ttft_s) == 4
    a = serve.main(base + fleet + ["--adaptive"])
    out = capsys.readouterr().out
    assert "adaptive: {" in out and a["adaptive"] is not None
    assert a["tokens"] == r["tokens"]
    cpu = ["--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit):                     # needs --channel sim
        serve.main(cpu + ["--arrival-rate", "20"])
    with pytest.raises(SystemExit):                     # needs a paged pool
        serve.main(cpu + ["--channel", "sim", "--adaptive"])


def test_entry_points_never_fall_back_to_cpu():
    """No device means CUDA; without a card that raises instead of running
    on the CPU."""
    cfg = TModelConfig(name="t", arch_type="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                       exit_layers=(1,))
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--max-new", "2"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_package_imports_neither_jax_nor_the_jax_package():
    """Every module of repro_torch imports in a fresh interpreter without
    pulling ``jax`` or ``repro`` into ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not pattern.search(f.read_text()), f


@pytest.mark.parametrize("fmt", ["float32", "float16", "int8"])
@pytest.mark.parametrize("seq,hit", [(1, 0), (9, 0), (9, 4), (9, 9)])
def test_wire_accounting_matches_jax(fmt, seq, hit):
    """Wire sizes from shapes equal the JAX package's (there taken from the
    quantized packet through ``jax.eval_shape``), packet for packet."""
    import jax.numpy as jnp
    from repro.core import transport as jt
    from repro_torch.core import transport as tt
    d = 96
    assert tt.hidden_wire_bytes(d, fmt, seq) == jt.hidden_wire_bytes(d, fmt,
                                                                      seq)
    assert (tt.prompt_upload_bytes(d, fmt, seq, hit)
            == jt.prompt_upload_bytes(d, fmt, seq, hit))
    assert tt.draft_request_bytes(seq) == jt.draft_request_bytes(seq)
    x = np.random.default_rng(seq).normal(size=(2, seq, d)).astype(np.float32)
    tpkt = tt.StatePacket(hidden=tt.quantize(torch.from_numpy(x), fmt),
                          pos=np.arange(2))
    jpkt = jt.StatePacket(hidden=jt.quantize(jnp.asarray(x), fmt),
                          pos=jnp.arange(2))
    assert tpkt.wire_breakdown() == jpkt.wire_breakdown()
    assert tpkt.nbytes() == jpkt.nbytes()
    assert tt.packet_breakdown({"a": tpkt.hidden, "b": [tpkt.hidden]}) == \
        jt.packet_breakdown({"a": jpkt.hidden, "b": [jpkt.hidden]})
    np.testing.assert_allclose(
        tt.dequantize(tpkt.hidden).numpy(),
        np.asarray(jt.dequantize(jpkt.hidden)), atol=1e-6, rtol=0)


def test_sync_channel_matches_jax():
    """Submit / notify / poll / drop in the same order on both channels:
    the same arrivals and the same stats."""
    from repro.core.transport import SyncChannel as JSync
    from repro_torch.core.transport import SyncChannel as TSync
    chans = (JSync(), TSync())
    for ch in chans:
        ch.notify_upload(0, 100, 0.0)
        for i in range(3):
            ch.submit(slot=i, seq=i, pos=10 + i, reply=i, now=0.5 * i,
                      nbytes_up=8, nbytes_down=8)
        assert ch.in_flight() == 3 and ch.next_arrival() == 0.0
        got = ch.poll(0.6)
        assert [r.reply for r in got] == [0, 1]
        ch.submit(slot=5, now=2.0, nbytes_up=8)
        ch.reset()
        assert ch.in_flight() == 0 and ch.next_arrival() is None
    assert chans[0].stats.as_row() == chans[1].stats.as_row()
