"""PyTorch port, module level: the cloud channel layer
(``repro_torch.core.transport``: ``CloudServicePoint``, ``CloudChannel``,
``SyncChannel``, ``AsyncSimChannel``, ``ScriptedChannel``) and the
virtual-time simulator (``repro_torch.core.netsim``) against the JAX
package's, on the CPU, with no model.

The same submit / notify / poll / reset sequence goes to a port channel and
a JAX channel: handles, arrival and deadline times, the order and contents
of every poll, ``next_arrival``, ``in_flight``, the ``ChannelStats`` rows
and the service point's ``batches``, ``requests`` and ``busy_s`` must be
equal (floats exactly: both run the same Python arithmetic).  Fixed
sequences cover each channel and a service point shared by several
channels, FIFO and batching; a Hypothesis property draws random sequences.
``netsim.simulate`` is compared field by field for every strategy, the
ablation switches of ``tests/test_core_components.py`` and the batching
knobs of ``tests/test_cloud_batcher.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import netsim as jnetsim  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core.workload import ALPACA, paper_calibrated_cases  # noqa: E402
from repro_torch.core import netsim as tnetsim  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402

WIFI = dict(up_bw=3.8e6, down_bw=8e6, rtt=0.003)


def _channels(mod, kind):
    """Channels of one kind over module ``mod`` (the JAX package's
    transport or the port's), and the service point they share, if any."""
    net = (jnetsim if mod is jtransport else tnetsim).NetworkParams(**WIFI)
    if kind == "sync":
        return [mod.SyncChannel()], None
    if kind == "base":
        return [mod.CloudChannel(deadline_s=0.05)], None
    if kind == "scripted":
        return [mod.ScriptedChannel([0.1, 0.3, 0.02, 0.07],
                                    deadline_s=0.2)], None
    if kind == "sim":
        return [mod.AsyncSimChannel(net, service_s=0.005,
                                    deadline_s=0.5)], None
    svc = (mod.CloudServicePoint(0.008) if kind == "fifo" else
           mod.CloudServicePoint(0.008, batch_window_s=0.004, max_batch=3))
    return [mod.AsyncSimChannel(net, service=svc, deadline_s=0.03)
            for _ in range(3)], svc


def _drive(mod, kind, ops):
    """Run ``ops`` on fresh channels of ``mod``; return everything the
    engines read from them."""
    chans, svc = _channels(mod, kind)
    out = []
    for op in ops:
        name, c = op[0], chans[op[1] % len(chans)]
        if name == "submit":
            _, _, slot, now, up, down = op
            h = c.submit(slot=slot, seq=slot + 1, pos=len(out), reply=len(out),
                         now=now, nbytes_up=up, nbytes_down=down)
            out.append(("submit", h, c.arrival_of(h), c.in_flight()))
        elif name == "notify":
            _, _, slot, now, nbytes = op
            c.notify_upload(slot, nbytes, now)
        elif name == "poll":
            reps = c.poll(op[2])
            out.append(("poll", [(r.handle, r.slot, r.seq, r.pos, r.reply,
                                  r.submit_t, r.arrival_t, r.deadline_t,
                                  r.nbytes_up, r.nbytes_down) for r in reps],
                        c.next_arrival(), c.in_flight()))
        elif name == "drop":
            out.append(("drop", c.drop_in_flight()))
        elif name == "reset":
            c.reset()
    out.append([c.stats.as_row() for c in chans])
    out.append([dataclasses.astuple(c.stats) for c in chans])
    if svc is not None:
        out.append((svc.batches, svc.requests, svc.busy_s, svc.batched))
    return out


FIXED = [("submit", 0, 0, 0.0, 8, 8), ("submit", 1, 1, 0.0, 8, 8),
         ("notify", 2, 2, 0.001, 9000), ("submit", 2, 2, 0.001, 8, 8),
         ("poll", 0, 1e-4), ("submit", 0, 0, 0.002, 8, 8),
         ("poll", 1, 0.012), ("poll", 2, 0.05), ("submit", 1, 1, 0.06, 8, 16),
         ("poll", 0, 0.15), ("submit", 2, 0, 0.2, 2048, 8),
         ("poll", 1, math.inf), ("submit", 0, 1, 0.3, 8, 8), ("drop", 0),
         ("reset", 0), ("submit", 0, 0, 0.0, 8, 8), ("poll", 0, math.inf)]
KINDS = ["sync", "base", "scripted", "sim", "fifo", "batched"]


@pytest.mark.parametrize("kind", KINDS)
def test_channel_sequence_matches_jax(kind):
    assert _drive(ttransport, kind, FIXED) == _drive(jtransport, kind, FIXED)


def _random_ops(seed: int):
    rng = np.random.default_rng(seed)
    now, ops = 0.0, []
    for _ in range(int(rng.integers(5, 40))):
        now += float(rng.choice([0.0, rng.uniform(0, 0.02)]))
        ch, slot = int(rng.integers(0, 3)), int(rng.integers(0, 4))
        r = rng.random()
        if r < 0.5:
            ops.append(("submit", ch, slot, now, int(rng.integers(0, 20000)),
                        int(rng.integers(0, 64))))
        elif r < 0.65:
            ops.append(("notify", ch, slot, now, int(rng.integers(0, 20000))))
        elif r < 0.9:
            ops.append(("poll", ch, now + float(rng.uniform(0, 0.05))))
        elif r < 0.95:
            ops.append(("drop", ch))
        else:
            ops.append(("reset", ch))
    return ops


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 10_000), kind=st.sampled_from(KINDS))
def test_channel_property_random_sequences(seed, kind):
    """Random submit / notify / poll / drop / reset sequences: the port's
    channels and service points are the JAX package's, event for event."""
    ops = _random_ops(seed)
    assert _drive(ttransport, kind, ops) == _drive(jtransport, kind, ops)


@pytest.mark.parametrize("batched", [False, True])
def test_service_point_matches_jax(batched):
    """``CloudServicePoint.service`` over ready times with ties, idle gaps
    and costlier members; a window without batching raises in both."""
    kw = dict(batch_window_s=0.005, max_batch=3) if batched else {}
    pts = [mod.CloudServicePoint(0.01, **kw) for mod in (ttransport,
                                                         jtransport)]
    calls = [(0.0, None), (0.004, None), (0.004, 0.03), (0.005, None),
             (0.02, None), (1.0, 0.002), (1.0, None)]
    got = [[p.service(t, s) for t, s in calls] + [p.batches, p.requests,
                                                  p.busy_s] for p in pts]
    assert got[0] == got[1]
    for p in pts:
        p.reset()
    assert [p.service(0.0) for p in pts] == [0.01 + (0.005 if batched
                                                     else 0.0)] * 2
    for mod in (ttransport, jtransport):
        with pytest.raises(ValueError):
            mod.CloudServicePoint(0.01, batch_window_s=0.005)
        with pytest.raises(ValueError):
            mod.CloudServicePoint(0.01, max_batch=0)


class _Window:
    """A duck-typed window controller: widens the window with each
    booking."""

    def __init__(self):
        self.n = 0

    def observe(self, ready_t, point):
        self.n += 1
        return 0.001 * self.n

    def reset(self):
        self.n = 0


def test_service_point_window_controller_matches_jax():
    pts = [mod.CloudServicePoint(0.008, max_batch=4,
                                 window_controller=_Window())
           for mod in (ttransport, jtransport)]
    for _ in range(2):                       # the second run after a reset
        ready = [0.0, 0.0005, 0.003, 0.02, 0.0201, 0.5]
        got = [[p.service(t) for t in ready] + [p.batches, p.busy_s,
                                                p.batch_window_s]
               for p in pts]
        assert got[0] == got[1]
        for p in pts:
            p.reset()


def test_scripted_channel_replays_trace():
    ch = ttransport.ScriptedChannel([0.1, 0.3], deadline_s=0.2)
    ch.submit(reply="a", now=0.0)
    ch.submit(reply="b", now=0.0)
    assert [r.reply for r in ch.poll(0.15)] == ["a"]
    assert ch.next_arrival() == pytest.approx(0.3)
    assert [r.reply for r in ch.poll(0.35)] == ["b"]
    with pytest.raises(ValueError):
        ttransport.ScriptedChannel([])


def test_async_channel_reset_clears_virtual_state():
    """A reset channel prices the same request as a fresh one; its own
    service point resets with it, a shared one does not."""
    ch = ttransport.AsyncSimChannel(tnetsim.NetworkParams(**WIFI),
                                    service_s=0.01)
    first = ch.arrival_of(ch.submit(slot=0, reply=0, now=0.0, nbytes_up=64))
    for i in range(20):
        ch.submit(slot=0, reply=i, now=0.0, nbytes_up=10_000)
    ch.poll(math.inf)
    ch.reset()
    again = ch.arrival_of(ch.submit(slot=0, reply=0, now=0.0, nbytes_up=64))
    assert again == first
    svc = ttransport.CloudServicePoint(0.01)
    shared = ttransport.AsyncSimChannel(tnetsim.NetworkParams(**WIFI),
                                        service=svc)
    shared.submit(slot=0, reply=0, now=0.0)
    shared.reset()
    assert svc.requests == 1                 # run_multi resets it


# ---------------------------------------------------------------------------
# netsim.simulate
# ---------------------------------------------------------------------------
STRATEGIES = ("cloud_llm", "naive", "ce_collm", "standalone")
VARIANTS = {
    "base": {},
    "fp32 wire": dict(half_precision=False),
    "no early exit": dict(early_exit=False),
    "no content manager": dict(content_manager=False),
    "backfill": dict(backfill=True),
    "theta 0.9": dict(theta=0.9),
    "batched cloud": dict(cloud_batch_window=0.004, cloud_max_batch=5),
}


def _sim(mod, strategy, n_clients, **kw):
    comp = mod.ComputeParams(edge_layer_time=1.28e-3,
                             cloud_layer_time=1.28e-3, exit_head_time=1e-3)
    net = mod.NetworkParams(up_bw=3.8e6, rtt=0.003)
    split = mod.ModelSplit(n_layers=32, l_ee1=8, l_ee2=16, d_model=4096,
                           backfill=kw.pop("backfill", False))
    cases = [mod.CaseTrace(prompt_len=c.prompt_len, arrival_t=c.arrival_t,
                           tokens=[mod.TokenTrace(t.conf1, t.conf2)
                                   for t in c.tokens])
             for c in paper_calibrated_cases(ALPACA, 12, seed=3)]
    clients = [list(cases) for _ in range(n_clients)]
    kw.setdefault("theta", 0.8)
    return mod.simulate(strategy, clients, net, comp, split, **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_netsim_matches_jax(strategy, variant):
    for n in (1, 5):
        got = _sim(tnetsim, strategy, n, **VARIANTS[variant])
        want = _sim(jnetsim, strategy, n, **VARIANTS[variant])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.as_row() == want.as_row()


def test_netsim_prices_through_the_port_transport():
    """The port's simulator bills packets and books the cloud through the
    port's transport, never the JAX package's."""
    assert tnetsim.TOKEN_BYTES is ttransport.TOKEN_BYTES
    assert tnetsim.CloudServicePoint is ttransport.CloudServicePoint
    for d in (64, 128, 4096):
        assert tnetsim._hidden_bytes(d, True) == \
            jnetsim._hidden_bytes(d, True)
        assert tnetsim._hidden_bytes(d, False) == \
            jnetsim._hidden_bytes(d, False)
