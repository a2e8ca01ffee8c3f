"""PyTorch port, slice level: open-loop fleet replay, SLOs and adaptive
control, against the JAX package's, on the CPU.

* The 19 scenarios of ``tests/test_fleet_sim.py``.  The controller and
  simulator cases run the port's ``serving/adaptive.py``,
  ``core/transport.py`` and ``core/netsim.py`` and JAX's on the same
  inputs and hold every output and counter equal; the engine cases
  (``tiny_trained``, weights carried across by
  ``repro_torch.bridge.params_from_jax``) hold each port run equal to
  JAX's: streams, every ``GenStats`` counter with ``slo_total`` and
  ``slo_met``, time to first token and inter-token gaps and
  ``virtual_time`` to 1e-9, the adaptive controller's row and the pool
  statistics.  JAX's own assertions then run on the port's results.
* The 14 scenarios of ``tests/test_workload.py`` on the port's copy of
  ``core/workload.py``: every trace, arrival time and error equals JAX's
  (both draw from Python's ``random`` with the same seed).
* ``tests/test_system.py`` on ``tiny_trained``: serving, the cloud
  baseline and the simulator replay of the measured traces, held equal to
  JAX's (exit confidences within 1e-5, the port's float32 tolerance).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_spec import assert_same_run, bridge, jax_system  # noqa: E402
from repro.core import netsim as jnetsim  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core import workload as jworkload  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.serving import adaptive as jadaptive  # noqa: E402
from repro_torch.core import netsim as tnetsim  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.core import workload as tworkload  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.serving import adaptive as tadaptive  # noqa: E402
from repro_torch.serving.engine import (ServingSystem,  # noqa: E402
                                        token_agreement)

PORT = types.SimpleNamespace(adaptive=tadaptive, transport=ttransport,
                             netsim=tnetsim, workload=tworkload)
JAX = types.SimpleNamespace(adaptive=jadaptive, transport=jtransport,
                            netsim=jnetsim, workload=jworkload)


def _plain(value):
    """Dataclasses (traces, results) as tuples, recursively."""
    if dataclasses.is_dataclass(value):
        return dataclasses.astuple(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _both(scenario):
    """Run ``scenario(mods)`` on the port and on JAX; the results must be
    equal.  Returns the port's."""
    got, want = scenario(PORT), scenario(JAX)
    assert _plain(got) == _plain(want)
    return got


def _raises_both(scenario, exc=ValueError):
    for m in (PORT, JAX):
        with pytest.raises(exc):
            scenario(m)


# ---------------------------------------------------------------------------
# WindowController
# ---------------------------------------------------------------------------
def _svc(m, window=0.004, max_batch=4, service=0.008, **kw):
    return m.transport.CloudServicePoint(service, batch_window_s=window,
                                         max_batch=max_batch, **kw)


def _observe(m, times, ctrl_kw, **svc_kw):
    ctrl = m.adaptive.WindowController(**ctrl_kw)
    svc = _svc(m, **svc_kw)
    out = [ctrl.observe(t, svc) for t in times]
    return out, ctrl.mean_gap_s, ctrl.adjustments, svc.batch_window_s


def test_window_controller_warmup_keeps_static_window():
    out, _, adj, window = _both(lambda m: _observe(
        m, [0.01 * k for k in range(4)], dict(min_obs=4)))
    assert out == [window] * 4 and adj == 0


def test_window_controller_sparse_arrivals_drop_window_to_zero():
    out, gap, _, _ = _both(lambda m: _observe(
        m, [0.1 * k for k in range(8)], dict(min_obs=2), service=0.008))
    assert out[-1] == 0.0
    assert gap == pytest.approx(0.1, rel=0.05)


def test_window_controller_dense_arrivals_size_window_to_batch():
    times = [0.002 * k for k in range(12)]
    out, *_ = _both(lambda m: _observe(
        m, times, dict(min_obs=2, max_window_s=0.016), max_batch=4,
        service=0.008))
    assert out[-1] == pytest.approx(3 * 0.002, rel=0.1)
    out2, *_ = _both(lambda m: _observe(
        m, times, dict(min_obs=2, max_window_s=0.003), max_batch=4))
    assert out2[-1] == 0.003                   # clamped to max_window_s


def test_window_controller_ignores_out_of_order_ready_times():
    def scenario(m):
        ctrl = m.adaptive.WindowController(min_obs=2)
        svc = _svc(m)
        ctrl.observe(0.10, svc)
        ctrl.observe(0.08, svc)        # out-of-order uplink interleave
        first = ctrl.mean_gap_s
        ctrl.observe(0.12, svc)
        return first, ctrl.mean_gap_s
    first, after = _both(scenario)
    assert first == 0.0 and after > 0.0


def test_service_point_consults_controller_and_resets_it():
    class Fixed:
        def __init__(self):
            self.calls, self.resets = 0, 0

        def observe(self, ready_t, svc):
            self.calls += 1
            return 0.123

        def reset(self):
            self.resets += 1

    def scenario(m):
        ctrl = Fixed()
        svc = _svc(m, max_batch=2, window_controller=ctrl)
        resets0 = ctrl.resets
        done = svc.service(0.0)
        row = (ctrl.calls, svc.batch_window_s)
        svc.reset()
        return done, row, svc.batch_window_s, ctrl.resets - resets0
    _, row, window, resets = _both(scenario)
    assert row == (1, 0.123) and window == 0.004 and resets == 1


def test_window_controller_validation():
    _raises_both(lambda m: m.adaptive.WindowController(max_window_s=0.0))
    _raises_both(lambda m: m.adaptive.WindowController(ewma=0.0))


# ---------------------------------------------------------------------------
# ResumeCostModel + FluidCapacity
# ---------------------------------------------------------------------------
def test_resume_cost_crossover():
    def scenario(m):
        rc = m.adaptive.ResumeCostModel(d0_s=0.004, d1_s=2e-4, host_bw=1e8)
        return (rc.recompute_s(0), rc.recompute_s(100),
                rc.swap_s(1_000_000), rc.prefer_swap(10, 10_000_000),
                rc.prefer_swap(1000, 1_000_000))
    r0, r100, sw, short, long_ = _both(scenario)
    assert r0 == 0.004 and r100 == pytest.approx(0.024)
    assert sw == pytest.approx(0.02)
    assert not short and long_


def test_fluid_capacity_curve_and_gate():
    def scenario(m):
        cap = m.adaptive.FluidCapacity(m_total=256, b_tokens=4, d0_s=0.004,
                                       d1_s=1e-3)
        return (cap.batch_time_s(0), cap.batch_time_s(100),
                cap.throughput(0), cap.throughput(4),
                cap.can_admit(resident_tokens=100, active_streams=2,
                              new_tokens=100),
                cap.can_admit(200, 2, 100), cap.can_admit(0, 4, 10))
    b0, b100, t0, t4, ok, mem, batch = _both(scenario)
    assert (b0, b100, t0) == (0.004, 0.008, 0.0)
    assert t4 == pytest.approx(4 / 0.008)
    assert ok and not mem and not batch


# ---------------------------------------------------------------------------
# AdaptiveController (watermark AIMD)
# ---------------------------------------------------------------------------
class _Pool:
    def __init__(self, num_pages=40, page_size=8, num_slots=4, watermark=0):
        self.num_pages, self.page_size = num_pages, page_size
        self.num_slots, self.watermark = num_slots, watermark


def _controller(m, **cfg_kw):
    cfg = m.adaptive.AdaptiveConfig(interval_ticks=2, quiet_intervals=2,
                                    **cfg_kw)
    ctrl = m.adaptive.AdaptiveController(cfg)
    pool = _Pool()
    ctrl.attach(pool, m.adaptive.ResumeCostModel())
    return ctrl, pool


def _ticks(m, events):
    ctrl, pool = _controller(m)
    marks = []
    for tick, pre, oops in events:
        ctrl.on_tick(tick, pool, preemptions=pre, oops=oops)
        marks.append(pool.watermark)
    return marks, ctrl.as_row()


def test_aimd_raises_watermark_under_pressure():
    marks, row = _both(lambda m: _ticks(m, [(2, 3, 1), (3, 3, 1),
                                            (4, 30, 0)]))
    assert marks == [4, 4, 10]                 # clamped at 25% of 40 pages
    assert row["watermark_raises"] == 2


def test_aimd_decays_watermark_after_quiet_intervals():
    events = [(2, 2, 0)] + [(t, 2, 0) for t in range(4, 16, 2)]
    marks, row = _both(lambda m: _ticks(m, events))
    assert marks[0] == 2 and marks[2] == 1 and marks[-1] == 0
    assert row["watermark_decays"] == 2


def test_adaptive_attach_derives_fluid_capacity_from_pool():
    def scenario(m):
        ctrl, pool = _controller(m)
        full = pool.num_pages * pool.page_size
        return (ctrl.capacity.m_total, ctrl.capacity.b_tokens,
                ctrl.admit_ok(0, 0, 10), ctrl.admit_ok(full, 0, 1),
                ctrl.as_row())
    m_total, b_tokens, ok, held, row = _both(scenario)
    assert (m_total, b_tokens) == (320, 4)
    assert ok and not held and row["gate_holds"] == 1


def test_adaptive_gate_can_be_disabled():
    def scenario(m):
        ctrl, _ = _controller(m, gate_admission=False)
        return ctrl.admit_ok(10 ** 9, 10 ** 9, 10 ** 9), ctrl.gate_holds
    assert _both(scenario) == (True, 0)


# ---------------------------------------------------------------------------
# netsim honors case arrival stamps
# ---------------------------------------------------------------------------
def test_netsim_waits_for_case_arrival():
    def scenario(m):
        ns = m.netsim
        net = ns.NetworkParams(up_bw=4e6, down_bw=8e6, rtt=0.003)
        comp = ns.ComputeParams(edge_layer_time=1e-3, cloud_layer_time=1e-3)
        split = ns.ModelSplit(n_layers=12, l_ee1=4, l_ee2=6, d_model=256)
        toks = [ns.TokenTrace(0.95, 0.99)] * 3
        closed = [[ns.CaseTrace(prompt_len=8, tokens=list(toks))]]
        stamped = [[ns.CaseTrace(prompt_len=8, tokens=list(toks),
                                 arrival_t=5.0)]]
        return (ns.simulate("standalone", closed, net, comp, split),
                ns.simulate("standalone", stamped, net, comp, split))
    r0, r1 = _both(scenario)
    assert r1.total_time >= 5.0
    assert r1.total_time == pytest.approx(5.0 + r0.total_time, rel=1e-6)
    assert r1.tokens == r0.tokens


# ---------------------------------------------------------------------------
# engine open-loop replay (tiny_trained)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served(tiny_trained):
    jm, params = tiny_trained["model"], tiny_trained["params"]
    data = SyntheticCorpus(DataConfig(vocab_size=jm.cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(8) for _ in range(4)]
    long_prompts = [data.sample_tokens(12) for _ in range(4)]
    tm = bridge(jm, params)
    cache = {}

    def systems(**kw):
        kw = {"theta": 0.8, **kw}
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = (ServingSystem(tm, CollmConfig(**kw)),
                          jax_system(jm, params, **kw))
        return cache[key]

    return {"systems": systems, "prompts": prompts,
            "long_prompts": long_prompts, "jm": jm, "params": params}


def _run(served, ccfg_kw, prompts, max_new, multi=False, **kw):
    tsys, jsys = served["systems"](**ccfg_kw)
    fn = "generate_multi" if multi else "generate"
    got = getattr(tsys, fn)(prompts, max_new, **kw)
    want = getattr(jsys, fn)(prompts, max_new, **kw)
    assert_same_run(got, want)
    assert got.get("adaptive") == want.get("adaptive")
    return got


def test_open_loop_arrivals_gate_admission_and_ttft(served):
    prompts = served["prompts"]
    r = _run(served, {}, prompts, 6, num_slots=2, tick_time_s=0.01,
             arrivals=[0.0, 0.2, 0.4, 3.0], slo_ttft_s=5.0, slo_tpot_s=5.0)
    st = r["stats"]
    assert len(st.ttft_s) == len(prompts)
    assert all(t >= 0.0 for t in st.ttft_s)
    assert len(st.token_lat_s) == sum(len(t) - 1 for t in r["tokens"])
    assert r["virtual_time"] >= 3.0
    assert st.slo_total == len(prompts) and st.slo_met == st.slo_total
    assert st.slo_attainment == 1.0
    r0 = _run(served, {}, prompts, 6, num_slots=2, tick_time_s=0.01)
    assert r["tokens"] == r0["tokens"]


def test_open_loop_arrival_idle_gap_counts_as_idle(served):
    r = _run(served, {}, served["prompts"][:1], 4, num_slots=1,
             tick_time_s=0.01, arrivals=[2.0])
    assert r["virtual_time"] >= 2.0
    assert r["stats"].ttft_s[0] < 1.0


def test_slo_miss_counted(served):
    r = _run(served, {}, served["prompts"][:2], 6, num_slots=2,
             tick_time_s=0.01, arrivals=[0.0, 0.0], slo_tpot_s=1e-9)
    st = r["stats"]
    assert st.slo_total == 2 and st.slo_met == 0
    assert st.slo_attainment == 0.0


def test_generate_multi_tolerates_idle_engines(served):
    prompts = served["prompts"][:2]
    r = _run(served, {}, prompts, 5, multi=True, n_engines=4,
             tick_time_s=0.01, arrivals=[0.0, 0.5])
    assert all(t is not None and len(t) == 5 for t in r["tokens"])
    assert r["virtual_time"] >= 0.5
    ref = _run(served, {}, prompts, 5, multi=True, n_engines=2,
               tick_time_s=0.01)
    assert r["tokens"] == ref["tokens"]


def test_adaptive_control_is_token_invisible(served):
    max_new = 8
    prompts = served["long_prompts"]
    arr = tworkload.arrival_times(
        tworkload.ArrivalProcess(rate=40.0, kind="gamma", cv2=4.0),
        len(prompts), seed=0)
    assert arr == jworkload.arrival_times(
        jworkload.ArrivalProcess(rate=40.0, kind="gamma", cv2=4.0),
        len(prompts), seed=0)
    ps = CollmConfig().page_size
    worst = max((len(p) + max_new - 1) // ps + 1 for p in prompts)
    pages = max(worst, int(0.6 * 2 * worst))
    kw = dict(num_slots=2, num_pages=pages, tick_time_s=0.01, arrivals=arr)
    tsys_ad, jsys_ad = served["systems"](kv_layout="paged",
                                         preemption="swap")
    r_ad = tsys_ad.generate(prompts, max_new, resume_cost=tadaptive
                            .ResumeCostModel(host_bw=2e7),
                            adaptive=tadaptive.AdaptiveConfig(), **kw)
    w_ad = jsys_ad.generate(prompts, max_new, resume_cost=jadaptive
                            .ResumeCostModel(host_bw=2e7),
                            adaptive=jadaptive.AdaptiveConfig(), **kw)
    assert_same_run(r_ad, w_ad)
    assert r_ad["adaptive"] == w_ad["adaptive"] is not None
    tsys_st, jsys_st = served["systems"](kv_layout="paged",
                                         preemption="recompute")
    r_st = tsys_st.generate(prompts, max_new, resume_cost=tadaptive
                            .ResumeCostModel(host_bw=2e7), **kw)
    w_st = jsys_st.generate(prompts, max_new, resume_cost=jadaptive
                            .ResumeCostModel(host_bw=2e7), **kw)
    assert_same_run(r_st, w_st)
    assert r_ad["tokens"] == r_st["tokens"]
    assert r_st["adaptive"] is None


def test_adaptive_requires_paged_pool(served):
    tsys, jsys = served["systems"]()
    for system, mod in ((tsys, tadaptive), (jsys, jadaptive)):
        with pytest.raises(ValueError, match="paged"):
            system.generate(served["prompts"][:1], 4,
                            adaptive=mod.AdaptiveConfig())


# ---------------------------------------------------------------------------
# workload generators (tests/test_workload.py)
# ---------------------------------------------------------------------------
def test_paper_cases_seed_deterministic():
    def scenario(m):
        w = m.workload
        return [w.paper_calibrated_cases(w.ALPACA, 20, seed=s)
                for s in (7, 7, 8)]
    a, b, c = _both(scenario)
    assert _plain(a) == _plain(b)
    assert [x.prompt_len for x in a] != [x.prompt_len for x in c]


def test_arrival_times_seed_deterministic():
    def scenario(m):
        w = m.workload
        proc = w.ArrivalProcess(rate=10.0, kind="gamma", cv2=4.0,
                                diurnal_amp=0.4, diurnal_period_s=2.0)
        return [w.arrival_times(proc, 50, seed=s) for s in (3, 3, 4)]
    a, b, c = _both(scenario)
    assert a == b and a != c


@pytest.mark.parametrize("profile", ["ALPACA", "XSUM"])
def test_sample_conf_exceedance_matches_profile(profile):
    def scenario(m):
        prof = getattr(m.workload, profile)
        return m.workload.paper_calibrated_cases(prof, 60, seed=0), prof
    cases, prof = _both(scenario)
    confs = np.array([t.conf2 for c in cases for t in c.tokens])
    assert len(confs) >= 3000
    assert abs((confs >= 0.8).mean() - prof.p2_ge_08) < 0.03
    assert abs((confs >= 0.9).mean() - prof.p2_ge_09) < 0.03


def _gaps(m, n, seed, **proc_kw):
    t = m.workload.arrival_times(m.workload.ArrivalProcess(**proc_kw), n,
                                 seed=seed)
    return t


def test_poisson_interarrival_moments():
    t = _both(lambda m: _gaps(m, 4000, 1, rate=20.0))
    gaps = np.diff([0.0] + t)
    assert abs(gaps.mean() - 1 / 20.0) < 0.005
    assert abs(gaps.var() / gaps.mean() ** 2 - 1.0) < 0.15


def test_gamma_interarrival_burstiness():
    t = _both(lambda m: _gaps(m, 4000, 1, rate=20.0, kind="gamma",
                              cv2=4.0))
    gaps = np.diff([0.0] + t)
    assert abs(gaps.mean() - 1 / 20.0) < 0.01
    assert 2.5 < gaps.var() / gaps.mean() ** 2 < 6.0


def test_diurnal_modulation_shifts_density():
    def scenario(m):
        proc = m.workload.ArrivalProcess(rate=50.0, diurnal_amp=0.8,
                                         diurnal_period_s=1.0)
        t = m.workload.arrival_times(proc, 4000, seed=2)
        return t, [proc._cum_intensity(x) for x in t]
    t, lam = _both(scenario)
    phase = np.mod(np.asarray(t), 1.0)
    up = ((phase >= 0.0) & (phase < 0.5)).sum()
    down = ((phase >= 0.5) & (phase < 1.0)).sum()
    assert up > 1.5 * down
    lgaps = np.diff(np.concatenate([[0.0], lam]))
    assert abs(lgaps.mean() - 1.0) < 0.05


def test_invert_roundtrips_cum_intensity():
    def scenario(m):
        proc = m.workload.ArrivalProcess(rate=3.0, diurnal_amp=0.5,
                                         diurnal_period_s=7.0)
        return [(t, proc._cum_intensity(t)) for t in
                (proc._invert(x) for x in (0.1, 1.0, 12.3, 400.0))]
    for (_, cum), target in zip(_both(scenario), (0.1, 1.0, 12.3, 400.0)):
        assert cum == pytest.approx(target, abs=1e-6)


def test_arrival_times_sorted_nonnegative():
    def scenario(m):
        proc = m.workload.ArrivalProcess(rate=5.0, kind="gamma", cv2=2.0,
                                         diurnal_amp=0.3)
        return (m.workload.arrival_times(proc, 200, seed=0),
                m.workload.arrival_times(proc, 0))
    t, empty = _both(scenario)
    assert all(x >= 0 for x in t) and t == sorted(t) and empty == []


@pytest.mark.parametrize("kw", [
    {"rate": 0.0},
    {"rate": -1.0},
    {"rate": 1.0, "kind": "weibull"},
    {"rate": 1.0, "cv2": 0.0},
    {"rate": 1.0, "diurnal_amp": 1.0},
    {"rate": 1.0, "diurnal_amp": -0.1},
    {"rate": 1.0, "diurnal_period_s": 0.0},
])
def test_arrival_process_validation(kw):
    _raises_both(lambda m: m.workload.ArrivalProcess(**kw))


def _cases(m, n):
    return [m.netsim.CaseTrace(prompt_len=4 + i,
                               tokens=[m.netsim.TokenTrace(0.5, 0.9)])
            for i in range(n)]


def test_split_clients_round_robin():
    out = _both(lambda m: m.workload.split_clients(_cases(m, 7), 3))
    assert [len(x) for x in out] == [3, 2, 2]
    assert out[1][0].prompt_len == 5


def test_split_clients_caps_oversized_fleet():
    out = _both(lambda m: m.workload.split_clients(_cases(m, 3), 8))
    assert len(out) == 3 and all(len(x) == 1 for x in out)


def test_split_clients_rejects_degenerate_inputs():
    _raises_both(lambda m: m.workload.split_clients(_cases(m, 3), 0))
    _raises_both(lambda m: m.workload.split_clients([], 2))


def test_stamp_arrivals_copies_with_timestamps():
    def scenario(m):
        cases = _cases(m, 3)
        stamped = m.workload.stamp_arrivals(cases, [0.5, 1.25, 9.0])
        return cases, stamped
    cases, stamped = _both(scenario)
    assert [c.arrival_t for c in stamped] == [0.5, 1.25, 9.0]
    assert all(c.arrival_t == 0.0 for c in cases)
    assert stamped[0].prompt_len == cases[0].prompt_len
    _raises_both(lambda m: m.workload.stamp_arrivals(_cases(m, 3), [0.1]))


def test_case_trace_arrival_default_is_closed_loop():
    def scenario(m):
        return ([f.name for f in dataclasses.fields(m.netsim.CaseTrace)],
                m.netsim.CaseTrace(prompt_len=1, tokens=[]).arrival_t,
                m.workload.traces_from_confidences(
                    [2], [[(0.1, 0.9)]])[0].arrival_t)
    names, arrival, traced = _both(scenario)
    assert names[-1] == "arrival_t" and arrival == traced == 0.0


# ---------------------------------------------------------------------------
# tests/test_system.py: the paper's pipeline end to end
# ---------------------------------------------------------------------------
def test_end_to_end_paper_pipeline(served):
    data = SyntheticCorpus(DataConfig(vocab_size=served["jm"].cfg.vocab_size,
                                      seq_len=64, batch_size=1))
    prompts = [data.sample_tokens(10) for _ in range(3)]
    r = _run(served, {}, prompts, 20, mode="collm")
    st = r["stats"]
    want = served["systems"]()[1].generate(prompts, 20, mode="collm")
    np.testing.assert_allclose(np.asarray(st.confidences),
                               np.asarray(want["stats"].confidences),
                               atol=1e-5, rtol=0)
    assert 0.0 <= st.request_rate <= 1.0 and len(st.confidences) > 0
    base = _run(served, dict(theta=1.0), prompts, 20, mode="cloud")
    ags = [token_agreement(a, b)
           for a, b in zip(r["tokens"], base["tokens"])]
    assert np.mean(ags) > 0.5

    def replay(m):
        per_client = [[], [], []]
        for i, c in enumerate(st.confidences):
            per_client[i % 3].append(c)
        cases = m.workload.traces_from_confidences(
            [10] * len(prompts), [c for c in per_client if c])
        cfg = served["jm"].cfg
        ns = m.netsim
        comp = ns.ComputeParams(edge_layer_time=1e-3, cloud_layer_time=1e-3,
                                exit_head_time=5e-4)
        split = ns.ModelSplit(n_layers=cfg.n_layers,
                              l_ee1=cfg.exit_layers[0],
                              l_ee2=cfg.exit_layers[-1], d_model=cfg.d_model)
        net = ns.NetworkParams()
        one = m.workload.split_clients(cases, 1)
        return (ns.simulate("ce_collm", one, net, comp, split, theta=0.8),
                ns.simulate("cloud_llm", one, net, comp, split),
                ns.simulate("naive", one, net, comp, split,
                            half_precision=False))
    res_collm, res_cloud, res_naive = _both(replay)
    assert res_naive.total_time > res_cloud.total_time
    assert res_collm.cloud_time < res_cloud.cloud_time
    assert res_collm.transmitted_mb < res_naive.transmitted_mb / 10
