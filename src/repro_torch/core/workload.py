"""Workload generators for the serving simulator.

A copy of ``repro.core.workload`` over the port's ``netsim`` (the port
imports nothing of the JAX package).  Arrivals come from Python's
``random`` with the seed given, so they equal the JAX package's.

Two sources of per-token exit-confidence traces:

  * ``paper_calibrated_cases`` — synthetic confidences whose exceedance
    probabilities match the paper's measured request-cloud rates
    (Table 2: Alpaca 49.58% @0.8 / 58.00% @0.9; XSum 27.73% @0.8 /
    36.13% @0.9), with prompt/generation lengths drawn from the paper's
    described ranges.  Used to replay Tables 2/4 and Fig 4.

  * measured traces — produced by running the trained tiny EE model
    (examples/quickstart.py) and recording real exit confidences.

Plus the **open-loop arrival layer** (docs/fleet_sim.md): an
``ArrivalProcess`` describes when requests *arrive* (Poisson or bursty
gamma interarrivals, optionally modulated by a diurnal sinusoid), and
``arrival_times`` realizes it into virtual-time stamps.  Closed-loop
replay (every request queued at t=0) answers "how fast can we drain a
backlog"; open-loop replay answers the capacity-planning questions the
fleet bench gates on (tail latency, SLO attainment under bursts).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Sequence, Tuple

from repro_torch.core.netsim import CaseTrace, TokenTrace


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    prompt_range: Tuple[int, int]
    gen_range: Tuple[int, int]
    # P(conf2 >= 0.8), P(conf2 >= 0.9): calibrated from Table 2 request rates
    p2_ge_08: float
    p2_ge_09: float
    # fraction of edge-exits that already clear at the FIRST exit
    first_exit_share: float = 0.5


ALPACA = DatasetProfile("alpaca", (13, 43), (60, 120),
                        p2_ge_08=1 - 0.4958, p2_ge_09=1 - 0.5800)
XSUM = DatasetProfile("xsum", (200, 500), (60, 120),
                      p2_ge_08=1 - 0.2773, p2_ge_09=1 - 0.3613)


def _sample_conf(rng: random.Random, p_ge_08: float, p_ge_09: float) -> float:
    """Piecewise-uniform confidence with the target exceedance probs."""
    u = rng.random()
    if u < 1 - p_ge_08:
        return rng.uniform(0.05, 0.80)      # below both thresholds
    if u < 1 - p_ge_09:
        return rng.uniform(0.80, 0.90)
    return rng.uniform(0.90, 0.999)


def paper_calibrated_cases(profile: DatasetProfile, n_cases: int,
                           seed: int = 0) -> List[CaseTrace]:
    rng = random.Random(seed)
    cases = []
    for _ in range(n_cases):
        p = rng.randint(*profile.prompt_range)
        g = rng.randint(*profile.gen_range)
        toks = []
        for _ in range(g):
            c2 = _sample_conf(rng, profile.p2_ge_08, profile.p2_ge_09)
            # first exit clears for a share of the tokens the second clears
            if c2 >= 0.8 and rng.random() < profile.first_exit_share:
                c1 = c2 * rng.uniform(0.97, 1.0)
            else:
                c1 = c2 * rng.uniform(0.4, 0.9)
            toks.append(TokenTrace(conf1=min(c1, 0.999), conf2=c2))
        cases.append(CaseTrace(prompt_len=p, tokens=toks))
    return cases


def split_clients(cases: Sequence[CaseTrace], n_clients: int
                  ) -> List[List[CaseTrace]]:
    """Round-robin the case list over N edge clients (Fig 4 scaling).

    Returns ``min(n_clients, len(cases))`` lists — never an empty one.
    Oversizing the fleet used to hand downstream engines empty case lists
    (each one an idle client silently starving its engine); capping the
    fan-out keeps every returned client busy, and multi-engine drivers
    must tolerate the smaller fleet (an idle engine's clock never
    advances, so it cannot skew the makespan)."""
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1, got {n_clients}")
    if not cases:
        raise ValueError("split_clients needs at least one case")
    n = min(n_clients, len(cases))
    out: List[List[CaseTrace]] = [[] for _ in range(n)]
    for i, c in enumerate(cases):
        out[i % n].append(c)
    return out


# ---------------------------------------------------------------------------
# Open-loop arrival processes (fleet replay)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """An open-loop request arrival model in virtual time.

    ``rate`` is the long-run mean arrival rate (requests / virtual
    second).  ``kind="poisson"`` draws exponential interarrivals;
    ``kind="gamma"`` draws gamma interarrivals with squared coefficient
    of variation ``cv2`` (cv2=1 degenerates to Poisson, cv2>1 is bursty:
    clumps of near-simultaneous arrivals separated by long gaps).

    ``diurnal_amp`` in [0, 1) modulates the instantaneous rate as
    ``rate * (1 + diurnal_amp * sin(2*pi*t / diurnal_period_s))`` — the
    classic day/night ramp, realized exactly by time-rescaling the
    unit-rate process through the inverse cumulative intensity."""
    rate: float
    kind: str = "poisson"
    cv2: float = 1.0
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 60.0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.kind not in ("poisson", "gamma"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.cv2 <= 0:
            raise ValueError(f"cv2 must be > 0, got {self.cv2}")
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1) so the "
                             "instantaneous rate stays positive")
        if self.diurnal_period_s <= 0:
            raise ValueError("diurnal_period_s must be > 0")

    # cumulative intensity Lambda(t) = integral of rate*(1 + amp*sin(...))
    def _cum_intensity(self, t: float) -> float:
        amp, period = self.diurnal_amp, self.diurnal_period_s
        w = 2.0 * math.pi / period
        return self.rate * (t + amp / w * (1.0 - math.cos(w * t)))

    def _invert(self, target: float) -> float:
        """Smallest t with Lambda(t) == target (Lambda is strictly
        increasing since amp < 1), by bisection."""
        lo, hi = 0.0, max(1.0, 2.0 * target / self.rate)
        while self._cum_intensity(hi) < target:
            hi *= 2.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if self._cum_intensity(mid) < target:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)


def arrival_times(proc: ArrivalProcess, n: int, seed: int = 0
                  ) -> List[float]:
    """Realize ``n`` arrival timestamps of ``proc`` (sorted, seeded).

    Draws a unit-rate renewal process (exponential or gamma
    interarrivals with mean 1), then maps each cumulative event time
    through the inverse cumulative intensity — for ``diurnal_amp=0``
    this is just ``s / rate``; with modulation, arrivals thin out in the
    troughs and bunch at the peaks with the exact target density."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = random.Random(seed)
    if proc.kind == "gamma" and proc.cv2 != 1.0:
        # Gamma(k, theta): mean k*theta = 1, cv^2 = 1/k  =>  k = 1/cv2
        k, theta = 1.0 / proc.cv2, proc.cv2
        draw = lambda: rng.gammavariate(k, theta)
    else:
        draw = lambda: rng.expovariate(1.0)
    out, s = [], 0.0
    for _ in range(n):
        s += draw()
        if proc.diurnal_amp == 0.0:
            out.append(s / proc.rate)
        else:
            out.append(proc._invert(s))
    return out


def stamp_arrivals(cases: Sequence[CaseTrace], times: Sequence[float]
                   ) -> List[CaseTrace]:
    """Copy ``cases`` with per-case virtual arrival timestamps attached
    (``netsim.simulate`` and the fleet bench replay them open-loop)."""
    if len(times) < len(cases):
        raise ValueError(f"{len(cases)} cases but only {len(times)} "
                         f"arrival times")
    return [dataclasses.replace(c, arrival_t=float(t))
            for c, t in zip(cases, times)]


def traces_from_confidences(prompt_lens: Sequence[int],
                            confs: Sequence[Sequence[Tuple[float, float]]]
                            ) -> List[CaseTrace]:
    """Build cases from measured (conf1, conf2) per generated token."""
    return [CaseTrace(prompt_len=p,
                      tokens=[TokenTrace(c1, c2) for c1, c2 in cs])
            for p, cs in zip(prompt_lens, confs)]
