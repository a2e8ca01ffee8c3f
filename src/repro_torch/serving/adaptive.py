"""Adaptive serving controllers (docs/fleet_sim.md).

A copy of ``repro.serving.adaptive`` (plain Python; the port imports
nothing of the JAX package).

Three loops close over knobs that already exist elsewhere in the stack:

  * ``WindowController`` sizes ``CloudServicePoint.batch_window_s`` from
    the observed request arrival rate at the service queue.  A static
    window taxes every request with its full accumulation delay even
    when arrivals are sparse and nothing ever joins the batch; shrinking
    it to zero in the troughs and re-opening it to ~(max_batch-1) mean
    interarrival gaps in the bursts keeps coalescing where it pays and
    removes the tax where it doesn't.

  * ``ResumeCostModel`` prices the two ways a preempted stream can come
    back — re-prefill (fluid-ODE batch-time curve ``d0 + d1 * ctx``) vs
    host page swap (``2 * kv_bytes / host_bw``: out at preempt, in at
    resume) — so the engine can pick per victim instead of globally, and
    so BOTH static and adaptive arms of a comparison pay the same
    physics (the model is a cost *meter*; the adaptive win comes from
    choosing the cheaper mode, never from deleting the cost).

  * ``FluidCapacity`` is the vLLM fluid-ODE capacity curve (SNIPPETS.md
    snippet 1): ``m_total`` tokens of KV memory, ``b_tokens`` of batch
    budget per step, batch time ``d0 + d1 * min(n, b)``.  ``AdaptiveConfig``
    uses it as an admission gate — hold a stream at the door while its
    worst-case residency would push the pool into preemption thrash —
    and ``WatermarkController`` complements it reactively by raising the
    ``PagePool`` watermark (reserved headroom) while ``OutOfPages`` /
    preemption events are observed, decaying it in quiet windows (AIMD).

Everything here runs in virtual time and is deterministic: controllers
observe only virtual-clock quantities, so a fleet replay with fixed
seeds reproduces bit-identical decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# ---------------------------------------------------------------------------
# Cloud batch-window controller (attaches to transport.CloudServicePoint)
# ---------------------------------------------------------------------------
class WindowController:
    """Size the cloud accumulation window from the observed arrival rate.

    ``observe(ready_t, svc)`` is called by ``CloudServicePoint.service``
    with each request's ready time and must return the window to use.
    It keeps an EWMA of interarrival gaps; once warmed up:

      * sparse arrivals (``rate * service_s < sat_threshold``): return 0
        — a window only delays the lone request in its batch;
      * dense arrivals: return ``(max_batch - 1) * mean_gap`` clamped to
        ``max_window_s`` — long enough that a full batch can actually
        accumulate, never longer.
    """

    def __init__(self, *, max_window_s: float = 0.008,
                 sat_threshold: float = 1.0, ewma: float = 0.25,
                 min_obs: int = 4):
        if max_window_s <= 0:
            raise ValueError("max_window_s must be > 0")
        if not 0.0 < ewma <= 1.0:
            raise ValueError("ewma must be in (0, 1]")
        self.max_window_s = float(max_window_s)
        self.sat_threshold = float(sat_threshold)
        self.ewma = float(ewma)
        self.min_obs = int(min_obs)
        self.adjustments = 0       # times the returned window changed
        self.reset()

    def reset(self) -> None:
        self._last_t: Optional[float] = None
        self._mean_gap: Optional[float] = None
        self._n = 0
        self._last_window: Optional[float] = None

    @property
    def mean_gap_s(self) -> Optional[float]:
        return self._mean_gap

    def observe(self, ready_t: float, svc) -> float:
        if self._last_t is None:
            self._last_t = ready_t
            return svc.batch_window_s
        # ready times from different uplinks can interleave slightly out
        # of order; a negative gap carries no rate information
        gap = max(0.0, ready_t - self._last_t)
        self._last_t = max(self._last_t, ready_t)
        self._mean_gap = (gap if self._mean_gap is None else
                          (1 - self.ewma) * self._mean_gap + self.ewma * gap)
        self._n += 1
        if self._n < self.min_obs or self._mean_gap <= 0.0:
            return svc.batch_window_s
        rate = 1.0 / self._mean_gap
        if rate * svc.service_s < self.sat_threshold:
            window = 0.0           # sparse: the window is pure latency tax
        else:
            window = min(self.max_window_s,
                         (svc.max_batch - 1) * self._mean_gap)
        if self._last_window is not None and window != self._last_window:
            self.adjustments += 1
        self._last_window = window
        return window


# ---------------------------------------------------------------------------
# Preemption resume pricing (shared physics for static AND adaptive arms)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ResumeCostModel:
    """Virtual-time price of bringing a preempted stream back.

    ``recompute_s`` follows the fluid-ODE batch-time curve (a re-prefill
    is one batch over ``ctx`` tokens); ``swap_s`` is the host round trip
    of the victim's KV bytes (page-out at preempt + page-in at resume).
    The engine bills the chosen mode's cost into its virtual clock at
    resume time; ``prefer_swap`` is the per-victim decision rule the
    adaptive controller applies with the *same* model."""
    d0_s: float = 0.004            # fixed batch overhead (re-prefill)
    d1_s: float = 2.0e-4           # per-context-token re-prefill time
    host_bw: float = 1.0e9         # host<->device bandwidth, bytes/s

    def recompute_s(self, ctx_tokens: int) -> float:
        return self.d0_s + self.d1_s * max(0, int(ctx_tokens))

    def swap_s(self, kv_bytes: int) -> float:
        return 2.0 * max(0, int(kv_bytes)) / self.host_bw

    def prefer_swap(self, ctx_tokens: int, kv_bytes: int) -> bool:
        """Short contexts re-prefill faster than their pages round-trip
        the host; long contexts flip — the crossover is exactly where
        the two curves meet."""
        return self.swap_s(kv_bytes) < self.recompute_s(ctx_tokens)


# ---------------------------------------------------------------------------
# Fluid-ODE capacity curve (SNIPPETS.md snippet 1: M_total / B / d0 / d1)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FluidCapacity:
    """The cheap-to-evaluate capacity model an admission controller can
    consult before accepting work: ``m_total`` tokens of KV memory,
    ``b_tokens`` of per-step batch budget, batch time ``d0 + d1 * n``."""
    m_total: int                   # KV memory capacity, in tokens
    b_tokens: int                  # batch token budget per step
    d0_s: float = 0.004
    d1_s: float = 2.0e-4

    def batch_time_s(self, n_tokens: int) -> float:
        return self.d0_s + self.d1_s * min(max(0, n_tokens), self.b_tokens)

    def throughput(self, n_tokens: int) -> float:
        """Steady-state tokens/s when ``n_tokens`` are resident."""
        n = min(max(0, n_tokens), self.b_tokens)
        return n / self.batch_time_s(n) if n else 0.0

    def can_admit(self, resident_tokens: int, active_streams: int,
                  new_tokens: int) -> bool:
        """Admission gate: the stream's worst-case residency must fit the
        memory curve AND the step must have batch budget for one more
        decoding stream — admitting past either point converts admission
        into guaranteed preemption churn."""
        if resident_tokens + new_tokens > self.m_total:
            return False
        return active_streams + 1 <= self.b_tokens


# ---------------------------------------------------------------------------
# PagePool watermark AIMD + per-victim mode choice + admission gate
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AdaptiveConfig:
    """Knobs for the engine-side adaptive loops (``BatchScheduler``
    consults an ``AdaptiveController`` built from this)."""
    interval_ticks: int = 8        # controller cadence, in scheduler ticks
    watermark_max_frac: float = 0.25   # AIMD ceiling as a pool fraction
    quiet_intervals: int = 4       # decay the watermark after this many
                                   # event-free intervals
    adapt_resume_mode: bool = True     # per-victim swap-vs-recompute
    capacity: Optional[FluidCapacity] = None   # None: derive from pool
    gate_admission: bool = True    # consult the fluid curve at admission


class AdaptiveController:
    """Engine-side adaptive loop: watermark AIMD + fluid admission gate.

    Stateless with respect to the engine except through public knobs
    (``pool.watermark``) and observed counters (``preemptions``,
    ``oops``); ``on_tick`` is called once per scheduler tick and is a
    no-op between intervals."""

    def __init__(self, cfg: AdaptiveConfig):
        self.cfg = cfg
        self.capacity: Optional[FluidCapacity] = cfg.capacity
        self.watermark_raises = 0
        self.watermark_decays = 0
        self.gate_holds = 0        # admissions delayed by the fluid gate
        self._last_tick = 0
        self._last_events = 0
        self._quiet = 0
        self._floor = 0
        self._ceiling = 0

    def attach(self, pool, resume_cost: Optional[ResumeCostModel]) -> None:
        """Derive unset pieces from the engine's actual pool geometry."""
        self._floor = pool.watermark
        self._ceiling = max(self._floor,
                            int(pool.num_pages * self.cfg.watermark_max_frac))
        if self.capacity is None:
            rc = resume_cost or ResumeCostModel()
            self.capacity = FluidCapacity(
                m_total=pool.num_pages * pool.page_size,
                b_tokens=max(1, pool.num_slots),
                d0_s=rc.d0_s, d1_s=rc.d1_s)

    def on_tick(self, tick_no: int, pool, preemptions: int,
                oops: int) -> None:
        """AIMD on the pool watermark: additive increase while the window
        saw preemption/OutOfPages pressure, multiplicative-ish decrease
        (one page per quiet streak) back toward the configured floor."""
        if tick_no - self._last_tick < self.cfg.interval_ticks:
            return
        self._last_tick = tick_no
        events = (preemptions + oops) - self._last_events
        self._last_events = preemptions + oops
        if events > 0:
            self._quiet = 0
            new = min(self._ceiling, pool.watermark + max(1, events))
            if new != pool.watermark:
                pool.watermark = new
                self.watermark_raises += 1
        else:
            self._quiet += 1
            if (self._quiet >= self.cfg.quiet_intervals
                    and pool.watermark > self._floor):
                pool.watermark -= 1
                self._quiet = 0
                self.watermark_decays += 1

    def admit_ok(self, resident_tokens: int, active_streams: int,
                 new_tokens: int) -> bool:
        if not self.cfg.gate_admission or self.capacity is None:
            return True
        ok = self.capacity.can_admit(resident_tokens, active_streams,
                                     new_tokens)
        if not ok:
            self.gate_holds += 1
        return ok

    def as_row(self) -> dict:
        return {"watermark_raises": self.watermark_raises,
                "watermark_decays": self.watermark_decays,
                "gate_holds": self.gate_holds}
