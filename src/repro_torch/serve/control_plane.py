"""Online power-orchestrated serving: the adaptive control plane.

The compiler emits static schedules; live traffic drifts.  This module
closes the loop without giving up the compile-time contract: every
schedule the plane ever runs is a *precompiled* artifact (the
:class:`~repro_torch.service.compile_service.ContingencyBundle` — frontier
snap points, deadline-tightened variants, the max-performance
aggressive point), so reacting to a spike is a table lookup, never a
blocking compile.  Three mechanisms stack:

  1. **Snap-to-frontier.**  :class:`RateTracker` follows the arrival
     rate (EWMA for the trend, windowed p95 for bursts) and queue
     depth; the plane snaps to the most relaxed precompiled frontier
     point whose compiled deadline still fits the current effective
     interval.  Under calm traffic it sits on exactly the schedule a
     static deployment would run (zero adaptation overhead).
  2. **Graceful degradation.**  A windowed miss ledger watches the
     deadline contract.  On a miss-rate breach the plane walks the
     ladder: frontier point → deadline-tightened variant (slack
     headroom absorbs cost-model error and transition jitter) →
     max-performance aggressive schedule; it recovers hysteretically
     (lower threshold, full clean window, dwell time) when misses
     subside.  Every transition is a structured :class:`ControlEvent`.
  3. **Async re-solve.**  On *sustained* drift outside the precompiled
     coverage the plane submits a background ``compile_many`` batch
     through :meth:`CompileService.compile_contingencies_async` and
     merges the new points when they land.  :class:`AsyncResolver`'s
     watchdog abandons a hung/slow compile (the serving loop polls and
     never blocks on it).
  4. **Ledger-learned recalibration** (``calib_enabled``).  Executed
     interval ledgers feed a
     :class:`~repro_torch.calib.learning.ResidualEstimator`; when the
     windowed per-layer cost residual diverges from the correction the
     plane last compiled under, it re-solves its contingency set under
     a ledger-learned
     :class:`~repro_torch.calib.learning.CalibratedCostModel` — re-centering
     the whole snap grid on the *true* costs instead of permanently
     paying the degradation ladder's tightened-headroom energy
     premium.  The re-solve rides the same async resolver (or runs
     inline with ``calib_blocking`` — simulated-time tests and
     benches).
  5. **Input-adaptive policy table** (``policy_table=``).  A
     :class:`~repro_torch.calib.policy_table.SchedulePolicyTable` compiled
     per observable band (activation density, batch, sequence length)
     adds a fourth snap axis: ``observe_input`` records the current
     band and the plane serves the band's frontier — still a table
     lookup, never a compile.

``serve_trace`` is the event-driven serving loop shared by
``chip_smoke.py``'s control phase and the tests: it plays a seeded
arrival trace (:mod:`repro_torch.serve.traffic`) and fault trace
(:mod:`repro_torch.serve.faults`) against any schedule policy — the
trivial :class:`StaticSchedulePolicy` baseline or the
:class:`AdaptiveScheduler` — under identical conditions, and accounts
deadline misses and energy (execution + idle gaps) over the identical
horizon.  Its sums run frame by frame in Python floats, as the JAX
package's do, so a report equals that package's field for field.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import time
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.calib.learning import ResidualEstimator, model_from_residuals
from repro_torch.hw.edge40nm import Edge40nmAccelerator
from repro_torch.perfmodel.gating import BankPlan
from repro_torch.perfmodel.layer_costs import LayerCost, LayerSpec
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.power_runtime import IntervalLedger, PowerRuntime
from repro_torch.core.schedule import PowerSchedule
from repro_torch.service.compile_service import ContingencyBundle


# ------------------------------------------------------------ events

@dataclasses.dataclass
class ControlEvent:
    """One structured control-plane transition (machine-readable: the
    benchmark asserts over these — e.g. "every snap resolved from a
    precompiled point")."""

    interval: int
    t: float
    kind: str          # snap | degrade | recover | resolve_* ...
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)


class EventLog:
    def __init__(self) -> None:
        self.events: list[ControlEvent] = []

    def log(self, interval: int, t: float, kind: str,
            **detail: Any) -> ControlEvent:
        ev = ControlEvent(interval, t, kind, detail)
        self.events.append(ev)
        return ev

    def of(self, kind: str) -> list[ControlEvent]:
        return [e for e in self.events if e.kind == kind]

    def kinds(self) -> dict[str, int]:
        return dict(collections.Counter(e.kind for e in self.events))

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events],
                          indent=2)

    def __len__(self) -> int:
        return len(self.events)


# ------------------------------------------------------- observation

class RateTracker:
    """Arrival-rate estimate: EWMA for the trend plus a windowed p95 of
    instantaneous rates so a short burst registers immediately (the
    paper's deadline contract is violated by the *fastest* recent
    traffic, not the average).

    The p95 only *overrides* the trend when it exceeds it by more than
    ``burst_tolerance`` — a genuine regime change.  Sub-tolerance
    dispersion (arrival jitter) is the provisioning headroom's job
    (``AdaptiveConfig.util_target``); letting it drive the snap would
    pin the plane one grid step too tight on every jittery-but-calm
    stretch.
    """

    def __init__(self, base_rate_hz: float, *, alpha: float = 0.25,
                 window: int = 12, burst_tolerance: float = 0.15):
        self.alpha = alpha
        self.burst_tolerance = burst_tolerance
        self._init_rate = float(base_rate_hz)
        # seeded from the first *observed* gap, not the prior — an EWMA
        # started at the provisioned rate decays only asymptotically
        # and would pin the plane on a too-tight point for dozens of
        # intervals after startup
        self.ewma: float | None = None
        self._win: collections.deque[float] = collections.deque(
            maxlen=window)

    def observe_gap(self, gap_s: float) -> None:
        rate = 1.0 / max(float(gap_s), 1e-9)
        self.ewma = rate if self.ewma is None \
            else self.ewma + self.alpha * (rate - self.ewma)
        self._win.append(rate)

    @property
    def p95(self) -> float:
        if not self._win:
            return self.ewma if self.ewma is not None \
                else self._init_rate
        return float(np.percentile(np.fromiter(self._win, float), 95))

    @property
    def rate(self) -> float:
        """The controlling estimate: the trend, unless the burst tail
        beats it by more than the jitter tolerance."""
        ewma = self.ewma if self.ewma is not None else self._init_rate
        p95 = self.p95
        return p95 if p95 > ewma * (1.0 + self.burst_tolerance) else ewma


class MissLedger:
    """Windowed per-interval deadline outcomes (dropped frames are not
    recorded — a frame that never arrived cannot miss)."""

    def __init__(self, window: int):
        self._win: collections.deque[bool] = collections.deque(
            maxlen=window)

    def record(self, miss: bool) -> None:
        self._win.append(bool(miss))

    def clear(self) -> None:
        self._win.clear()

    @property
    def n(self) -> int:
        return len(self._win)

    @property
    def full(self) -> bool:
        return len(self._win) == self._win.maxlen

    def miss_rate(self) -> float:
        if not self._win:
            return 0.0
        return sum(self._win) / len(self._win)


# --------------------------------------------------- async re-solve

class AsyncResolver:
    """Watchdog'd handle on one in-flight background re-solve.

    The serving loop calls :meth:`poll` between intervals: a finished
    future yields its result, one that exceeds ``watchdog_s`` is
    *abandoned* (``on_timeout`` lets the owner detach the worker pool)
    — either way the loop itself never blocks on a compile.
    """

    def __init__(self, watchdog_s: float = 30.0, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_timeout: Callable[[], None] | None = None):
        if not (watchdog_s > 0.0):
            raise ValueError(
                f"watchdog_s must be positive, got {watchdog_s!r}")
        self.watchdog_s = watchdog_s
        self.clock = clock
        self.on_timeout = on_timeout
        self._inflight: tuple[str, Any, float] | None = None

    @property
    def busy(self) -> bool:
        return self._inflight is not None

    def watch(self, tag: str, future: Any) -> None:
        if self._inflight is not None:
            raise RuntimeError(
                f"AsyncResolver already watching {self._inflight[0]!r}")
        self._inflight = (tag, future, self.clock())

    def poll(self) -> tuple[str, str, Any] | None:
        """``("done", tag, result)``, ``("error", tag, repr)``,
        ``("timeout", tag, elapsed_s)``, or None (idle / still
        running within budget)."""
        if self._inflight is None:
            return None
        tag, future, t0 = self._inflight
        if future.done():
            self._inflight = None
            exc = future.exception()
            if exc is not None:
                return ("error", tag, repr(exc))
            return ("done", tag, future.result())
        elapsed = self.clock() - t0
        if elapsed > self.watchdog_s:
            # abandon: the zombie compile may still finish in the
            # background (its artifact-store writes stay valid) but the
            # control plane stops waiting for it
            self._inflight = None
            if self.on_timeout is not None:
                self.on_timeout()
            return ("timeout", tag, elapsed)
        return None


# ------------------------------------------------------ the policies

class StaticSchedulePolicy:
    """The paper's deployment baseline: one compiled schedule, replayed
    every interval, no reaction to anything."""

    def __init__(self, schedule: PowerSchedule,
                 costs: Sequence[LayerCost], plan: BankPlan,
                 acc: Edge40nmAccelerator):
        self.schedule = schedule
        self.runtime = PowerRuntime(schedule, costs, plan, acc)
        self.events = EventLog()

    def pick(self, interval: int, now: float, gap_s: float,
             queue_depth: int) -> tuple[PowerSchedule, PowerRuntime]:
        return self.schedule, self.runtime

    def record(self, interval: int, *, miss: bool, dropped: bool,
               now: float, ledger: IntervalLedger | None = None) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Control-plane knobs (defaults tuned for frame-rate workloads in
    the tens-of-Hz band; all windows are in intervals)."""

    window: int = 24                  # miss-ledger window
    rate_window: int = 12             # burst-tail (p95) window
    ewma_alpha: float = 0.25
    burst_tolerance: float = 0.15     # p95 overrides trend beyond this
    # a point whose compiled deadline is within snap_eps of the
    # effective interval still fits: estimator noise at grid boundaries
    # must not flip the snap (headroom comes from util_target, not eps)
    snap_eps: float = 0.05
    queue_drain_horizon: float = 4.0  # backlog drained over ~N intervals
    # provisioning headroom: the plane targets util_target of the
    # observed interval, never 100% — a point compiled to exactly the
    # arrival gap has zero margin, so any cost-model noise flips ~half
    # the frames to misses.  Provision the static baseline at the same
    # utilization for a fair comparison.
    util_target: float = 0.85
    # graceful-degradation ladder
    breach_miss_rate: float = 0.3
    breach_min_samples: int = 8
    recover_miss_rate: float = 0.05   # hysteresis: << breach threshold
    dwell_intervals: int = 16         # min intervals between ladder moves
    # async re-solve
    drift_patience: int = 48          # sustained out-of-coverage ticks
    coverage_slack: float = 1.3       # relaxed-side grid coverage margin
    resolve_rate_band: tuple[float, float] = (0.5, 2.0)
    resolve_points: int = 4
    watchdog_s: float = 30.0
    # ledger-learned recalibration (see repro_torch.calib.learning): observe
    # executed-vs-predicted cost residuals and re-solve the contingency
    # set under the learned CalibratedCostModel once the estimate
    # diverges from the currently applied correction by more than
    # calib_threshold.  calib_blocking compiles inline instead of
    # through the async resolver — for simulated-time serving loops
    # (tests, benches) whose wall clock is unrelated to trace time.
    calib_enabled: bool = False
    calib_threshold: float = 0.06
    calib_window: int = 32
    calib_min_samples: int = 12
    calib_cooldown: int = 24          # min intervals between re-solves
    calib_blocking: bool = False

    def __post_init__(self) -> None:
        if not (0.0 < self.util_target <= 1.0):
            raise ValueError(
                f"util_target must lie in (0, 1], got "
                f"{self.util_target!r}")
        if not (0.0 <= self.recover_miss_rate < self.breach_miss_rate):
            raise ValueError(
                "hysteresis requires 0 <= recover_miss_rate < "
                f"breach_miss_rate, got {self.recover_miss_rate!r} vs "
                f"{self.breach_miss_rate!r}")
        if not (self.calib_threshold > 0.0):
            raise ValueError(
                f"calib_threshold must be > 0, got "
                f"{self.calib_threshold!r}")
        if self.calib_min_samples < 1 \
                or self.calib_window < self.calib_min_samples:
            raise ValueError(
                f"need 1 <= calib_min_samples <= calib_window, got "
                f"{self.calib_min_samples!r} vs {self.calib_window!r}")
        if self.calib_cooldown < 0:
            raise ValueError(
                f"calib_cooldown must be >= 0, got "
                f"{self.calib_cooldown!r}")


#: degradation-ladder rungs, in escalation order
RUNG_POINT, RUNG_TIGHTENED, RUNG_AGGRESSIVE = 0, 1, 2
_RUNG_NAMES = ("point", "tightened", "aggressive")


class AdaptiveScheduler:
    """Snap-to-frontier + graceful degradation + async re-solve (see
    module docstring).  Implements the same policy protocol as
    :class:`StaticSchedulePolicy`, so :func:`serve_trace` drives both.

    ``service`` (a :class:`~repro_torch.service.CompileService`, or anything
    with ``compile_contingencies_async`` / ``abandon_async_pool``) and
    ``specs`` enable the background re-solve path; without them the
    plane runs purely on the precompiled bundle.
    """

    def __init__(self, bundle: ContingencyBundle,
                 costs: Sequence[LayerCost], plan: BankPlan,
                 acc: Edge40nmAccelerator, *,
                 service: Any = None,
                 specs: Sequence[LayerSpec] | None = None,
                 compile_cfg: Any = None,
                 acfg: AdaptiveConfig | None = None,
                 policy_table: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        if not bundle.points:
            raise ValueError(
                "ContingencyBundle has no feasible frontier points — "
                "nothing to serve with")
        self.bundle = bundle
        self.costs = costs
        self.plan = plan
        self.acc = acc
        self.acfg = acfg or AdaptiveConfig()
        self.service = service
        self.specs = specs
        self.compile_cfg = compile_cfg
        self.events = EventLog()
        self.tracker = RateTracker(
            1.0 / bundle.base_deadline_s,
            alpha=self.acfg.ewma_alpha, window=self.acfg.rate_window,
            burst_tolerance=self.acfg.burst_tolerance)
        self.misses = MissLedger(self.acfg.window)
        self.rung = RUNG_POINT
        self.resolver = AsyncResolver(
            self.acfg.watchdog_s, clock=clock,
            on_timeout=self._abandon_pool) \
            if service is not None else None
        self._grid = sorted(bundle.points)
        self._runtimes: dict[int, PowerRuntime] = {}
        self._current: tuple | None = None
        self._since_transition = 0
        self._drift_ticks = 0
        # input-adaptive policy table (fourth snap axis)
        self.policy_table = policy_table
        self._observable: float | None = None
        # ledger-learned recalibration state: the estimator tracks the
        # world's per-layer cost bias in the *static-model frame* (the
        # runtimes predict with static costs whatever model the
        # schedule was compiled under), and _applied_scale is the
        # correction the current contingency set was compiled under —
        # in the same frame, so their divergence is the re-solve
        # trigger
        acfg = self.acfg
        self._estimator = ResidualEstimator(
            len(costs), window=acfg.calib_window,
            min_samples=acfg.calib_min_samples) \
            if acfg.calib_enabled else None
        self._applied_scale = np.ones(len(costs))
        self._applied_model = None     # CalibratedCostModel once landed
        self._predicted: dict[int, IntervalLedger] = {}
        self._last_pick: tuple[PowerSchedule, PowerRuntime] | None = None
        self._pending_model = None
        self._calib_cooldown = 0

    # -- plumbing ------------------------------------------------------
    def _abandon_pool(self) -> None:
        if self.service is not None and hasattr(self.service,
                                                "abandon_async_pool"):
            self.service.abandon_async_pool()

    def runtime_for(self, sched: PowerSchedule) -> PowerRuntime:
        rt = self._runtimes.get(id(sched))
        if rt is None:
            rt = PowerRuntime(sched, self.costs, self.plan, self.acc)
            self._runtimes[id(sched)] = rt
        return rt

    # -- snap ----------------------------------------------------------
    def _snap_deadline(self, eff_deadline: float) -> float:
        """Most relaxed precompiled deadline that still fits the
        effective interval; below coverage, the tightest point we have
        (the plane keeps serving at max effort rather than stalling)."""
        i = bisect.bisect_right(
            self._grid,
            eff_deadline * (1.0 + self.acfg.snap_eps)) - 1
        return self._grid[i] if i >= 0 else self._grid[0]

    def _schedule_for(self, rung: int, deadline: float
                      ) -> tuple[PowerSchedule, str]:
        b = self.bundle
        if rung >= RUNG_AGGRESSIVE:
            cands = [s for s in (b.aggressive, b.budget)
                     if s is not None]
            if cands:
                return min(cands, key=lambda s: s.t_infer), "aggressive"
        if rung >= RUNG_TIGHTENED:
            tight = b.tightened.get(deadline)
            if tight is not None:
                return tight, "tightened"
            if b.aggressive is not None:
                return b.aggressive, "aggressive"
        return b.points[deadline], "point"

    # -- policy protocol ----------------------------------------------
    def pick(self, interval: int, now: float, gap_s: float,
             queue_depth: int) -> tuple[PowerSchedule, PowerRuntime]:
        acfg = self.acfg
        self.tracker.observe_gap(gap_s)
        # queue pressure tightens the effective interval: drain the
        # backlog over ~queue_drain_horizon intervals
        required_rate = self.tracker.rate * (
            1.0 + queue_depth / acfg.queue_drain_horizon)
        eff_deadline = acfg.util_target / required_rate
        self._poll_resolver(interval, now)
        self._watch_drift(interval, now, eff_deadline)
        # input-adaptive axis: at the healthy rung, an observed input
        # band serves its own precompiled frontier (the degradation
        # ladder outranks it — the table has no tightened variants)
        if (self.rung == RUNG_POINT and self.policy_table is not None
                and self._observable is not None):
            tsched = self.policy_table.lookup(self._observable,
                                              eff_deadline)
            if tsched is not None:
                band = self.policy_table.band_for(self._observable)
                key = ("table", band.lo, band.hi, tsched.t_max)
                if key != self._current:
                    self.events.log(
                        interval, now, "snap",
                        deadline_s=tsched.t_max, variant="policy_table",
                        rung=self.rung, eff_deadline_s=eff_deadline,
                        rate_hz=required_rate, queue_depth=queue_depth,
                        observable=self._observable,
                        band=(band.lo, band.hi),
                        schedule_t_max_s=tsched.t_max,
                        schedule_t_infer_s=tsched.t_infer,
                        precompiled=True, source="policy_table")
                    self._current = key
                self._last_pick = (tsched, self.runtime_for(tsched))
                return self._last_pick
        deadline = self._snap_deadline(eff_deadline)
        sched, variant = self._schedule_for(self.rung, deadline)
        key = (self.rung, deadline, variant)
        if key != self._current:
            self.events.log(
                interval, now, "snap",
                deadline_s=deadline, variant=variant, rung=self.rung,
                eff_deadline_s=eff_deadline,
                rate_hz=required_rate, queue_depth=queue_depth,
                schedule_t_max_s=sched.t_max,
                schedule_t_infer_s=sched.t_infer,
                precompiled=True, source="precompiled")
            self._current = key
        self._last_pick = (sched, self.runtime_for(sched))
        return self._last_pick

    def observe_input(self, interval: int, observable: float) -> None:
        """Record the cheap runtime observable (activation density,
        batch size, ...) the policy table is indexed by; the next
        :meth:`pick` serves the matching band."""
        self._observable = float(observable)

    def record(self, interval: int, *, miss: bool, dropped: bool,
               now: float, ledger: IntervalLedger | None = None) -> None:
        if dropped:
            return
        acfg = self.acfg
        if (self._estimator is not None and ledger is not None
                and self._last_pick is not None):
            self._observe_ledger(interval, now, ledger)
        self.misses.record(miss)
        self._since_transition += 1
        if self._since_transition < acfg.dwell_intervals:
            return
        rate = self.misses.miss_rate()
        if (rate > acfg.breach_miss_rate
                and self.misses.n >= acfg.breach_min_samples
                and self.rung < RUNG_AGGRESSIVE):
            self.rung += 1
            self.events.log(
                interval, now, "degrade",
                to_rung=self.rung, rung_name=_RUNG_NAMES[self.rung],
                miss_rate=rate)
            self.misses.clear()
            self._since_transition = 0
        elif (self.misses.full and rate <= acfg.recover_miss_rate
                and self.rung > RUNG_POINT):
            # hysteretic: a *full* clean window at a threshold far
            # below the breach one, after the dwell time
            self.rung -= 1
            self.events.log(
                interval, now, "recover",
                to_rung=self.rung, rung_name=_RUNG_NAMES[self.rung],
                miss_rate=rate)
            self.misses.clear()
            self._since_transition = 0

    # -- ledger-learned recalibration ---------------------------------
    def _observe_ledger(self, interval: int, now: float,
                        executed: IntervalLedger) -> None:
        sched, rt = self._last_pick
        pred = self._predicted.get(id(sched))
        if pred is None:
            # fault-free replay of the schedule the interval ran under:
            # the per-layer executed/predicted time ratio is then
            # exactly the world's op_scale for that interval
            pred = rt.execute_interval()
            self._predicted[id(sched)] = pred
        self._estimator.observe(executed, pred)
        if self._calib_cooldown > 0:
            self._calib_cooldown -= 1
            return
        est = self._estimator.estimate()
        if est is None:
            return
        dev = float(np.max(np.abs(est / self._applied_scale - 1.0)))
        if dev > self.acfg.calib_threshold:
            self._recalibrate(interval, now, est, dev)

    def _recalibrate(self, interval: int, now: float,
                     est: np.ndarray, dev: float) -> None:
        if self.service is None or self.specs is None:
            return
        acfg = self.acfg
        model = model_from_residuals(est)
        # re-solve at the bundle's own base rate so the replacement
        # grid *replaces* the live snap points (compile_contingencies
        # always puts the base deadline itself on the grid) instead of
        # extending coverage sideways
        base_rate = 1.0 / self.bundle.base_deadline_s
        kwargs = dict(rate_band=acfg.resolve_rate_band,
                      n_points=acfg.resolve_points,
                      tighten_frac=self.bundle.tighten_frac,
                      budget_frac=None, cfg=self.compile_cfg,
                      network=self.bundle.network, cost_model=model)
        if acfg.calib_blocking:
            self._calib_cooldown = acfg.calib_cooldown
            self.events.log(
                interval, now, "calibrate_start", deviation=dev,
                model=model.digest, blocking=True,
                scale_min=float(min(model.scale)),
                scale_max=float(max(model.scale)))
            fresh = self.service.compile_contingencies(
                self.specs, base_rate, **kwargs)
            self._land_calibration(interval, now, fresh, model)
            return
        if self.resolver is None or self.resolver.busy:
            return                     # retry once the resolver frees
        self._calib_cooldown = acfg.calib_cooldown
        self.events.log(
            interval, now, "calibrate_start", deviation=dev,
            model=model.digest, blocking=False,
            scale_min=float(min(model.scale)),
            scale_max=float(max(model.scale)))
        future = self.service.compile_contingencies_async(
            self.specs, base_rate, **kwargs)
        self._pending_model = model
        self.resolver.watch(f"calibrate@{model.digest[:12]}", future)

    def _land_calibration(self, interval: int, now: float,
                          fresh: ContingencyBundle, model) -> None:
        b = self.bundle
        if not fresh.points:
            # every grid point came back infeasible under the learned
            # model (extreme transient): keep serving the stale set —
            # wrong-but-runnable beats nothing — and let the next
            # estimate retry
            self.events.log(
                interval, now, "calibrate_done", model=model.digest,
                replaced_points=0, dropped_stale=0, n_points=0)
            return
        replaced = sum(1 for d in fresh.points if d in b.points)
        dropped = len(b.points) - replaced
        # a calibration invalidates every schedule compiled under the
        # previous model, so the whole operating set is REPLACED, not
        # merged: a stale point left at an off-grid deadline would keep
        # serving a wrong-model schedule whenever the snap lands on it
        b.points.clear()
        b.points.update(fresh.points)
        b.tightened.clear()
        b.tightened.update(fresh.tightened)
        b.aggressive = fresh.aggressive
        b.budget = fresh.budget
        b.infeasible.extend(fresh.infeasible)
        self._grid = sorted(b.points)
        self._runtimes.clear()
        self._predicted.clear()
        self._applied_scale = np.asarray(model.scale, dtype=float)
        self._applied_model = model
        self._estimator.clear()
        # the old residual evidence and ladder state described the
        # stale compile — restart both cleanly under the new one
        self.misses.clear()
        self.rung = RUNG_POINT
        self._since_transition = 0
        self._current = None           # force a fresh snap event
        self.events.log(
            interval, now, "calibrate_done", model=model.digest,
            replaced_points=replaced, dropped_stale=dropped,
            n_points=len(b.points))

    # -- background re-solve ------------------------------------------
    def _watch_drift(self, interval: int, now: float,
                     eff_deadline: float) -> None:
        acfg = self.acfg
        covered = (self._grid[0] <= eff_deadline
                   <= self._grid[-1] * acfg.coverage_slack)
        if covered:
            self._drift_ticks = 0
            return
        self._drift_ticks += 1
        if (self._drift_ticks < acfg.drift_patience
                or self.resolver is None or self.resolver.busy
                or self.specs is None):
            return
        rate = 1.0 / eff_deadline
        # coverage extensions stay in the live cost-model frame: after
        # a calibration has landed, a static-model point merged into
        # the calibrated grid would serve wrong-model schedules
        future = self.service.compile_contingencies_async(
            self.specs, rate, rate_band=acfg.resolve_rate_band,
            n_points=acfg.resolve_points,
            tighten_frac=self.bundle.tighten_frac,
            budget_frac=None, cfg=self.compile_cfg,
            network=self.bundle.network,
            cost_model=self._applied_model)
        self.resolver.watch(f"resolve@{rate:.3g}Hz", future)
        self._drift_ticks = 0
        self.events.log(interval, now, "resolve_start",
                        rate_hz=rate, eff_deadline_s=eff_deadline)

    def _poll_resolver(self, interval: int, now: float) -> None:
        if self.resolver is None:
            return
        polled = self.resolver.poll()
        if polled is None:
            return
        status, tag, payload = polled
        if status == "done":
            if tag.startswith("calibrate@"):
                model, self._pending_model = self._pending_model, None
                self._land_calibration(interval, now, payload, model)
                return
            n_before = len(self.bundle.points)
            self.bundle.merge_points(payload)
            self._grid = sorted(self.bundle.points)
            self.events.log(
                interval, now, "resolve_done", tag=tag,
                new_points=len(self.bundle.points) - n_before)
        elif status == "timeout":
            self._pending_model = None
            self.events.log(interval, now, "resolve_timeout", tag=tag,
                            elapsed_s=payload)
        else:
            self._pending_model = None
            self.events.log(interval, now, "resolve_error", tag=tag,
                            error=payload)


# ------------------------------------------------- the serving loop

@dataclasses.dataclass
class ServeReport:
    """Outcome of one :func:`serve_trace` run (identical horizon and
    fault trace across policies → directly comparable)."""

    frames: int
    served: int
    dropped: int
    misses: int
    miss_rate: float
    e_exec_j: float
    e_idle_j: float
    energy_j: float
    duration_s: float
    avg_power_mw: float
    events: EventLog | None = None

    def summary(self) -> str:
        return (f"{self.served}/{self.frames} served "
                f"({self.dropped} dropped), miss rate "
                f"{self.miss_rate:.3f}, energy {self.energy_j*1e3:.3f} mJ "
                f"({self.avg_power_mw:.2f} mW avg)")


def serve_trace(frame_times: np.ndarray, policy: Any, *,
                injector: FaultInjector | None = None,
                observables: np.ndarray | None = None,
                on_interval: Callable[[int, IntervalLedger], None]
                | None = None) -> ServeReport:
    """Play an arrival trace against a schedule policy.

    ``frame_times`` holds ``n + 1`` timestamps (frame ``k``'s deadline
    is the next arrival — the periodic contract under drift, see
    :mod:`repro_torch.serve.traffic`).  Frames are served FCFS; a frame's
    processing starts when both it has arrived (late faults shift the
    arrival) and the previous frame finished.  Energy accounts real
    execution plus the idle model over the gaps the server spends
    waiting, over the identical horizon for every policy.

    ``observables`` optionally carries one cheap per-frame runtime
    observable (activation density, batch size, ...) fed to policies
    that implement ``observe_input`` — the policy-table snap axis.
    Executed ledgers are handed to ``policy.record(..., ledger=)`` so a
    learning policy can estimate cost residuals.
    """
    times = np.asarray(frame_times, dtype=float)
    if times.ndim != 1 or len(times) < 2:
        raise ValueError(
            "frame_times must hold at least 2 timestamps "
            "(n frames need n+1 times)")
    n = len(times) - 1
    if observables is not None:
        observables = np.asarray(observables, dtype=float)
        if observables.shape != (n,):
            raise ValueError(
                f"observables must hold one value per frame "
                f"({n}), got shape {observables.shape}")
    observe = getattr(policy, "observe_input", None) \
        if observables is not None else None
    t_free = float(times[0])
    e_exec = e_idle = 0.0
    misses = served = dropped = 0
    runtime = None
    for k in range(n):
        arrival = float(times[k])
        deadline = float(times[k + 1])
        faults = injector.interval(k) if injector is not None else None
        if faults is not None and faults.dropped:
            dropped += 1
            policy.record(k, miss=False, dropped=True, now=arrival)
            continue
        if faults is not None:
            arrival += faults.late_s
            if faults.late_s:
                # strip the late component: the trace applied it to the
                # arrival; execute_interval must not charge it again
                faults = dataclasses.replace(faults, late_s=0.0)
        start = max(t_free, arrival)
        backlog = int(np.searchsorted(times[:n], start,
                                      side="right")) - k - 1
        gap = float(times[k] - times[k - 1]) if k > 0 \
            else float(times[1] - times[0])
        if observe is not None:
            observe(k, float(observables[k]))
        sched, runtime = policy.pick(k, start, gap, max(backlog, 0))
        if start > t_free:
            e_idle += runtime.idle.energy(start - t_free)
        led = runtime.execute_interval(
            faults=faults, deadline_s=max(deadline - start, 0.0))
        e_exec += led.e_exec
        finish = start + led.t_infer
        miss = finish > deadline + 1e-12
        misses += int(miss)
        served += 1
        policy.record(k, miss=miss, dropped=False, now=finish,
                      ledger=led)
        if on_interval is not None:
            on_interval(k, led)
        t_free = finish
    if runtime is not None and times[-1] > t_free:
        e_idle += runtime.idle.energy(float(times[-1]) - t_free)
    duration = float(times[-1] - times[0])
    energy = e_exec + e_idle
    return ServeReport(
        frames=n, served=served, dropped=dropped, misses=misses,
        miss_rate=misses / served if served else 0.0,
        e_exec_j=e_exec, e_idle_j=e_idle, energy_j=energy,
        duration_s=duration,
        avg_power_mw=energy / duration * 1e3 if duration > 0 else 0.0,
        events=getattr(policy, "events", None))
