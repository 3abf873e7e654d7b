"""Deadline-constrained periodic inference scheduler (the paper's
workload class, §1: "inference at a fixed frame rate").

Pairs an edge-CNN workload with a compiled PowerSchedule: every
1/R_target interval runs exactly one inference under the static power
schedule and accounts energy per interval.  The scheduler is
intentionally trivial — determinism is the point (§2.2): no
predictive/reactive control, no run-time heuristics.  The *adaptive*
counterpart (traffic tracking, contingency snaps, graceful degradation)
lives in :mod:`repro_torch.serve.control_plane`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.power_runtime import IntervalLedger, PowerRuntime


@dataclasses.dataclass
class PeriodicScheduler:
    runtime: PowerRuntime
    target_rate_hz: float

    def __post_init__(self) -> None:
        if not (self.target_rate_hz > 0.0):
            raise ValueError(
                f"PeriodicScheduler needs target_rate_hz > 0, got "
                f"{self.target_rate_hz!r} (the interval is "
                f"1/target_rate_hz)")

    def run(self, n_intervals: int,
            on_interval: Callable[[int, IntervalLedger], None] | None
            = None, *, injector: FaultInjector | None = None) -> dict:
        """Execute ``n_intervals`` periodic inferences; returns totals.

        ``n_intervals=0`` is a no-op that returns zeroed totals (not a
        ZeroDivisionError).  ``injector`` perturbs each interval with
        its seeded faults (see :mod:`repro_torch.serve.faults`).
        """
        if n_intervals < 0:
            raise ValueError(
                f"n_intervals must be >= 0, got {n_intervals}")
        ledgers = []
        missed = 0
        dropped = 0
        for i in range(n_intervals):
            faults = injector.interval(i) if injector is not None \
                else None
            led = self.runtime.execute_interval(faults=faults)
            if not led.met_deadline:
                missed += 1
            if led.dropped:
                dropped += 1
            ledgers.append(led)
            if on_interval:
                on_interval(i, led)
        total_e = sum(l.e_total for l in ledgers)
        elapsed = n_intervals / self.target_rate_hz
        return {
            "intervals": n_intervals,
            "total_energy_j": total_e,
            "avg_interval_energy_uj": (total_e / n_intervals * 1e6
                                       if n_intervals else 0.0),
            "deadline_misses": missed,
            "dropped_frames": dropped,
            "avg_power_mw": (total_e / elapsed * 1e3
                             if elapsed else 0.0),
            "ledgers": ledgers,
        }
