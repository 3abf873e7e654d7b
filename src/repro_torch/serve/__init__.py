"""Run-time replay of compiled power schedules: :class:`PowerRuntime`
executes one inference interval, :class:`PeriodicScheduler` one per
period."""

from repro_torch.serve.power_runtime import (
    IntervalLedger,
    LayerLedger,
    LedgerMismatch,
    PowerRuntime,
    simulate_interval,
)
from repro_torch.serve.scheduler import PeriodicScheduler

__all__ = ["PowerRuntime", "simulate_interval", "LedgerMismatch",
           "IntervalLedger", "LayerLedger", "PeriodicScheduler"]
