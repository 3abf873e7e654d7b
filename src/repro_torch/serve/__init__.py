"""Serving: the continuous-batching LM engine (:class:`ServingEngine`)
and the run-time replay of compiled power schedules
(:class:`PowerRuntime` executes one inference interval,
:class:`PeriodicScheduler` one per period)."""

from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.serve.power_runtime import (
    IntervalLedger,
    LayerLedger,
    LedgerMismatch,
    PowerRuntime,
    simulate_interval,
)
from repro_torch.serve.scheduler import PeriodicScheduler

__all__ = ["ServingEngine", "EngineConfig", "Request", "PowerRuntime",
           "simulate_interval", "LedgerMismatch", "IntervalLedger",
           "LayerLedger", "PeriodicScheduler"]
