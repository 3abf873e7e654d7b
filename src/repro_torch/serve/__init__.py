"""Serving: the continuous-batching LM engine (:class:`ServingEngine`)
and the run-time replay of compiled power schedules
(:class:`PowerRuntime` executes one inference interval,
:class:`PeriodicScheduler` one per period); the compile side of a
deployment (:class:`CompileService` and its store) is re-exported from
:mod:`repro_torch.service`."""

from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.serve.power_runtime import (
    IntervalLedger,
    LayerLedger,
    LedgerMismatch,
    PowerRuntime,
    simulate_interval,
)
from repro_torch.serve.scheduler import PeriodicScheduler
# the compile side of the serving deployment: schedules served by
# PowerRuntime are produced by the fleet compile service
from repro_torch.service import (
    ArtifactStore,
    CompileRequest,
    CompileService,
    ContingencyBundle,
)

__all__ = ["ServingEngine", "EngineConfig", "Request", "PowerRuntime",
           "simulate_interval", "LedgerMismatch", "IntervalLedger",
           "LayerLedger", "PeriodicScheduler", "CompileService",
           "CompileRequest", "ArtifactStore", "ContingencyBundle"]
