"""Serving: the continuous-batching LM engine (:class:`ServingEngine`),
the run-time replay of compiled power schedules (:class:`PowerRuntime`
executes one inference interval, :class:`PeriodicScheduler` one per
period), seeded fault and traffic traces, and the adaptive control
plane that serves a precompiled contingency set under them
(:class:`AdaptiveScheduler`, :func:`serve_trace`); the compile side of
a deployment (:class:`CompileService` and its store) is re-exported
from :mod:`repro_torch.service`."""

from repro_torch.serve.control_plane import (
    AdaptiveConfig,
    AdaptiveScheduler,
    AsyncResolver,
    ControlEvent,
    EventLog,
    MissLedger,
    RateTracker,
    ServeReport,
    StaticSchedulePolicy,
    serve_trace,
)
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.serve.faults import FaultConfig, FaultInjector, linear_drift
from repro_torch.serve.power_runtime import (
    IntervalLedger,
    LayerLedger,
    LedgerMismatch,
    PowerRuntime,
    simulate_interval,
)
from repro_torch.serve.scheduler import PeriodicScheduler
from repro_torch.serve.traffic import (
    SCENARIOS,
    TrafficConfig,
    TrafficSimulator,
)
# the compile side of the serving deployment: schedules served by
# PowerRuntime are produced by the fleet compile service
from repro_torch.service import (
    ArtifactStore,
    CompileRequest,
    CompileService,
    ContingencyBundle,
)

__all__ = ["ServingEngine", "EngineConfig", "Request", "PeriodicScheduler",
           "PowerRuntime", "simulate_interval", "LedgerMismatch",
           "IntervalLedger", "LayerLedger",
           "FaultConfig", "FaultInjector", "linear_drift",
           "TrafficConfig", "TrafficSimulator", "SCENARIOS",
           "AdaptiveScheduler", "AdaptiveConfig", "StaticSchedulePolicy",
           "RateTracker", "MissLedger", "AsyncResolver",
           "EventLog", "ControlEvent", "ServeReport", "serve_trace",
           "CompileService", "CompileRequest", "ArtifactStore",
           "ContingencyBundle"]
