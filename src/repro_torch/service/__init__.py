"""Fleet compile service: process-wide artifact store, warm-started
compiles, cross-network bucket stacking, persistent schedule cache,
and the multi-tenant compile farm.

  - :class:`ArtifactStore` — thread-safe content-addressable cache of
    every shareable compilation artifact (characterization, master
    tables, transition matrices, subset lane stores, schedules);
    ``disk_path=`` adds the per-entry on-disk tier
    (:class:`~repro_torch.service.disk.DiskTier`: digest-named immutable
    files, atomic-rename publication, LRU/size eviction, schema
    versioning) shared across processes;
  - :class:`CompileService` — ``compile`` / ``compile_many`` drivers
    that warm-start from the store and co-schedule many networks'
    rail sweeps in one round scheduler; context-manager/``close()``
    shut down the async resolve pool deterministically;
  - :class:`CompileFarm` — multi-process workers over one shared disk
    store with per-tenant fair-share admission; each admitted batch
    merges many tenants' requests into one round scheduler.
"""

from repro_torch.core.goals import (           # noqa: F401  (service-level API)
    InfeasibleGoal,
    MinEnergy,
    MinLatency,
    ParetoFront,
    ParetoFrontier,
)
from repro_torch.service.compile_service import (
    CompileRequest,
    CompileService,
    ContingencyBundle,
)
from repro_torch.service.disk import DiskTier
from repro_torch.service.farm import (
    CompileFarm,
    FairShareAdmission,
    FarmResult,
    latency_summary,
)
from repro_torch.service.store import ArtifactStore

__all__ = ["ArtifactStore", "DiskTier", "CompileService",
           "CompileRequest", "ContingencyBundle",
           "CompileFarm", "FairShareAdmission", "FarmResult",
           "latency_summary",
           "MinEnergy", "MinLatency", "ParetoFront", "ParetoFrontier",
           "InfeasibleGoal"]
