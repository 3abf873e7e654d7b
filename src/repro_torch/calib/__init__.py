"""Calibration subsystem: measured cost models, ledger-learned
corrections, and input-adaptive schedule policy tables.

Three routes from *evidence about true costs* to a compile the
evidence justifies (all expressed as a
:class:`CalibratedCostModel` — a per-layer work multiplier whose
digest namespaces every artifact compiled under it):

  - **measured** (:mod:`repro_torch.calib.harness`): a seeded
    characterization harness benchmarks one micro-workload per kernel
    kind across the DVFS voltage grid, records measured-vs-modelled
    rooflines as a content-addressed store artifact, and distills them
    into a per-layer model;
  - **learned** (:mod:`repro_torch.calib.learning`): windowed per-layer
    residuals from the serving runtime's executed interval ledgers,
    driving the adaptive control plane's calibrated re-solves;
  - **input-adaptive** (:mod:`repro_torch.calib.policy_table`): a family of
    schedules compiled per observable band (activation density, batch,
    sequence length) in one fleet batch, served as a per-inference
    table lookup.
"""

from repro_torch.calib.harness import (
    REFERENCE_SPECS,
    HarnessConfig,
    RooflinePoint,
    RooflineTable,
    calibration_key,
    host_fingerprint,
    run_harness,
    solver_kernel_walls,
    synthetic_measurement,
)
from repro_torch.calib.learning import (
    CalibratedCostModel,
    ResidualEstimator,
    identity_model,
    model_from_residuals,
)
from repro_torch.calib.policy_table import (
    PolicyBand,
    SchedulePolicyTable,
    compile_policy_table,
    sparsity_cost_model,
)

__all__ = [
    "CalibratedCostModel",
    "HarnessConfig",
    "PolicyBand",
    "REFERENCE_SPECS",
    "ResidualEstimator",
    "RooflinePoint",
    "RooflineTable",
    "SchedulePolicyTable",
    "calibration_key",
    "compile_policy_table",
    "host_fingerprint",
    "identity_model",
    "model_from_residuals",
    "run_harness",
    "solver_kernel_walls",
    "sparsity_cost_model",
    "synthetic_measurement",
]
