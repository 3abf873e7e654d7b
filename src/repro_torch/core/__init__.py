"""PowerFlow-DNN core on PyTorch: the ``pfdnn`` compile path.

Public API:
  - ScheduleProblem / StateCost / IdleModel  — §4 problem formulation
  - CompilationContext                       — shared master-table stage
  - register_policy / get_policy             — policy registry
  - solve_lambda_dp / dp_paths_multi         — §4.3 λ-DP search on the
    backend's DP kernel
  - TorchBackend / get_backend               — the solver kernels on one
    torch device (CUDA kernels on the card, plain versions on the CPU)
  - prune_problem                            — §4.3 structure pruning
  - run_stacked_sweeps / select_rails_stacked — §6.3 rail selection
  - compile / MinEnergy / InfeasibleGoal     — goal-driven entry
  - compile_power_schedule                   — rate → schedule or None
  - PowerSchedule                            — §3.3 compiled artifact
"""

from repro_torch.core.backend import (
    BucketStack,
    StackCaches,
    TorchBackend,
    get_backend,
)
from repro_torch.core.context import CompilationContext
from repro_torch.core.edge_builder import build_edge_problem, build_idle_model
from repro_torch.core.goals import InfeasibleGoal, MinEnergy, as_goal
from repro_torch.core.lambda_dp import (
    SolverStats,
    StackedLambdaTask,
    dp_paths_multi,
    dp_paths_multi_weighted,
    kbest_paths_multi,
    solve_lambda_dp,
)
from repro_torch.core.orchestrator import (
    OrchestratorConfig,
    compile,
    compile_power_schedule,
    get_policy,
    policy_names,
    register_policy,
)
from repro_torch.core.problem import IdleModel, ScheduleProblem, StateCost
from repro_torch.core.pruning import prune_problem, unprune_path
from repro_torch.core.rails import (
    MinEnergySelection,
    StackedSweep,
    all_rail_subsets,
    run_stacked_sweeps,
    select_rails_stacked,
)
from repro_torch.core.schedule import PowerSchedule

__all__ = [
    "ScheduleProblem", "StateCost", "IdleModel",
    "CompilationContext", "register_policy", "get_policy",
    "policy_names", "MinEnergy", "as_goal", "InfeasibleGoal",
    "solve_lambda_dp", "dp_paths_multi", "dp_paths_multi_weighted",
    "kbest_paths_multi", "SolverStats", "StackedLambdaTask",
    "TorchBackend", "get_backend", "BucketStack", "StackCaches",
    "StackedSweep", "run_stacked_sweeps", "select_rails_stacked",
    "MinEnergySelection", "all_rail_subsets",
    "prune_problem", "unprune_path",
    "build_edge_problem", "build_idle_model",
    # ``compile`` is importable explicitly but left out of __all__ so
    # ``from repro_torch.core import *`` never shadows the builtin
    "OrchestratorConfig", "PowerSchedule", "compile_power_schedule",
]
