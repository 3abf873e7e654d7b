"""PowerFlow-DNN core on PyTorch: the compiler with its full policy
and goal menu.

Public API:
  - ScheduleProblem / StateCost / IdleModel  — §4 problem formulation
  - CompilationContext                       — shared master-table stage
  - register_policy / get_policy / POLICIES  — policy registry (POLICIES
    is a live view of the registered names)
  - solve_lambda_dp / dp_paths_multi         — §4.3 λ-DP search on the
    backend's DP kernel; min_time_path, solve_budget_dp (the dual)
  - TorchBackend / get_backend /
    available_backends                       — the solver kernels on one
    torch device (CUDA kernels on the card, plain versions on the CPU)
  - refine_candidates / refine_path          — §4.3 local refinement
  - prune_problem                            — §4.3 structure pruning
  - solve_ilp / solve_ilp_min_latency        — §4.3 exact oracles (HiGHS)
  - solve_greedy                             — §6 marginal-utility baseline
  - run_stacked_sweeps / select_rails /
    evenly_spaced_rails                      — §6.3 rail selection
  - compile / MinEnergy / MinLatency / ParetoFront — goal-driven entry
    (InfeasibleGoal for goals with no schedule, ParetoFrontier)
  - compile_power_schedule                   — rate → schedule or None
  - PowerSchedule                            — §3.3 compiled artifact
"""

from repro_torch.core.backend import (
    BucketStack,
    StackCaches,
    TorchBackend,
    available_backends,
    get_backend,
)
from repro_torch.core.context import CompilationContext
from repro_torch.core.edge_builder import build_edge_problem, build_idle_model
from repro_torch.core.goals import (
    Goal,
    InfeasibleGoal,
    MinEnergy,
    MinLatency,
    ParetoFront,
    ParetoFrontier,
    ParetoPoint,
    as_goal,
)
from repro_torch.core.greedy import min_energy_path, solve_greedy
from repro_torch.core.ilp import (
    IlpBlowupError,
    solve_ilp,
    solve_ilp_min_latency,
)
from repro_torch.core.lambda_dp import (
    SolverStats,
    StackedLambdaTask,
    dp_paths_multi,
    dp_paths_multi_weighted,
    kbest_paths_multi,
    min_time_path,
    solve_budget_dp,
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
    MinLatencySelection,
    StackedSweep,
    all_rail_subsets,
    evenly_spaced_rails,
    run_stacked_sweeps,
    select_rails,
    select_rails_stacked,
)
from repro_torch.core.refinement import refine_candidates, refine_path
from repro_torch.core.schedule import PowerSchedule


def __getattr__(name: str):
    # live view of the registry: policies registered after this module's
    # import still appear in ``repro_torch.core.POLICIES``
    if name == "POLICIES":
        return policy_names()
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ScheduleProblem", "StateCost", "IdleModel",
    "CompilationContext", "register_policy", "get_policy",
    "policy_names", "Goal", "MinEnergy", "MinLatency", "ParetoFront",
    "as_goal", "InfeasibleGoal", "ParetoFrontier", "ParetoPoint",
    "solve_lambda_dp", "solve_budget_dp", "min_time_path",
    "dp_paths_multi", "dp_paths_multi_weighted",
    "kbest_paths_multi", "SolverStats", "StackedLambdaTask",
    "TorchBackend", "get_backend", "available_backends",
    "BucketStack", "StackCaches",
    "StackedSweep", "run_stacked_sweeps", "select_rails_stacked",
    "select_rails", "evenly_spaced_rails",
    "MinEnergySelection", "MinLatencySelection", "all_rail_subsets",
    "refine_candidates", "refine_path",
    "prune_problem", "unprune_path",
    "solve_ilp", "solve_ilp_min_latency", "IlpBlowupError",
    "solve_greedy", "min_energy_path",
    "build_edge_problem", "build_idle_model",
    # ``compile`` is importable explicitly but left out of __all__ so
    # ``from repro_torch.core import *`` never shadows the builtin
    "OrchestratorConfig", "POLICIES", "PowerSchedule",
    "compile_power_schedule",
]
