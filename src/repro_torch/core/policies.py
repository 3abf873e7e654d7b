"""Policy registry for the staged compiler pipeline (§3.3 + §6).

Each policy is a small function registered with :func:`register_policy`;
the driver (:mod:`repro_torch.core.orchestrator`) looks it up by name
and calls ``policy(ctx, cfg, goal=goal)`` with a shared
:class:`CompilationContext`.

Policies:
  baseline       fixed V_max everywhere, no gating, active idle — the
                 "aggressive baseline without power orchestration" [5]
  pfdnn          the proposed method: unified problem, λ-DP + refinement
                 + structure pruning + optimized rail selection, run on
                 the subset-stacked sweep over the device kernels
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.backend import get_backend
from repro_torch.core.context import CompilationContext
from repro_torch.core.goals import MinEnergy
from repro_torch.core.lambda_dp import StackedLambdaTask
from repro_torch.core.problem import ScheduleProblem
from repro_torch.core.pruning import prune_problem, unprune_path
from repro_torch.core.rails import (
    StackedSweep,
    all_rail_subsets,
    run_stacked_sweeps,
)
from repro_torch.core.refinement import refine_rounds
from repro_torch.core.schedule import PowerSchedule


@dataclasses.dataclass
class OrchestratorConfig:
    policy: str = "pfdnn"
    n_max_rails: int = 3
    e_switch_nom: float | None = None   # None → accelerator default (1 nJ)
    k_candidates: int = 10              # §4.3: up to ten candidate paths
    max_moves: int = 8                  # §4.3: up to eight replacement moves
    prune: bool = True
    refine: bool = True
    # sweep acceleration: the incumbent cut is provably schedule-
    # preserving (sound lower bound); warm_start=False runs every
    # subset's λ search cold to the exact envelope breakpoint
    warm_start: bool = True
    bisect_rel_tol: float = 1e-7
    # live-task cap of the stacked scheduler (None → 16)
    stack_max_live: int | None = None
    # torch device of the solver kernels: "cuda" launches the CUDA
    # kernels and raises when no card is present; "cpu" runs their
    # plain PyTorch versions
    device: str = "cuda"


PolicyFn = Callable[..., PowerSchedule | None]

_REGISTRY: dict[str, PolicyFn] = {}


def _default_goal(ctx: CompilationContext, goal):
    """Resolve a policy's goal: an explicit goal value wins; otherwise
    the context's default deadline."""
    if goal is not None:
        return goal
    if ctx.t_max is None:
        raise ValueError(
            "no goal given and the CompilationContext is deadline-free; "
            "pass goal= (or build the context with a rate/deadline)")
    return MinEnergy(deadline_s=ctx.t_max)


def register_policy(name: str) -> Callable[[PolicyFn], PolicyFn]:
    """Register a compilation policy under ``name`` (decorator)."""
    def deco(fn: PolicyFn) -> PolicyFn:
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = fn
        return fn
    return deco


def get_policy(name: str) -> PolicyFn:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown policy {name!r}; one of {policy_names()}")
    return _REGISTRY[name]


def policy_names() -> tuple[str, ...]:
    """Registered policy names, in registration order."""
    return tuple(_REGISTRY)


def emit_schedule(policy: str, ctx: CompilationContext,
                  problem: ScheduleProblem, result: dict,
                  stats: dict, *, gating: bool,
                  goal=None) -> PowerSchedule:
    """Bind a solver result to the deployable artifact (§3.3 emit);
    ``goal`` records the compile objective and its binding constraint
    on the artifact."""
    volts = [problem.state_voltages(i, s)
             for i, s in enumerate(result["path"])]
    awake = [ctx.plan.awake_banks(i, gating)
             for i in range(problem.n_layers)]
    return PowerSchedule(
        policy=policy,
        network=ctx.network,
        rails=problem.rails,
        layer_voltages=volts,
        awake_banks=awake,
        t_max=problem.t_max,
        t_infer=result["t_infer"],
        e_total=result["e_total"],
        e_op=result["e_op"],
        e_trans=result["e_trans"],
        e_idle=result["e_idle"],
        z_active_idle=result["z"],
        n_rail_switches=result["n_rail_switches"],
        feasible=result["feasible"],
        solver_stats=stats,
        goal=None if goal is None else goal.describe(),
        binding_constraint=None if goal is None else goal.binding,
        cost_model=ctx.cost_model_digest,
    )


# ------------------------------------------------------- fixed policy

@register_policy("baseline")
def solve_baseline(ctx: CompilationContext, cfg: OrchestratorConfig,
                   goal=None) -> PowerSchedule | None:
    """V_max everywhere, no gating (single rail ⇒ no inter-layer
    coupling to optimize: the per-layer minimum-energy state is the
    schedule)."""
    goal = _default_goal(ctx, goal)
    tic = time.perf_counter()
    problem = ctx.problem_for((ctx.acc.v_max,), gating=False,
                              allow_sleep=False, via_master=False,
                              t_max=goal.deadline)
    path = [int(np.argmin(problem.op_arrays(i)[1]))
            for i in range(problem.n_layers)]
    result = problem.evaluate(path)
    if not result["feasible"]:
        return None
    return emit_schedule("baseline", ctx, problem, result,
                         {"wall_time_s": time.perf_counter() - tic},
                         gating=False, goal=goal)


# ------------------------------------------------------- pfdnn sweep

class _PfdnnStackedTask(StackedLambdaTask):
    """One rail subset of the subset-stacked pfdnn sweep: the λ-search
    machine of :class:`StackedLambdaTask` plus the per-subset pipeline
    around it (prune → solve → refine → unprune).  Refinement runs as
    post-λ machine rounds, so its move scoring and path evaluations
    stack across subsets like every other round."""

    def __init__(self, idx: int, rails: tuple[float, ...],
                 problem: ScheduleProblem, cfg: OrchestratorConfig,
                 agg: dict, problems: dict,
                 lam_hint: float | None = None,
                 lane_key=None, sig_prefix: tuple = ()):
        self._orig = problem
        self._cfg = cfg
        self._agg = agg
        self._problems = problems
        self._index_maps = None
        self._best: dict | None = None
        self._moves: int | None = None
        target = problem
        if cfg.prune:
            target, pinfo = prune_problem(problem)
            self._index_maps = pinfo.pop("index_maps")
        super().__init__(
            idx, rails, target, k_candidates=cfg.k_candidates,
            bisect_rel_tol=cfg.bisect_rel_tol if cfg.warm_start else 0.0,
            lam_hint=lam_hint, lane_key=lane_key, sig_prefix=sig_prefix)
        self.stats.backend = get_backend(cfg.device).name

    def _post_machine(self):
        candidates = self.candidates()
        self._best = candidates[0] if candidates else None
        if self._best is None or not self._cfg.refine:
            return None
        return self._refine_machine(candidates)

    def _refine_machine(self, candidates: list[dict]):
        results, moves = yield from refine_rounds(
            self.problem,
            [c["path"] for c in candidates[:self._cfg.k_candidates]],
            self._cfg.max_moves)
        best = results[0]
        for refined in results[1:]:
            if refined["e_total"] < best["e_total"]:
                best = refined
        self._best = best
        self._moves = sum(moves)

    def finalize(self) -> dict | None:
        lstats = dataclasses.asdict(self.stats)
        best = self._best if self.ok else None
        if best is not None and self._moves is not None:
            lstats["refinement_moves"] = self._moves
        if best is not None and self._index_maps is not None:
            # re-express in the unpruned problem for reporting
            best = self._orig.evaluate(
                unprune_path(best["path"], self._index_maps))
        for key in self._agg:
            self._agg[key] += lstats.get(key, 0)
        if best is None:
            return None
        self._problems[self.rails] = self._orig
        best = dict(best)
        best["rails"] = self.rails
        best["lambda_star"] = lstats.get("lambda_star")
        return best


class StackedSweepJob:
    """One network's pfdnn rail sweep, prepared for the round scheduler
    but not yet run.

    ``job.sweep`` is the :class:`~repro_torch.core.rails.StackedSweep`
    to hand to :func:`~repro_torch.core.rails.run_stacked_sweeps`
    (alone, or together with other networks' jobs for cross-network
    bucket stacking); ``job.emit(fleet_stats)`` afterwards binds the
    sweep's selection to the deployable
    :class:`~repro_torch.core.schedule.PowerSchedule`.  Tasks carry
    content-derived lane keys (network content × rails × pruning).
    """

    def __init__(self, policy: str, ctx: CompilationContext,
                 cfg: OrchestratorConfig, *, goal=None):
        self.policy = policy
        self.ctx = ctx
        self.cfg = cfg
        self.goal = goal = _default_goal(ctx, goal)
        self._tic = time.perf_counter()
        self.problems: dict[tuple, ScheduleProblem] = {}
        self.agg = {"dp_calls": 0, "dp_lambdas": 0,
                    "candidates_evaluated": 0, "lambda_iterations": 0,
                    "refinement_moves": 0}
        subsets = all_rail_subsets(ctx.levels, cfg.n_max_rails)
        t_max = goal.deadline
        bound_fn = (lambda rails: ctx.min_e_op_bound(
            rails, gating=True)) if cfg.warm_start else None
        # lane content is fully determined by (network content, rails,
        # gating/sleep flags, pruning) — NOT the deadline; bucket stores
        # partition by the accelerator's level set so same-accelerator
        # networks stack
        lane_base = (ctx.content_key, True, True, bool(cfg.prune))
        sig_prefix = (ctx.levels,)

        def make_task(idx: int, rails: tuple[float, ...],
                      hint: dict | None = None) -> _PfdnnStackedTask:
            problem = ctx.problem_for(rails, gating=True,
                                      allow_sleep=True,
                                      materialize_states=False,
                                      t_max=t_max)
            lam_hint = (hint or {}).get("lam_hint") \
                if cfg.warm_start else None
            return _PfdnnStackedTask(idx, rails, problem, cfg,
                                     self.agg, self.problems,
                                     lam_hint=lam_hint,
                                     lane_key=lane_base + (rails,),
                                     sig_prefix=sig_prefix)

        self.sweep = StackedSweep(subsets, make_task, bound_fn=bound_fn,
                                  max_live=cfg.stack_max_live,
                                  name=ctx.network)

    def emit(self, fleet: dict) -> PowerSchedule | None:
        """Bind the finished sweep's selection to the schedule artifact
        (None when every subset was deadline-infeasible)."""
        best, best_rails = self.sweep.selection()
        if best is None or best_rails is None:
            return None
        sel_stats = dict(self.sweep.stats)
        sel_stats["stacked_rounds"] = fleet["stacked_rounds"]
        sel_stats["stacked_calls"] = fleet["stacked_calls"]
        if fleet.get("networks", 1) > 1:
            sel_stats["fleet_networks"] = fleet["networks"]
        sel_stats.update(self.agg)
        sel_stats["backend"] = get_backend(self.cfg.device).name
        sel_stats["wall_time_s"] = time.perf_counter() - self._tic
        return emit_schedule(self.policy, self.ctx,
                             self.problems[best_rails], best, sel_stats,
                             gating=True, goal=self.goal)


@register_policy("pfdnn")
def solve_pfdnn(ctx: CompilationContext, cfg: OrchestratorConfig,
                goal=None) -> PowerSchedule | None:
    """The subset-stacked pfdnn sweep over every rail subset of up to
    ``cfg.n_max_rails`` levels."""
    job = StackedSweepJob("pfdnn", ctx, cfg, goal=goal)
    fleet = run_stacked_sweeps([job.sweep], backend=cfg.device)
    return job.emit(fleet)
