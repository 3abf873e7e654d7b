"""Policy registry for the staged compiler pipeline (§3.3 + §6).

Each policy is a small function registered with :func:`register_policy`;
the driver (:mod:`repro_torch.core.orchestrator`) looks it up by name
and calls ``policy(ctx, cfg, goal=goal)`` with a shared
:class:`CompilationContext`.

Policies reproduced for the paper's comparisons (§6):
  baseline       fixed V_max everywhere, no gating, active idle — the
                 "aggressive baseline without power orchestration" [5]
  gating         baseline + fine-grained RRAM bank gating [26, 27]
  greedy         marginal-utility layer-wise DVFS on evenly spaced rails
  greedy_gating  both of the above
  pfdnn          the proposed method: unified problem, λ-DP + refinement
                 + structure pruning + optimized rail selection, run on
                 the subset-stacked sweep over the device kernels
  pfdnn_even     pfdnn restricted to evenly spaced rails (§6.3 ablation)
  pfdnn_nopp     pfdnn without pruning (solver-runtime ablation, §6.5)
  ilp            exact oracle on the pfdnn-selected rails (§4.3)

The fixed and greedy policies run on the host (no DP); the pfdnn family
runs its DP, k-best and cost gathers on ``cfg.device``; the ILP oracle
runs the pfdnn sweep there, then HiGHS on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.backend import get_backend
from repro_torch.core.context import CompilationContext
from repro_torch.core.goals import MinEnergy, MinLatency
from repro_torch.core.greedy import solve_greedy
from repro_torch.core.ilp import solve_ilp, solve_ilp_min_latency
from repro_torch.core.lambda_dp import StackedLambdaTask, solve_lambda_dp
from repro_torch.core.problem import ScheduleProblem
from repro_torch.core.pruning import prune_problem, unprune_path
from repro_torch.core.rails import (
    MinLatencySelection,
    StackedSweep,
    all_rail_subsets,
    evenly_spaced_rails,
    run_stacked_sweeps,
    select_rails,
)
from repro_torch.core.refinement import (
    budget_refine_rounds,
    refine_candidates,
    refine_rounds,
)
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
    ilp_time_limit: float = 300.0
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
    """Bind a solver result to the deployable artifact (§3.3 emit).

    ``goal`` records the compile objective and its binding constraint
    on the artifact.  Under a :class:`~repro_torch.core.goals.MinLatency`
    goal the problem is deadline-free (``t_max=0``): the artifact's
    period is the achieved latency (zero slack, no idle interval) and
    the energy budget — respected by construction — is the binding
    constraint, so ``feasible`` is True.
    """
    volts = [problem.state_voltages(i, s)
             for i, s in enumerate(result["path"])]
    awake = [ctx.plan.awake_banks(i, gating)
             for i in range(problem.n_layers)]
    t_max = problem.t_max
    feasible = result["feasible"]
    goal_desc = None
    binding = None
    if goal is not None:
        goal_desc = goal.describe()
        binding = goal.binding
        if isinstance(goal, MinLatency):
            t_max = result["t_infer"]
            feasible = True
    return PowerSchedule(
        policy=policy,
        network=ctx.network,
        rails=problem.rails,
        layer_voltages=volts,
        awake_banks=awake,
        t_max=t_max,
        t_infer=result["t_infer"],
        e_total=result["e_total"],
        e_op=result["e_op"],
        e_trans=result["e_trans"],
        e_idle=result["e_idle"],
        z_active_idle=result["z"],
        n_rail_switches=result["n_rail_switches"],
        feasible=feasible,
        solver_stats=stats,
        goal=goal_desc,
        binding_constraint=binding,
        cost_model=ctx.cost_model_digest,
    )


# ------------------------------------------------------- fixed policies

def _solve_fixed(policy: str, ctx: CompilationContext,
                 cfg: OrchestratorConfig, *, gating: bool,
                 goal=None) -> PowerSchedule | None:
    """V_max-everywhere; with gating, weightless layers also expose an
    RRAM-gated state — the per-layer minimum-energy one IS the gating
    behaviour (single rail ⇒ no inter-layer coupling to optimize).

    Under a MinLatency goal the single meaningful schedule is the same
    one (V_max is already the fastest point); it either fits the energy
    budget or the policy is infeasible.
    """
    goal = _default_goal(ctx, goal)
    tic = time.perf_counter()
    if isinstance(goal, MinLatency):
        problem = ctx.problem_for((ctx.acc.v_max,), gating=gating,
                                  allow_sleep=gating, via_master=False,
                                  t_max=0.0)
        path = [int(np.argmin(problem.op_arrays(i)[1]))
                for i in range(problem.n_layers)]
        result = problem.evaluate(path)
        if result["e_op"] + result["e_trans"] > goal.energy_budget_j:
            return None
        return emit_schedule(policy, ctx, problem, result,
                             {"wall_time_s": time.perf_counter() - tic},
                             gating=gating, goal=goal)
    problem = ctx.problem_for((ctx.acc.v_max,), gating=gating,
                              allow_sleep=gating, via_master=False,
                              t_max=goal.deadline)
    path = [int(np.argmin(problem.op_arrays(i)[1]))
            for i in range(problem.n_layers)]
    result = problem.evaluate(path)
    if not result["feasible"]:
        return None
    return emit_schedule(policy, ctx, problem, result,
                         {"wall_time_s": time.perf_counter() - tic},
                         gating=gating, goal=goal)


@register_policy("baseline")
def solve_baseline(ctx: CompilationContext, cfg: OrchestratorConfig,
                   goal=None) -> PowerSchedule | None:
    return _solve_fixed("baseline", ctx, cfg, gating=False, goal=goal)


@register_policy("gating")
def solve_gating_policy(ctx: CompilationContext, cfg: OrchestratorConfig,
                        goal=None) -> PowerSchedule | None:
    return _solve_fixed("gating", ctx, cfg, gating=True, goal=goal)


# ------------------------------------------------------ greedy policies

def _solve_greedy_policy(policy: str, ctx: CompilationContext,
                         cfg: OrchestratorConfig, *, gating: bool,
                         goal=None) -> PowerSchedule | None:
    goal = _default_goal(ctx, goal)
    if not isinstance(goal, MinEnergy):
        raise ValueError(
            f"policy {policy!r} supports only MinEnergy goals (the "
            f"marginal-utility ascent is deadline-driven); got "
            f"{type(goal).__name__} — use a pfdnn-family, fixed, or "
            f"ilp policy for budget goals")
    tic = time.perf_counter()
    rails = evenly_spaced_rails(ctx.levels, cfg.n_max_rails)
    problem = ctx.problem_for(rails, gating=gating, allow_sleep=gating,
                              via_master=False, t_max=goal.deadline)
    result = solve_greedy(problem)
    if result is None:
        return None
    return emit_schedule(policy, ctx, problem, result,
                         {"wall_time_s": time.perf_counter() - tic},
                         gating=gating, goal=goal)


@register_policy("greedy")
def solve_greedy_nom(ctx: CompilationContext, cfg: OrchestratorConfig,
                     goal=None) -> PowerSchedule | None:
    return _solve_greedy_policy("greedy", ctx, cfg, gating=False,
                                goal=goal)


@register_policy("greedy_gating")
def solve_greedy_gating(ctx: CompilationContext, cfg: OrchestratorConfig,
                        goal=None) -> PowerSchedule | None:
    return _solve_greedy_policy("greedy_gating", ctx, cfg, gating=True,
                                goal=goal)


# ------------------------------------------------------- pfdnn sweep

def _solve_pfdnn_on_rails(problem: ScheduleProblem, cfg: OrchestratorConfig,
                          lam_hint: float | None = None
                          ) -> tuple[dict | None, dict]:
    """λ-DP (+ pruning, + refinement) on one rail subset, through the
    non-stacked backend calls (the kernels with one lane)."""
    stats: dict = {}
    target = problem
    index_maps = None
    if cfg.prune:
        target, pinfo = prune_problem(problem)
        index_maps = pinfo["index_maps"]
    best, candidates, sstats = solve_lambda_dp(
        target, k_candidates=cfg.k_candidates, lam_hint=lam_hint,
        bisect_rel_tol=cfg.bisect_rel_tol if cfg.warm_start else 0.0,
        backend=cfg.device)
    stats["lambda_dp"] = dataclasses.asdict(sstats)
    if best is None:
        return None, stats
    if cfg.refine and candidates:
        best, moves = refine_candidates(
            target, candidates,
            max_candidates=cfg.k_candidates, max_moves=cfg.max_moves)
        stats["lambda_dp"]["refinement_moves"] = moves
    if index_maps is not None:
        # re-express in the unpruned problem for reporting
        orig_path = unprune_path(best["path"], index_maps)
        best = problem.evaluate(orig_path)
    return best, stats


class _PfdnnStackedTask(StackedLambdaTask):
    """One rail subset of the subset-stacked pfdnn sweep: the λ-search
    machine of :class:`StackedLambdaTask` plus the per-subset pipeline
    around it (prune → solve → refine → unprune), mirroring
    :func:`_solve_pfdnn_on_rails`.  Refinement runs as post-λ machine
    rounds, so its move scoring and path evaluations stack across
    subsets like every other round."""

    def __init__(self, idx: int, rails: tuple[float, ...],
                 problem: ScheduleProblem, cfg: OrchestratorConfig,
                 agg: dict, problems: dict,
                 lam_hint: float | None = None,
                 lane_key=None, sig_prefix: tuple = (), caches=None,
                 goal=None, prune_cache=None, prune_key=None):
        self._orig = problem
        self._cfg = cfg
        self._agg = agg
        self._problems = problems
        self._index_maps = None
        self._best: dict | None = None
        self._moves: int | None = None
        target = problem
        if cfg.prune:
            target, pinfo = prune_problem(problem, cache=prune_cache,
                                          cache_key=prune_key)
            self._index_maps = pinfo.pop("index_maps")
        super().__init__(
            idx, rails, target, k_candidates=cfg.k_candidates,
            bisect_rel_tol=cfg.bisect_rel_tol if cfg.warm_start else 0.0,
            lam_hint=lam_hint, lane_key=lane_key, sig_prefix=sig_prefix,
            caches=caches, goal=goal)
        self.stats.backend = get_backend(cfg.device).name

    def _post_machine(self):
        candidates = self.candidates()
        self._best = candidates[0] if candidates else None
        if self._best is None or not self._cfg.refine:
            return None
        if self._budget is not None:
            # dual goal: time-objective refinement within the budget
            return self._budget_refine_machine(self._best)
        return self._refine_machine(candidates)

    def _budget_refine_machine(self, start: dict):
        best, moves = yield from budget_refine_rounds(
            self.problem, start, self._budget, self._cfg.max_moves)
        self._best = best
        self._moves = moves

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
    """One network's pfdnn-family rail sweep, prepared for the round
    scheduler but not yet run.

    ``job.sweep`` is the :class:`~repro_torch.core.rails.StackedSweep`
    to hand to :func:`~repro_torch.core.rails.run_stacked_sweeps`
    (alone, or together with other sweeps — the frontier compiler runs
    one per deadline); ``job.emit(fleet_stats)`` afterwards binds the
    sweep's selection to the deployable
    :class:`~repro_torch.core.schedule.PowerSchedule`.  Tasks carry
    content-derived lane keys (network content × rails × pruning), so a
    persistent store-owned cache (``caches``) recognizes resident subset
    lanes across compiles, and the fleet compile service co-schedules
    many networks' jobs in one round scheduler.
    """

    def __init__(self, policy: str, ctx: CompilationContext,
                 cfg: OrchestratorConfig, *, prune: bool = True,
                 caches=None, goal=None, subsets=None):
        self.policy = policy
        self.ctx = ctx
        self.cfg = cfg
        self.goal = goal = _default_goal(ctx, goal)
        self._tic = time.perf_counter()
        cfg_local = dataclasses.replace(cfg, prune=(cfg.prune and prune))
        self.problems: dict[tuple, ScheduleProblem] = {}
        self.agg = {"dp_calls": 0, "dp_lambdas": 0,
                    "candidates_evaluated": 0, "lambda_iterations": 0,
                    "refinement_moves": 0}
        if subsets is None:
            subsets = all_rail_subsets(ctx.levels, cfg.n_max_rails)
        # goal-aware sweep semantics: the primal (deadline) sweep keeps
        # its incumbent/ceiling cuts; the dual (budget) sweep swaps in
        # the MinLatency objective with the energy-infeasibility and
        # latency-incumbent bounds
        budget = goal.energy_budget_j \
            if isinstance(goal, MinLatency) else None
        if budget is not None:
            t_max = 0.0
            bound_fn = None
            objective = MinLatencySelection(
                budget,
                e_bound_fn=lambda rails: ctx.min_e_op_bound(
                    rails, gating=True),
                t_bound_fn=(lambda rails: ctx.min_t_op_bound(
                    rails, gating=True)) if cfg.warm_start else None)
        else:
            t_max = goal.deadline
            bound_fn = (lambda rails: ctx.min_e_op_bound(
                rails, gating=True)) if cfg.warm_start else None
            objective = None
        # lane content is fully determined by (network content, rails,
        # gating/sleep flags, pruning) — NOT the deadline or goal, so
        # frontier points and budget compiles reuse resident lanes;
        # bucket stores partition by the accelerator's level set so
        # same-accelerator networks stack
        lane_base = (ctx.content_key, True, True, bool(cfg_local.prune))
        sig_prefix = (ctx.levels,)
        prune_cache = ctx.store if cfg_local.prune else None

        def make_task(idx: int, rails: tuple[float, ...],
                      hint: dict | None = None) -> _PfdnnStackedTask:
            problem = ctx.problem_for(rails, gating=True,
                                      allow_sleep=True,
                                      materialize_states=False,
                                      t_max=t_max)
            lam_hint = (hint or {}).get("lam_hint") \
                if cfg.warm_start else None
            return _PfdnnStackedTask(idx, rails, problem, cfg_local,
                                     self.agg, self.problems,
                                     lam_hint=lam_hint,
                                     lane_key=lane_base + (rails,),
                                     sig_prefix=sig_prefix,
                                     caches=caches, goal=goal,
                                     prune_cache=prune_cache,
                                     prune_key=(ctx.content_key, True,
                                                rails))

        self.sweep = StackedSweep(subsets, make_task, bound_fn=bound_fn,
                                  objective=objective,
                                  max_live=cfg.stack_max_live,
                                  name=ctx.network)

    def start_clock(self) -> None:
        """Restart the wall-time clock: ``compile_many`` builds every
        job up front but runs one fleet per device, so each job's
        ``wall_time_s`` starts when its fleet does."""
        self._tic = time.perf_counter()

    def emit(self, fleet: dict) -> PowerSchedule | None:
        """Bind the finished sweep's selection to the schedule artifact
        (None when every subset was goal-infeasible)."""
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


# pfdnn-family policies whose rail sweep the round scheduler can stack
# (policy name -> prune flag); the evenly-spaced ablation solves only
# n_max subsets, so there is nothing to stack
_STACKABLE_SWEEPS = {"pfdnn": True, "pfdnn_nopp": False}


def stacked_compile_job(ctx: CompilationContext, cfg: OrchestratorConfig,
                        *, caches=None, goal=None
                        ) -> StackedSweepJob | None:
    """Build the :class:`StackedSweepJob` for ``cfg`` when its policy
    routes to the subset-stacked engine, else None (a non-sweep policy
    or the evenly-spaced ablation).  The frontier compiler and the
    fleet service use this to co-schedule many sweeps — of any mix of
    MinEnergy and MinLatency goals — in one round scheduler."""
    goal = _default_goal(ctx, goal)
    prune = _STACKABLE_SWEEPS.get(cfg.policy)
    if prune is None:
        return None
    return StackedSweepJob(cfg.policy, ctx, cfg, prune=prune,
                           caches=caches, goal=goal)


def _solve_budget_sweep(policy: str, ctx: CompilationContext,
                        cfg: OrchestratorConfig, *, even: bool,
                        prune: bool, goal) -> PowerSchedule | None:
    """The dual rail sweep (fastest schedule within the energy budget):
    always routed through the subset-stacked engine — the budget
    machine (:func:`repro_torch.core.lambda_dp.budget_rounds`) is built
    on it — even for the evenly-spaced subsets."""
    if even:
        subsets = [evenly_spaced_rails(ctx.levels, k)
                   for k in range(1, cfg.n_max_rails + 1)]
    else:
        subsets = None
    caches = ctx.store.stack_caches if ctx.store is not None else None
    job = StackedSweepJob(policy, ctx, cfg, prune=prune, caches=caches,
                          goal=goal, subsets=subsets)
    fleet = run_stacked_sweeps([job.sweep], backend=cfg.device,
                               caches=caches)
    return job.emit(fleet)


def _solve_sweep(policy: str, ctx: CompilationContext,
                 cfg: OrchestratorConfig, *, even: bool,
                 prune: bool, goal=None) -> PowerSchedule | None:
    goal = _default_goal(ctx, goal)
    if isinstance(goal, MinLatency):
        return _solve_budget_sweep(policy, ctx, cfg, even=even,
                                   prune=prune, goal=goal)
    t_max = goal.deadline
    tic = time.perf_counter()
    if not even:
        # subset-stacked engine: whole same-bucket buckets of live
        # subsets advance one λ-search round per kernel launch
        caches = ctx.store.stack_caches if ctx.store is not None else None
        job = StackedSweepJob(policy, ctx, cfg, prune=prune,
                              caches=caches, goal=goal)
        fleet = run_stacked_sweeps([job.sweep], backend=cfg.device,
                                   caches=caches)
        return job.emit(fleet)

    # the evenly-spaced ablation: n_max subsets solved one after the
    # other on the kernels with one lane
    cfg_local = dataclasses.replace(cfg, prune=(cfg.prune and prune))
    problems: dict[tuple, ScheduleProblem] = {}
    agg = {"dp_calls": 0, "dp_lambdas": 0, "candidates_evaluated": 0,
           "lambda_iterations": 0, "refinement_moves": 0}

    def solve_subset(rails: tuple[float, ...],
                     hint: dict | None = None) -> dict | None:
        # a single subset per rail count: no master table to amortize,
        # so its states are enumerated directly
        problem = ctx.problem_for(rails, gating=True, allow_sleep=True,
                                  via_master=False,
                                  materialize_states=True, t_max=t_max)
        lam_hint = (hint or {}).get("lam_hint") if cfg.warm_start else None
        best, stats = _solve_pfdnn_on_rails(problem, cfg_local,
                                            lam_hint=lam_hint)
        lstats = stats.get("lambda_dp", {})
        for key in agg:
            agg[key] += lstats.get(key, 0)
        if best is not None:
            problems[rails] = problem
            best = dict(best)
            best["rails"] = rails
            best["lambda_star"] = lstats.get("lambda_star")
        return best

    subsets = [evenly_spaced_rails(ctx.levels, k)
               for k in range(1, cfg.n_max_rails + 1)]
    best, best_rails, sel_stats = select_rails(
        ctx.levels, cfg.n_max_rails, solve_subset, subsets=subsets)
    if best is None or best_rails is None:
        return None
    sel_stats.update(agg)
    sel_stats["backend"] = get_backend(cfg.device).name
    sel_stats["wall_time_s"] = time.perf_counter() - tic
    return emit_schedule(policy, ctx, problems[best_rails], best,
                         sel_stats, gating=True, goal=goal)


@register_policy("pfdnn")
def solve_pfdnn(ctx: CompilationContext, cfg: OrchestratorConfig,
                goal=None) -> PowerSchedule | None:
    return _solve_sweep("pfdnn", ctx, cfg, even=False, prune=True,
                        goal=goal)


@register_policy("pfdnn_even")
def solve_pfdnn_even(ctx: CompilationContext, cfg: OrchestratorConfig,
                     goal=None) -> PowerSchedule | None:
    return _solve_sweep("pfdnn_even", ctx, cfg, even=True, prune=True,
                        goal=goal)


@register_policy("pfdnn_nopp")
def solve_pfdnn_nopp(ctx: CompilationContext, cfg: OrchestratorConfig,
                     goal=None) -> PowerSchedule | None:
    return _solve_sweep("pfdnn_nopp", ctx, cfg, even=False, prune=False,
                        goal=goal)


# --------------------------------------------------------- ILP oracle

@register_policy("ilp")
def solve_ilp_policy(ctx: CompilationContext, cfg: OrchestratorConfig,
                     goal=None) -> PowerSchedule | None:
    """Exact oracle on the PF-DNN-selected rails (reference solver,
    §4.3).  Shares the context's master tables with the inner pfdnn
    sweep (on ``cfg.device``); HiGHS then solves on the host.  Under a
    MinLatency goal the oracle is the dual ILP (min time s.t. energy ≤
    budget) on the rails the dual pfdnn sweep selected."""
    goal = _default_goal(ctx, goal)
    tic = time.perf_counter()
    pf = solve_pfdnn(ctx, dataclasses.replace(cfg, policy="pfdnn"),
                     goal=goal)
    if pf is None:
        return None
    if isinstance(goal, MinLatency):
        problem = ctx.problem_for(pf.rails, gating=True,
                                  allow_sleep=True, t_max=0.0)
        result = solve_ilp_min_latency(problem, goal.energy_budget_j,
                                       time_limit=cfg.ilp_time_limit)
    else:
        problem = ctx.problem_for(pf.rails, gating=True,
                                  allow_sleep=True, t_max=goal.deadline)
        result = solve_ilp(problem, time_limit=cfg.ilp_time_limit)
    if not result.get("feasible"):
        return None
    return emit_schedule("ilp", ctx, problem, result,
                         {"wall_time_s": time.perf_counter() - tic,
                          "ilp_wall_time_s": result.get("wall_time_s")},
                         gating=True, goal=goal)
