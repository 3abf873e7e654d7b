"""Top-level compiler driver (paper §3.3 + §6 policy definitions).

``compile`` is the goal-driven entry point: objectives and constraints
are first-class :mod:`repro_torch.core.goals` values —

  compile(specs, MinEnergy(rate_hz=40.0))       # the paper's primal
  compile(specs, MinLatency(energy_budget_j=b)) # the dual
  compile(specs, ParetoFront(n_points=8))       # the whole frontier

It runs the staged PF-DNN pipeline:

  characterize layers → bank plan → master state arrays (CompilationContext)
  → policy lookup                                       (policy registry)
  → goal-aware rail selection: the subset-stacked sweep groups live
    rail subsets by padded bucket and advances every subset one
    λ-search round per kernel launch; MinEnergy bisects the deadline
    axis of the λ envelope, MinLatency the energy axis, and
    ParetoFront co-schedules one sweep per deadline through
    :func:`~repro_torch.core.rails.run_stacked_sweeps`
  → emit the PowerSchedule (goal + binding constraint recorded), a
    structured InfeasibleGoal, or a ParetoFrontier

The per-policy solve strategies live in
:mod:`repro_torch.core.policies`; the shared precomputation lives in
:mod:`repro_torch.core.context`.  This module is only the driver:
validate, build the context, dispatch.
"""

from __future__ import annotations

import os
from typing import Sequence

from repro_torch.core.context import CompilationContext
from repro_torch.core.goals import (
    REASON_BUDGET,
    REASON_DEADLINE,
    REASON_POLICY,
    Goal,
    InfeasibleGoal,
    MinEnergy,
    MinLatency,
    ParetoFront,
    ParetoFrontier,
    ParetoPoint,
    as_goal,
)
from repro_torch.core.policies import (    # noqa: F401  (re-exports)
    OrchestratorConfig,
    get_policy,
    policy_names,
    register_policy,
    stacked_compile_job,
)
from repro_torch.core.rails import accepts_param, run_stacked_sweeps
from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.edge40nm import Edge40nmAccelerator, EDGE40NM_DEFAULT
from repro_torch.perfmodel.layer_costs import LayerSpec


def compile(
    specs: Sequence[LayerSpec],
    goal: Goal,
    *,
    cfg: OrchestratorConfig | None = None,
    acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
    network: str | None = None,
    ctx: CompilationContext | None = None,
    store=None,
    cost_model=None,
) -> PowerSchedule | InfeasibleGoal | ParetoFrontier:
    """Compile a deployment power schedule for an explicit goal.

    Returns the :class:`PowerSchedule` (goal and binding constraint
    recorded on the artifact), a structured :class:`InfeasibleGoal`
    when no schedule meets a point goal (the reason says whether the
    constraint provably lies below the network's bound), or — for
    :class:`ParetoFront` goals — a :class:`ParetoFrontier` whose
    per-point schedules are identical to independent MinEnergy
    compiles at those deadlines.  The solver kernels run on
    ``cfg.device`` (``"cuda"`` by default).

    ``ctx`` reuses a prebuilt :class:`CompilationContext` across
    policies, goals and deadlines of the same network (none of the
    context's artifacts depend on the deadline); it must describe the
    same network, accelerator, and transition energy — mismatches raise
    ``ValueError``.  ``store`` plugs a process-wide artifact store
    (:class:`repro_torch.service.ArtifactStore`) into a freshly built
    context; a ``str``/``PathLike`` builds a *disk-backed* store over
    that directory (the on-disk tier of :mod:`repro_torch.service.disk`,
    shared by every process pointed at the same path).

    ``cost_model`` compiles under a measured or learned cost model
    (anything with a ``digest`` and an ``apply(costs)``) instead of the
    static analytic one; its digest is folded into every derived
    artifact key and stamped on the emitted schedule
    (``PowerSchedule.cost_model``).
    """
    goal = as_goal(goal)
    cfg = cfg or OrchestratorConfig()
    store = _resolve_store(store)
    if ctx is None:
        ctx = CompilationContext(
            specs, acc=acc,
            network=network if network is not None else "net",
            e_switch_nom=cfg.e_switch_nom, store=store,
            deadline_s=goal.deadline if isinstance(goal, MinEnergy)
            else None, cost_model=cost_model)
    else:
        _check_reused_context(ctx, specs, acc, cfg, network=network,
                              store=store, cost_model=cost_model)
    if isinstance(goal, ParetoFront):
        return _compile_frontier(ctx, goal, cfg)
    sched = _dispatch(ctx, cfg, goal)
    if sched is None:
        return infeasible_result(goal, ctx)
    return sched


def compile_power_schedule(
    specs: Sequence[LayerSpec],
    target_rate_hz: float,
    *,
    cfg: OrchestratorConfig | None = None,
    acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
    network: str | None = None,
    ctx: CompilationContext | None = None,
    store=None,
) -> PowerSchedule | None:
    """Back-compat wrapper: compile the paper's scenario — min energy at
    a periodic inference rate (``MinEnergy(rate_hz=...)``, §3.3) — and
    keep the legacy ``None`` for an infeasible deadline."""
    result = compile(specs, MinEnergy(rate_hz=target_rate_hz), cfg=cfg,
                     acc=acc, network=network, ctx=ctx, store=store)
    return None if isinstance(result, InfeasibleGoal) else result


def _resolve_store(store):
    """Accept a ready store object or a filesystem path: paths build a
    disk-backed :class:`~repro_torch.service.ArtifactStore` on the fly.
    Imported lazily; :mod:`repro_torch.service` depends on this
    module."""
    if store is None or hasattr(store, "characterization"):
        return store
    if isinstance(store, (str, os.PathLike)):
        from repro_torch.service.store import ArtifactStore

        return ArtifactStore(disk_path=store)
    raise TypeError(
        f"store= must be an ArtifactStore-like object or a directory "
        f"path, got {type(store).__name__}")


def _dispatch(ctx: CompilationContext, cfg: OrchestratorConfig,
              goal: Goal) -> PowerSchedule | None:
    """Run the policy for one point goal (MinEnergy / MinLatency)."""
    policy = get_policy(cfg.policy)
    if _accepts_goal(policy):
        return policy(ctx, cfg, goal=goal)
    # custom policy with the plain (ctx, cfg) signature: it reads the
    # deadline off the context, so the context must actually be built
    # at this goal's deadline — a silent mismatch would emit a
    # wrong-deadline schedule
    if not isinstance(goal, MinEnergy):
        raise ValueError(
            f"policy {cfg.policy!r} does not accept goal=; only "
            f"MinEnergy goals can run through the (ctx, cfg) signature")
    if ctx.t_max != goal.deadline:
        raise ValueError(
            f"policy {cfg.policy!r} does not accept goal= and the "
            f"reused context's deadline {ctx.t_max} differs from the "
            f"goal's {goal.deadline}; build a matching context or add "
            f"a goal parameter to the policy")
    return policy(ctx, cfg)


def infeasible_result(goal: Goal, ctx: CompilationContext
                      ) -> InfeasibleGoal:
    """Structured infeasible result for a point goal.  The reason is
    honest: the provably-impossible reasons are claimed only when the
    constraint actually lies below the network's bound; otherwise the
    policy simply found no schedule (heuristics can miss, the ILP can
    time out) and :data:`~repro_torch.core.goals.REASON_POLICY` says
    so.  Either way the bound ships in ``detail``."""
    if isinstance(goal, MinLatency):
        e_bound = ctx.min_e_op_bound(ctx.levels)
        return InfeasibleGoal(
            reason=REASON_BUDGET if goal.energy_budget_j < e_bound
            else REASON_POLICY,
            goal=goal.describe(),
            detail={"energy_budget_j": goal.energy_budget_j,
                    "min_energy_lower_bound_j": e_bound},
            network=ctx.network)
    t_bound = ctx.min_t_op_bound(ctx.levels)
    return InfeasibleGoal(
        reason=REASON_DEADLINE if goal.deadline < t_bound
        else REASON_POLICY,
        goal=goal.describe(),
        detail={"deadline_s": goal.deadline,
                "min_time_lower_bound_s": t_bound},
        network=ctx.network)


def _compile_frontier(ctx: CompilationContext, goal: ParetoFront,
                      cfg: OrchestratorConfig) -> ParetoFrontier:
    """Frontier compile: one MinEnergy point per deadline, co-scheduled
    as separate :class:`~repro_torch.core.rails.StackedSweep`s through
    ONE round scheduler, so masters, transitions and subset lanes are
    shared and the curve costs little more than one compile.  Each
    sweep's admission order, cuts, and hints read only its own state,
    so every point's schedule is identical to an independent MinEnergy
    compile at that deadline."""
    deadlines = goal.resolve_deadlines(ctx.min_t_op_bound(ctx.levels))
    caches = ctx.store.stack_caches if ctx.store is not None else None
    # duplicate deadlines (explicit repeats) solve once and fan out
    results: dict[float, object] = {}
    jobs = []
    for deadline in deadlines:
        if deadline in results:
            continue
        sub = MinEnergy(deadline_s=deadline)
        job = stacked_compile_job(ctx, cfg, caches=caches, goal=sub)
        if job is None:
            # non-stackable policy or config: plain per-point compile
            sched = _dispatch(ctx, cfg, sub)
            results[deadline] = sched if sched is not None \
                else infeasible_result(sub, ctx)
        else:
            results[deadline] = None           # placeholder: in a job
            jobs.append((deadline, sub, job))
    if jobs:
        _wire_incumbent_seeds(jobs)
        fleet = run_stacked_sweeps([job.sweep for _, _, job in jobs],
                                   backend=cfg.device, caches=caches)
        for deadline, sub, job in jobs:
            sched = job.emit(fleet)
            results[deadline] = sched if sched is not None \
                else infeasible_result(sub, ctx)
    return ParetoFrontier(
        network=ctx.network,
        points=[ParetoPoint(d, results[d]) for d in deadlines])


def _wire_incumbent_seeds(jobs: list) -> None:
    """Share per-point incumbents across adjacent frontier deadlines.

    ``jobs`` is deadline-ascending (tightest first).  A subset solved
    at a tighter deadline stays feasible at any looser one — same path,
    same op/transition energy, only the idle slack grows — so its
    schedule re-priced at the looser deadline,

        ê  =  (e_op + e_trans) + idle.energy(d_loose − t_infer),

    is an *achievable* energy there (the idle model never depends on
    the deadline; the op order above matches ``finish_costs`` exactly).
    Seeding ê as the looser sweep's incumbent strengthens its
    warm-start bound cuts before (or while) that subset solves itself.
    Selection stays identical to independent per-point compiles:
    achievable seeds can only *cut* subsets the exact solve would also
    have rejected, and ``StackedSweep.selection`` reads solved results
    only (see :meth:`~repro_torch.core.rails.StackedSweep.seed_incumbent`).
    """
    for (_, _, tight_job), (d_loose, _, loose_job) in zip(jobs,
                                                          jobs[1:]):
        def seed(rails, result, tight_job=tight_job,
                 loose_job=loose_job, d_loose=d_loose):
            problem = tight_job.problems.get(tuple(rails))
            if problem is None or not result.get("feasible", True):
                return
            e_hat = (result["e_op"] + result["e_trans"]) \
                + problem.idle.energy(d_loose - result["t_infer"])
            loose_job.sweep.seed_incumbent(e_hat, tuple(rails))
        tight_job.sweep.on_result = seed


def _accepts_goal(policy) -> bool:
    """True when the policy declares a ``goal`` parameter (or
    **kwargs); custom policies may keep the plain ``(ctx, cfg)``
    signature."""
    return accepts_param(policy, "goal")


def _check_reused_context(ctx: CompilationContext,
                          specs: Sequence[LayerSpec],
                          acc: Edge40nmAccelerator,
                          cfg: OrchestratorConfig, *,
                          network: str | None, store,
                          cost_model=None) -> None:
    """A reused context must match the compile request — a silently
    mismatched context would emit a schedule for the wrong network or
    transition energies (or bypass the caller's artifact store).  The
    deadline is deliberately NOT checked: none of the context's
    artifacts depend on it."""
    if store is not None and store is not ctx.store:
        raise ValueError(
            "ctx= carries its own artifact store; passing a different "
            "store= alongside it would be silently ignored — build the "
            "context with that store instead")
    if network is not None and network != ctx.network:
        raise ValueError(
            f"ctx= was built for network label {ctx.network!r} but the "
            f"request names {network!r}; the emitted schedule's label "
            "comes from the context — build a new CompilationContext "
            "(or drop the network= argument)")
    if list(specs) != ctx.specs:
        raise ValueError(
            "ctx= was built for a different network (layer specs "
            "differ); build a new CompilationContext")
    if acc != ctx.acc:
        raise ValueError("ctx= was built for a different accelerator")
    if ctx.transition_model != acc.transitions(cfg.e_switch_nom):
        raise ValueError(
            "ctx= was built with a different e_switch_nom than cfg "
            "requests; build a new CompilationContext")
    # cost_model=None inherits whatever model the context carries; an
    # explicit model must match it (a silent mismatch would emit a
    # schedule stamped — and cached — under the wrong model)
    if cost_model is not None \
            and cost_model.digest != ctx.cost_model_digest:
        raise ValueError(
            f"ctx= was built under cost model "
            f"{ctx.cost_model_digest!r} but the request passes "
            f"{cost_model.digest!r}; build a matching "
            "CompilationContext (or drop cost_model= to inherit)")
