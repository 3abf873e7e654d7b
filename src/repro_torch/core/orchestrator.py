"""Top-level compiler driver (paper §3.3 + §6 policy definitions).

``compile(specs, MinEnergy(rate_hz=40.0))`` runs the staged PF-DNN
pipeline:

  characterize layers → bank plan → master state arrays (CompilationContext)
  → policy lookup                                       (policy registry)
  → rail selection: the subset-stacked sweep groups live rail subsets by
    padded bucket and advances every subset one λ-search round per
    kernel launch (:func:`~repro_torch.core.rails.run_stacked_sweeps`)
  → emit the PowerSchedule, or a structured InfeasibleGoal

The per-policy solve strategies live in
:mod:`repro_torch.core.policies`; the shared precomputation lives in
:mod:`repro_torch.core.context`.  This module is only the driver:
validate, build the context, dispatch.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.context import CompilationContext
from repro_torch.core.goals import (
    REASON_DEADLINE,
    REASON_POLICY,
    InfeasibleGoal,
    MinEnergy,
    as_goal,
)
from repro_torch.core.policies import (    # noqa: F401  (re-exports)
    OrchestratorConfig,
    get_policy,
    policy_names,
    register_policy,
)
from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.edge40nm import Edge40nmAccelerator, EDGE40NM_DEFAULT
from repro_torch.perfmodel.layer_costs import LayerSpec


def compile(
    specs: Sequence[LayerSpec],
    goal: MinEnergy,
    *,
    cfg: OrchestratorConfig | None = None,
    acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
    network: str | None = None,
    ctx: CompilationContext | None = None,
) -> PowerSchedule | InfeasibleGoal:
    """Compile a deployment power schedule for a :class:`MinEnergy`
    goal.

    Returns the :class:`PowerSchedule` (goal and binding constraint
    recorded on the artifact), or a structured :class:`InfeasibleGoal`
    when no schedule meets the deadline.  The solver kernels run on
    ``cfg.device`` (``"cuda"`` by default).

    ``ctx`` reuses a prebuilt :class:`CompilationContext` across
    policies and deadlines of the same network (none of the context's
    artifacts depend on the deadline); it must describe the same
    network, accelerator, and transition energy — mismatches raise
    ``ValueError``.
    """
    goal = as_goal(goal)
    cfg = cfg or OrchestratorConfig()
    if ctx is None:
        ctx = CompilationContext(
            specs, acc=acc,
            network=network if network is not None else "net",
            e_switch_nom=cfg.e_switch_nom, deadline_s=goal.deadline)
    else:
        _check_reused_context(ctx, specs, acc, cfg, network=network)
    sched = get_policy(cfg.policy)(ctx, cfg, goal=goal)
    if sched is None:
        return infeasible_result(goal, ctx)
    return sched


def infeasible_result(goal: MinEnergy, ctx: CompilationContext
                      ) -> InfeasibleGoal:
    """Structured infeasible result.  :data:`REASON_DEADLINE` is claimed
    only when the deadline actually lies below the network's min-time
    bound; otherwise the policy simply found no schedule
    (:data:`REASON_POLICY`).  Either way the bound ships in
    ``detail``."""
    t_bound = ctx.min_t_op_bound(ctx.levels)
    return InfeasibleGoal(
        reason=REASON_DEADLINE if goal.deadline < t_bound
        else REASON_POLICY,
        goal=goal.describe(),
        detail={"deadline_s": goal.deadline,
                "min_time_lower_bound_s": t_bound},
        network=ctx.network)


def _check_reused_context(ctx: CompilationContext,
                          specs: Sequence[LayerSpec],
                          acc: Edge40nmAccelerator,
                          cfg: OrchestratorConfig, *,
                          network: str | None) -> None:
    """A reused context must match the compile request — a silently
    mismatched context would emit a schedule for the wrong network or
    transition energies.  The deadline is deliberately NOT checked:
    none of the context's artifacts depend on it."""
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
