"""The port's goal menu and the compiler modules behind it, held on the
CPU against the JAX package's numpy backend: ``repro_torch`` with
``device="cpu"`` (the kernels' plain versions) against ``repro`` with
``backend="numpy"``.

  - goal values (``MinEnergy``, ``MinLatency``, ``ParetoFront``) and
    ``as_goal`` validate exactly like the reference's;
  - ``MinLatency`` compiles equal the reference's byte for byte, never
    exceed their budget, and ``solve_budget_dp`` matches an exhaustive
    scan on tiny seeded problems (the candidate pool covers the whole
    path space when k ≥ |paths|);
  - ``solve_ilp_min_latency`` / ``solve_ilp`` agree with the brute
    force and with the reference;
  - a ``ParetoFront`` compile equals solo ``MinEnergy`` compiles, point
    for point, and the reference's frontier;
  - infeasible goals come back as structured ``InfeasibleGoal`` values
    with the reference's reasons, and round-trip through JSON;
  - the module-level pieces (``min_time_path``, ``refine_path``,
    ``refine_candidates``, ``solve_greedy``, ``select_rails``,
    ``evenly_spaced_rails``) equal the reference's.

Tolerance: exact (same paths, bit-equal floats, byte-identical JSON
once the wall-clock and backend-name solver stats are set aside).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.core as R
from conftest import max_rate, random_problem
from repro.core.goals import REASON_BUDGET as REF_REASON_BUDGET
from repro.core.orchestrator import infeasible_result as ref_infeasible
from repro.models.edge_cnn import edge_network as ref_network
from repro_torch.core import (
    CompilationContext,
    IdleModel,
    InfeasibleGoal,
    MinEnergy,
    MinLatency,
    OrchestratorConfig,
    ParetoFront,
    ParetoFrontier,
    PowerSchedule,
    ScheduleProblem,
    StateCost,
    as_goal,
    compile,
    compile_power_schedule,
    evenly_spaced_rails,
    get_policy,
    min_time_path,
    refine_candidates,
    refine_path,
    register_policy,
    select_rails,
    solve_budget_dp,
    solve_greedy,
    solve_ilp,
    solve_ilp_min_latency,
    solve_lambda_dp,
)
from repro_torch.core.goals import (
    REASON_BUDGET,
    REASON_DEADLINE,
    REASON_POLICY,
)
from repro_torch.core.orchestrator import infeasible_result
from repro_torch.hw.dvfs import TransitionModel
from repro_torch.models.edge_cnn import edge_network

NET = "squeezenet1.1"
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")


def _cfg(**kw):
    return OrchestratorConfig(n_max_rails=2, device="cpu", **kw)


def _ref_cfg(**kw):
    return R.OrchestratorConfig(n_max_rails=2, backend="numpy", **kw)


def _host_free(result) -> str:
    if isinstance(result, (InfeasibleGoal, R.InfeasibleGoal)):
        return result.to_json()
    stats = {k: v for k, v in result.solver_stats.items()
             if k not in HOST_STATS}
    return dataclasses.replace(result, solver_stats=stats).to_json()


def _both(goal, ref_goal, policy="pfdnn"):
    port = compile(edge_network(NET), goal, cfg=_cfg(policy=policy),
                   network=NET)
    ref = R.compile(ref_network(NET), ref_goal,
                    cfg=_ref_cfg(policy=policy), network=NET)
    return port, ref


def _port_problem(ref: R.ScheduleProblem, *, t_max=None
                  ) -> ScheduleProblem:
    """The port's copy of a reference problem built from states."""
    return ScheduleProblem(
        layer_states=[[StateCost(**dataclasses.asdict(s)) for s in layer]
                      for layer in ref.layer_states],
        t_max=ref.t_max if t_max is None else t_max,
        idle=IdleModel(**dataclasses.asdict(ref.idle)),
        transition_model=TransitionModel(
            **dataclasses.asdict(ref.transition_model)))


def _dual_problems(seed):
    """A tiny seeded problem, deadline-free (t_max=0: no idle), in both
    packages."""
    rng = np.random.default_rng(seed)
    prob = random_problem(rng, n_layers=3, n_states=3)
    ref = R.ScheduleProblem(layer_states=prob.layer_states, t_max=0.0,
                            idle=prob.idle,
                            transition_model=prob.transition_model)
    return _port_problem(ref), ref


def _brute_force_dual(prob, budget):
    """Exhaustive fastest-within-budget scan: (t, e_infer) or None."""
    best = None
    for path in itertools.product(*(range(n) for n in prob.sizes)):
        r = prob.evaluate(list(path))
        e = r["e_op"] + r["e_trans"]
        if e > budget:
            continue
        key = (r["t_infer"], e)
        if best is None or key < best:
            best = key
    return best


def _energies(prob):
    return sorted(
        r["e_op"] + r["e_trans"] for r in
        (prob.evaluate(list(p)) for p in
         itertools.product(*(range(n) for n in prob.sizes))))


# ----------------------------------------------------- goal value rules

def test_goal_validation_matches_reference():
    for cls, ref_cls, kw, exc in (
            (MinEnergy, R.MinEnergy, {}, ValueError),
            (MinEnergy, R.MinEnergy, dict(deadline_s=0.1, rate_hz=10.0),
             ValueError),
            (MinEnergy, R.MinEnergy, dict(rate_hz=0.0), ValueError),
            (MinLatency, R.MinLatency, dict(energy_budget_j=-1.0),
             ValueError),
            (ParetoFront, R.ParetoFront, {}, ValueError),
            (ParetoFront, R.ParetoFront, dict(n_points=1), ValueError),
            (ParetoFront, R.ParetoFront, dict(deadlines=(0.1, -0.2)),
             ValueError)):
        with pytest.raises(exc) as got:
            cls(**kw)
        with pytest.raises(exc) as want:
            ref_cls(**kw)
        assert str(got.value) == str(want.value)
    assert MinEnergy(rate_hz=40.0).deadline == 1.0 / 40.0
    assert ParetoFront(deadlines=(0.3, 0.1)).deadlines == (0.1, 0.3)
    for goal, ref_goal in ((MinEnergy(rate_hz=40.0),
                            R.MinEnergy(rate_hz=40.0)),
                           (MinLatency(energy_budget_j=1e-4),
                            R.MinLatency(energy_budget_j=1e-4)),
                           (ParetoFront(n_points=3),
                            R.ParetoFront(n_points=3))):
        assert goal.describe() == ref_goal.describe()
        assert goal.key() == ref_goal.key()
        assert goal.binding == ref_goal.binding
    assert ParetoFront(n_points=5).resolve_deadlines(1e-3) == \
        R.ParetoFront(n_points=5).resolve_deadlines(1e-3)
    with pytest.raises(TypeError, match="goal must be"):
        as_goal("min_energy")
    with pytest.raises(TypeError, match="goal must be"):
        compile(edge_network(NET), 40.0, cfg=_cfg())


# --------------------------------------------------- MinLatency (dual)

@pytest.mark.parametrize("seed", range(6))
def test_budget_dp_matches_brute_force_and_reference(seed):
    port, ref = _dual_problems(seed)
    energies = _energies(ref)
    for budget in (energies[0] * 0.99, energies[0] * 1.0001,
                   energies[len(energies) // 2], energies[-1] * 1.1):
        best, cands, stats = solve_budget_dp(port, budget, k_candidates=32,
                                             backend="cpu")
        rbest, rcands, rstats = R.solve_budget_dp(
            ref, budget, k_candidates=32, backend="numpy")
        want = _brute_force_dual(ref, budget)
        if want is None:
            assert best is None and rbest is None
            continue
        assert best["e_op"] + best["e_trans"] <= budget
        assert best["t_infer"] == pytest.approx(want[0], rel=1e-12)
        assert [c["path"] for c in cands] == [c["path"] for c in rcands]
        assert best == rbest
        assert (stats.dp_calls, stats.lambda_star) == \
            (rstats.dp_calls, rstats.lambda_star)


@pytest.mark.parametrize("seed", range(3))
def test_dual_ilp_oracle_matches_brute_force(seed):
    port, ref = _dual_problems(seed)
    budget = float(np.median(_energies(ref)))
    out = solve_ilp_min_latency(port, budget)
    want = R.solve_ilp_min_latency(ref, budget)
    assert out["feasible"]
    assert out["e_op"] + out["e_trans"] <= budget * (1 + 1e-9)
    assert out["t_infer"] == pytest.approx(_brute_force_dual(ref, budget)[0],
                                           rel=1e-9)
    assert (out["path"], out["ilp_objective"]) == \
        (want["path"], want["ilp_objective"])


@pytest.mark.parametrize("seed", range(2))
def test_primal_ilp_oracle_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ref = random_problem(rng, n_layers=4, n_states=3)
    out = solve_ilp(_port_problem(ref))
    want = R.solve_ilp(ref)
    assert out["feasible"] == want["feasible"]
    if want["feasible"]:
        assert (out["path"], out["e_total"], out["ilp_objective"]) == \
            (want["path"], want["e_total"], want["ilp_objective"])


def test_min_latency_compile_respects_budget_and_matches_reference():
    """End-to-end dual compile: budget respected, dual artifact
    semantics, the dual ILP on the sweep's rails no slower, and every
    schedule byte-identical to the reference's."""
    rate = max_rate(NET) * 0.5
    base = compile(edge_network(NET), MinEnergy(rate_hz=rate),
                   cfg=_cfg(), network=NET)
    budget = (base.e_op + base.e_trans) * 1.25
    sched, ref = _both(MinLatency(energy_budget_j=budget),
                       R.MinLatency(energy_budget_j=budget))
    assert isinstance(sched, PowerSchedule)
    assert sched.e_op + sched.e_trans <= budget
    assert sched.e_idle == 0.0 and sched.feasible
    assert sched.t_max == sched.t_infer          # zero slack by design
    assert sched.binding_constraint == "energy_budget"
    assert sched.goal == {"type": "min_latency", "energy_budget_j": budget}
    assert _host_free(sched) == _host_free(ref)
    ilp, ref_ilp = _both(MinLatency(energy_budget_j=budget),
                         R.MinLatency(energy_budget_j=budget), "ilp")
    assert ilp.e_op + ilp.e_trans <= budget * (1 + 1e-9)
    assert ilp.t_infer <= sched.t_infer * (1 + 1e-9)
    assert _host_free(ilp) == _host_free(ref_ilp)


@pytest.mark.parametrize("policy", ["baseline", "gating", "pfdnn_even",
                                    "pfdnn_nopp"])
def test_min_latency_other_policies_match_reference(policy):
    rate = max_rate(NET) * 0.5
    base = compile(edge_network(NET), MinEnergy(rate_hz=rate),
                   cfg=_cfg(), network=NET)
    for mult in (1.01, 2.5):
        budget = (base.e_op + base.e_trans) * mult
        port, ref = _both(MinLatency(energy_budget_j=budget),
                          R.MinLatency(energy_budget_j=budget), policy)
        assert type(port).__name__ == type(ref).__name__
        assert _host_free(port) == _host_free(ref)


def test_min_latency_selects_across_rail_subsets():
    """A looser budget buys a faster schedule; every result stays
    within its own budget."""
    rate = max_rate(NET) * 0.5
    base = compile(edge_network(NET), MinEnergy(rate_hz=rate),
                   cfg=_cfg(), network=NET)
    e0 = base.e_op + base.e_trans
    times = []
    for mult in (1.01, 1.4, 2.5):
        s = compile(edge_network(NET), MinLatency(energy_budget_j=e0 * mult),
                    cfg=_cfg(), network=NET)
        assert s.e_op + s.e_trans <= e0 * mult
        times.append(s.t_infer)
    assert times[0] >= times[1] >= times[2]
    assert times[2] < times[0]


def test_greedy_rejects_budget_goals():
    for policy in ("greedy", "greedy_gating"):
        with pytest.raises(ValueError, match="only MinEnergy"):
            compile(edge_network(NET), MinLatency(energy_budget_j=1e-3),
                    cfg=_cfg(policy=policy), network=NET)


def test_one_context_serves_all_goals_and_deadlines():
    specs = edge_network(NET)
    rate = max_rate(NET) * 0.9
    ctx = CompilationContext(specs, network="sqz")      # deadline-free
    a = compile(specs, MinEnergy(rate_hz=rate), cfg=_cfg(), ctx=ctx)
    b = compile(specs, MinEnergy(rate_hz=rate * 0.6), cfg=_cfg(), ctx=ctx)
    assert a.t_max != b.t_max and a.e_total != b.e_total
    for sched, rr in ((a, rate), (b, rate * 0.6)):
        solo = compile(specs, MinEnergy(rate_hz=rr), cfg=_cfg(),
                       network="sqz")
        assert _host_free(sched) == _host_free(solo)
    d = compile(specs, MinLatency(energy_budget_j=(a.e_op + a.e_trans)
                                  * 1.2), cfg=_cfg(), ctx=ctx)
    assert isinstance(d, PowerSchedule)
    # a policy without a goal parameter takes MinEnergy only
    name = "test_torch_goalless_policy"
    try:
        @register_policy(name)
        def goalless(ctx, cfg):                 # pragma: no cover
            return None

        assert get_policy(name) is goalless
        with pytest.raises(ValueError, match="does not accept goal"):
            compile(specs, MinLatency(energy_budget_j=1.0),
                    cfg=_cfg(policy=name), ctx=ctx)
    finally:
        from repro_torch.core import policies

        policies._REGISTRY.pop(name, None)


# ------------------------------------------------ weak duality property

try:
    from hypothesis import given, settings, strategies as st

    @given(seed=st.integers(0, 10_000),
           f1=st.floats(0.05, 0.95), f2=st.floats(0.05, 0.95))
    @settings(max_examples=25, deadline=None)
    def test_weak_duality_tighter_budget_never_faster(seed, f1, f2):
        port, ref = _dual_problems(seed)
        energies = _energies(ref)
        span = energies[-1] - energies[0]
        b_lo, b_hi = sorted((energies[0] + f1 * span,
                             energies[0] + f2 * span))
        r_lo, _, _ = solve_budget_dp(port, b_lo, k_candidates=32,
                                     backend="cpu")
        r_hi, _, _ = solve_budget_dp(port, b_hi, k_candidates=32,
                                     backend="cpu")
        assert r_hi is not None
        assert r_hi["e_op"] + r_hi["e_trans"] <= b_hi
        if r_lo is not None:
            assert r_lo["e_op"] + r_lo["e_trans"] <= b_lo
            assert r_lo["t_infer"] >= r_hi["t_infer"] - 1e-18
except ImportError:                               # pragma: no cover
    pass


# ----------------------------------------------------- Pareto frontier

def test_pareto_front_equals_solo_min_energy_compiles():
    frontier, ref = _both(ParetoFront(n_points=4), R.ParetoFront(n_points=4))
    assert isinstance(frontier, ParetoFrontier)
    assert len(frontier.points) == 4
    deadlines = [p.deadline_s for p in frontier.points]
    assert deadlines == sorted(deadlines)
    assert deadlines == [p.deadline_s for p in ref.points]
    for p, rp in zip(frontier.points, ref.points):
        solo = compile(edge_network(NET), MinEnergy(deadline_s=p.deadline_s),
                       cfg=_cfg(), network=NET)
        # the sweep's round counts differ when co-scheduled; the
        # schedule does not
        assert (p.schedule.e_total, p.schedule.t_infer, p.schedule.rails,
                p.schedule.layer_voltages) == \
            (solo.e_total, solo.t_infer, solo.rails, solo.layer_voltages)
        assert _host_free(p.schedule) == _host_free(rp.schedule)
    feas = frontier.feasible_points()
    e_infer = [p.schedule.e_op + p.schedule.e_trans for p in feas]
    assert all(a >= b - 1e-18 for a, b in zip(e_infer, e_infer[1:]))
    assert frontier.summary() == ref.summary()


def test_pareto_front_explicit_deadlines_and_infeasible_points():
    t_ok = 1.0 / (max_rate(NET) * 0.8)
    frontier, ref = _both(ParetoFront(deadlines=(1e-6, t_ok)),
                          R.ParetoFront(deadlines=(1e-6, t_ok)))
    assert not frontier.points[0].feasible
    assert frontier.points[0].schedule.reason == REASON_DEADLINE
    assert frontier.points[1].feasible
    assert "infeasible" in frontier.summary()
    for p, rp in zip(frontier.points, ref.points):
        assert _host_free(p.schedule) == _host_free(rp.schedule)


@pytest.mark.parametrize("policy", ["greedy_gating", "pfdnn_even"])
def test_pareto_front_non_stackable_policy_runs_per_point(policy):
    frontier, ref = _both(ParetoFront(n_points=3), R.ParetoFront(n_points=3),
                          policy)
    assert isinstance(frontier, ParetoFrontier)
    for p, rp in zip(frontier.points, ref.points):
        assert _host_free(p.schedule) == _host_free(rp.schedule)
        if p.feasible:
            solo = compile(edge_network(NET),
                           MinEnergy(deadline_s=p.deadline_s),
                           cfg=_cfg(policy=policy), network=NET)
            assert p.schedule.e_total == solo.e_total


# ------------------------------------------------- structured infeasible

def test_infeasible_goal_reasons_and_json_roundtrip():
    inf_t, ref_t = _both(MinEnergy(deadline_s=1e-7),
                         R.MinEnergy(deadline_s=1e-7))
    assert isinstance(inf_t, InfeasibleGoal)
    assert inf_t.reason == REASON_DEADLINE
    assert inf_t.detail["min_time_lower_bound_s"] > 1e-7
    inf_e, ref_e = _both(MinLatency(energy_budget_j=1e-12),
                         R.MinLatency(energy_budget_j=1e-12))
    assert isinstance(inf_e, InfeasibleGoal)
    assert inf_e.reason == REASON_BUDGET == REF_REASON_BUDGET
    assert inf_e.detail["min_energy_lower_bound_j"] > 1e-12
    for got, want in ((inf_t, ref_t), (inf_e, ref_e)):
        assert got.to_json() == want.to_json()
        assert InfeasibleGoal.from_json(got.to_json()) == got
        assert InfeasibleGoal.from_json(want.to_json()) == got
    assert compile_power_schedule(edge_network(NET), 1e7, cfg=_cfg()) is None


def test_infeasible_reason_is_honest_about_policy_failures():
    ctx = CompilationContext(edge_network(NET), network="sqz")
    ref_ctx = R.CompilationContext(ref_network(NET), network="sqz")
    t_bound = ctx.min_t_op_bound(ctx.levels)
    e_bound = ctx.min_e_op_bound(ctx.levels)
    cases = [(MinEnergy(deadline_s=t_bound * 0.5), REASON_DEADLINE),
             (MinEnergy(deadline_s=t_bound * 2.0), REASON_POLICY),
             (MinLatency(energy_budget_j=e_bound * 0.5), REASON_BUDGET),
             (MinLatency(energy_budget_j=e_bound * 2.0), REASON_POLICY)]
    for goal, reason in cases:
        got = infeasible_result(goal, ctx)
        ref_goal = (R.MinEnergy(deadline_s=goal.deadline)
                    if isinstance(goal, MinEnergy)
                    else R.MinLatency(energy_budget_j=goal.energy_budget_j))
        assert got.reason == reason
        assert got.to_json() == ref_infeasible(ref_goal, ref_ctx).to_json()


# ------------------------------------------- module-level counterparts

@pytest.fixture(scope="module")
def subset_problems():
    """One 2-rail subset problem of squeezenet1.1 at 0.7 × max rate, in
    both packages (states materialized)."""
    t_max = 1.0 / (max_rate(NET) * 0.7)
    kw = dict(gating=True, allow_sleep=True, t_max=t_max)
    rails = (1.2, 0.9)
    ref = R.CompilationContext(ref_network(NET), network=NET) \
        .problem_for(rails, **kw)
    port = CompilationContext(edge_network(NET), network=NET) \
        .problem_for(rails, **kw)
    return port, ref


def test_min_time_path_matches_reference(subset_problems):
    port, ref = subset_problems
    assert min_time_path(port, backend="cpu") == R.min_time_path(ref)


def test_refinement_matches_reference(subset_problems):
    port, ref = subset_problems
    best, cands, _ = solve_lambda_dp(port, backend="cpu")
    rbest, rcands, _ = R.solve_lambda_dp(ref, backend="numpy")
    assert [c["path"] for c in cands] == [c["path"] for c in rcands]
    assert refine_candidates(port, cands) == R.refine_candidates(ref,
                                                                 rcands)
    fastest = min_time_path(port, backend="cpu")
    assert refine_path(port, fastest, max_moves=3) == \
        R.refine_path(ref, fastest, max_moves=3)


def test_greedy_matches_reference(subset_problems):
    port, ref = subset_problems
    assert solve_greedy(port) == R.solve_greedy(ref)


def test_select_rails_and_even_rails_match_reference():
    levels = (0.9, 0.95, 1.0, 1.05, 1.1, 1.15, 1.2, 1.25, 1.3)
    for k in range(1, 6):
        assert evenly_spaced_rails(levels, k) == \
            R.evenly_spaced_rails(levels, k)
    assert evenly_spaced_rails((1.0, 1.0, 1.2, 0.8), 3) == \
        R.evenly_spaced_rails((1.0, 1.0, 1.2, 0.8), 3)
    with pytest.raises(ValueError, match="distinct"):
        evenly_spaced_rails((1.0, 1.1), 3)

    def solve(rails, hint=None):
        # infeasible when the top rail is below 1.1; energy falls with
        # the top rail and with the rail count
        if max(rails) < 1.1:
            return None
        return {"e_total": 2.0 - max(rails) - 0.01 * len(rails),
                "lambda_star": max(rails)}

    def bound(rails):
        # a sound lower bound on every feasible subset's energy
        return 0.0 if max(rails) < 1.1 else 1.95 - max(rails)

    got = select_rails(levels, 3, solve, bound_fn=bound)
    want = R.select_rails(levels, 3, solve, bound_fn=bound)
    assert got == want
    assert got[2]["subsets_cut"] > 0 and got[2]["subsets_skipped"] > 0


def test_goal_compiles_on_cuda_refuse_without_a_card(monkeypatch):
    from repro_torch.core import backend as tb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tb, "_INSTANCES", {})
    for goal in (MinLatency(energy_budget_j=1e-3), ParetoFront(n_points=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            compile(edge_network(NET), goal,
                    cfg=OrchestratorConfig(n_max_rails=1), network="sqz")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile(edge_network(NET), MinEnergy(rate_hz=40.0),
                cfg=OrchestratorConfig(policy="pfdnn_even", n_max_rails=1),
                network="sqz")
