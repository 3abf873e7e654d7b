"""λ-DP: Lagrangian dynamic-programming search on the layered state graph.

Paper §4.3: the deadline-constrained problem is solved with a weighted
shortest-path search where λ reweights the objective as ``E + λT``; a
search on λ finds the tightest feasible schedule, and candidate paths
discovered along the way feed the local-refinement step (because some
minimum-energy feasible schedules are not representable by any λ).

Implementation notes:
  - ``dp_paths_multi_weighted`` is the batched DP: one pass over the
    layers evaluates a whole weight batch ``w_e·e + w_t·t`` on the
    backend's DP kernel (:mod:`repro_torch.kernels.dp_sweep`).
  - ``mu`` is the generic per-second price.  Plain λ-DP uses ``mu = λ``.
    Because the terminal idle energy is linear in the slack for a fixed
    duty-cycle decision z, running the same DP with ``mu = λ − P_z``
    yields exact idle-aware paths for that branch; both branches are
    added to the candidate pool.
  - The batched λ search: ONE batched call evaluates min-time + μ=0 +
    both idle-priced branches + a geometric λ bracket grid, and the
    bracket is then narrowed by parametric (Megiddo-style) cuts on the
    piecewise-linear ``min_p E_p + λT_p`` envelope, landing on the exact
    breakpoint λ* in a handful of DP calls.
  - ``lam_hint`` warm-starts the λ search from a previous solve (the
    rail-subset sweep passes the last subset's λ*).
  - The dual (:class:`~repro_torch.core.goals.MinLatency`: fastest
    schedule within an energy budget) runs the same engine on the
    energy axis of the envelope (:func:`budget_rounds`,
    :func:`solve_budget_dp`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.backend import bucket_key, get_backend, pad_bucket
from repro_torch.core.goals import MinLatency
from repro_torch.core.problem import ScheduleProblem


@dataclasses.dataclass
class SolverStats:
    lambda_iterations: int = 0
    dp_calls: int = 0
    dp_lambdas: int = 0
    candidates_evaluated: int = 0
    refinement_moves: int = 0
    wall_time_s: float = 0.0
    lambda_star: float = 0.0
    states_explored: int = 0
    edges_explored: int = 0
    backend: str = "torch"


# --------------------------------------------------------- DP calls

def dp_paths_multi_weighted(problem: ScheduleProblem,
                            w_e: Sequence[float],
                            w_t: Sequence[float],
                            *, backend=None) -> np.ndarray:
    """Batched DP: best path per weight pair in ONE pass of the layers.

    ``w_e``/``w_t``: [K] node-cost weights.  Returns a ``[K, L]`` int64
    matrix of state indices (the backend's DP kernel with one lane).
    """
    w_e = np.asarray(w_e, dtype=float)
    w_t = np.asarray(w_t, dtype=float)
    if w_e.shape != w_t.shape or w_e.ndim != 1:
        raise ValueError(
            f"w_e/w_t must be equal-length 1-D, got {w_e.shape} "
            f"and {w_t.shape}")
    return get_backend(backend).dp_multi(problem.padded_arrays(), w_e, w_t)


def dp_paths_multi(problem: ScheduleProblem, mus: Sequence[float],
                   *, backend=None) -> np.ndarray:
    """Batched λ-DP: best path under ``e + mu·t`` for every ``mu`` in the
    batch, one DP pass total.  Returns ``[K, L]`` int64 state indices."""
    mus = np.asarray(mus, dtype=float)
    return dp_paths_multi_weighted(problem, np.ones_like(mus), mus,
                                   backend=backend)


def kbest_paths_multi(problem: ScheduleProblem, mus: Sequence[float],
                      k: int, *, backend=None) -> list[list[list[int]]]:
    """k-best frontier for every ``mu`` in the batch, one DP pass total
    (the backend's k-best kernel with one lane; stable ``(value,
    index)`` tie breaking)."""
    mus = np.asarray(mus, dtype=float)
    paths, counts = get_backend(backend).kbest_multi(
        problem.padded_arrays(), mus, k)
    return kbest_rows_to_lists(paths, counts)


def kbest_rows_to_lists(paths: np.ndarray, counts: np.ndarray
                        ) -> list[list[list[int]]]:
    """Convert a backend k-best result ``(paths [K, k, L], counts [K])``
    to the per-μ list-of-paths form (rows past ``counts[q]`` dropped)."""
    return [[paths[q, j].tolist() for j in range(int(counts[q]))]
            for q in range(paths.shape[0])]


def min_time_path(problem: ScheduleProblem, *, backend=None) -> list[int]:
    """Fastest possible schedule (λ → ∞ limit): minimize time only, on
    the backend's DP kernel (``w_e = 0, w_t = 1``)."""
    return dp_paths_multi_weighted(problem, [0.0], [1.0],
                                   backend=backend)[0].tolist()


# ------------------------------------------------------------- λ search

def _make_consider_all(problem: ScheduleProblem, seen: dict,
                       stats: SolverStats, backend):
    """The sequential solvers' shared candidate pool: batch-evaluate
    every not-yet-seen path in one vectorized shot, memoized in
    ``seen`` (one implementation, so the primal and dual pools dedup
    and account identically)."""

    def consider_all(paths: Iterable[Sequence[int]]) -> list[dict]:
        if isinstance(paths, np.ndarray):
            paths = paths.tolist()
        keys = [tuple(p) for p in paths]
        fresh: list[tuple] = []
        fresh_set: set[tuple] = set()
        for key in keys:
            if key not in seen and key not in fresh_set:
                fresh.append(key)
                fresh_set.add(key)
        if fresh:
            batch = problem.evaluate_paths([list(key) for key in fresh],
                                           backend=backend)
            for j, key in enumerate(fresh):
                seen[key] = ScheduleProblem.result_row(batch, j)
            stats.candidates_evaluated += len(fresh)
        return [seen[key] for key in keys]

    return consider_all


def solve_lambda_dp(
    problem: ScheduleProblem,
    *,
    k_candidates: int = 10,
    bisect_iters: int = 48,
    bisect_rel_tol: float = 0.0,
    collect_idle_branches: bool = True,
    lam_hint: float | None = None,
    backend=None,
) -> tuple[dict | None, list[dict], SolverStats]:
    """λ-DP search on one problem; returns (best, feasible_candidates,
    stats).

    ``best`` is the exact-evaluated minimum-energy feasible schedule found
    by the weighted search; ``feasible_candidates`` are the ≤k best
    distinct feasible paths (input to refinement).  Returns ``best=None``
    when even the fastest schedule misses the deadline.  The rounds of
    :func:`lambda_rounds` run on ``backend``'s kernels one at a time
    (the subset-stacked sweep runs the same machine, grouped).
    """
    stats = SolverStats()
    tic = time.perf_counter()
    stats.states_explored = problem.n_states()
    stats.edges_explored = problem.n_edges()
    bk = get_backend(backend)
    stats.backend = bk.name

    seen: dict[tuple, dict] = {}
    consider_all = _make_consider_all(problem, seen, stats, bk)
    machine = lambda_rounds(
        problem, stats, k_candidates=k_candidates,
        bisect_iters=bisect_iters, bisect_rel_tol=bisect_rel_tol,
        collect_idle_branches=collect_idle_branches, lam_hint=lam_hint)
    if not _drive_machine(machine, problem, consider_all, bk):
        stats.wall_time_s = time.perf_counter() - tic
        return None, [], stats

    feas = sorted((r for r in seen.values() if r["feasible"]),
                  key=lambda r: r["e_total"])
    candidates = feas[:k_candidates]
    best = candidates[0] if candidates else None
    stats.wall_time_s = time.perf_counter() - tic
    return best, candidates, stats


# geometric bracket grids (16 λs each) around the seed λ.  Cold solves
# sweep ratio 4 from seed/64 to seed·4¹².  A warm hint usually lands
# within a factor of two of λ*, so the hinted grid spends its points
# non-uniformly: a dense ratio-2^¼ band across [hint/2, 2·hint] (the λ*
# bracket is then ~1.19× wide — one or two envelope cuts finish it), a
# couple of points below to pin the infeasible side, and a coarse tail
# to hint·2048 for when the hint is badly off.  One extension sweep
# spans another 4¹⁶; _MAX_GRID_ROUNDS rounds cover far beyond the
# legacy 4⁸⁰ expansion cap.
_COLD_MULTS = 4.0 ** np.arange(-3, 13)
_WARM_MULTS = np.concatenate([
    2.0 ** np.arange(-3.0, -1.0),          # hint/8, hint/4
    2.0 ** np.linspace(-1.0, 1.0, 9),      # dense band around the hint
    2.0 * 4.0 ** np.arange(1.0, 6.0),      # coarse tail to hint·2048
])
_EXTEND_EXPS = np.arange(1, 17)
_MAX_GRID_ROUNDS = 8


@dataclasses.dataclass
class WorkRequest:
    """One round of backend work the λ-search machine asks for.

    ``kind="dp"``: run the batched DP under the ``[K]`` weight pair and
    evaluate + pool the first ``eval_n`` result paths (``None`` = all).
    The response is ``(paths [K, L] int64, rows)`` where ``rows`` are
    the evaluations of the pooled prefix.

    ``kind="eval"``: evaluate + pool ``paths`` (deduped against the
    pool); response is their evaluation rows, pool-order preserved.

    ``kind="kbest"``: run the fused multi-μ k-best frontier and pool
    every returned path (μ-major order); no response payload needed.

    ``kind="eval_batch"``: plain batch evaluation of ``paths`` (no
    pooling, no dedup); response is the
    :meth:`~repro_torch.core.problem.ScheduleProblem.evaluate_paths`-format
    dict.  ``kind="moves"``: score the single-layer replacements of
    the candidate rows ``paths`` (``aux`` carries their
    ``(t_infer, e_idle)``); response is
    :func:`repro_torch.core.refinement.move_scores` output.  Both are issued
    by the refinement machine.
    """

    kind: str
    w_e: np.ndarray | None = None
    w_t: np.ndarray | None = None
    eval_n: int | None = None
    paths: np.ndarray | None = None
    mus: list[float] | None = None
    k: int = 0
    aux: tuple | None = None


def lambda_rounds(problem: ScheduleProblem, stats: SolverStats, *,
                  k_candidates: int, bisect_iters: int,
                  bisect_rel_tol: float, collect_idle_branches: bool,
                  lam_hint: float | None):
    """The λ search as a resumable state machine (generator).

    Yields :class:`WorkRequest` rounds and receives their responses via
    ``send``; returns True when a feasible schedule exists (candidates
    are in the pool) and False when even the min-time schedule misses
    the deadline.  Both the sequential driver
    (:func:`solve_lambda_dp`) and the subset-stacked scheduler
    (:func:`repro_torch.core.rails.select_rails_stacked`) drive this one
    implementation, so the probe sequence — and therefore the candidate
    pool — is identical no matter how rounds are batched across
    subsets.

    Round structure (the batched multi-λ engine, unrolled into
    requests): one batched DP evaluates the min-time limit, μ=0, both
    idle-priced branches, and a geometric λ bracket grid; extension
    sweeps extend the grid upward when needed; parametric envelope cuts
    then land on the exact breakpoint λ*; a fused multi-μ k-best pass
    enriches the candidate pool at λ* (and its sleep-priced branch).
    """

    def line(r: dict) -> tuple[float, float]:
        # the DP objective's (E, T) of a path: op+transition cost only
        return (r["e_op"] + r["e_trans"], r["t_infer"])

    # -- round A+B: limits, idle branches, AND the bracket grid in ONE
    # batched DP pass.  The grid λs cost vector work only; their paths
    # enter the candidate pool solely when the subset really needs the
    # bracket (μ=0 infeasible), so the search behaves exactly like a
    # separate grid round — minus one full pass over the layers.
    w_e = [0.0, 1.0]
    w_t = [1.0, 0.0]
    if collect_idle_branches:
        w_e += [1.0, 1.0]
        w_t += [-problem.idle.p_sleep, -problem.idle.p_idle]
    n_a = len(w_t)
    hinted = lam_hint is not None and lam_hint > 0.0
    lam0 = lam_hint if hinted else max(problem.idle.p_idle, 1e-3)
    grid = lam0 * (_WARM_MULTS if hinted else _COLD_MULTS)
    stats.dp_calls += 1
    stats.dp_lambdas += n_a + len(grid)
    all_paths, rows = yield WorkRequest(
        "dp", w_e=np.array(w_e + [1.0] * len(grid)),
        w_t=np.array(w_t + list(grid)), eval_n=n_a)
    if not rows[0]["feasible"]:       # even the min-time schedule misses
        return False
    feasible_at_zero = rows[1]["feasible"]

    if feasible_at_zero:
        # deadline slack is abundant: idle-priced unconstrained optima
        # (the speculative grid paths stay out of the candidate pool)
        yield _frontier_request(problem, 0.0, k_candidates,
                                collect_idle_branches)
        return True

    # -- bracket the feasibility threshold on the grid
    lo, lo_pt = 0.0, line(rows[1])
    hi: float | None = None
    hi_pt: tuple[float, float] | None = None
    grid_paths = all_paths[n_a:]
    for round_no in range(_MAX_GRID_ROUNDS):
        if round_no > 0:              # extension sweep: λ* above the grid
            grid = grid[-1] * 4.0 ** _EXTEND_EXPS
            stats.dp_calls += 1
            stats.dp_lambdas += len(grid)
            grid_paths, grows = yield WorkRequest(
                "dp", w_e=np.ones(len(grid)), w_t=np.asarray(grid),
                eval_n=None)
        else:
            grows = yield WorkRequest("eval", paths=grid_paths)
        for mu, r in zip(grid, grows):
            if r["feasible"]:
                hi, hi_pt = float(mu), line(r)
                break
            lo, lo_pt = float(mu), line(r)
        if hi is not None:
            break
    if hi is None:
        # pathological λ scale: treat the (feasible) min-time line as
        # the feasible endpoint and let the cuts take over
        hi, hi_pt = float(grid[-1]), line(rows[0])

    # -- parametric envelope cuts
    while stats.lambda_iterations < bisect_iters:
        if bisect_rel_tol > 0.0 and hi - lo <= bisect_rel_tol * hi:
            break
        denom = lo_pt[1] - hi_pt[1]            # T_lo − T_hi > 0
        if denom <= 0.0:
            break
        lam = (hi_pt[0] - lo_pt[0]) / denom
        # the crossing of two envelope-optimal lines always lies inside
        # [lo, hi] (concavity); a crossing ON a bracket endpoint proves
        # no third line fits below the two known ones, so the breakpoint
        # is exact — terminate without probing
        if lam <= lo:                          # λ* = lo⁺
            hi = min(hi, lo + (hi - lo) * 1e-9)
            break
        if lam >= hi:                          # envelope below hi is
            break                              # lo's line: λ* = hi
        stats.lambda_iterations += 1
        stats.dp_calls += 1
        stats.dp_lambdas += 1
        _, probe_rows = yield WorkRequest(
            "dp", w_e=np.ones(1), w_t=np.array([lam]), eval_n=None)
        r = probe_rows[0]
        pt = line(r)
        if r["feasible"]:
            if pt == hi_pt:
                # the optimum flips from lo's line straight to hi's at
                # their crossing — λ* is exactly lam
                hi = lam
                break
            hi, hi_pt = lam, pt
        else:
            if pt == lo_pt:
                # tie at the crossing resolved to the infeasible line:
                # everything above lam is hi's (feasible) line
                hi = min(hi, lam * (1.0 + max(bisect_rel_tol, 1e-12)))
                break
            lo, lo_pt = lam, pt

    stats.lambda_star = hi
    yield _frontier_request(problem, hi, k_candidates,
                            collect_idle_branches)
    return True


def budget_rounds(problem: ScheduleProblem, stats: SolverStats, *,
                  budget: float, k_candidates: int, bisect_iters: int,
                  bisect_rel_tol: float, lam_hint: float | None):
    """The dual λ search as a resumable state machine: fastest schedule
    with inference energy ``E_op + E_trans ≤ budget``.

    Same engine as :func:`lambda_rounds` — one batched DP evaluates the
    limits plus a geometric λ bracket grid, extension sweeps stretch it
    upward, and parametric envelope cuts land on the exact breakpoint —
    but the bracket bisects the **energy** axis of the piecewise-linear
    envelope ``min_p E_p + λT_p`` instead of the time axis: raising λ
    walks the envelope toward faster, *more expensive* paths, so the
    budget crossing (not the deadline crossing) is the breakpoint.  The
    roles of the bracket endpoints flip accordingly: ``lo`` (small λ)
    is the within-budget side, ``hi`` the over-budget side.

    The problem must be built deadline-free (``t_max=0.0``): every
    slack is then ≤ 0, so ``e_idle == 0`` exactly and ``e_total`` *is*
    the inference energy the budget bounds (there is no idle interval
    to price — idle-branch probes would be meaningless and are not
    issued).  Returns True when the budget is attainable (candidates in
    the pool) and False when even the min-energy schedule exceeds it.
    """

    def line(r: dict) -> tuple[float, float]:
        # the DP objective's (E, T) of a path: op+transition cost only
        return (r["e_op"] + r["e_trans"], r["t_infer"])

    # -- round A+B: min-time + min-energy limits AND the bracket grid
    # in ONE batched DP pass (mirrors the primal's fused first round)
    hinted = lam_hint is not None and lam_hint > 0.0
    lam0 = lam_hint if hinted else max(problem.idle.p_idle, 1e-3)
    grid = lam0 * (_WARM_MULTS if hinted else _COLD_MULTS)
    stats.dp_calls += 1
    stats.dp_lambdas += 2 + len(grid)
    all_paths, rows = yield WorkRequest(
        "dp", w_e=np.array([0.0, 1.0] + [1.0] * len(grid)),
        w_t=np.array([1.0, 0.0] + list(grid)), eval_n=2)
    if line(rows[1])[0] > budget:     # even the cheapest path overshoots
        return False
    if line(rows[0])[0] <= budget:
        # budget is abundant: the fastest schedule overall is optimal;
        # enrich with the frontier at the grid top for energy tie-breaks
        stats.lambda_star = 0.0
        yield WorkRequest("kbest", mus=[float(grid[-1])], k=k_candidates)
        return True

    # -- bracket the budget crossing on the grid (E(λ) non-decreasing)
    lo, lo_pt = 0.0, line(rows[1])
    hi: float | None = None
    hi_pt: tuple[float, float] | None = None
    grid_paths = all_paths[2:]
    for round_no in range(_MAX_GRID_ROUNDS):
        if round_no > 0:          # extension sweep: crossing above grid
            grid = grid[-1] * 4.0 ** _EXTEND_EXPS
            stats.dp_calls += 1
            stats.dp_lambdas += len(grid)
            grid_paths, grows = yield WorkRequest(
                "dp", w_e=np.ones(len(grid)), w_t=np.asarray(grid),
                eval_n=None)
        else:
            grows = yield WorkRequest("eval", paths=grid_paths)
        for mu, r in zip(grid, grows):
            if line(r)[0] > budget:
                hi, hi_pt = float(mu), line(r)
                break
            lo, lo_pt = float(mu), line(r)
        if hi is not None:
            break
    if hi is None:
        # pathological λ scale: the (over-budget) min-time line is the
        # over-budget endpoint; let the cuts take over
        hi, hi_pt = float(grid[-1]), line(rows[0])

    # -- parametric envelope cuts (identical crossing formula; the
    # probe classification tests the budget instead of the deadline)
    while stats.lambda_iterations < bisect_iters:
        if bisect_rel_tol > 0.0 and hi - lo <= bisect_rel_tol * hi:
            break
        denom = lo_pt[1] - hi_pt[1]            # T_lo − T_hi > 0
        if denom <= 0.0:
            break
        lam = (hi_pt[0] - lo_pt[0]) / denom
        if lam <= lo or lam >= hi:
            # crossing ON a bracket endpoint: no third line fits below
            # the two known ones — the breakpoint is exact
            break
        stats.lambda_iterations += 1
        stats.dp_calls += 1
        stats.dp_lambdas += 1
        _, probe_rows = yield WorkRequest(
            "dp", w_e=np.ones(1), w_t=np.array([lam]), eval_n=None)
        r = probe_rows[0]
        pt = line(r)
        if pt[0] <= budget:
            if pt == lo_pt:
                # optimum at lam is still lo's line and the hi line
                # takes over right above it: breakpoint is exactly lam
                lo = lam
                break
            lo, lo_pt = lam, pt
        else:
            if pt == hi_pt:
                # tie at the crossing resolved to the over-budget line:
                # the within-budget region ends just below lam
                hi = lam
                break
            hi, hi_pt = lam, pt

    stats.lambda_star = lo if lo > 0.0 else hi
    # candidate enrichment on BOTH sides of the breakpoint: the k-best
    # frontier at lo holds the fastest within-budget hull paths, the one
    # at hi their just-over-budget neighbours whose k-best pools still
    # contain budget-feasible near-ties
    yield WorkRequest("kbest", mus=[lo, hi], k=k_candidates)
    return True


def budget_candidates(seen: Iterable[dict], budget: float,
                      k_candidates: int) -> list[dict]:
    """The dual's candidate rule: ≤k fastest distinct paths within the
    energy budget, ties broken toward lower energy (shared by the
    sequential and the stacked solvers so both rank identically)."""
    feas = sorted((r for r in seen
                   if r["e_op"] + r["e_trans"] <= budget),
                  key=lambda r: (r["t_infer"], r["e_total"]))
    return feas[:k_candidates]


def _frontier_request(problem, lam: float, k_candidates: int,
                      collect_idle_branches: bool) -> WorkRequest:
    """Candidate enrichment at λ (and its sleep-priced branch), fused
    into one multi-μ k-best request; pool order matches the sequential
    per-μ ``kbest_paths`` calls exactly."""
    mus = [lam]
    if collect_idle_branches:
        mus.append(lam - problem.idle.p_sleep)
    return WorkRequest("kbest", mus=mus, k=k_candidates)


def serve_request(problem: ScheduleProblem, req: WorkRequest,
                  consider_all, bk):
    """Serve one machine request on the backend's kernels with one lane.

    The subset-stacked scheduler replaces this with grouped stacked
    calls; both produce bit-identical responses.
    """
    if req.kind == "dp":
        paths = dp_paths_multi_weighted(problem, req.w_e, req.w_t,
                                        backend=bk)
        n = len(paths) if req.eval_n is None else req.eval_n
        return paths, consider_all(paths[:n])
    if req.kind == "eval":
        return consider_all(req.paths)
    if req.kind == "kbest":
        paths, counts = bk.kbest_multi(problem.padded_arrays(),
                                       np.asarray(req.mus, dtype=float),
                                       req.k)
        flat = [p for per_mu in kbest_rows_to_lists(paths, counts)
                for p in per_mu]
        consider_all(flat)
        return None
    raise ValueError(f"unknown work request kind {req.kind!r}")


def _drive_machine(machine, problem, consider_all, bk) -> bool:
    """Drive a λ-search machine to completion on the (non-stacked)
    backend kernels; shared by the primal and the dual solvers."""
    resp = None
    while True:
        try:
            req = machine.send(resp)
        except StopIteration as stop:
            return stop.value
        resp = serve_request(problem, req, consider_all, bk)


def solve_budget_dp(
    problem: ScheduleProblem,
    budget: float,
    *,
    k_candidates: int = 10,
    bisect_iters: int = 48,
    bisect_rel_tol: float = 0.0,
    lam_hint: float | None = None,
    backend=None,
) -> tuple[dict | None, list[dict], SolverStats]:
    """Dual λ-DP search: fastest schedule with ``E_op + E_trans ≤
    budget``; returns (best, within-budget candidates, stats) exactly
    like :func:`solve_lambda_dp` returns its deadline counterparts.

    The problem must be built deadline-free (``t_max=0.0``, see
    :func:`budget_rounds`); ``best=None`` means the budget lies below
    the minimum inference energy on this problem's rails.
    """
    stats = SolverStats()
    tic = time.perf_counter()
    stats.states_explored = problem.n_states()
    stats.edges_explored = problem.n_edges()
    bk = get_backend(backend)
    stats.backend = bk.name

    seen: dict[tuple, dict] = {}
    consider_all = _make_consider_all(problem, seen, stats, bk)

    machine = budget_rounds(
        problem, stats, budget=budget, k_candidates=k_candidates,
        bisect_iters=bisect_iters, bisect_rel_tol=bisect_rel_tol,
        lam_hint=lam_hint)
    ok = _drive_machine(machine, problem, consider_all, bk)
    if not ok:
        stats.wall_time_s = time.perf_counter() - tic
        return None, [], stats
    candidates = budget_candidates(seen.values(), budget, k_candidates)
    best = candidates[0] if candidates else None
    stats.wall_time_s = time.perf_counter() - tic
    return best, candidates, stats


# ----------------------------------------------- subset-stacked tasks

class StackedLambdaTask:
    """Per-subset λ-search state for the subset-stacked sweep.

    Wraps one :func:`lambda_rounds` machine plus its candidate pool so a
    round-based scheduler (:func:`repro_torch.core.rails.select_rails_stacked`)
    can advance many subsets per stacked backend call:

      1. the scheduler reads :attr:`request` and batches same-shaped
         kernel work across same-:attr:`bucket` tasks;
      2. :meth:`take_kernel` receives this task's slice of the stacked
         kernel result and returns the not-yet-pooled paths that still
         need evaluation (deduplication mirrors the sequential pool);
      3. :meth:`take_rows` receives the gathered cost components of
         those paths (one stacked gather for the whole bucket), builds
         the evaluation rows through the problem's own
         :meth:`~repro_torch.core.problem.ScheduleProblem.finish_costs`, and
         advances the machine to its next request.

    Because the machine, the pool bookkeeping, and the row math are the
    exact objects the sequential driver uses, the pool contents — and
    hence the solved result — are bit-identical to a sequential
    ``solve_lambda_dp`` on the same problem (same backend, no hint).
    """

    def __init__(self, idx: int, rails: tuple[float, ...],
                 problem: ScheduleProblem, *, k_candidates: int = 10,
                 bisect_iters: int = 48, bisect_rel_tol: float = 0.0,
                 collect_idle_branches: bool = True,
                 lam_hint: float | None = None,
                 lane_key=None, sig_prefix: tuple = (), caches=None,
                 goal=None):
        self.idx = idx
        self.rails = rails
        self.problem = problem
        self.k_candidates = k_candidates
        self.goal = goal
        self._budget = goal.energy_budget_j \
            if isinstance(goal, MinLatency) else None
        self.stats = SolverStats()
        self.stats.states_explored = problem.n_states()
        self.stats.edges_explored = problem.n_edges()
        # lane provenance for the round scheduler: a content-derived
        # lane key lets a BucketStack shared across compiles (the
        # fleet service's) recognize this subset's padded tensors,
        # skipping both the admission copy and, here, build_padded (the
        # resident lane is read back as a zero-copy view).  The bucket
        # signature is ``sig_prefix + (n_layers, s_pad)`` (the pfdnn
        # sweep prefixes the accelerator's voltage levels).
        self.lane_key = lane_key
        self.bucket_sig = sig_prefix + (
            problem.n_layers, pad_bucket(max(problem.sizes)))
        if caches is not None and lane_key is not None \
                and problem._padded is None:
            warm = caches.warm_padded(self.bucket_sig, lane_key)
            if warm is not None:
                problem._padded = warm
        self.uid: int | None = None      # assigned by run_stacked_sweeps
        self.padded = problem.padded_arrays()
        self.bucket = bucket_key(self.padded)
        self.seen: dict[tuple, dict] = {}
        if self._budget is not None:
            # dual goal: bisect the energy axis (no idle branches —
            # the problem is deadline-free, see budget_rounds)
            self._machine = budget_rounds(
                problem, self.stats, budget=self._budget,
                k_candidates=k_candidates, bisect_iters=bisect_iters,
                bisect_rel_tol=bisect_rel_tol, lam_hint=lam_hint)
        else:
            self._machine = lambda_rounds(
                problem, self.stats, k_candidates=k_candidates,
                bisect_iters=bisect_iters, bisect_rel_tol=bisect_rel_tol,
                collect_idle_branches=collect_idle_branches,
                lam_hint=lam_hint)
        self.request: WorkRequest | None = None
        self.ok: bool | None = None
        self._phase = "lambda"
        self._tic = time.perf_counter()
        self._pending_keys: list[tuple] | None = None
        self._fresh: list[tuple] | None = None
        self._raw: np.ndarray | None = None

    def start(self) -> None:
        self._advance(None)

    def _post_machine(self):
        """Hook: a second request generator to drive after a feasible
        λ search (e.g. stacked refinement).  None = no post phase."""
        return None

    def _advance(self, resp) -> None:
        while True:
            try:
                self.request = self._machine.send(resp)
                return
            except StopIteration as stop:
                if self._phase == "lambda":
                    self.ok = bool(stop.value)
                    self._phase = "post"
                    nxt = self._post_machine() if self.ok else None
                    if nxt is not None:
                        self._machine = nxt
                        resp = None
                        continue
                break
        self.request = None
        self._machine = None
        self.stats.wall_time_s = time.perf_counter() - self._tic

    def take_kernel(self, raw) -> np.ndarray:
        """Consume this task's slice of the round's stacked kernel
        output; returns the [F, L] paths still needing cost gathers
        (possibly empty)."""
        req = self.request
        if req.kind == "moves":
            self._raw = raw                     # (layer, state, gain)
            return np.empty((0, self.problem.n_layers), dtype=np.int64)
        if req.kind == "eval_batch":            # plain eval, no pooling
            return req.paths
        if req.kind == "dp":
            self._raw = raw
            pend = raw if req.eval_n is None else raw[:req.eval_n]
        elif req.kind == "kbest":
            paths, counts = raw
            pend = [p for per_mu in kbest_rows_to_lists(paths, counts)
                    for p in per_mu]
        else:                                   # "eval": no kernel ran
            pend = req.paths
        if isinstance(pend, np.ndarray):
            pend = pend.tolist()
        keys = [tuple(p) for p in pend]
        fresh: list[tuple] = []
        fresh_set: set[tuple] = set()
        for key in keys:
            if key not in self.seen and key not in fresh_set:
                fresh.append(key)
                fresh_set.add(key)
        self._pending_keys = keys
        self._fresh = fresh
        if not fresh:
            return np.empty((0, self.problem.n_layers), dtype=np.int64)
        return np.asarray([list(key) for key in fresh], dtype=np.int64)

    def take_rows(self, batch: dict[str, np.ndarray] | None) -> None:
        """Consume the finished evaluation batch of this task's fresh
        paths (the :meth:`~repro_torch.core.problem.ScheduleProblem
        .finish_costs` slice the scheduler computed for the whole
        bucket), update the pool, and advance the machine one round."""
        req = self.request
        if req.kind == "moves":
            resp = self._raw
            self._raw = None
            self._advance(resp)
            return
        if req.kind == "eval_batch":
            self._advance(batch)
            return
        if self._fresh:
            for j, key in enumerate(self._fresh):
                self.seen[key] = ScheduleProblem.result_row(batch, j)
            self.stats.candidates_evaluated += len(self._fresh)
        rows = [self.seen[key] for key in self._pending_keys]
        if req.kind == "dp":
            resp = (self._raw, rows)
        elif req.kind == "eval":
            resp = rows
        else:
            resp = None
        self._pending_keys = self._fresh = self._raw = None
        self._advance(resp)

    def candidates(self) -> list[dict]:
        """The ≤k best distinct goal-feasible paths, exactly as
        :func:`solve_lambda_dp` (or, under a budget goal,
        :func:`solve_budget_dp`) would have returned them."""
        if self._budget is not None:
            return budget_candidates(self.seen.values(), self._budget,
                                     self.k_candidates)
        feas = sorted((r for r in self.seen.values() if r["feasible"]),
                      key=lambda r: r["e_total"])
        return feas[:self.k_candidates]

    def finalize(self) -> dict | None:
        """Default finalization for the scheduler: the best feasible
        candidate — exactly ``solve_lambda_dp``'s ``best`` — annotated
        with this task's rails and λ*, or None when infeasible.
        Subclasses override to run their per-subset post-processing
        (see ``repro_torch.core.policies._PfdnnStackedTask``)."""
        if not self.ok:
            return None
        candidates = self.candidates()
        if not candidates:
            return None
        best = dict(candidates[0])
        best["rails"] = self.rails
        best["lambda_star"] = self.stats.lambda_star
        return best
