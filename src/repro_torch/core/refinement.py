"""Local refinement (paper §4.3).

The λ-weighted search can miss minimum-energy feasible schedules that no
λ represents (the Lagrangian duality gap of the discrete problem).  The
compiler therefore takes up to ten feasible candidate paths and greedily
applies up to eight single-layer replacement moves — each move chosen
across *all* layers and *all* alternative states, accepted only if it
reduces total energy while preserving the deadline (and, implicitly, the
rail subset: candidate states are already restricted to R).

The move search is fully vectorized AND batched over candidates: each
pass scores all C·L·S candidate replacements as one padded [C, L, S_max]
tensor (Δ op cost, Δ adjacent transitions, Δ idle energy from the slack
change) and every still-active candidate applies its own global-argmin
move — matching the legacy per-candidate scalar loop up to exact ties:
both keep the earliest (layer, state) among equal-gain moves, but where
the scalar loop required a later layer to beat the incumbent gain by
>1e-18 to win, the global argmin takes any strictly smaller Δ (the
golden tests pin that schedules are unchanged on the shipped configs).

§6.5: refinement costs ≈3–6× the bare λ-DP and closes the optimality gap
from 1.43% to 0.04% of the ILP oracle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.problem import ScheduleProblem


def move_deltas(problem: ScheduleProblem, path: list[int], i: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """ΔT_infer and Δ(E_op+E_trans) for replacing layer i's state with
    every alternative, holding the rest of the path fixed.

    Shared move-scoring primitive: :func:`refine_paths` batches the same
    computation over candidates, and
    :func:`repro_torch.core.greedy.solve_greedy` uses it for its
    marginal-utility ascent."""
    ti, ei = problem.op_arrays(i)
    cur = path[i]
    d_t = ti - ti[cur]
    d_e = ei - ei[cur]
    if i > 0:
        tt, et = problem.transition_arrays(i - 1)
        d_t = d_t + tt[path[i - 1], :] - tt[path[i - 1], cur]
        d_e = d_e + et[path[i - 1], :] - et[path[i - 1], cur]
    if i + 1 < problem.n_layers:
        tt, et = problem.transition_arrays(i)
        d_t = d_t + tt[:, path[i + 1]] - tt[cur, path[i + 1]]
        d_e = d_e + et[:, path[i + 1]] - et[cur, path[i + 1]]
    return d_t, d_e


def move_scores(stacked, lanes: np.ndarray, pa: np.ndarray,
                t_infer: np.ndarray, e_idle: np.ndarray,
                t_max: float, idle) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Score every (candidate, layer, state) single-layer replacement
    of P candidate rows living on lanes of a
    :class:`~repro_torch.core.backend.StackedArrays`.

    Returns per-row ``(layer, state, gain)`` of the best move (the
    global argmin over the row's padded [L, S] move tensor).  Rows are
    independent — per-row results are bit-identical no matter how rows
    are grouped into calls, and identical to scoring on the row's own
    (narrower) padded bucket: pad entries are masked to inf and the
    layer-major argmin tie order is S-invariant.
    """
    n_layers = stacked.n_layers
    s_pad = stacked.s_pad
    ln = lanes[:, None]
    li = np.arange(n_layers)[None, :]
    lt = np.arange(max(n_layers - 1, 0))[None, :]
    t_op = stacked.t_op[lanes]                          # [P, L, S]
    e_op = stacked.e_op[lanes]
    # [P, L, S] move tensors, same accumulation order as the scalar
    # move deltas: Δop, then the inbound edge, then the outbound
    d_t = t_op - stacked.t_op[ln, li, pa][:, :, None]
    d_e = e_op - stacked.e_op[ln, li, pa][:, :, None]
    if n_layers > 1:
        prev, cur_t = pa[:, :-1], pa[:, 1:]             # inbound, i ≥ 1
        d_t[:, 1:, :] += stacked.t_trans[ln, lt, prev, :]
        d_t[:, 1:, :] -= stacked.t_trans[ln, lt, prev, cur_t][:, :, None]
        d_e[:, 1:, :] += stacked.e_trans[ln, lt, prev, :]
        d_e[:, 1:, :] -= stacked.e_trans[ln, lt, prev, cur_t][:, :, None]
        cur_h, nxt = pa[:, :-1], pa[:, 1:]              # outbound, i < L-1
        d_t[:, :-1, :] += stacked.t_trans[ln, lt, :, nxt]
        d_t[:, :-1, :] -= stacked.t_trans[ln, lt, cur_h, nxt][:, :, None]
        d_e[:, :-1, :] += stacked.e_trans[ln, lt, :, nxt]
        d_e[:, :-1, :] -= stacked.e_trans[ln, lt, cur_h, nxt][:, :, None]
    # padded states are not real moves: ΔT → inf makes them
    # infeasible, which the feasibility mask turns into Δ = inf.
    # From here on everything is computed in place on d_t / d_e — the
    # [P, L, S] move tensors are the refinement hot loop and each saved
    # pass is measurable on deep networks
    np.copyto(d_t, np.inf, where=~stacked.valid[lanes])
    d_t += t_infer[:, None, None]                       # d_t is now new_t
    feasible = d_t <= t_max + 1e-15
    # Δ total energy includes the idle-energy change from ΔT
    np.subtract(t_max, d_t, out=d_t)                    # ... now new slack
    d_idle = idle.energy_batch(d_t)
    d_idle -= e_idle[:, None, None]
    # d_e + (e_idle_new − e_idle): the pre-inplace exact association
    d_e += d_idle
    np.copyto(d_e, np.inf, where=~feasible)
    rows_ix = np.arange(pa.shape[0])
    d_e[rows_ix[:, None], li, pa] = np.inf              # no-ops
    flat = d_e.reshape(pa.shape[0], -1)
    best = np.argmin(flat, axis=1)
    gain = -flat[rows_ix, best]
    return best // s_pad, best % s_pad, gain


def refine_rounds(problem: ScheduleProblem,
                  paths: Sequence[Sequence[int]],
                  max_moves: int = 8):
    """The refinement loop as a resumable state machine (generator).

    Yields :class:`~repro_torch.core.lambda_dp.WorkRequest` rounds — ``kind
    "moves"`` (score all replacements of the active rows, answered with
    :func:`move_scores` output) and ``kind "eval_batch"`` (plain batch
    evaluation, answered with the :meth:`evaluate_paths`-format dict) —
    and returns ``(evaluations, moves)``.  The sequential
    :func:`refine_paths` and the subset-stacked sweep drive this one
    implementation, so refined schedules are identical however rounds
    are batched across rail subsets.
    """
    from repro_torch.core.lambda_dp import WorkRequest

    p = np.asarray([list(path) for path in paths], dtype=np.int64)
    n_cand, n_layers = p.shape
    assert n_layers == problem.n_layers
    ev = yield WorkRequest("eval_batch", paths=p.copy())
    t_infer = ev["t_infer"].copy()
    e_idle = ev["e_idle"].copy()
    moves = np.zeros(n_cand, dtype=np.int64)
    active = np.full(n_cand, max_moves > 0, dtype=bool)

    while True:
        act = np.nonzero(active)[0]
        if act.size == 0:
            break
        pa = p[act]                                     # [A, L]
        layer, state, gain = yield WorkRequest(
            "moves", paths=pa, aux=(t_infer[act], e_idle[act]))
        accept = gain > 1e-18
        active[act[~accept]] = False
        rows = act[accept]
        if rows.size == 0:
            break
        p[rows, layer[accept]] = state[accept]
        moves[rows] += 1
        ev2 = yield WorkRequest("eval_batch", paths=p[rows].copy())
        t_infer[rows] = ev2["t_infer"]
        e_idle[rows] = ev2["e_idle"]
        active[rows] = moves[rows] < max_moves

    final = yield WorkRequest("eval_batch", paths=p.copy())
    results = [ScheduleProblem.result_row(final, c) for c in range(n_cand)]
    return results, [int(m) for m in moves]


def budget_refine_rounds(problem: ScheduleProblem, start: dict,
                         budget: float, max_moves: int = 8):
    """Dual-goal refinement: greedy single-layer replacements that
    reduce ``(t_infer, e_total)`` lexicographically while keeping the
    inference energy within ``budget``.

    Yields ``eval_batch`` :class:`~repro_torch.core.lambda_dp.WorkRequest`
    rounds (all replacements of the incumbent path, evaluated in one
    shot) and returns ``(best_row, moves)``.  The move objective is
    time, not energy, so the primal's analytic move scorer
    (:func:`move_scores`) does not apply — each round is one batched
    path evaluation instead.
    """
    from repro_torch.core.lambda_dp import WorkRequest

    best = start
    moves = 0
    sizes = problem.sizes
    while moves < max_moves:
        path = best["path"]
        variants = []
        for i, n in enumerate(sizes):
            for s in range(n):
                if s != path[i]:
                    v = list(path)
                    v[i] = s
                    variants.append(v)
        if not variants:
            break
        ev = yield WorkRequest(
            "eval_batch", paths=np.asarray(variants, dtype=np.int64))
        e_infer = ev["e_op"] + ev["e_trans"]
        within = e_infer <= budget
        if not within.any():
            break
        t = np.where(within, ev["t_infer"], np.inf)
        j = int(np.lexsort((ev["e_total"], t))[0])
        cand = ScheduleProblem.result_row(ev, j)
        if (cand["t_infer"], cand["e_total"]) < (best["t_infer"],
                                                 best["e_total"]):
            best = cand
            moves += 1
        else:
            break
    return best, moves


def refine_paths(problem: ScheduleProblem,
                 paths: Sequence[Sequence[int]],
                 max_moves: int = 8) -> tuple[list[dict], list[int]]:
    """Refine C candidate paths together; returns (evaluations, moves).

    Each candidate independently applies its best single-layer
    replacement per pass until no move gains energy or ``max_moves`` is
    reached; the passes are batched so one numpy sweep scores every
    (candidate, layer, state) replacement at once (sequential runner of
    :func:`refine_rounds`, on the host like the stacked sweep's move
    scoring).
    """
    from repro_torch.core.backend import _single_lane

    gen = refine_rounds(problem, paths, max_moves)
    resp = None
    stacked = None
    while True:
        try:
            req = gen.send(resp)
        except StopIteration as stop:
            return stop.value
        if req.kind == "eval_batch":
            resp = problem.evaluate_paths(req.paths)
        else:
            if stacked is None:
                stacked = _single_lane(problem.padded_arrays())
            lanes = np.zeros(len(req.paths), dtype=np.int64)
            resp = move_scores(stacked, lanes, req.paths,
                               req.aux[0], req.aux[1],
                               problem.t_max, problem.idle)


def refine_path(problem: ScheduleProblem, path: Sequence[int],
                max_moves: int = 8) -> tuple[dict, int]:
    """Greedy single-layer replacement; returns (evaluation, moves used)."""
    results, moves = refine_paths(problem, [list(path)], max_moves)
    return results[0], moves[0]


def refine_candidates(problem: ScheduleProblem, candidates: Sequence[dict],
                      max_candidates: int = 10,
                      max_moves: int = 8) -> tuple[dict, int]:
    """Refine each candidate path; return the best result overall."""
    cands = list(candidates)[:max_candidates]
    assert cands, "refine_candidates needs ≥1 candidate"
    results, moves = refine_paths(
        problem, [c["path"] for c in cands], max_moves)
    best = results[0]
    for refined in results[1:]:
        if refined["e_total"] < best["e_total"]:
            best = refined
    return best, sum(moves)
