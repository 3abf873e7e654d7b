"""Layer-wise marginal-utility DVFS heuristic — the paper's ``+greedy``
baseline (§6), inspired by prior accelerator DVFS work [8, 20, 33].

"Starting from the minimum-energy configuration, the heuristic iteratively
applies per-layer voltage adjustments that provide the largest latency
reduction per unit energy increase until the target deadline is met.
While transition overheads are considered during candidate evaluation,
decisions are made locally and independently, without jointly optimizing
power-state assignments across layers."

This is exactly the law-of-equi-marginal-utility policy [3, 34]: spend
energy where it buys the most time.  Its failure mode — the paper's
motivation — is that it cannot see inter-layer coupling (transition costs
of moving *between* rails, shared-rail restrictions across layers).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.problem import ScheduleProblem
from repro_torch.core.refinement import move_deltas


def min_energy_path(problem: ScheduleProblem) -> list[int]:
    """Per-layer independent minimum-energy configuration (greedy start)."""
    return [int(np.argmin(problem.op_arrays(i)[1]))
            for i in range(problem.n_layers)]


def solve_greedy(problem: ScheduleProblem,
                 max_iters: int = 10_000) -> dict | None:
    """Marginal-utility ascent to feasibility; None if it never gets there.

    Each iteration scores every (layer, alternative-state) replacement —
    the same Δ(T, E) move deltas refinement uses, with local transition
    awareness — as one padded [L, S_max] matrix and applies the global
    best latency-per-energy ratio.
    """
    path = min_energy_path(problem)
    ev = problem.evaluate(path)
    n_layers = problem.n_layers
    sizes = list(problem.sizes)
    s_max = max(sizes)
    iters = 0
    while not ev["feasible"] and iters < max_iters:
        iters += 1
        d_t = np.zeros((n_layers, s_max))
        d_e = np.zeros((n_layers, s_max))
        valid = np.zeros((n_layers, s_max), dtype=bool)
        for i in range(n_layers):
            dt_i, de_i = move_deltas(problem, path, i)
            d_t[i, :sizes[i]] = dt_i
            d_e[i, :sizes[i]] = de_i
            valid[i, :sizes[i]] = True
        speedup = -d_t
        cost = d_e
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(
                speedup > 0,
                np.where(cost <= 0, np.inf, speedup / cost),
                -np.inf,
            )
        ratio[~valid] = -np.inf
        ratio[np.arange(n_layers), path] = -np.inf
        flat = int(np.argmax(ratio))
        i, j = divmod(flat, s_max)
        best_ratio = float(ratio[i, j])
        if not np.isfinite(best_ratio):
            return None                      # cannot reach the deadline
        path[i] = j
        ev = problem.evaluate(path)
    if not ev["feasible"]:
        return None
    ev["greedy_iterations"] = iters
    return ev
