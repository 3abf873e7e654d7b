"""Exact ILP oracles for the §4.2 optimization (paper §4.3 / §6.5).

Used only for validation on small instances — the paper's observation
that ILP "instantiates binary variables and transition constraints over
layer-state pairs" and runs out of memory as the layered graph grows is
reproduced here: the variable count is Σ|S_i| + Σ|S_i||S_{i+1}|, and we
raise ``IlpBlowupError`` past a configurable budget instead of swapping.

Two oracles share one layered-path polytope (:class:`_FlowModel`):

  x[i,s] ∈ {0,1}     layer i uses state s           (Σ_s x[i,s] = 1)
  y[i,a,b] ∈ [0,1]   flow linking consecutive states; with binary x the
                     transportation constraints force y integral.

``solve_ilp`` is the paper's primal (min energy s.t. the deadline, with
the idle/duty-cycle tail):

  u_a, u_s ≥ 0       active-idle / sleep portions of the slack
  z ∈ {0,1}          duty-cycle decision (§4.2), z=1 ⇒ stay active

  min Σ e_op·x + Σ e_trans·y + P_idle·u_a + P_sleep·u_s + E_wake·(1−z)
  s.t. flow conservation, u_a+u_s + Σ t_op·x + Σ t_trans·y = T_max,
       u_a ≤ M·z, u_s ≤ M·(1−z), u_a+u_s ≥ t_wake·(1−z).

``solve_ilp_min_latency`` is the goal API's dual (min time s.t. an
energy budget): deadline-free, so the idle variables drop and the
budget is one knapsack row.

Both run scipy's HiGHS ``milp`` on the host; nothing here touches the
card.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from repro_torch.core.problem import ScheduleProblem


class IlpBlowupError(RuntimeError):
    """Raised when the ILP instance exceeds the variable budget
    (the paper's ILP-out-of-memory regime, §6.5)."""


_MILP_OPTIONS = {"presolve": True, "mip_rel_gap": 0.0}


class _FlowModel:
    """The layered-path polytope both oracles build on: variable
    offsets, the one-state-per-layer assignment rows, and the
    flow-conservation (transportation) rows.  Oracles append their
    goal-specific rows via :meth:`add_row` and extra variables via
    ``n_extra`` (appended after the x/y block)."""

    def __init__(self, problem: ScheduleProblem, *, n_extra: int,
                 max_variables: int):
        self.problem = problem
        L = problem.n_layers
        sizes = list(problem.sizes)
        self.L, self.sizes = L, sizes
        self.nx = sum(sizes)
        self.ny = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
        self.n = self.nx + self.ny + n_extra
        if self.n > max_variables:
            raise IlpBlowupError(
                f"ILP instance needs {self.n} variables "
                f"(Σ|S_i|={self.nx}, Σ|S_i||S_i+1|={self.ny}) > "
                f"budget {max_variables}")

        self.x_off = np.zeros(L, dtype=int)
        for i in range(1, L):
            self.x_off[i] = self.x_off[i - 1] + sizes[i - 1]
        self.y_off = np.zeros(max(L - 1, 0), dtype=int)
        acc = self.nx
        for i in range(L - 1):
            self.y_off[i] = acc
            acc += sizes[i] * sizes[i + 1]

        self._rows: list[int] = []
        self._cols: list[int] = []
        self._vals: list[float] = []
        self._lb: list[float] = []
        self._ub: list[float] = []
        self.r = 0

        # one state per layer
        for i in range(L):
            idx = list(range(self.x_off[i], self.x_off[i] + sizes[i]))
            self.add_row(idx, [1.0] * sizes[i], 1.0, 1.0)
        # flow conservation
        for i in range(L - 1):
            sa, sb = sizes[i], sizes[i + 1]
            for a in range(sa):
                idx = [self.y_off[i] + a * sb + b for b in range(sb)]
                idx.append(self.x_off[i] + a)
                self.add_row(idx, [1.0] * sb + [-1.0], 0.0, 0.0)
            for b in range(sb):
                idx = [self.y_off[i] + a * sb + b for a in range(sa)]
                idx.append(self.x_off[i + 1] + b)
                self.add_row(idx, [1.0] * sa + [-1.0], 0.0, 0.0)

    def add_row(self, idx, coef, lo, hi) -> None:
        self._rows.extend([self.r] * len(idx))
        self._cols.extend(idx)
        self._vals.extend(coef)
        self._lb.append(lo)
        self._ub.append(hi)
        self.r += 1

    def xy_terms(self, component: int) -> tuple[list[int], list[float]]:
        """Indices + raw coefficients of Σ c_op·x + Σ c_trans·y where
        ``component`` selects (0 = time, 1 = energy) from the problem's
        op/transition arrays — the linear form every objective and
        budget row in both oracles is built from."""
        idx: list[int] = []
        coef: list[float] = []
        for i in range(self.L):
            arrs = self.problem.op_arrays(i)
            idx.extend(range(self.x_off[i],
                             self.x_off[i] + self.sizes[i]))
            coef.extend(np.asarray(arrs[component], dtype=float))
        for i in range(self.L - 1):
            mats = self.problem.transition_arrays(i)
            idx.extend(range(self.y_off[i],
                             self.y_off[i] + mats[component].size))
            coef.extend(mats[component].ravel())
        return idx, coef

    def constraints(self) -> LinearConstraint:
        a_mat = sp.csr_matrix((self._vals, (self._rows, self._cols)),
                              shape=(self.r, self.n))
        return LinearConstraint(a_mat, np.array(self._lb),
                                np.array(self._ub))

    def integrality(self, *extra_int: int) -> np.ndarray:
        out = np.zeros(self.n)
        out[:self.nx] = 1             # x binary; y continuous (TU flow)
        for i in extra_int:
            out[i] = 1
        return out

    def extract_path(self, x: np.ndarray) -> list[int]:
        path = []
        for i in range(self.L):
            xs = x[self.x_off[i]:self.x_off[i] + self.sizes[i]]
            path.append(int(np.argmax(xs)))
        return path


def solve_ilp(problem: ScheduleProblem, *, time_limit: float = 300.0,
              max_variables: int = 2_000_000) -> dict:
    """Solve the primal exactly; returns the standard evaluation dict +
    solver info."""
    tic = time.perf_counter()
    m = _FlowModel(problem, n_extra=3, max_variables=max_variables)
    L = m.L

    # Normalize units to O(1): raw instances mix joules (1e-4), transition
    # joules (1e-9) and seconds (1e-2..1e-6), which trips MIP feasibility/
    # gap tolerances.  Scale time by 1/T_max and energy by 1/ΣE_op(min).
    t_scale = 1.0 / problem.t_max
    e_ref = sum(float(np.min(problem.op_arrays(i)[1])) for i in range(L))
    e_scale = 1.0 / max(e_ref, 1e-30)
    iu_a, iu_s, iz = m.n - 3, m.n - 2, m.n - 1

    idle = problem.idle
    tmax = problem.t_max
    big_m = tmax

    # ---- objective ----
    c = np.zeros(m.n)
    e_idx, e_coef = m.xy_terms(1)
    c[e_idx] = np.asarray(e_coef) * e_scale
    # u_a/u_s live in scaled time units → power coefficients get e/t scale
    c[iu_a] = idle.p_idle * e_scale / t_scale
    c[iu_s] = idle.p_sleep * e_scale / t_scale
    c[iz] = -idle.e_sleep_wake * e_scale  # +E_wake·(1−z) → const + (−E_wake)z
    obj_const = idle.e_sleep_wake * e_scale

    # time budget: Σ t_op x + Σ t_trans y + u_a + u_s = T_max
    t_idx, t_coef = m.xy_terms(0)
    m.add_row(t_idx + [iu_a, iu_s],
              [v * t_scale for v in t_coef] + [1.0, 1.0],
              tmax * t_scale, tmax * t_scale)

    # idle-branch switching (scaled time units; M = scaled deadline = 1)
    m_s = big_m * t_scale
    m.add_row([iu_a, iz], [1.0, -m_s], -np.inf, 0.0)          # u_a ≤ M z
    m.add_row([iu_s, iz], [1.0, m_s], -np.inf, m_s)           # u_s ≤ M(1−z)
    if idle.t_sleep_wake > 0:
        tw = idle.t_sleep_wake * t_scale
        m.add_row([iu_a, iu_s, iz], [1.0, 1.0, tw], tw, np.inf)

    lb = np.zeros(m.n)
    ub = np.ones(m.n)
    ub[iu_a] = ub[iu_s] = tmax * t_scale
    if not idle.allow_sleep:
        lb[iz] = 1.0

    res = milp(c=c, constraints=m.constraints(),
               integrality=m.integrality(iz), bounds=Bounds(lb, ub),
               options=dict(_MILP_OPTIONS, time_limit=time_limit))
    wall = time.perf_counter() - tic
    if res.status != 0 or res.x is None:
        return {"feasible": False, "status": int(res.status),
                "message": str(res.message), "wall_time_s": wall}

    out = problem.evaluate(m.extract_path(res.x))
    out["ilp_objective"] = float((res.fun + obj_const) / e_scale)
    out["wall_time_s"] = wall
    out["n_variables"] = m.n
    return out


def solve_ilp_min_latency(problem: ScheduleProblem, budget: float, *,
                          time_limit: float = 300.0,
                          max_variables: int = 2_000_000) -> dict:
    """Exact dual oracle: min ``T_infer`` s.t. ``E_op + E_trans ≤
    budget`` (the goal API's MinLatency scenario).

    The deadline-free dual has no terminal idle interval, so the
    formulation drops the ``u_a/u_s/z`` idle variables: the shared
    path polytope plus one knapsack row for the budget.  The problem
    should be built deadline-free (``t_max=0``); returns the standard
    evaluation dict (``feasible`` = a within-budget schedule exists) +
    solver info.
    """
    tic = time.perf_counter()
    m = _FlowModel(problem, n_extra=0, max_variables=max_variables)

    # normalize to O(1): time by 1/Σ t_op(min), energy by 1/budget
    t_ref = sum(float(np.min(problem.op_arrays(i)[0]))
                for i in range(m.L))
    t_scale = 1.0 / max(t_ref, 1e-30)
    e_scale = 1.0 / max(budget, 1e-30)

    # ---- objective: total inference time ----
    c = np.zeros(m.n)
    t_idx, t_coef = m.xy_terms(0)
    c[t_idx] = np.asarray(t_coef) * t_scale

    # energy budget: Σ e_op x + Σ e_trans y ≤ B
    e_idx, e_coef = m.xy_terms(1)
    m.add_row(e_idx, [v * e_scale for v in e_coef],
              -np.inf, budget * e_scale)

    res = milp(c=c, constraints=m.constraints(),
               integrality=m.integrality(),
               bounds=Bounds(np.zeros(m.n), np.ones(m.n)),
               options=dict(_MILP_OPTIONS, time_limit=time_limit))
    wall = time.perf_counter() - tic
    if res.status != 0 or res.x is None:
        return {"feasible": False, "status": int(res.status),
                "message": str(res.message), "wall_time_s": wall}

    out = problem.evaluate(m.extract_path(res.x))
    # deadline-free evaluation flags everything infeasible (t_max=0);
    # the dual's feasibility is the budget, honored by construction
    out["feasible"] = True
    out["ilp_objective"] = float(res.fun / t_scale)
    out["wall_time_s"] = wall
    out["n_variables"] = m.n
    return out
