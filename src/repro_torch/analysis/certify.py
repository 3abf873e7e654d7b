"""Independent schedule certification.

The compiler's own evaluators (``repro_torch.core.problem`` /
``repro_torch.core.backend``) are fast, vectorized, master-table-sliced and
heavily shared — precisely the kind of code whose bugs golden pinning
cannot see (a wrong shared evaluator produces wrong goldens that then
"pass").  This module re-derives every claim a :class:`PowerSchedule`
makes from first principles, on purpose in the dumbest possible way:
scalar loops over the hardware spec (``repro_torch.hw``) and the
performance model (``repro_torch.perfmodel``), with **no** imports from
the solver machinery in ``repro_torch.core`` (the artifact dataclass
itself is the one exception — it is the thing being certified).  It is
host float64 numpy in the JAX package's summation order, so its
certificates equal that package's bit for bit; nothing here runs on
the card.

Checks and their typed violations:

  - ``DEADLINE_VIOLATED``   — re-derived T_infer exceeds the recorded
    period while the artifact claims feasibility.
  - ``RAIL_COUNT_EXCEEDED`` — more distinct rails than the compile
    allowed, or a layer driven from a voltage outside the declared
    rail set.
  - ``ILLEGAL_TRANSITION``  — a physically meaningless state: gated
    compute/feeder domain, gated RRAM under a layer that streams
    weights, or a voltage not on the accelerator's menu.
  - ``ENERGY_MISMATCH``     — re-derived E_op/E_trans/E_idle/T_infer
    disagree with the recorded ledger beyond tolerance, or the
    recorded energy dips below the λ-envelope dual lower bound.
  - ``LEDGER_DRIFT``        — internally inconsistent bookkeeping:
    E_total ≠ E_op+E_trans+E_idle, wrong rail-switch count, wrong
    awake-bank counts vs the bank plan, an idle-mode flag that
    contradicts the slack arithmetic, or claimed infeasibility of a
    deadline-holding schedule.

The dual-bound check is weak duality on the λ-relaxation: for any
λ ≥ 0, ``B(λ) = min_path (E_op+E_trans + λ·T_infer) − λ·T_max`` lower
bounds the operational energy of *every* deadline-feasible schedule,
so the certified schedule's gap to ``max_λ B(λ)`` is a one-sided
optimality certificate (reported, not just pass/fail).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Sequence

import numpy as np

from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.dvfs import V_GATED
from repro_torch.hw.edge40nm import (
    D_COMPUTE,
    D_FEEDER,
    D_RRAM,
    EDGE40NM_DEFAULT,
    Edge40nmAccelerator,
)
from repro_torch.perfmodel import characterize_network, plan_banks

DEADLINE_VIOLATED = "DEADLINE_VIOLATED"
RAIL_COUNT_EXCEEDED = "RAIL_COUNT_EXCEEDED"
ILLEGAL_TRANSITION = "ILLEGAL_TRANSITION"
ENERGY_MISMATCH = "ENERGY_MISMATCH"
LEDGER_DRIFT = "LEDGER_DRIFT"

VIOLATION_KINDS = (DEADLINE_VIOLATED, RAIL_COUNT_EXCEEDED,
                   ILLEGAL_TRANSITION, ENERGY_MISMATCH, LEDGER_DRIFT)

#: mirrors the evaluator's deadline slop (problem.finish_costs)
_DEADLINE_EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class Violation:
    kind: str
    where: str          # e.g. "layer 3", "e_trans", "rails"
    detail: str
    recorded: float | None = None
    derived: float | None = None

    def __str__(self) -> str:
        s = f"{self.kind} @ {self.where}: {self.detail}"
        if self.recorded is not None or self.derived is not None:
            s += f" (recorded={self.recorded!r} derived={self.derived!r})"
        return s


@dataclasses.dataclass(frozen=True)
class DualBound:
    """λ-envelope lower bound on E_op + E_trans (weak duality)."""

    lambda_star: float
    bound: float
    energy: float       # the schedule's recorded E_op + E_trans
    gap_abs: float
    gap_rel: float


@dataclasses.dataclass
class Certificate:
    network: str
    policy: str
    ok: bool
    violations: list[Violation]
    derived: dict[str, float]
    dual: DualBound | None = None

    def summary(self) -> str:
        head = (f"certificate[{self.policy}] {self.network}: "
                f"{'PASS' if self.ok else 'FAIL'}")
        if self.dual is not None:
            head += (f"  dual-gap={self.dual.gap_rel * 100:.4f}%"
                     f" (λ*={self.dual.lambda_star:.4g})")
        lines = [head] + [f"  - {v}" for v in self.violations]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "network": self.network,
            "policy": self.policy,
            "ok": self.ok,
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "derived": self.derived,
            "dual": None if self.dual is None
            else dataclasses.asdict(self.dual),
        }


# --------------------------------------------------------------- helpers

def _close(a: float, b: float, rel_tol: float) -> bool:
    return abs(a - b) <= rel_tol * max(abs(a), abs(b), 1e-30)


def _idle_energy_and_z(acc: Edge40nmAccelerator, n_banks: int, *,
                       gating: bool, allow_sleep: bool,
                       slack: float) -> tuple[float, int]:
    """Terminal idle interval, re-derived from the accelerator spec
    (§4.2): active idle vs duty-cycled deep sleep."""
    if gating:
        leak = (acc.leak_compute + acc.leak_feeder + acc.leak_rram_bank)
        p_idle = leak * (1.0 + acc.idle_residual_dyn)
    else:
        p_idle = acc.idle_power(n_banks)
    p_sleep = acc.sleep_power(n_banks)
    if slack <= 0:
        return 0.0, 1
    active = p_idle * slack
    if not allow_sleep or slack <= acc.sleep_wake_latency:
        return active, 1
    sleep = acc.sleep_wake_energy + p_sleep * slack
    return min(active, sleep), int(active < sleep)


def _layer_op(cost, layer_idx: int, acc: Edge40nmAccelerator, plan, *,
              volts: Sequence[float], gating: bool
              ) -> tuple[float, float]:
    """Scalar T_op/E_op of one layer at one voltage assignment —
    the module-docstring formulas, one float op at a time, in the
    exact operation order of the compiler's state builder so a clean
    schedule reproduces bit-identical per-layer values."""
    v_c, v_f, v_r = volts
    dvfs_c = acc.dvfs(D_COMPUTE)
    dvfs_f = acc.dvfs(D_FEEDER)
    dvfs_r = acc.dvfs(D_RRAM)
    bank = acc.dvfs(D_RRAM, n_rram_banks=1)
    tm = acc.transitions()

    n_awake = plan.awake_banks(layer_idx, gating)
    wakes = plan.wake_events(layer_idx, gating)
    cyc_c, cyc_f, cyc_r = cost.cycles
    dyn_c, dyn_f, dyn_r = cost.dyn_energy_nom

    t_c = cyc_c / dvfs_c.freq(v_c)
    e_c = dyn_c * dvfs_c.dyn_energy_scale(v_c)
    l_c = dvfs_c.leak_power(v_c)
    t_f = cyc_f / dvfs_f.freq(v_f)
    e_f = dyn_f * dvfs_f.dyn_energy_scale(v_f)
    l_f = dvfs_f.leak_power(v_f)
    if v_r == V_GATED:
        t_r = e_r = l_r = e_wake = 0.0
    else:
        t_r = cyc_r / dvfs_r.freq(v_r)
        e_r = dyn_r * dvfs_r.dyn_energy_scale(v_r)
        l_r = n_awake * bank.leak_power(v_r)
        e_wake = wakes * (tm.energy(V_GATED, v_r) / plan.n_banks)

    t_op = max(max(t_c, t_f), t_r) + wakes * tm.t_wake
    e_op = ((e_c + e_f) + e_r) + ((l_c + l_f) + l_r) * t_op + e_wake
    return t_op, e_op


def _boundary_trans(tm, va: Sequence[float], vb: Sequence[float]
                    ) -> tuple[float, float, int]:
    """Scalar transition cost of one layer boundary: domains switch in
    parallel (latency = max), energies add; a *true* rail switch is a
    voltage change where neither endpoint is gated."""
    t_tr = 0.0
    e_tr = 0.0
    any_switch = False
    for d in range(len(va)):
        a, b = va[d], vb[d]
        t_tr = max(t_tr, tm.latency(a, b))
        e_tr += tm.energy(a, b)
        if a != b and a != V_GATED and b != V_GATED:
            any_switch = True
    return t_tr, e_tr, int(any_switch)


#: gating flag of every shipped policy (data, not solver code) — the
#: primary evidence when recovering the compile's gating mode from an
#: artifact; the awake-bank timeline is cross-checked against it
_POLICY_GATING = {
    "baseline": False, "greedy": False,
    "gating": True, "greedy_gating": True,
    "pfdnn": True, "pfdnn_even": True, "pfdnn_nopp": True, "ilp": True,
}


def _infer_gating(sched: PowerSchedule, plan,
                  violations: list[Violation]) -> bool:
    """Recover the compile's gating flag from the artifact itself —
    the recorded policy name when known, otherwise the awake-bank
    timeline (a gated RRAM voltage is also positive evidence) — and
    cross-check the awake-bank timeline against the bank plan."""
    awake_gated = [plan.awake_banks(i, True)
                   for i in range(len(sched.awake_banks))]
    awake_full = [plan.awake_banks(i, False)
                  for i in range(len(sched.awake_banks))]
    any_gated_volts = any(v[D_RRAM] == V_GATED
                          for v in sched.layer_voltages)
    recorded = list(sched.awake_banks)
    flag = _POLICY_GATING.get(sched.policy)
    if flag is None:
        if recorded == awake_gated and (recorded != awake_full
                                        or any_gated_volts):
            flag = True
        elif recorded == awake_full and not any_gated_volts:
            flag = False
        else:
            flag = any_gated_volts or recorded == awake_gated
    expected = awake_gated if flag else awake_full
    for i, (got, want) in enumerate(zip(recorded, expected)):
        if got != want:
            violations.append(Violation(
                LEDGER_DRIFT, f"awake_banks[{i}]",
                "awake-bank count contradicts the RRAM bank plan",
                recorded=float(got), derived=float(want)))
    return flag


# --------------------------------------------------------------- certify

def certify(sched: PowerSchedule, specs, *,
            acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
            n_max_rails: int | None = None,
            gating: bool | None = None,
            allow_sleep: bool | None = None,
            e_switch_nom: float | None = None,
            cost_model=None,
            dual: bool = True,
            rel_tol: float = 1e-9) -> Certificate:
    """Re-derive every claim of ``sched`` for network ``specs`` and
    return a :class:`Certificate` (see module docstring).

    ``gating``/``allow_sleep`` override the inference from the
    artifact's awake-bank timeline (all shipped policies use
    ``allow_sleep == gating``).  ``cost_model`` must be passed for
    artifacts compiled under a calibrated model (``sched.cost_model``
    records the digest).
    """
    violations: list[Violation] = []
    costs = characterize_network(specs, acc)
    if cost_model is not None:
        if getattr(cost_model, "digest", None) != sched.cost_model:
            violations.append(Violation(
                LEDGER_DRIFT, "cost_model",
                f"artifact records cost model {sched.cost_model!r} but "
                f"was certified under {getattr(cost_model, 'digest', None)!r}"))
        costs = cost_model.apply(costs)
    elif sched.cost_model != "static":
        raise ValueError(
            f"schedule was compiled under calibrated cost model "
            f"{sched.cost_model!r}; pass cost_model= to certify it")
    plan = plan_banks(costs, acc)
    tm = acc.transitions(e_switch_nom)

    def cert(ok: bool, derived: dict | None = None,
             dual_bound: DualBound | None = None) -> Certificate:
        return Certificate(network=sched.network, policy=sched.policy,
                           ok=ok, violations=violations,
                           derived=derived or {}, dual=dual_bound)

    # ---- structural sanity (anything here is fatal for derivation)
    n_layers = len(costs)
    if len(sched.layer_voltages) != n_layers \
            or len(sched.awake_banks) != n_layers:
        violations.append(Violation(
            LEDGER_DRIFT, "layers",
            f"network has {n_layers} layers but the artifact carries "
            f"{len(sched.layer_voltages)} voltage rows / "
            f"{len(sched.awake_banks)} awake-bank entries"))
        return cert(False)
    if any(len(v) != len(sched.domains) for v in sched.layer_voltages):
        violations.append(Violation(
            LEDGER_DRIFT, "domains",
            "a voltage row does not cover every domain"))
        return cert(False)
    if not sched.rails:
        violations.append(Violation(
            LEDGER_DRIFT, "rails", "empty rail set"))
        return cert(False)

    # ---- rail-set and voltage legality
    levels = set(acc.levels())
    rail_set = set(sched.rails)
    for r in sched.rails:
        if r not in levels:
            violations.append(Violation(
                ILLEGAL_TRANSITION, "rails",
                f"declared rail {r} V is not on the accelerator's "
                f"voltage menu", recorded=r))
    if n_max_rails is not None and len(rail_set) > n_max_rails:
        violations.append(Violation(
            RAIL_COUNT_EXCEEDED, "rails",
            f"{len(rail_set)} distinct rails exceed the compile's "
            f"limit of {n_max_rails}",
            recorded=float(len(rail_set)), derived=float(n_max_rails)))

    if gating is None:
        gating = _infer_gating(sched, plan, violations)
    if allow_sleep is None:
        allow_sleep = gating

    derivable = True
    for i, volts in enumerate(sched.layer_voltages):
        for d, v in enumerate(volts):
            name = sched.domains[d] if d < len(sched.domains) else str(d)
            if v == V_GATED:
                if d != D_RRAM:
                    violations.append(Violation(
                        ILLEGAL_TRANSITION, f"layer {i}",
                        f"{name} domain cannot be power-gated"))
                    derivable = False
                elif costs[i].weight_bytes != 0 or costs[i].cycles[2] > 0:
                    violations.append(Violation(
                        ILLEGAL_TRANSITION, f"layer {i}",
                        "RRAM gated under a layer that streams weights"))
                    derivable = False
                elif not gating:
                    violations.append(Violation(
                        LEDGER_DRIFT, f"layer {i}",
                        "RRAM gated but the awake-bank timeline says "
                        "gating was disabled"))
                continue
            if v not in levels:
                violations.append(Violation(
                    ILLEGAL_TRANSITION, f"layer {i}",
                    f"{name} voltage {v} V is not on the accelerator's "
                    f"menu", recorded=v))
                derivable = False
            elif v not in rail_set:
                violations.append(Violation(
                    RAIL_COUNT_EXCEEDED, f"layer {i}",
                    f"{name} voltage {v} V is outside the declared "
                    f"rail set {tuple(sorted(rail_set))}", recorded=v))
    if not derivable:
        return cert(False)

    # ---- independent re-derivation
    t_ops = np.empty(n_layers)
    e_ops = np.empty(n_layers)
    for i in range(n_layers):
        t_ops[i], e_ops[i] = _layer_op(
            costs[i], i, acc, plan,
            volts=sched.layer_voltages[i], gating=gating)
    t_trs = np.empty(max(n_layers - 1, 0))
    e_trs = np.empty(max(n_layers - 1, 0))
    switches = 0
    for i in range(n_layers - 1):
        t_trs[i], e_trs[i], sw = _boundary_trans(
            tm, sched.layer_voltages[i], sched.layer_voltages[i + 1])
        switches += sw

    e_op = float(np.sum(e_ops))
    t_infer = float(np.sum(t_ops) + np.sum(t_trs))
    e_trans = float(np.sum(e_trs))
    slack = sched.t_max - t_infer
    e_idle, z = _idle_energy_and_z(
        acc, plan.n_banks, gating=gating, allow_sleep=allow_sleep,
        slack=slack)
    e_total = e_op + e_trans + e_idle
    derived = {
        "t_infer": t_infer, "e_op": e_op, "e_trans": e_trans,
        "e_idle": e_idle, "e_total": e_total, "slack": slack,
        "n_rail_switches": switches, "z_active_idle": z,
        "gating": gating, "allow_sleep": allow_sleep,
    }

    # ---- ledger comparison
    for field, rec, der in (("t_infer", sched.t_infer, t_infer),
                            ("e_op", sched.e_op, e_op),
                            ("e_trans", sched.e_trans, e_trans),
                            ("e_idle", sched.e_idle, e_idle),
                            ("e_total", sched.e_total, e_total)):
        if not _close(rec, der, rel_tol):
            violations.append(Violation(
                ENERGY_MISMATCH, field,
                "re-derived value disagrees with the recorded ledger",
                recorded=rec, derived=der))
    internal = sched.e_op + sched.e_trans + sched.e_idle
    if not _close(sched.e_total, internal, rel_tol):
        violations.append(Violation(
            LEDGER_DRIFT, "e_total",
            "E_total ≠ E_op + E_trans + E_idle in the recorded ledger",
            recorded=sched.e_total, derived=internal))
    if sched.n_rail_switches != switches:
        violations.append(Violation(
            LEDGER_DRIFT, "n_rail_switches",
            "rail-switch count disagrees with the voltage timeline",
            recorded=float(sched.n_rail_switches),
            derived=float(switches)))
    if int(sched.z_active_idle) != z and _close(
            sched.e_idle, e_idle, rel_tol):
        # (when e_idle already mismatches, z is subsumed by that)
        violations.append(Violation(
            LEDGER_DRIFT, "z_active_idle",
            "idle-mode flag contradicts the slack arithmetic",
            recorded=float(sched.z_active_idle), derived=float(z)))

    # ---- deadline (the evaluator's 1e-15 slop plus the certifier's
    # relative tolerance — recorded walls may drift from the scalar
    # re-derivation by an ulp under the jitted backends)
    slop = _DEADLINE_EPS + rel_tol * max(abs(sched.t_max), abs(t_infer))
    deadline_ok = t_infer <= sched.t_max + slop
    if sched.feasible and not deadline_ok:
        violations.append(Violation(
            DEADLINE_VIOLATED, "t_infer",
            "schedule claims feasibility but overruns its period",
            recorded=sched.t_max, derived=t_infer))
    elif not sched.feasible and t_infer <= sched.t_max - slop:
        violations.append(Violation(
            LEDGER_DRIFT, "feasible",
            "schedule claims infeasibility yet holds its deadline",
            recorded=0.0, derived=t_infer))

    # ---- dual-bound optimality certificate
    dual_bound = None
    if dual and sched.feasible and deadline_ok:
        dual_bound = dual_energy_bound(
            costs, plan, acc, tm, rails=tuple(sorted(rail_set)),
            gating=gating, t_max=sched.t_max,
            energy=sched.e_op + sched.e_trans,
            lambda_hint=sched.solver_stats.get("lambda_star")
            if isinstance(sched.solver_stats, dict) else None)
        if dual_bound.gap_abs < -rel_tol * max(dual_bound.energy, 1e-30):
            violations.append(Violation(
                ENERGY_MISMATCH, "dual_bound",
                "recorded energy dips below the λ-envelope lower "
                "bound — the ledger under-reports",
                recorded=dual_bound.energy, derived=dual_bound.bound))

    return cert(not violations, derived, dual_bound)


# ----------------------------------------------------------- dual bound

def _state_menu(cost, layer_idx: int, acc, plan, rails, *,
                gating: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every feasible (voltages, t_op, e_op) of one layer over
    ``rails`` — the certifier's own enumeration (compute × feeder ×
    rram, gated RRAM option for weightless layers)."""
    r_opts = list(rails)
    volts_rows = []
    t_rows = []
    e_rows = []
    gate_ok = gating and cost.weight_bytes == 0 and cost.cycles[2] == 0
    rram_opts = r_opts + ([V_GATED] if gate_ok else [])
    for v_c in r_opts:
        for v_f in r_opts:
            for v_r in rram_opts:
                t, e = _layer_op(cost, layer_idx, acc, plan,
                                 volts=(v_c, v_f, v_r), gating=gating)
                volts_rows.append((v_c, v_f, v_r))
                t_rows.append(t)
                e_rows.append(e)
    return (np.array(volts_rows), np.array(t_rows), np.array(e_rows))


def dual_energy_bound(costs, plan, acc, tm, *, rails, gating: bool,
                      t_max: float, energy: float,
                      lambda_hint: float | None = None,
                      n_grid: int = 25) -> DualBound:
    """``max_λ B(λ)`` over a λ grid, where ``B(λ) = min_path
    (E + λ·T) − λ·T_max`` (weak duality: a lower bound on the
    operational energy of every deadline-feasible schedule over
    ``rails``).  The inner minimization is a plain forward DP over the
    layered state graph — independent of the solver's λ-DP kernels."""
    menus = [_state_menu(c, i, acc, plan, rails, gating=gating)
             for i, c in enumerate(costs)]
    trans = []
    for i in range(len(menus) - 1):
        va, vb = menus[i][0], menus[i + 1][0]
        t_m = np.empty((len(va), len(vb)))
        e_m = np.empty((len(va), len(vb)))
        for a in range(len(va)):
            for b in range(len(vb)):
                t_m[a, b], e_m[a, b], _ = _boundary_trans(
                    tm, va[a], vb[b])
        trans.append((t_m, e_m))

    def envelope(lam: float) -> float:
        _, t0, e0 = menus[0]
        cur = e0 + lam * t0
        for i in range(len(menus) - 1):
            t_m, e_m = trans[i]
            _, t_n, e_n = menus[i + 1]
            step = cur[:, None] + (e_m + lam * t_m)
            cur = np.min(step, axis=0) + (e_n + lam * t_n)
        return float(np.min(cur)) - lam * t_max

    # λ scale heuristic: trade the full per-layer energy range against
    # the full per-layer time range, then sweep a wide geometric grid
    e_span = sum(float(np.max(m[2]) - np.min(m[2])) for m in menus)
    t_span = sum(float(np.max(m[1]) - np.min(m[1])) for m in menus)
    lam_ref = e_span / t_span if t_span > 0 else 1.0
    grid = [0.0]
    if lambda_hint is not None and np.isfinite(lambda_hint) \
            and lambda_hint >= 0:
        grid.append(float(lambda_hint))
    grid.extend(lam_ref * np.geomspace(1e-3, 1e3, n_grid))
    best_lam, best = 0.0, -np.inf
    for lam in grid:
        b = envelope(lam)
        if b > best:
            best_lam, best = lam, b
    gap_abs = energy - best
    return DualBound(lambda_star=best_lam, bound=best, energy=energy,
                     gap_abs=gap_abs,
                     gap_rel=gap_abs / max(energy, 1e-30))


# ----------------------------------------------------------- store audit

def certify_store(store_or_path, *, rel_tol: float = 1e-9) -> dict:
    """Audit every schedule entry of an artifact store for
    key↔content consistency.

    Accepts an ``ArtifactStore``, a ``DiskTier``, or a tier root path.
    For each persisted schedule entry: the file name must equal the
    content digest of its recorded key, the entry schema must be
    readable, and the payload must parse into an internally consistent
    :class:`PowerSchedule` ledger (or a known infeasibility sentinel).
    Memory-tier entries of an ``ArtifactStore`` get the same payload
    checks.  Digests are recomputed with this package's
    ``entry_digest`` from the key each entry records, so the port's
    keys (whose config part holds ``("backend", "torch")``) audit as
    they were written.  Returns ``{"entries", "ok", "problems": [...]}``.
    """
    from repro_torch.service.disk import (
        DiskTier,
        READABLE_SCHEMAS,
        entry_digest,
    )

    problems: list[dict] = []
    n_entries = 0

    def payload_problems(text: str, where: str) -> None:
        if text == "__infeasible__" \
                or text.startswith("__infeasible_goal__:"):
            return
        try:
            sched = PowerSchedule.from_json(text)
        except (ValueError, KeyError, TypeError) as exc:
            problems.append({"where": where,
                             "detail": f"payload does not parse: {exc}"})
            return
        internal = sched.e_op + sched.e_trans + sched.e_idle
        if not _close(sched.e_total, internal, rel_tol):
            problems.append({
                "where": where,
                "detail": "ledger drift: E_total ≠ E_op+E_trans+E_idle"})
        if sched.feasible and sched.t_infer > sched.t_max + _DEADLINE_EPS:
            problems.append({
                "where": where,
                "detail": "claims feasibility but t_infer > t_max"})

    # memory tier of an ArtifactStore (duck-typed: no service import)
    mem = getattr(store_or_path, "_schedules", None)
    disk = getattr(store_or_path, "disk", store_or_path)
    if mem is not None:
        for key, text in sorted(mem.items(), key=lambda kv: repr(kv[0])):
            n_entries += 1
            where = f"memory:{key!r}"
            if not (isinstance(key, tuple) and len(key) == 3):
                problems.append({
                    "where": where,
                    "detail": "schedule key is not the "
                              "(content, goal, cfg) triple"})
            payload_problems(text, where)

    root = None
    if isinstance(disk, DiskTier):
        root = disk.root
    elif isinstance(disk, (str, pathlib.Path)):
        root = pathlib.Path(disk)
    if root is not None and (root / "schedules").is_dir():
        for path in sorted((root / "schedules").glob("*.json")):
            n_entries += 1
            where = str(path)
            try:
                ent = json.loads(path.read_bytes().decode())
            except (ValueError, OSError) as exc:
                problems.append({"where": where,
                                 "detail": f"unreadable entry: {exc}"})
                continue
            if ent.get("schema") not in READABLE_SCHEMAS:
                problems.append({
                    "where": where,
                    "detail": f"unreadable schema {ent.get('schema')!r}"})
                continue
            key = tuple(ent.get("key", ()))
            digest = entry_digest("schedule", *key)
            if digest != path.stem:
                problems.append({
                    "where": where,
                    "detail": f"key↔content mismatch: recorded key "
                              f"digests to {digest}, file is named "
                              f"{path.stem}"})
            payload_problems(ent.get("payload", ""), where)

    return {"entries": n_entries, "ok": not problems,
            "problems": problems}
