"""Run-time executor for compiled PowerSchedules (paper §3.3's
run-time half: the static schedule + pg_manager).

``PowerRuntime`` plays a :class:`PowerSchedule` against the hardware
model: it walks the schedule layer by layer, applies rail switches /
bank gating with their transition costs, accumulates the per-layer
energy/latency ledger, and enforces the deadline.  Because the schedule
is static and the workload deterministic (§2.2), this simulated
execution *is* the deployment semantics — there is no dynamic control
path to diverge from it.

``simulate_interval`` is the one-call version: it returns the interval
ledger and cross-checks the executed ``e_total`` / ``t_infer`` against
the compiler's prediction — beyond float tolerance it raises a
structured :class:`LedgerMismatch`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.edge_builder import build_idle_model
from repro_torch.core.problem import IdleModel
from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.dvfs import V_GATED
from repro_torch.hw.edge40nm import (
    D_COMPUTE,
    D_FEEDER,
    D_RRAM,
    Edge40nmAccelerator,
)
from repro_torch.perfmodel.gating import BankPlan
from repro_torch.perfmodel.layer_costs import LayerCost


@dataclasses.dataclass
class LayerLedger:
    layer: int
    voltages: tuple[float, ...]
    t_op: float
    e_op: float
    t_trans: float
    e_trans: float
    awake_banks: int


@dataclasses.dataclass
class IntervalLedger:
    layers: list[LayerLedger]
    t_infer: float
    e_exec: float
    e_idle: float
    e_total: float
    deadline: float
    met_deadline: bool
    z_active_idle: int
    # layer boundaries whose crossing performs a true rail switch on ≥1
    # domain (gating entries/exits excluded — same semantics as the
    # compiler's ScheduleProblem evaluators)
    n_rail_switches: int = 0


class LedgerMismatch(RuntimeError):
    """Executed ledger disagrees with the compiled schedule's prediction
    beyond float tolerance — the runtime model and the compiler's cost
    model have diverged.  ``field`` is ``"e_total"`` or ``"t_infer"``,
    with the executed and predicted values and the relative error."""

    def __init__(self, *, network: str, policy: str, field: str,
                 executed: float, predicted: float, rtol: float):
        self.network = network
        self.policy = policy
        self.field = field
        self.executed = executed
        self.predicted = predicted
        self.rtol = rtol
        denom = max(abs(predicted), 1e-300)
        self.rel_err = abs(executed - predicted) / denom
        super().__init__(
            f"ledger/schedule mismatch on {field} for "
            f"{network} [{policy}]: executed {executed!r} vs predicted "
            f"{predicted!r} (rel err {self.rel_err:.3e} > rtol {rtol:g})")


class PowerRuntime:
    def __init__(self, schedule: PowerSchedule,
                 costs: Sequence[LayerCost], plan: BankPlan,
                 acc: Edge40nmAccelerator):
        self.schedule = schedule
        self.costs = costs
        self.plan = plan
        self.acc = acc
        gating = any(b < plan.n_banks for b in schedule.awake_banks) \
            or plan.n_banks == 1
        self.idle: IdleModel = build_idle_model(
            acc, plan.n_banks, gating=gating,
            allow_sleep=not schedule.z_active_idle or gating)

    def execute_interval(self) -> IntervalLedger:
        """Execute one inference interval against the compiled
        ``t_max``."""
        deadline = self.schedule.t_max
        acc = self.acc
        tm = acc.transitions()
        dvfs = [acc.dvfs(D_COMPUTE), acc.dvfs(D_FEEDER), acc.dvfs(D_RRAM)]
        ledger: list[LayerLedger] = []
        t = 0.0
        e = 0.0
        n_switches = 0
        prev_v: tuple[float, ...] | None = None
        for i, (cost, volts) in enumerate(
                zip(self.costs, self.schedule.layer_voltages)):
            # transition at the anchor
            t_tr = e_tr = 0.0
            if prev_v is not None:
                t_tr = max(tm.latency(a, b)
                           for a, b in zip(prev_v, volts))
                e_tr = sum(tm.energy(a, b)
                           for a, b in zip(prev_v, volts))
                if any(a != b and a != V_GATED and b != V_GATED
                       for a, b in zip(prev_v, volts)):
                    n_switches += 1
            # op execution at the selected state
            awake = self.schedule.awake_banks[i]
            times = []
            e_dyn = 0.0
            for d, v in enumerate(volts):
                if v == V_GATED:
                    continue
                f = dvfs[d].freq(v)
                times.append(cost.cycles[d] / f if f > 0 else 0.0)
                e_dyn += (cost.dyn_energy_nom[d]
                          * dvfs[d].dyn_energy_scale(v))
            t_op = max(times) if times else 0.0
            wakes = self.plan.wake_events(
                i, gating=awake < self.plan.n_banks)
            t_op += wakes * tm.t_wake
            p_leak = (dvfs[D_COMPUTE].leak_power(volts[D_COMPUTE])
                      + dvfs[D_FEEDER].leak_power(volts[D_FEEDER]))
            if volts[D_RRAM] != V_GATED:
                bank = acc.dvfs(D_RRAM, n_rram_banks=1)
                p_leak += awake * bank.leak_power(volts[D_RRAM])
                e_dyn += wakes * (tm.energy(V_GATED, volts[D_RRAM])
                                  / self.plan.n_banks)
            e_op = e_dyn + p_leak * t_op
            ledger.append(LayerLedger(i, volts, t_op, e_op, t_tr, e_tr,
                                      awake))
            t += t_op + t_tr
            e += e_op + e_tr
            prev_v = volts

        slack = deadline - t
        e_idle = self.idle.energy(max(slack, 0.0))
        return IntervalLedger(
            layers=ledger,
            t_infer=t,
            e_exec=e,
            e_idle=e_idle,
            e_total=e + e_idle,
            deadline=deadline,
            met_deadline=t <= deadline + 1e-15,
            z_active_idle=self.idle.z_choice(max(slack, 0.0)),
            n_rail_switches=n_switches,
        )


def simulate_interval(schedule: PowerSchedule, costs: Sequence[LayerCost],
                      plan: BankPlan, acc: Edge40nmAccelerator, *,
                      check: bool = True, rtol: float = 1e-6
                      ) -> IntervalLedger:
    """Execute one interval and cross-check the executed ledger against
    the compiled schedule's prediction: the executed ``e_total`` and
    ``t_infer`` must equal the compiler's prediction to float precision
    — a divergence beyond ``rtol`` raises a structured
    :class:`LedgerMismatch` (``check=False`` disables the check)."""
    led = PowerRuntime(schedule, costs, plan, acc).execute_interval()
    if check:
        for field, executed, predicted in (
                ("t_infer", led.t_infer, schedule.t_infer),
                ("e_total", led.e_total, schedule.e_total)):
            if abs(executed - predicted) > rtol * max(abs(predicted),
                                                      1e-300):
                raise LedgerMismatch(
                    network=schedule.network, policy=schedule.policy,
                    field=field, executed=executed,
                    predicted=predicted, rtol=rtol)
    return led
