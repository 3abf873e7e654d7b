"""Run-time executor for compiled PowerSchedules (paper §3.3's
run-time half: the static schedule + pg_manager).

``PowerRuntime`` plays a :class:`PowerSchedule` against the hardware
model: it walks the schedule layer by layer, applies rail switches /
bank gating with their transition costs, accumulates the per-layer
energy/latency ledger, and enforces the deadline.  Because the schedule
is static and the workload deterministic (§2.2), this simulated
execution *is* the deployment semantics in the fault-free case — there
is no dynamic control path to diverge from it.

Online, the world does diverge: ``execute_interval`` accepts a seeded
:class:`~repro_torch.serve.faults.IntervalFaults` perturbation
(layer-cost error, transition-latency overrun, dropped / late frames)
and an explicit ``deadline_s`` override so the adaptive control plane
(:mod:`repro_torch.serve.control_plane`) can execute any precompiled
schedule against the *current* traffic interval rather than the
deadline it was compiled for.

``simulate_interval`` is the one-call version: it returns the interval
ledger and cross-checks the executed ``e_total`` / ``t_infer`` against
the compiler's prediction — beyond float tolerance it raises a
structured :class:`LedgerMismatch` (the check is skipped when faults or
a deadline override intentionally diverge the execution).
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
from repro_torch.serve.faults import IntervalFaults


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
    # fault-injection provenance: arrival delay charged against this
    # interval's budget, and whether the frame never arrived at all
    # (a dropped frame executes nothing and cannot miss its deadline)
    t_late: float = 0.0
    dropped: bool = False


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

    def execute_interval(self, *, faults: IntervalFaults | None = None,
                         deadline_s: float | None = None
                         ) -> IntervalLedger:
        """Execute one inference interval.

        ``faults`` applies a seeded perturbation (see
        :mod:`repro_torch.serve.faults`): per-layer op time+energy and
        transition-latency scale factors, an arrival delay charged
        against the interval budget, or a dropped frame (nothing
        executes; the whole interval idles).  ``deadline_s`` executes
        the schedule against an external deadline (the adaptive plane's
        current traffic interval) instead of the compiled ``t_max`` —
        the terminal idle/slack accounting follows it.
        """
        deadline = self.schedule.t_max if deadline_s is None \
            else float(deadline_s)
        late = faults.late_s if faults is not None else 0.0
        if faults is not None and faults.dropped:
            # the frame never arrived: no execution, the interval is
            # one long idle stretch (and trivially meets its deadline)
            e_idle = self.idle.energy(deadline)
            return IntervalLedger(
                layers=[], t_infer=0.0, e_exec=0.0, e_idle=e_idle,
                e_total=e_idle, deadline=deadline, met_deadline=True,
                z_active_idle=self.idle.z_choice(deadline),
                n_rail_switches=0, t_late=0.0, dropped=True)
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
                if faults is not None:
                    t_tr *= float(faults.trans_scale[i])
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
            if faults is not None:
                # cost-model error scales the layer's work: time and
                # energy move together (more cycles at the same state)
                s = float(faults.op_scale[i])
                t_op *= s
                e_op *= s
            ledger.append(LayerLedger(i, volts, t_op, e_op, t_tr, e_tr,
                                      awake))
            t += t_op + t_tr
            e += e_op + e_tr
            prev_v = volts

        slack = deadline - t - late
        e_idle = self.idle.energy(max(slack, 0.0))
        return IntervalLedger(
            layers=ledger,
            t_infer=t,
            e_exec=e,
            e_idle=e_idle,
            e_total=e + e_idle,
            deadline=deadline,
            met_deadline=t + late <= deadline + 1e-15,
            z_active_idle=self.idle.z_choice(max(slack, 0.0)),
            n_rail_switches=n_switches,
            t_late=late,
        )


def simulate_interval(schedule: PowerSchedule, costs: Sequence[LayerCost],
                      plan: BankPlan, acc: Edge40nmAccelerator, *,
                      faults: IntervalFaults | None = None,
                      deadline_s: float | None = None,
                      check: bool = True, rtol: float = 1e-6
                      ) -> IntervalLedger:
    """Execute one interval and cross-check the executed ledger against
    the compiled schedule's prediction.

    In the fault-free, native-deadline case the executed ``e_total``
    and ``t_infer`` must equal the compiler's prediction to float
    precision — a divergence beyond ``rtol`` raises a structured
    :class:`LedgerMismatch`.  With ``faults`` or a ``deadline_s``
    override the execution diverges *by design* and the cross-check is
    skipped (``check=False`` disables it explicitly).
    """
    led = PowerRuntime(schedule, costs, plan, acc).execute_interval(
        faults=faults, deadline_s=deadline_s)
    if check and faults is None and deadline_s is None:
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
