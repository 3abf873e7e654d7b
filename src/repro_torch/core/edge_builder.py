"""Build a :class:`ScheduleProblem` for the 40nm edge accelerator.

This is the compiler front-end of §3.3: given the characterized layer
costs (cycle counts + per-event energies from the performance model) and
the RRAM bank plan (gating analysis), enumerate each layer's feasible
operating states under a rail subset R and attach T_op/E_op.

State semantics for layer i under voltages (V_c, V_f, V_r):
  T_op  = max_d cycles_d / f_d(V_d)       (ping-pong pipelined domains)
          + wake_events·t_wake            (bank wake anchors, §3.2)
  E_op  = Σ_d E_dyn,d·(V_d/V_nom)²        (first-order V² scaling, §5.2)
          + [P_leak,c(V_c) + P_leak,f(V_f) + n_awake·P_leak,bank(V_r)]·T_op
          + wake_events·E_bank_wake(V_r)

Weightless layers (pool/eltwise/residual-add) may fully gate the RRAM
domain (V_r = 0) when gating is enabled — RRAM is non-volatile, so no
state is lost (§1's motivation for RRAM-based weight storage).

``layer_states`` doubles as the master-table builder for
:class:`repro_torch.core.context.CompilationContext`: called with the full
level set it enumerates every state the rail sweep can ever use, and the
per-subset problems are index slices of that table.  The enumeration
order (each domain ascending over its sorted options, gated RRAM last)
is the invariant that makes those slices elementwise identical to a
direct per-subset build — change it only together with
``CompilationContext._subset_indices``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.problem import IdleModel, ScheduleProblem, StateCost
from repro_torch.hw.dvfs import V_GATED
from repro_torch.hw.edge40nm import (
    D_COMPUTE,
    D_FEEDER,
    D_RRAM,
    Edge40nmAccelerator,
)
from repro_torch.perfmodel.gating import BankPlan
from repro_torch.perfmodel.layer_costs import LayerCost


def build_idle_model(acc: Edge40nmAccelerator, n_banks: int, *,
                     gating: bool, allow_sleep: bool) -> IdleModel:
    """Idle power depends on whether the pg_manager can gate banks during
    the inter-inference interval (gating hardware present or not)."""
    if gating:
        # banks gated during idle; pg_manager keeps one bank-equivalent on
        leak = (acc.leak_compute + acc.leak_feeder + acc.leak_rram_bank)
        p_idle = leak * (1.0 + acc.idle_residual_dyn)
    else:
        p_idle = acc.idle_power(n_banks)
    return IdleModel(
        p_idle=p_idle,
        p_sleep=acc.sleep_power(n_banks),
        e_sleep_wake=acc.sleep_wake_energy,
        t_sleep_wake=acc.sleep_wake_latency,
        allow_sleep=allow_sleep,
    )


def layer_states(cost: LayerCost, layer_idx: int, acc: Edge40nmAccelerator,
                 plan: BankPlan, rails: Sequence[float], *,
                 gating: bool) -> list[StateCost]:
    """Per-state :class:`StateCost` list (see module docstring).

    Thin wrapper over :func:`layer_state_arrays` — the array form is the
    master-table hot path; the object list exists for policies and
    reporting code that want per-state records."""
    volts, t_op, e_op = layer_state_arrays(cost, layer_idx, acc, plan,
                                           rails, gating=gating)
    return [StateCost(voltages=(float(v[0]), float(v[1]), float(v[2])),
                      t_op=float(t), e_op=float(e))
            for v, t, e in zip(volts, t_op, e_op)]


def layer_state_arrays(cost: LayerCost, layer_idx: int,
                       acc: Edge40nmAccelerator, plan: BankPlan,
                       rails: Sequence[float], *, gating: bool
                       ) -> tuple:
    """Vectorized :func:`layer_states`: ``(voltages [S, 3], t_op [S],
    e_op [S])`` numpy arrays in the exact enumeration order (and with
    the exact per-element float arithmetic) of the scalar state loop —
    compute-major, feeder, RRAM minor, gated RRAM option last."""
    dvfs_c = acc.dvfs(D_COMPUTE)
    dvfs_f = acc.dvfs(D_FEEDER)
    dvfs_r = acc.dvfs(D_RRAM)     # freq model; leakage handled per-bank
    tm = acc.transitions()

    n_awake = plan.awake_banks(layer_idx, gating)
    wakes = plan.wake_events(layer_idx, gating)
    cyc_c, cyc_f, cyc_r = cost.cycles
    dyn_c, dyn_f, dyn_r = cost.dyn_energy_nom

    rram_options: list[float] = list(rails)
    if gating and cost.weight_bytes == 0:
        rram_options.append(V_GATED)

    # hoist the per-voltage model terms out of the |R|³ state loop —
    # each is a function of a single rail voltage, so |R| evaluations
    # (identical floats) cover all |R|³ states.  This is the master-
    # table hot path: it runs once per layer per compile, over the FULL
    # level set.
    bank = acc.dvfs(D_RRAM, n_rram_banks=1)
    t_wake_ovh = wakes * tm.t_wake        # bank wake anchors: time
    c_tab = [(v_c, cyc_c / f_c, dyn_c * dvfs_c.dyn_energy_scale(v_c),
              dvfs_c.leak_power(v_c))
             for v_c in rails if (f_c := dvfs_c.freq(v_c)) > 0]
    f_tab = [(v_f, cyc_f / f_f, dyn_f * dvfs_f.dyn_energy_scale(v_f),
              dvfs_f.leak_power(v_f))
             for v_f in rails if (f_f := dvfs_f.freq(v_f)) > 0]
    r_tab: list[tuple[float, float, float, float, float]] = []
    for v_r in rram_options:
        if v_r == V_GATED:
            if cyc_r > 0:
                continue                  # needs weight streaming
            r_tab.append((V_GATED, 0.0, 0.0, 0.0, 0.0))
            continue
        f_r = dvfs_r.freq(v_r)
        if f_r <= 0:
            continue
        r_tab.append((v_r, cyc_r / f_r,
                      dyn_r * dvfs_r.dyn_energy_scale(v_r),
                      n_awake * bank.leak_power(v_r),
                      wakes * (tm.energy(V_GATED, v_r) / plan.n_banks)))

    if not c_tab or not f_tab or not r_tab:
        return (np.zeros((0, 3)), np.zeros(0), np.zeros(0))
    vc, tc, ec, lc = (np.array(col) for col in zip(*c_tab))
    vf, tf, ef, lf = (np.array(col) for col in zip(*f_tab))
    vr, tr, er, lr, ew = (np.array(col) for col in zip(*r_tab))
    # broadcast the compute×feeder×rram cross product; every elementwise
    # expression mirrors the scalar loop's operation order exactly, so
    # the arrays are bit-identical to the per-state construction
    t_cf = np.maximum(tc[:, None], tf[None, :])           # [C, F]
    e_cf = ec[:, None] + ef[None, :]
    leak_cf = lc[:, None] + lf[None, :]
    t_op = np.maximum(t_cf[:, :, None], tr[None, None, :]) + t_wake_ovh
    e_op = (e_cf[:, :, None] + er[None, None, :]) \
        + (leak_cf[:, :, None] + lr[None, None, :]) * t_op \
        + ew[None, None, :]
    volts = np.empty(t_op.shape + (3,))
    volts[..., 0] = vc[:, None, None]
    volts[..., 1] = vf[None, :, None]
    volts[..., 2] = vr[None, None, :]
    return volts.reshape(-1, 3), t_op.ravel(), e_op.ravel()


def build_edge_problem(
    costs: Sequence[LayerCost],
    plan: BankPlan,
    acc: Edge40nmAccelerator,
    rails: Sequence[float],
    t_max: float,
    *,
    gating: bool = True,
    allow_sleep: bool = True,
    e_switch_nom: float | None = None,
    name: str = "",
) -> ScheduleProblem:
    layers = [layer_states(c, i, acc, plan, rails, gating=gating)
              for i, c in enumerate(costs)]
    return ScheduleProblem(
        layer_states=layers,
        t_max=t_max,
        idle=build_idle_model(acc, plan.n_banks, gating=gating,
                              allow_sleep=allow_sleep),
        transition_model=acc.transitions(e_switch_nom),
        rails=tuple(rails),
        name=name,
    )
