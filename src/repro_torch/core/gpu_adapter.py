"""PF-DNN power orchestration for an H100 serving deadline-constrained
periodic inference: the reference's accelerator adaptation
(``repro.core.tpu_adapter``) on the card's power domains.

Mapping (paper → card):
  layers            → per-layer transformer phases, with latency/energy
                      terms from the dry-run's costs
                      (``repro_torch.launch.dryrun``): FLOPs → SM
                      domain, bytes → HBM domain, collective bytes →
                      NVLink domain
  DVFS domains      → SM / HBM / NVLink voltage-frequency domains
                      (:class:`~repro_torch.hw.gpu.GpuChipModel`)
  RRAM bank gating  → idle-block gating: MoE expert banks (top-k of E
                      active per token); an NVLink domain that carries no
                      bytes may be gated
  rail scarcity     → board-level shared supplies (N_max rails)
  deadline          → 1/R_target serving SLO

The formulation (:mod:`repro_torch.core.problem`) and the solvers
(λ-DP, refinement, pruning, ILP) are reused unchanged: this module only
builds the per-layer state spaces from the card's terms, in the
reference's loop order, so that the same constants build the
reference's problem bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.problem import IdleModel, ScheduleProblem, StateCost
from repro_torch.hw.dvfs import V_GATED
from repro_torch.hw.gpu import H100_SXM, GpuChipModel


@dataclasses.dataclass(frozen=True)
class GpuLayerCost:
    """Per-layer roofline terms for ONE card (from the dry-run JSON)."""

    name: str
    flops: float              # per-device FLOPs for this layer
    hbm_bytes: float          # per-device bytes accessed
    nvlink_bytes: float       # per-device collective bytes
    gateable_fraction: float = 0.0   # idle weight banks (MoE: 1 − k/E)


def layer_costs_from_dryrun(record: dict, n_layers: int,
                            gateable_fraction: float = 0.0,
                            ) -> list[GpuLayerCost]:
    """Split a dry-run cell's corrected per-device costs into uniform
    per-layer phases (every layer's body is the same)."""
    c = record["cost"]
    return [
        GpuLayerCost(
            name=f"L{i}",
            flops=c["flops_per_device"] / n_layers,
            hbm_bytes=c["bytes_per_device"] / n_layers,
            nvlink_bytes=c["collective_bytes_per_device"] / n_layers,
            gateable_fraction=gateable_fraction,
        )
        for i in range(n_layers)
    ]


def build_gpu_problem(
    layers: Sequence[GpuLayerCost],
    rails: Sequence[float],
    deadline_s: float,
    *,
    chip: GpuChipModel = H100_SXM,
    gating: bool = True,
    allow_sleep: bool = True,
    name: str = "gpu",
) -> ScheduleProblem:
    """Layered state graph over (V_sm, V_hbm, V_nvlink) assignments."""
    dv = [chip.dvfs(d) for d in range(3)]
    tm = chip.transitions()

    def states_for(lc: GpuLayerCost, idx: int) -> list[StateCost]:
        out = []
        work = (lc.flops, lc.hbm_bytes, lc.nvlink_bytes)
        nvlink_options = list(rails)
        if gating and lc.nvlink_bytes == 0:
            nvlink_options.append(V_GATED)
        for vs in rails:
            for vh in rails:
                for vn in nvlink_options:
                    volts = (vs, vh, vn)
                    times = []
                    e_dyn = 0.0
                    p_leak = 0.0
                    for d, v in enumerate(volts):
                        if v == V_GATED:
                            continue
                        thr = dv[d].freq(v)       # throughput at this V
                        if thr <= 0 or (work[d] > 0 and thr == 0):
                            times.append(float("inf"))
                            continue
                        t_d = work[d] / thr if work[d] else 0.0
                        times.append(t_d)
                        # dynamic energy ∝ work · V², calibrated so that
                        # full utilization at nominal V draws the
                        # domain's nominal dynamic power
                        p_dyn_nom = chip.dyn_power_nom(d)
                        e_dyn += (p_dyn_nom * t_d
                                  * dv[d].dyn_energy_scale(v))
                        leak = dv[d].leak_power(v)
                        if d == 0 and gating and lc.gateable_fraction:
                            # gate idle weight banks (MoE experts):
                            # remove their share of the SMs' leakage
                            leak *= (1.0 - 0.9 * lc.gateable_fraction)
                        p_leak += leak
                    t_op = max(times)
                    if t_op == float("inf"):
                        continue
                    e_op = e_dyn + p_leak * t_op
                    out.append(StateCost(volts, float(t_op), float(e_op),
                                         label=f"L{idx}"))
        return out

    idle = IdleModel(
        p_idle=chip.p_leak_total * 1.2,
        p_sleep=chip.p_leak_total * 0.08,
        e_sleep_wake=chip.e_switch_nom * 3,
        t_sleep_wake=chip.t_rail * 4,
        allow_sleep=allow_sleep,
    )
    return ScheduleProblem(
        layer_states=[states_for(lc, i) for i, lc in enumerate(layers)],
        t_max=deadline_s,
        idle=idle,
        transition_model=tm,
        rails=tuple(rails),
        name=name,
    )
