"""The paper's evaluation platform: a TSMC-40nm edge DNN accelerator.

Configuration (paper Fig. 4):
  - output-stationary 8×8 INT8 PE array, weight-tile reuse dataflow
  - lane buffers 77×8 and weight buffers 576×8, both ping-pong
  - chip clock up to 500 MHz; RRAM subsystem at 100 MHz
  - RRAM weight banks (model-dependent count) + SRAM activation buffers
  - voltages 0.9–1.3 V in 0.05 V steps (§5.2)

Three DVFS-controlled domains (§3.1: compute, feeder, RRAM memory
subsystem) plus per-bank RRAM power gating at memory-access-phase
granularity (§3.2).

We cannot rerun the paper's P&R flow, so per-event energies are analytic
constants calibrated to 40nm literature (Horowitz ISSCC'14 scaling; CHIMERA
/ MINOTAUR RRAM numbers [26, 27]) such that the *published qualitative
characteristics* hold: layer-dependent dynamic/static composition (Fig 1),
interior minimum-energy voltage points (Fig 2), and ≈90% leakage removal
from fine-grained bank gating (§6.4).  All headline comparisons are
relative, matching the paper's own reporting.
"""

from __future__ import annotations

import dataclasses

from repro_torch.hw.dvfs import DvfsModel, TransitionModel, voltage_levels

# Domain names (order fixed: index = domain id everywhere downstream).
DOMAINS = ("compute", "feeder", "rram")
D_COMPUTE, D_FEEDER, D_RRAM = 0, 1, 2


def _scaled_f_nom(f_max: float, v_nom: float, v_max: float,
                  v_th: float = 0.35, alpha: float = 1.35) -> float:
    """f_nom at v_nom such that f(v_max) == f_max under the alpha-power law."""
    def shape(v: float) -> float:
        return (v - v_th) ** alpha / v

    return f_max * shape(v_nom) / shape(v_max)


@dataclasses.dataclass(frozen=True)
class Edge40nmAccelerator:
    """Static description + energy lookup for the 40nm accelerator."""

    # Array geometry (Fig 4)
    pe_rows: int = 8
    pe_cols: int = 8
    lane_buffer_depth: int = 77
    weight_buffer_depth: int = 576

    # Voltage space (§5.2)
    v_min: float = 0.9
    v_max: float = 1.3
    v_step: float = 0.05
    v_nom: float = 1.1

    # Clocks: "up to 500 MHz" chip, RRAM subsystem at 100 MHz → max V.
    f_compute_max: float = 500e6
    f_feeder_max: float = 500e6
    f_rram_max: float = 100e6

    # Per-event dynamic energies at v_nom [J] (INT8, 40nm-calibrated).
    e_mac: float = 0.25e-12          # one INT8 MAC
    e_sram_lane: float = 1.2e-12     # lane-buffer access, per byte
    e_sram_weight: float = 1.8e-12   # weight-buffer access, per byte
    e_rram_read: float = 12.0e-12    # RRAM read, per byte
    e_feeder_byte: float = 1.5e-12   # DMA/NoC movement, per byte

    # Leakage at v_nom, active [W].
    leak_compute: float = 0.60e-3
    leak_feeder: float = 0.20e-3
    leak_rram_bank: float = 0.12e-3  # per awake RRAM bank (periphery-heavy)
    rram_bank_bytes: int = 64 * 1024

    # Idle power when the accelerator stays active between inferences
    # (clock-gated residual dynamic + full static) as a fraction of the
    # all-domain nominal leakage; duty-cycled sleep retains this fraction.
    idle_residual_dyn: float = 0.15
    sleep_retention_frac: float = 0.03
    sleep_wake_energy: float = 25e-9   # deep-sleep exit [J]
    sleep_wake_latency: float = 2e-6   # deep-sleep exit [s]

    # Transition model (§5.2).
    t_rail: float = 15e-9
    t_wake: float = 5e-9
    e_switch_nom: float = 1e-9

    def levels(self) -> tuple[float, ...]:
        return voltage_levels(self.v_min, self.v_max, self.v_step)

    def dvfs(self, domain: int, n_rram_banks: int = 16) -> DvfsModel:
        f_max = (self.f_compute_max, self.f_feeder_max,
                 self.f_rram_max)[domain]
        leak = (self.leak_compute, self.leak_feeder,
                self.leak_rram_bank * n_rram_banks)[domain]
        return DvfsModel(
            v_nom=self.v_nom,
            f_nom=_scaled_f_nom(f_max, self.v_nom, self.v_max),
            leak_nom=leak,
        )

    def transitions(self, e_switch_nom: float | None = None) -> TransitionModel:
        return TransitionModel(
            t_rail=self.t_rail,
            t_wake=self.t_wake,
            e_switch_nom=(self.e_switch_nom if e_switch_nom is None
                          else e_switch_nom),
            v_min=self.v_min,
            v_max=self.v_max,
        )

    # -- derived idle/sleep power ------------------------------------
    def total_leak_nom(self, n_rram_banks: int) -> float:
        return (self.leak_compute + self.leak_feeder
                + self.leak_rram_bank * n_rram_banks)

    def idle_power(self, n_rram_banks: int) -> float:
        """P_idle (§4.2): leakage + residual clock-gated dynamic power."""
        leak = self.total_leak_nom(n_rram_banks)
        return leak * (1.0 + self.idle_residual_dyn)

    def sleep_power(self, n_rram_banks: int) -> float:
        return self.total_leak_nom(n_rram_banks) * self.sleep_retention_frac


EDGE40NM_DEFAULT = Edge40nmAccelerator()
