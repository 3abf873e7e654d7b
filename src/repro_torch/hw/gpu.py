"""The H100 as the PF-DNN formulation's accelerator: three DVFS domains
and the roofline's rates.

The card is exposed as three voltage/frequency domains, as the
reference models its accelerator: the SMs (compute), HBM (memory) and
NVLink (interconnect).  The throughput of each domain scales with its
frequency (the alpha-power law of :class:`~repro_torch.hw.dvfs.DvfsModel`,
``v_th = 0.45``, ``alpha = 1.2``, ``leak_beta = 2.5``, as the reference's
chip model sets them), and dynamic energy per unit of work with V².

Published rates of the NVIDIA H100 SXM5 80 GB (dense, without
sparsity), from NVIDIA's data sheet
(https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet)
and the Hopper architecture whitepaper
(https://resources.nvidia.com/en-us-tensor-core/gtc22-whitepaper-hopper):

  - 989 TFLOP/s bf16 on the tensor cores (1,979 with sparsity);
  - 3.35 TB/s of HBM3;
  - NVLink 4: 900 GB/s over 18 links, 50 GB/s a link;
  - a board power of up to 700 W.

``hbm_bytes`` is the capacity the card reports,
``torch.cuda.get_device_properties(0).total_memory`` on an "NVIDIA H100
80GB HBM3" (85,017,493,504 bytes; ``chip_smoke.py`` checks it against
the card it runs on).

NVIDIA publishes no per-domain voltage range, no split of the board's
power between the domains, and no rail-switch time or energy.  Those
fields below are modelling constants, never vendor data, used only for
the PF-DNN adaptation's relative comparisons: a voltage range of 0.65–
1.00 V with the published rates at 1.00 V, and dynamic and leakage
powers that sum to the 700 W limit when every domain is busy at 1.00 V
(480 W SMs, 120 W HBM, 40 W NVLink, 60 W of leakage).
"""

from __future__ import annotations

import dataclasses

from repro_torch.hw.dvfs import DvfsModel, TransitionModel, voltage_levels

GPU_DOMAINS = ("sm", "hbm", "nvlink")


@dataclasses.dataclass(frozen=True)
class GpuChipModel:
    peak_flops_bf16: float = 989e12      # [FLOP/s] dense bf16
    hbm_bw: float = 3.35e12              # [B/s]
    nvlink_bw_per_link: float = 50e9     # [B/s/link]: 900 GB/s over 18
    hbm_bytes: int = 85_017_493_504      # total_memory the card reports

    # power model (modelling constants, see the module docstring)
    v_min: float = 0.65
    v_max: float = 1.0
    v_step: float = 0.05
    v_nom: float = 1.0
    p_sm_dyn_nom: float = 480.0          # [W] at full utilization, v_nom
    p_hbm_dyn_nom: float = 120.0
    p_nvlink_dyn_nom: float = 40.0
    p_leak_total: float = 60.0           # [W] static, split below
    leak_split: tuple[float, float, float] = (0.7, 0.2, 0.1)

    t_rail: float = 100e-6               # board-level rail switch [s]
    t_wake: float = 20e-6
    e_switch_nom: float = 500e-6         # [J]

    def levels(self) -> tuple[float, ...]:
        return voltage_levels(self.v_min, self.v_max, self.v_step)

    def dvfs(self, domain: int) -> DvfsModel:
        f_nom = (self.peak_flops_bf16, self.hbm_bw,
                 self.nvlink_bw_per_link)[domain]  # "frequency" = throughput
        leak = self.p_leak_total * self.leak_split[domain]
        return DvfsModel(v_nom=self.v_nom, v_th=0.45, alpha=1.2,
                         f_nom=f_nom, leak_nom=leak, leak_beta=2.5)

    def dyn_power_nom(self, domain: int) -> float:
        return (self.p_sm_dyn_nom, self.p_hbm_dyn_nom,
                self.p_nvlink_dyn_nom)[domain]

    def transitions(self) -> TransitionModel:
        return TransitionModel(t_rail=self.t_rail, t_wake=self.t_wake,
                               e_switch_nom=self.e_switch_nom,
                               v_min=self.v_min, v_max=self.v_max)


H100_SXM = GpuChipModel()
