"""Analytic performance/energy characterization of DNN layers on the 40nm
edge accelerator (stand-in for the paper's cycle-accurate model + gate-level
power analysis, §5.1)."""

from repro_torch.perfmodel.layer_costs import (
    LayerSpec,
    LayerCost,
    characterize_layer,
    characterize_network,
    conv_spec,
    dwconv_spec,
    fc_spec,
    attention_spec,
    pool_spec,
    eltwise_spec,
)
from repro_torch.perfmodel.gating import BankPlan, plan_banks

__all__ = [
    "LayerSpec",
    "LayerCost",
    "characterize_layer",
    "characterize_network",
    "conv_spec",
    "dwconv_spec",
    "fc_spec",
    "attention_spec",
    "pool_spec",
    "eltwise_spec",
    "BankPlan",
    "plan_banks",
]
