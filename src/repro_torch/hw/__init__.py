"""Hardware models: DVFS scaling laws, the paper's 40nm edge
accelerator, and the H100 chip model for the PF-DNN adaptation to the
card (``repro_torch.core.gpu_adapter``) and the roofline."""

from repro_torch.hw.dvfs import DvfsModel, TransitionModel
from repro_torch.hw.edge40nm import Edge40nmAccelerator, EDGE40NM_DEFAULT
from repro_torch.hw.gpu import GpuChipModel, H100_SXM

__all__ = [
    "DvfsModel",
    "TransitionModel",
    "Edge40nmAccelerator",
    "EDGE40NM_DEFAULT",
    "GpuChipModel",
    "H100_SXM",
]
