"""Hardware models: DVFS scaling laws and the paper's 40nm edge
accelerator."""

from repro_torch.hw.dvfs import DvfsModel, TransitionModel
from repro_torch.hw.edge40nm import Edge40nmAccelerator, EDGE40NM_DEFAULT

__all__ = [
    "DvfsModel",
    "TransitionModel",
    "Edge40nmAccelerator",
    "EDGE40NM_DEFAULT",
]
