from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticLMStream,
    make_global_batch,
)

__all__ = ["DataConfig", "SyntheticLMStream", "make_global_batch"]
