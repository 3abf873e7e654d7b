"""hymba-1.5b [arXiv:2411.13676]: hybrid — parallel attention + Mamba/SSD
heads in every block (ssm_state=16), sliding-window attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64, ssm_state=16,
    window=1024,
)
