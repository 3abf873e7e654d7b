"""qwen2-vl-72b [arXiv:2409.12191]: VLM backbone with M-RoPE; the vision
frontend is a stub (input_specs supplies position grids / embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6, mrope_sections=(16, 24, 24),
)
