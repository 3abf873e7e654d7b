"""deepseek-v2-lite-16b [arXiv:2405.04434]: MLA (kv_lora=512) + MoE
(64 routed experts top-6, 2 shared, expert d_ff=1408)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128, rope_theta=1e4,
    n_experts=64, moe_top_k=6, n_shared_experts=2, d_ff_expert=1408,
    kv_lora_rank=512, rope_head_dim=64,
)
