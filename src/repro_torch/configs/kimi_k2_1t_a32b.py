"""kimi-k2-1t-a32b [arXiv:2501.kimi2]: trillion-parameter MoE
(384 routed experts, top-8, 1 shared, expert d_ff=2048)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112, rope_theta=5e4,
    n_experts=384, moe_top_k=8, n_shared_experts=1, d_ff_expert=2048,
)
