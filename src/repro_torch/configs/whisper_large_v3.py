"""whisper-large-v3 [arXiv:2212.04356]: encoder-decoder backbone; the
conv/audio frontend is a stub (input_specs supplies frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866, head_dim=64,
    norm="layernorm", act="gelu",
    n_encoder_layers=32, encoder_seq=1500,
)
