"""xlstm-350m [arXiv:2405.04517]: sLSTM + mLSTM blocks (7:1 mLSTM-heavy),
no FFN (d_ff=0); blocks carry their own 2x up/down projections."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, proj_factor=2, slstm_every=8,
    scan_layers=False,
)
