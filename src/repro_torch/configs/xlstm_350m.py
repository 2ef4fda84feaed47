"""xLSTM-350m [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks.

24L d_model=1024 4H d_ff=0 (memory-cell blocks contain their own 2×
up/down projections) vocab=50304. Every 8th layer is sLSTM (paper's 7:1
mix). Recurrent state is O(1) in sequence length ⇒ long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=True,
    slstm_every=8,
    supports_long_context=True,
    dtype="bfloat16",
)
