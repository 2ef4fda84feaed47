"""MiniCPM-2B [arXiv:2404.06395; hf] (copy of `repro.configs.minicpm_2b`):
llama-like arch trained with the WSD schedule and μP-style depth/width
scaling.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
scale_emb=12, residual scale 1.4/sqrt(L), logit divisor d_model/256.
"""
from repro_torch.configs.base import ArchConfig

_L = 40
CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=_L,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    emb_scale=12.0,
    residual_scale=1.4 / (_L ** 0.5),
    logit_divisor=2304 / 256.0,
    lr_schedule="wsd",
    dtype="bfloat16",
)
