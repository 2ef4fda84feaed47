"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified] (copy of
`repro.configs.phi3_mini_3_8b`): RoPE SwiGLU MHA.

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    dtype="bfloat16",
)
