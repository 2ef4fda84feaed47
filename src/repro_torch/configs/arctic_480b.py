"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864(expert) vocab=32000,
MoE 128 experts top-2 with a parallel dense-FFN residual
(dense-MoE hybrid).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dtype="bfloat16",
)
