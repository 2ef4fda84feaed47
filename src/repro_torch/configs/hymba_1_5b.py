"""Hymba-1.5B [arXiv:2411.13676; hf]: parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention heads use sliding windows (Hymba uses SWA in all but 3 layers;
we use SWA throughout — DESIGN.md §5), so long_500k decode is O(window)
for attention + O(1) for the SSM state ⇒ the long-context cell RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    attn_pattern="sliding",
    window=1024,
    ssm=True,
    ssm_state=16,
    ssm_expand=2,
    supports_long_context=True,
    dtype="bfloat16",
)
