"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. M-RoPE over
(temporal, height, width) position components; the dynamic-resolution
ViT frontend is a stub: the caller supplies precomputed patch and text
embeddings and 3-D positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    mrope=True,
    input_kind="embeddings",
    dtype="bfloat16",
)
