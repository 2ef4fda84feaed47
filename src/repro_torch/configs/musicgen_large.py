"""MusicGen-large [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 per codebook. The
EnCodec frontend is a stub: the caller supplies precomputed frame
embeddings (the sum of the 4 codebook embeddings under the delay
pattern); 4 output heads predict the 4 codebooks.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    input_kind="embeddings",
    n_codebooks=4,
    dtype="bfloat16",
)
