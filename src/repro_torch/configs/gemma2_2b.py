"""Gemma-2 2B [arXiv:2408.00118; hf] (copy of `repro.configs.gemma2_2b`).

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000. Alternating
local(4096-window)/global attention, attn-logit softcap 50.0, final-logit
softcap 30.0, zero-centered RMSNorm with post-norms, GeGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    attn_pattern="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    ffn_act="geglu",
    zero_centered_norm=True,
    post_norms=True,
    emb_scale=48.0,  # sqrt(d_model)
    dtype="bfloat16",
)
