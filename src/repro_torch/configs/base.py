"""Architecture configuration and registry (port of `repro.configs.base`).

The fields and `.smoke()` match the reference exactly, so one config
describes the same model in both packages. `policy()` is not ported: the
port resolves `precision` strings with its own `repro_torch.precision`.
Only the architectures of ported slices are registered; the others raise
and name the ROADMAP item that adds them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention
    attn_pattern: str = "global"   # global | local_global | sliding
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope: bool = False
    ffn_act: str = "swiglu"        # swiglu | geglu
    zero_centered_norm: bool = False
    post_norms: bool = False
    # residual/embedding scaling (minicpm muP-style)
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_divisor: float = 1.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_groups: Optional[int] = None
    # hybrid (hymba): parallel attention + mamba heads
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    # xlstm
    xlstm: bool = False
    slstm_every: int = 8
    # io
    input_kind: str = "tokens"     # tokens | embeddings
    n_codebooks: int = 1
    norm_eps: float = 1e-6
    # execution
    q_chunk: int = 512
    ssm_chunk: int = 128
    supports_long_context: bool = False
    dtype: str = "float32"
    lr_schedule: str = "cosine"
    remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 2048
    ssm_unroll: bool = False
    bfp_kv_cache: bool = False
    # unified precision policy string (DESIGN.md §11)
    precision: Optional[str] = None
    kernel_backend: str = "sim"
    hbfp_spec: Optional[str] = None
    hbfp_overrides: Tuple[Tuple[str, int], ...] = ()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if not self.xlstm else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            head_dim=32,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            window=min(self.window, 16) if self.window else None,
            q_chunk=8,
            ssm_chunk=8,
            slstm_every=2,
            moe_groups=2,
        )


_REGISTRY = ("yi_9b",)


def arch_ids() -> Tuple[str, ...]:
    return tuple(a.replace("_", "-") for a in _REGISTRY)


def get_arch(name: str) -> ArchConfig:
    mod = name.replace("-", "_").replace(".", "_")
    if mod not in _REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP A12); ported: "
            f"{arch_ids()}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
