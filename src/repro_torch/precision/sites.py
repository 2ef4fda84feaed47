"""Quantization sites: the address space of the precision policy (port
of `repro.precision.sites`).

Every BFP decision in the system is keyed by a `QuantSite` — *where* a
quantization happens, expressed as three orthogonal coordinates:

  * `layer_path`   — the parameter / call-site name ("layers/ffn_wg",
                     "lm_head", ...). Parameter paths come from
                     `opt_shell.param_path_name`; in-graph call sites use
                     their `ctx_matmul` site string.
  * `gemm_role`    — which of the training GEMMs the operand feeds:
                     the forward product (`fwd`), the activation-gradient
                     product (`dgrad`), the weight-gradient outer-product
                     accumulation (`wgrad`), or the two attention
                     contractions (`attn_qk`, `attn_pv`).
  * `operand_kind` — what the tensor *is* at that site: a `weight`, an
                     `act`ivation, or a `grad`ient.

`PrecisionPolicy.resolve(site)` (precision/policy.py) maps a site to the
concrete `ResolvedQuant` governing it — the single entry point for the
`HBFPConfig` / schedule / controller / backend knobs (DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses

GEMM_ROLES = ("fwd", "dgrad", "wgrad", "attn_qk", "attn_pv")
OPERAND_KINDS = ("weight", "act", "grad")


@dataclasses.dataclass(frozen=True)
class QuantSite:
    """One quantization site: (layer_path, gemm_role, operand_kind).

    Frozen and hashable — sites are used as resolution keys and never carry
    tensors.
    """

    layer_path: str
    gemm_role: str = "fwd"
    operand_kind: str = "weight"

    def __post_init__(self):
        if self.gemm_role not in GEMM_ROLES:
            raise ValueError(f"unknown gemm_role {self.gemm_role!r}; "
                             f"expected one of {GEMM_ROLES}")
        if self.operand_kind not in OPERAND_KINDS:
            raise ValueError(f"unknown operand_kind {self.operand_kind!r}; "
                             f"expected one of {OPERAND_KINDS}")

    def __str__(self):
        return f"{self.layer_path}@{self.gemm_role}/{self.operand_kind}"
