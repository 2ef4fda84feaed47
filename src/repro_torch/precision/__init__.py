"""Site-addressed precision API of the port (DESIGN.md §11): one frozen
`PrecisionPolicy` composes format, step schedule, per-layer overrides,
controller overrides, per-GEMM-role widths and the kernel backend, and
resolves every quantization decision through `policy.resolve(site,
step)`."""
from repro_torch.precision.policy import (BACKENDS, OverrideValue,
                                          PrecisionPolicy, ResolvedPolicy,
                                          ResolvedQuant, RoleWidth,
                                          as_policy, as_segment,
                                          parse_policy, role_width_for)
from repro_torch.precision.sites import GEMM_ROLES, OPERAND_KINDS, QuantSite

__all__ = ["BACKENDS", "GEMM_ROLES", "OPERAND_KINDS", "OverrideValue",
           "PrecisionPolicy", "QuantSite", "ResolvedPolicy", "ResolvedQuant",
           "RoleWidth", "as_policy", "as_segment", "parse_policy",
           "role_width_for"]
