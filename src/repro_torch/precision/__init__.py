"""Precision policies of the port (DESIGN.md §11): constant specs."""
from repro_torch.precision.policy import (BACKENDS, GEMM_ROLES,
                                          PrecisionPolicy, ResolvedPolicy,
                                          RoleWidth, as_policy, as_segment,
                                          parse_policy, role_width_for)

__all__ = ["BACKENDS", "GEMM_ROLES", "PrecisionPolicy", "ResolvedPolicy",
           "RoleWidth", "as_policy", "as_segment", "parse_policy",
           "role_width_for"]
