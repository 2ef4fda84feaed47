"""Precision policies for constant specs (port of the constant-policy part
of `repro.precision.policy`, DESIGN.md §11).

`parse_policy("8; lm_head:12; wgrad+2; backend=pallas")` gives a
`PrecisionPolicy` whose only segment, `resolve_segment(0)`, is the
`ResolvedPolicy` serving needs: the global format, per-layer overrides
(substring match, first wins), per-role widths and the GEMM backend. Step
schedules ("4@0,8@90%", "b=16@0,b=64@50%") come with ROADMAP A9 and raise.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple, Union

from repro_torch.core.formats import HBFPConfig

BACKENDS = ("sim", "pallas")
GEMM_ROLES = ("fwd", "dgrad", "wgrad", "attn_qk", "attn_pv")

OverrideValue = Union[None, int, dict, HBFPConfig]


def _apply_override(base: Optional[HBFPConfig],
                    value: OverrideValue) -> Optional[HBFPConfig]:
    """Merge a per-layer override into the segment format: a config
    replaces it, a bare width or {"m", "b"} dict merges into it, None keeps
    the layer FP. In an FP segment bare widths stay FP."""
    if value is None or isinstance(value, HBFPConfig):
        return value
    if base is None:
        return None
    if isinstance(value, dict):
        cfg = base
        m = value.get("m")
        if m is not None:
            cfg = cfg.with_(mantissa_bits=int(m),
                            wide_mantissa_bits=max(cfg.wide_mantissa_bits,
                                                   int(m)))
        b = value.get("b")
        if b is not None:
            cfg = cfg.with_block(int(b))
        return cfg
    return base.with_(mantissa_bits=int(value),
                      wide_mantissa_bits=max(base.wide_mantissa_bits,
                                             int(value)))


@dataclasses.dataclass(frozen=True)
class RoleWidth:
    """Width adjustment of one non-fwd GEMM role: relative (`delta`,
    "wgrad+2") or absolute (`bits`, "wgrad=8")."""

    role: str
    delta: Optional[int] = None
    bits: Optional[int] = None

    def __post_init__(self):
        if self.role not in GEMM_ROLES or self.role == "fwd":
            raise ValueError(
                f"role widths adjust non-fwd roles {GEMM_ROLES[1:]}; the "
                f"base format is the fwd width (got {self.role!r})")
        if (self.delta is None) == (self.bits is None):
            raise ValueError("RoleWidth needs exactly one of delta / bits")
        if self.bits is not None and not (2 <= self.bits <= 24):
            raise ValueError(f"mantissa_bits out of range: {self.bits}")

    def apply(self, cfg: Optional[HBFPConfig]) -> Optional[HBFPConfig]:
        """Adjust cfg's width; returns cfg itself when unchanged."""
        if cfg is None:
            return None
        m = self.bits if self.bits is not None \
            else cfg.mantissa_bits + self.delta
        m = max(2, min(24, int(m)))
        if m == cfg.mantissa_bits:
            return cfg
        return cfg.with_(mantissa_bits=m,
                         wide_mantissa_bits=max(cfg.wide_mantissa_bits, m))


def role_width_for(role_widths, role: str) -> Optional[RoleWidth]:
    """First RoleWidth of `role` in a role_widths tuple, or None."""
    for rw in role_widths or ():
        if rw.role == role:
            return rw
    return None


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """The precision state of one policy segment: global format, per-layer
    overrides, per-role widths and backend."""

    global_cfg: Optional[HBFPConfig]
    layer_overrides: Tuple[Tuple[str, Optional[HBFPConfig]], ...] = ()
    role_widths: Tuple[RoleWidth, ...] = ()
    backend: str = "sim"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        roles = [rw.role for rw in self.role_widths]
        if len(set(roles)) != len(roles):
            raise ValueError(f"duplicate role widths: {roles}")

    def for_param(self, name: str, role: str = "fwd"
                  ) -> Optional[HBFPConfig]:
        """Config of one parameter in one GEMM role (None: FP)."""
        lname = name.lower()
        for frag, cfg in self.layer_overrides:
            if frag.lower() in lname:
                return cfg
        rw = role_width_for(self.role_widths, role)
        return rw.apply(self.global_cfg) if rw is not None else self.global_cfg

    @property
    def has_overrides(self) -> bool:
        return bool(self.layer_overrides)

    @property
    def is_fp32(self) -> bool:
        return (self.global_cfg is None
                and all(c is None for _, c in self.layer_overrides))

    @property
    def any_stochastic(self) -> bool:
        cfgs = [self.global_cfg] + [c for _, c in self.layer_overrides]
        return any(c is not None and c.rounding == "stochastic"
                   for c in cfgs)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """A constant precision policy: one segment."""

    base: Optional[HBFPConfig] = None
    layer_overrides: Tuple[Tuple[str, OverrideValue], ...] = ()
    role_widths: Tuple[RoleWidth, ...] = ()
    backend: str = "sim"
    block: Optional[int] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")

    def segment_cfg(self, i: int = 0) -> Optional[HBFPConfig]:
        if i != 0:
            raise IndexError(f"constant policy has one segment, not {i + 1}")
        cfg = self.base
        if cfg is not None and self.block is not None:
            cfg = cfg.with_block(self.block)
        return cfg

    def resolve_segment(self, i: int) -> ResolvedPolicy:
        seg = self.segment_cfg(i)
        return ResolvedPolicy(
            global_cfg=seg,
            layer_overrides=tuple((f, _apply_override(seg, v))
                                  for f, v in self.layer_overrides),
            role_widths=self.role_widths, backend=self.backend)


def as_policy(spec, backend: Optional[str] = None) -> PrecisionPolicy:
    """Coerce a precision spec (PrecisionPolicy, spec string, HBFPConfig or
    None) into a PrecisionPolicy; `backend` applies to the non-policy
    kinds."""
    if isinstance(spec, PrecisionPolicy):
        return spec
    if isinstance(spec, str):
        return parse_policy(spec, backend=backend)
    if spec is None or isinstance(spec, HBFPConfig):
        return PrecisionPolicy(base=spec, backend=backend or "sim")
    raise TypeError(f"not a precision spec: {type(spec).__name__}")


def as_segment(spec, backend: Optional[str] = None) -> ResolvedPolicy:
    """A static precision state (None, HBFPConfig or ResolvedPolicy) as a
    ResolvedPolicy segment."""
    if isinstance(spec, ResolvedPolicy):
        return spec
    if spec is None or isinstance(spec, HBFPConfig):
        return ResolvedPolicy(global_cfg=spec, backend=backend or "sim")
    raise TypeError(f"not a static precision state: {type(spec).__name__}")


_ROLE_RE = re.compile(r"^(dgrad|wgrad|attn_qk|attn_pv)\s*([+\-=])\s*(\d+)$")
_BLOCK_RE = re.compile(r"^b\s*=\s*(\d+)\s*(?:@\s*0\s*)?$")
_FORMAT_RE = re.compile(r"^(\d+)\s*(?:@\s*0\s*)?(?:~(nearest|stochastic))?$")


def _schedule_error(spec: str) -> NotImplementedError:
    return NotImplementedError(
        f"policy {spec!r} has a step schedule; schedules come with ROADMAP "
        f"A9 (the port parses constant policies)")


def parse_policy(spec: str, base: Optional[HBFPConfig] = None,
                 backend: Optional[str] = None) -> PrecisionPolicy:
    """Parse a constant policy spec: FORMAT (";" CLAUSE)*, FORMAT being
    "fp32" or WIDTH[~ROUNDING], clauses role widths ("wgrad+2",
    "dgrad=8"), one constant block size ("b=16"), per-layer overrides
    ("lm_head:12", "name:fp32") and "backend=sim|pallas"."""
    clauses = [c.strip() for c in spec.split(";") if c.strip()]
    if not clauses:
        raise ValueError("empty policy spec")
    fmt, rest = clauses[0], clauses[1:]
    roles, overrides = [], []
    block = None
    be = backend
    for c in rest:
        m = _ROLE_RE.match(c)
        if m:
            role, op, n = m.group(1), m.group(2), int(m.group(3))
            roles.append(RoleWidth(role, bits=n) if op == "="
                         else RoleWidth(role, delta=n if op == "+" else -n))
            continue
        if c.startswith("backend="):
            be = c[len("backend="):].strip()
            if be not in BACKENDS:
                raise ValueError(f"unknown backend {be!r} in policy "
                                 f"spec {spec!r}")
            continue
        if re.match(r"^b\s*=", c):
            mb = _BLOCK_RE.match(c)
            if mb is None:
                raise _schedule_error(spec)
            if block is not None:
                raise ValueError(f"duplicate block clause {c!r} in policy "
                                 f"spec {spec!r}")
            block = int(mb.group(1))
            continue
        if ":" in c:
            name, w = (p.strip() for p in c.split(":", 1))
            overrides.append((name, None if w in ("fp32", "fp", "0")
                              else int(w)))
            continue
        raise ValueError(f"unparseable policy clause {c!r} in {spec!r}")
    if fmt == "fp32":
        fmt_base = None
    else:
        if "," in fmt:
            raise _schedule_error(spec)
        mf = _FORMAT_RE.match(fmt)
        if mf is None:
            raise ValueError(f"unparseable format {fmt!r} in {spec!r}")
        b = base if base is not None else HBFPConfig()
        m = int(mf.group(1))
        fmt_base = b.with_(mantissa_bits=m,
                           wide_mantissa_bits=max(b.wide_mantissa_bits, m))
        if mf.group(2) is not None:
            fmt_base = fmt_base.with_(rounding=mf.group(2))
    return PrecisionPolicy(base=fmt_base, layer_overrides=tuple(overrides),
                           role_widths=tuple(roles), backend=be or "sim",
                           block=block)
