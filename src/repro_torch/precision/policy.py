"""`PrecisionPolicy`: the one object that decides "which BFP, where, when"
(port of `repro.precision.policy`, DESIGN.md §11, plain Python).

A policy composes the base format, the step schedule (mantissa and block
size), per-layer overrides, the numerics controller's overrides,
per-GEMM-role widths and the kernel backend, and resolves through

    policy.resolve(site: QuantSite, step=0) -> ResolvedQuant

with precedence, highest first: per-layer override > controller override
> schedule segment > base; role widths ("wgrad+2") adjust the
schedule/base-resolved formats. `resolve_segment(i)` returns the frozen,
hashable `ResolvedPolicy` of one segment, so `train.make_step` builds one
step variant per distinct segment and dispatches on the step counter.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from repro_torch.core import schedule_precision as sp
from repro_torch.core.formats import HBFPConfig
from repro_torch.precision.sites import GEMM_ROLES, QuantSite

# Override values mirror the schedule DSL: a full HBFPConfig, a bare
# mantissa width (merged into the deciding segment's grid), or None (FP).
OverrideValue = sp.OverrideValue

BACKENDS = ("sim", "pallas")


# ---------------------------------------------------------------------------
# ResolvedQuant — what one site resolves to
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolvedQuant:
    """The concrete quantization decision for one `QuantSite`.

    cfg:     the HBFP format governing the site (None ⇒ the site stays FP).
    backend: which GEMM implementation executes it ("sim" | "pallas").
    source:  which precedence layer decided — "override" (per-layer),
             "controller", "schedule", or "base" (informational).
    """

    cfg: Optional[HBFPConfig]
    backend: str = "sim"
    source: str = "base"

    @property
    def mantissa_bits(self) -> int:
        """Resolved mantissa width (0 ⇒ FP)."""
        return 0 if self.cfg is None else self.cfg.mantissa_bits


# ---------------------------------------------------------------------------
# RoleWidth — per-GEMM-role width adjustment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoleWidth:
    """Width adjustment for one GEMM role, relative (`delta`, the DSL's
    "wgrad+2") or absolute (`bits`, the DSL's "wgrad=8"). The forward width
    IS the base/schedule width, so `role != "fwd"` by construction — adjust
    the base instead."""

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
        """Adjust `cfg`'s mantissa width; identity on None (FP stays FP)
        and when the width is unchanged (returns the same object, so the
        uniform fast paths stay bit-identical)."""
        if cfg is None:
            return None
        m = self.bits if self.bits is not None \
            else cfg.mantissa_bits + self.delta
        m = max(2, min(24, int(m)))
        if m == cfg.mantissa_bits:
            return cfg
        return cfg.with_(mantissa_bits=m,
                         wide_mantissa_bits=max(cfg.wide_mantissa_bits, m))

    @property
    def spec(self) -> str:
        if self.bits is not None:
            return f"{self.role}={self.bits}"
        return f"{self.role}{self.delta:+d}"


def role_width_for(role_widths, role: str) -> Optional[RoleWidth]:
    """First RoleWidth matching `role` in a role_widths tuple (or None)."""
    for rw in role_widths or ():
        if rw.role == role:
            return rw
    return None


# ---------------------------------------------------------------------------
# ResolvedPolicy — one schedule segment, fully concrete and hashable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """The precision state of one policy segment (one step variant).

    global_cfg:   the segment's format for everything no override matches
                  (None ⇒ FP32).
    layer_overrides: (name-fragment, config) pairs, matched as substrings
                  against the lowercased parameter name, first match wins
                  (the user-facing per-layer axis; highest precedence).
    controller_overrides: (name, config) pairs matched *exactly* — the
                  numerics controller emits full parameter names, so one
                  layer's decision can never substring-capture another.
                  Names may be role-qualified ("name@wgrad") to pin a
                  single GEMM role.
    role_widths:  per-GEMM-role width adjustments applied to schedule/base
                  -resolved formats (explicit overrides pin all roles).
    backend:      GEMM implementation for every site in the segment.

    Scope note (DESIGN.md §8): per-layer resolution governs the *weight*
    axis — the optimizer shell's narrowing and the numerics taps.
    Activation/gradient quantization follows `global_cfg` plus the
    (global) role_widths, as in the reference.
    """

    global_cfg: Optional[HBFPConfig]
    layer_overrides: Tuple[Tuple[str, Optional[HBFPConfig]], ...] = ()
    controller_overrides: Tuple[Tuple[str, Optional[HBFPConfig]], ...] = ()
    role_widths: Tuple[RoleWidth, ...] = ()
    backend: str = "sim"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        roles = [rw.role for rw in self.role_widths]
        if len(set(roles)) != len(roles):
            raise ValueError(f"duplicate role widths: {roles}")

    # -- resolution --------------------------------------------------------
    def _lookup(self, name: str, role: str):
        lname = name.lower()
        for frag, cfg in self.layer_overrides:
            if frag.lower() in lname:
                return cfg, "override"
        qualified = lname + "@" + role
        for nm, cfg in self.controller_overrides:
            if nm.lower() == qualified:
                return cfg, "controller"
        for nm, cfg in self.controller_overrides:
            if nm.lower() == lname:
                return cfg, "controller"
        rw = role_width_for(self.role_widths, role)
        cfg = rw.apply(self.global_cfg) if rw is not None else self.global_cfg
        return cfg, "base"

    def for_param(self, name: str, role: str = "fwd"
                  ) -> Optional[HBFPConfig]:
        """Concrete config for one parameter in one GEMM role (None ⇒ FP).
        The optimizer shell narrows weights at the fwd width; the gradient
        taps measure at the wgrad width (numerics/collect.py)."""
        return self._lookup(name, role)[0]

    def resolve(self, site) -> ResolvedQuant:
        """`PrecisionPolicy.resolve` for an already-resolved segment."""
        if isinstance(site, str):
            site = QuantSite(site)
        cfg, src = self._lookup(site.layer_path, site.gemm_role)
        return ResolvedQuant(cfg=cfg, backend=self.backend, source=src)

    def role_cfg(self, role: str) -> Optional[HBFPConfig]:
        """The segment-global format adjusted for one GEMM role — what the
        in-graph quantization of that role's act/grad operands uses."""
        rw = role_width_for(self.role_widths, role)
        return rw.apply(self.global_cfg) if rw is not None \
            else self.global_cfg

    # -- controller composition ---------------------------------------------
    def with_controller(self, overrides) -> "ResolvedPolicy":
        """Merge controller decisions ((name[, @role], width|cfg|None), ...)
        onto this segment — bare widths take the segment's grid (tile /
        rounding / wide storage), exactly like schedule overrides."""
        merged = tuple((str(n), sp._apply_override(self.global_cfg, v))
                       for n, v in overrides)
        return dataclasses.replace(self, controller_overrides=merged)

    # -- aggregate properties (train-step plumbing) --------------------------
    @property
    def has_overrides(self) -> bool:
        return bool(self.layer_overrides or self.controller_overrides)

    @property
    def is_fp32(self) -> bool:
        return (self.global_cfg is None
                and all(c is None for _, c in self.layer_overrides)
                and all(c is None for _, c in self.controller_overrides))

    @property
    def any_stochastic(self) -> bool:
        cfgs = [self.global_cfg] \
            + [c for _, c in self.layer_overrides] \
            + [c for _, c in self.controller_overrides]
        return any(c is not None and c.rounding == "stochastic"
                   for c in cfgs)


# ---------------------------------------------------------------------------
# PrecisionPolicy — the composed, step-aware policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Frozen composition of format × schedule × overrides × roles × backend.

    base:       the static format (None ⇒ FP32) — used when no `schedule`
                is given, and as documentation of the run's grid otherwise.
    schedule:   optional step-driven `PrecisionSchedule`; its segments
                replace `base` per step and its own overrides merge after
                (i.e. below) `layer_overrides`.
    layer_overrides: user per-layer overrides ((name-fragment, width|cfg|
                None), ...) — substring match, first wins, highest
                precedence.
    controller_overrides: exact-name overrides (optionally "@role"-
                qualified); normally fed live by `train.make_step`'s
                controller loop rather than baked in here.
    role_widths: per-GEMM-role width adjustments (RoleWidth, ...).
    backend:    "sim" | "pallas" for every dot product under the policy.
    block_schedule: step-driven block-size axis ((start_step, b), ...) —
                the exponent-sharing block size `b` applied on top of the
                deciding format via `HBFPConfig.with_block` (DSL clause
                "b=16@0,b=64@50%"; DESIGN.md §13). Segments are the union
                of mantissa- and block-schedule boundaries; empty ⇒ the
                format's own tile/act_block stand.

    Construct directly, via `parse_policy` (the spec-string DSL), or via
    `as_policy` (coercion from every legacy spec kind).
    """

    base: Optional[HBFPConfig] = None
    schedule: Optional[sp.PrecisionSchedule] = None
    layer_overrides: Tuple[Tuple[str, OverrideValue], ...] = ()
    controller_overrides: Tuple[Tuple[str, OverrideValue], ...] = ()
    role_widths: Tuple[RoleWidth, ...] = ()
    backend: str = "sim"
    block_schedule: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        roles = [rw.role for rw in self.role_widths]
        if len(set(roles)) != len(roles):
            raise ValueError(f"duplicate role widths: {roles}")
        if self.block_schedule:
            starts = [s for s, _ in self.block_schedule]
            if starts[0] != 0:
                raise ValueError(
                    f"first block segment must start at 0, got {starts[0]}")
            if any(b <= a for a, b in zip(starts, starts[1:])):
                raise ValueError(
                    f"block-segment starts must strictly increase: {starts}")
            if any(int(b) < 1 for _, b in self.block_schedule):
                raise ValueError(
                    f"block sizes must be positive: {self.block_schedule}")

    # -- segment table -------------------------------------------------------
    # Segments are the union of the mantissa schedule's boundaries and the
    # block schedule's boundaries: the step variant changes whenever EITHER
    # axis changes (DESIGN.md §13).
    @property
    def num_segments(self) -> int:
        return len(self.boundaries())

    def boundaries(self) -> Tuple[int, ...]:
        starts = {0}
        if self.schedule is not None:
            starts.update(self.schedule.boundaries())
        starts.update(s for s, _ in self.block_schedule)
        return tuple(sorted(starts))

    def segment_index(self, step: int) -> int:
        i = 0
        for j, start in enumerate(self.boundaries()):
            if step >= start:
                i = j
        return i

    def block_at(self, step: int) -> Optional[int]:
        """The scheduled block size governing `step` (None ⇒ the deciding
        format's own tile/act_block stand — no block scheduling)."""
        b = None
        for start, bb in self.block_schedule:
            if step >= start:
                b = int(bb)
        return b

    def segment_cfg(self, i: int) -> Optional[HBFPConfig]:
        step = self.boundaries()[i]
        if self.schedule is not None:
            cfg = self.schedule.segments[
                self.schedule.segment_index(step)][1]
        else:
            cfg = self.base
        b = self.block_at(step)
        if cfg is not None and b is not None:
            cfg = cfg.with_block(b)
        return cfg

    def resolve_segment(self, i: int) -> ResolvedPolicy:
        """Everything one train-step variant needs, frozen and hashable.
        Equal segments hash equal, so `train.make_step` shares variants
        across segments."""
        seg_cfg = self.segment_cfg(i)
        ovr = tuple(self.layer_overrides)
        if self.schedule is not None:
            ovr = ovr + tuple(self.schedule.overrides)
        return ResolvedPolicy(
            global_cfg=seg_cfg,
            layer_overrides=tuple(
                (f, sp._apply_override(seg_cfg, v)) for f, v in ovr),
            controller_overrides=tuple(
                (n, sp._apply_override(seg_cfg, v))
                for n, v in self.controller_overrides),
            role_widths=self.role_widths,
            backend=self.backend)

    # -- the single entry point ----------------------------------------------
    def resolve(self, site, step: int = 0) -> ResolvedQuant:
        """Concrete quantization decision for one site at one step."""
        rq = self.resolve_segment(self.segment_index(step)).resolve(site)
        if rq.source == "base" and self.num_segments > 1:
            rq = dataclasses.replace(rq, source="schedule")
        return rq

    def format(self, step: int = 0) -> Optional[HBFPConfig]:
        """The global (fwd) format at `step` — the serving/packing width."""
        return self.segment_cfg(self.segment_index(step))

    # -- construction ----------------------------------------------------------
    @staticmethod
    def parse(spec: str, total_steps: Optional[int] = None,
              base: Optional[HBFPConfig] = None,
              backend: Optional[str] = None) -> "PrecisionPolicy":
        return parse_policy(spec, total_steps=total_steps, base=base,
                            backend=backend)

    def with_(self, **kw) -> "PrecisionPolicy":
        return dataclasses.replace(self, **kw)

    @property
    def name(self) -> str:
        parts = []
        if self.schedule is not None:
            parts.append(self.schedule.name)
        else:
            parts.append("fp32" if self.base is None else self.base.name)
        if self.block_schedule:
            parts.append(",".join(f"b={b}@{s}"
                                  for s, b in self.block_schedule))
        parts += [rw.spec for rw in self.role_widths]
        parts += [f"{f}:{0 if v is None else v}" if not isinstance(
            v, HBFPConfig) else f"{f}:{v.name}"
            for f, v in self.layer_overrides]
        parts.append(f"backend={self.backend}")
        return "; ".join(parts)

    # -- serialization (checkpoint meta) ---------------------------------------
    def to_dict(self) -> dict:
        def ovr(pairs):
            return [[f, sp.config_to_dict(v) if isinstance(v, HBFPConfig)
                     else v] for f, v in pairs]
        return {
            "kind": "policy",
            "base": sp.config_to_dict(self.base),
            "schedule": None if self.schedule is None
            else self.schedule.to_dict(),
            "layer_overrides": ovr(self.layer_overrides),
            "controller_overrides": ovr(self.controller_overrides),
            "role_widths": [[rw.role, rw.delta, rw.bits]
                            for rw in self.role_widths],
            "backend": self.backend,
            "block_schedule": [[int(s), int(b)]
                               for s, b in self.block_schedule],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionPolicy":
        def ovr(pairs):
            # Dicts are serialized HBFPConfigs (kind == "hbfp") or {"m","b"}
            # axis overrides, which pass through verbatim (DESIGN.md §13).
            return tuple(
                (f, sp.config_from_dict(v)
                 if isinstance(v, dict) and v.get("kind") == "hbfp" else v)
                for f, v in pairs)
        return cls(
            base=sp.config_from_dict(d.get("base")),
            schedule=None if d.get("schedule") is None
            else sp.PrecisionSchedule.from_dict(d["schedule"]),
            layer_overrides=ovr(d.get("layer_overrides", [])),
            controller_overrides=ovr(d.get("controller_overrides", [])),
            role_widths=tuple(RoleWidth(r, delta=dl, bits=b)
                              for r, dl, b in d.get("role_widths", [])),
            backend=d.get("backend", "sim"),
            block_schedule=tuple((int(s), int(b))
                                 for s, b in d.get("block_schedule", [])))


# ---------------------------------------------------------------------------
# Coercion — every legacy precision spec maps onto the policy
# ---------------------------------------------------------------------------

def as_policy(spec, backend: Optional[str] = None,
              total_steps: Optional[int] = None) -> PrecisionPolicy:
    """Coerce any precision spec into a PrecisionPolicy.

    Accepts: a PrecisionPolicy (returned as-is — its own backend is
    authoritative), None / HBFPConfig (the static formats),
    a PrecisionSchedule, or a policy spec string (`parse_policy`).
    `backend` applies only when coercing legacy spec kinds.
    """
    if isinstance(spec, PrecisionPolicy):
        return spec
    if isinstance(spec, str):
        return parse_policy(spec, total_steps=total_steps, backend=backend)
    be = backend or "sim"
    if spec is None or isinstance(spec, HBFPConfig):
        return PrecisionPolicy(base=spec, backend=be)
    if isinstance(spec, sp.PrecisionSchedule):
        return PrecisionPolicy(schedule=spec, backend=be)
    raise TypeError(f"not a precision spec: {type(spec).__name__}")


def as_segment(spec, backend: Optional[str] = None) -> ResolvedPolicy:
    """Coerce a *static* precision state into a ResolvedPolicy segment.

    Accepts what `train.make_train_step` historically took: None, an
    HBFPConfig, a `schedule_precision.ResolvedPrecision` (exact=True maps
    to controller overrides, else layer overrides), or a ResolvedPolicy
    (returned as-is)."""
    if isinstance(spec, ResolvedPolicy):
        return spec
    be = backend or "sim"
    if spec is None or isinstance(spec, HBFPConfig):
        return ResolvedPolicy(global_cfg=spec, backend=be)
    if isinstance(spec, sp.ResolvedPrecision):
        if spec.exact:
            return ResolvedPolicy(global_cfg=spec.global_cfg,
                                  controller_overrides=spec.overrides,
                                  backend=be)
        return ResolvedPolicy(global_cfg=spec.global_cfg,
                              layer_overrides=spec.overrides, backend=be)
    raise TypeError(f"not a static precision state: {type(spec).__name__}")


# ---------------------------------------------------------------------------
# Spec-string DSL
# ---------------------------------------------------------------------------

_ROLE_RE = re.compile(r"^(dgrad|wgrad|attn_qk|attn_pv)\s*([+\-=])\s*(\d+)$")
_BLOCK_RE = re.compile(r"^b\s*=\s*(\d+)\s*(?:@\s*([0-9.]+%|\d+)\s*)?$")


def _parse_block_clause(clause: str, total_steps: Optional[int],
                        spec: str) -> Tuple[Tuple[int, int], ...]:
    """Parse one block-schedule clause: "b=16" or "b=16@0,b=64@50%"."""
    pairs = []
    for i, term in enumerate(t.strip() for t in clause.split(",")):
        m = _BLOCK_RE.match(term)
        if not m:
            raise ValueError(f"unparseable block term {term!r} in policy "
                             f"spec {spec!r} (grammar: b=SIZE[@START])")
        b, s = int(m.group(1)), m.group(2)
        if s is None:
            if i > 0:
                raise ValueError(
                    f"block term {term!r} of spec {spec!r} needs an explicit "
                    f"@START (only the first block term defaults to 0)")
            start = 0
        elif s.endswith("%"):
            if total_steps is None:
                raise ValueError(
                    f"spec {spec!r} uses %-steps; pass total_steps")
            start = int(round(total_steps * float(s[:-1]) / 100.0))
        else:
            start = int(s)
        pairs.append((start, b))
    return tuple(pairs)


def parse_policy(spec: str, total_steps: Optional[int] = None,
                 base: Optional[HBFPConfig] = None,
                 backend: Optional[str] = None) -> PrecisionPolicy:
    """Parse the policy DSL (the schedule grammar, extended per role).

    Grammar (semicolon-separated clauses; the FIRST clause is the format /
    schedule, in the `schedule_precision.from_spec` grammar):

        POLICY  := FORMAT (";" CLAUSE)*
        FORMAT  := "fp32" | SEG ("," SEG)*          # from_spec grammar
        SEG     := WIDTH [@START] [~ROUNDING]
        CLAUSE  := ROLE ("+"|"-") DELTA             # e.g. "wgrad+2"
                 | ROLE "=" BITS                    # e.g. "dgrad=8"
                 | BLK ("," BLK)*                   # block-size schedule
                 | NAME ":" (WIDTH | "fp32" | "0")  # per-layer override
                 | "backend=" ("sim" | "pallas")
        BLK     := "b=" SIZE [@START]               # e.g. "b=16@0,b=64@50%"

    Examples:
        "8"                                      constant hbfp8_16
        "4@0,8@90%,16@95%"                       Accuracy-Boosters staircase
        "4@0,8@90%; wgrad+2; lm_head:8; backend=pallas"
            4-bit fwd (8-bit from 90%), wgrad two bits wider, the LM head
            pinned at 8 bits, all GEMMs on the Pallas kernels.
        "4@0,8@90%; b=16@0,b=64@50%; wgrad+2"
            small exponent blocks early (finer scaling while 4-bit), coarser
            64-wide blocks from midway (FAST-style two-axis schedule).
    """
    clauses = [c.strip() for c in spec.split(";") if c.strip()]
    if not clauses:
        raise ValueError("empty policy spec")
    fmt, rest = clauses[0], clauses[1:]

    roles, overrides = [], []
    blocks: Tuple[Tuple[int, int], ...] = ()
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
            if blocks:
                raise ValueError(f"duplicate block clause {c!r} in policy "
                                 f"spec {spec!r}")
            blocks = _parse_block_clause(c, total_steps, spec)
            continue
        if ":" in c:
            name, w = (p.strip() for p in c.split(":", 1))
            if w in ("fp32", "fp", "0"):
                overrides.append((name, None))
            else:
                overrides.append((name, int(w)))
            continue
        raise ValueError(f"unparseable policy clause {c!r} in {spec!r} "
                         f"(roles: dgrad/wgrad/attn_qk/attn_pv; layer "
                         f"overrides: 'name:width'; block schedule "
                         f"'b=SIZE[@START]'; 'backend=sim|pallas')")

    if fmt == "fp32":
        fmt_base, fmt_sched = None, None
    else:
        sched = sp.from_spec(fmt, total_steps=total_steps, base=base)
        if sched.num_segments == 1:
            fmt_base, fmt_sched = sched.segments[0][1], None
        else:
            fmt_base, fmt_sched = base, sched

    return PrecisionPolicy(base=fmt_base, schedule=fmt_sched,
                           layer_overrides=tuple(overrides),
                           role_widths=tuple(roles),
                           backend=be or "sim",
                           block_schedule=blocks)
