"""Precision schedules: variable-mantissa HBFP over a training run (port
of `repro.core.schedule_precision`, plain Python).

The paper fixes one mantissa width for the whole run (hbfp8_16 / hbfp12_16).
Follow-up work relaxes that: Accuracy Boosters (Harma et al., arXiv:2211.10737)
trains most epochs with 4-bit mantissas and widens only for the final epochs;
FAST (Zhang et al., HPCA'22) grows precision layer- and iteration-wise. This
module adds that axis on top of the static reproduction (DESIGN.md §8):

  * `PrecisionSchedule` — a step-driven piecewise-constant table of
    `HBFPConfig` segments (mantissa width AND rounding mode may change per
    segment), plus per-layer overrides keyed by parameter-name substring.
  * `resolve(step, layer_name)` returns the concrete `HBFPConfig` governing
    one parameter at one step — `None` means "stay FP".
  * `resolve_segment(i)` returns a `ResolvedPrecision`: everything the train
    step needs for one segment, as a static (hashable) object. Because the
    schedule is a *finite* table, a scheduled run builds one step variant
    per segment and dispatches on the host step counter (see
    `train.make_step`).

Scope note: per-layer overrides govern the *weight* precision (the optimizer
shell's narrow/widen quantization, applied per parameter name). The
activation/gradient quantization follows the schedule's global segment
config, one activation config per step, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core.formats import HBFPConfig

# Per-layer override values: a full HBFPConfig, a bare mantissa width (applied
# to the segment config via with_), an {"m": ..., "b": ...} axis dict (mantissa
# and/or block size merged into the segment config — the numerics controller
# emits these when a block-size decision diverges a layer, DESIGN.md §13), or
# None (keep the parameter in FP).
OverrideValue = Union[None, int, dict, HBFPConfig]


def _apply_override(base: Optional[HBFPConfig],
                    value: OverrideValue) -> Optional[HBFPConfig]:
    if value is None or isinstance(value, HBFPConfig):
        return value
    # Bare width / axis dict: merge into the segment config so unspecified
    # axes (tile/rounding/wide; mantissa or block for a dict) follow the
    # segment. In an FP32 segment there is no grid to merge into — such an
    # override follows the segment and stays FP (an explicit HBFPConfig
    # override, above, still applies even there).
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
class ResolvedPrecision:
    """The precision state of one schedule segment, fully concrete.

    `global_cfg` governs in-graph activation/gradient quantization and any
    parameter no override matches; `overrides` are (name-fragment, config)
    pairs resolved per parameter by `for_param` (first match wins, matching
    the FP-exemption rule's substring semantics in `opt_shell`). With
    `exact=True` fragments must equal the full parameter name instead —
    machine-generated overrides (the numerics controller emits full names)
    use this so one layer's decision can never substring-capture another.
    """

    global_cfg: Optional[HBFPConfig]
    overrides: Tuple[Tuple[str, Optional[HBFPConfig]], ...] = ()
    exact: bool = False

    def for_param(self, name: str,
                  role: str = "fwd") -> Optional[HBFPConfig]:
        """`role` is accepted for signature-compatibility with
        `precision.ResolvedPolicy.for_param` and ignored — per-GEMM-role
        widths are a policy concept (DESIGN.md §11)."""
        del role
        lname = name.lower()
        for frag, cfg in self.overrides:
            if frag.lower() == lname if self.exact else frag.lower() in lname:
                return cfg
        return self.global_cfg

    @property
    def is_fp32(self) -> bool:
        return self.global_cfg is None and all(c is None
                                               for _, c in self.overrides)

    @property
    def any_stochastic(self) -> bool:
        cfgs = [self.global_cfg] + [c for _, c in self.overrides]
        return any(c is not None and c.rounding == "stochastic" for c in cfgs)


@dataclasses.dataclass(frozen=True)
class PrecisionSchedule:
    """Piecewise-constant precision over training steps + per-layer overrides.

    Attributes:
      segments: ((start_step, config), ...) sorted by start_step; the first
        segment must start at 0. `config` may be None (FP32 for that span).
      overrides: ((name_fragment, value), ...) — value is an HBFPConfig, a
        bare mantissa width (int, merged into the segment config), or None
        (parameter stays FP). First matching fragment wins.
    """

    segments: Tuple[Tuple[int, Optional[HBFPConfig]], ...]
    overrides: Tuple[Tuple[str, OverrideValue], ...] = ()

    def __post_init__(self):
        if not self.segments:
            raise ValueError("schedule needs at least one segment")
        starts = [s for s, _ in self.segments]
        if starts[0] != 0:
            raise ValueError(f"first segment must start at 0, got {starts[0]}")
        if any(b <= a for a, b in zip(starts, starts[1:])):
            raise ValueError(f"segment starts must strictly increase: {starts}")

    # -- lookup ----------------------------------------------------------
    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def boundaries(self) -> Tuple[int, ...]:
        """Steps at which the resolved config changes (segment starts)."""
        return tuple(s for s, _ in self.segments)

    def segment_index(self, step: int) -> int:
        """Index of the segment governing `step` (host int)."""
        i = 0
        for j, (start, _) in enumerate(self.segments):
            if step >= start:
                i = j
        return i

    def resolve(self, step: int,
                layer_name: Optional[str] = None) -> Optional[HBFPConfig]:
        """Concrete HBFPConfig for (step, parameter) — None means FP."""
        base = self.segments[self.segment_index(step)][1]
        if layer_name is None:
            return base
        return self.resolve_segment(self.segment_index(step)) \
                   .for_param(layer_name)

    def resolve_segment(self, i: int) -> ResolvedPrecision:
        base = self.segments[i][1]
        return ResolvedPrecision(
            global_cfg=base,
            overrides=tuple((frag, _apply_override(base, v))
                            for frag, v in self.overrides))

    # -- construction ----------------------------------------------------
    def with_overrides(self, overrides) -> "PrecisionSchedule":
        return dataclasses.replace(self, overrides=tuple(
            (str(f), v) for f, v in overrides))

    @property
    def name(self) -> str:
        parts = []
        for start, c in self.segments:
            parts.append(f"{'fp32' if c is None else c.mantissa_bits}@{start}")
        tag = "sched[" + ",".join(parts) + "]"
        if self.overrides:
            tag += "+ovr" + str(len(self.overrides))
        return tag

    # -- serialization (checkpoint meta round-trip) ----------------------
    def to_dict(self) -> dict:
        return {
            "kind": "schedule",
            "segments": [[int(s), config_to_dict(c)] for s, c in self.segments],
            "overrides": [[f, config_to_dict(v) if isinstance(v, HBFPConfig)
                           else v] for f, v in self.overrides],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionSchedule":
        def ovr(v):
            # Dicts are either serialized HBFPConfigs (kind == "hbfp") or
            # {"m", "b"} axis overrides, which pass through verbatim.
            if isinstance(v, dict) and v.get("kind") == "hbfp":
                return config_from_dict(v)
            return v
        return cls(
            segments=tuple((int(s), config_from_dict(c))
                           for s, c in d["segments"]),
            overrides=tuple((f, ovr(v)) for f, v in d.get("overrides", [])))


# ---------------------------------------------------------------------------
# Constructors — the schedule shapes from the literature
# ---------------------------------------------------------------------------

def constant(cfg: Optional[HBFPConfig],
             overrides=()) -> PrecisionSchedule:
    """One config for the whole run — bit-identical to the static path."""
    return PrecisionSchedule(segments=((0, cfg),),
                             overrides=tuple(overrides))


def staircase(widths_at_steps: Sequence[Tuple[int, int]],
              base: Optional[HBFPConfig] = None,
              overrides=()) -> PrecisionSchedule:
    """Accuracy-Boosters-style staircase: ((start_step, mantissa_bits), ...).

    E.g. ((0, 4), (900, 8), (950, 16)): 4-bit mantissas for most of the run,
    widened near the end. `base` supplies tile/wide/rounding defaults.
    """
    b = base if base is not None else HBFPConfig()
    segs = tuple((int(s), b.with_(mantissa_bits=int(m),
                                  wide_mantissa_bits=max(b.wide_mantissa_bits,
                                                         int(m))))
                 for s, m in widths_at_steps)
    return PrecisionSchedule(segments=segs, overrides=tuple(overrides))


def warmup_then_narrow(wide_bits: int, narrow_bits: int, switch_step: int,
                       base: Optional[HBFPConfig] = None,
                       overrides=()) -> PrecisionSchedule:
    """Train the unstable warmup phase wide, then drop to the narrow format
    (the transpose of Accuracy Boosters; useful when early training diverges
    at 4-bit)."""
    return staircase(((0, wide_bits), (int(switch_step), narrow_bits)),
                     base=base, overrides=tuple(overrides))


def as_schedule(spec) -> PrecisionSchedule:
    """Coerce None / HBFPConfig / PrecisionSchedule into a PrecisionSchedule."""
    if isinstance(spec, PrecisionSchedule):
        return spec
    if spec is None or isinstance(spec, HBFPConfig):
        return constant(spec)
    raise TypeError(f"not a precision spec: {type(spec).__name__}")


# ---------------------------------------------------------------------------
# Spec-string DSL (configs/base.py `hbfp_spec`, CLI flags)
# ---------------------------------------------------------------------------

def from_spec(spec: str, total_steps: Optional[int] = None,
              base: Optional[HBFPConfig] = None,
              overrides=()) -> PrecisionSchedule:
    """Parse a compact schedule spec into a PrecisionSchedule.

    Grammar (comma-separated segments):
        SEG  := WIDTH [@START] [~ROUNDING]
        WIDTH := int mantissa bits, or "fp32"
        START := step int, or "P%" of total_steps (requires total_steps);
                 defaults to 0 and is therefore only optional on the FIRST
                 segment — later segments must say where they start
        ROUNDING := "nearest" | "stochastic"

    Examples:
        "8"                      constant hbfp8_16
        "4@0,8@90%,16@95%"       Accuracy-Boosters staircase
        "12@0,4@200~stochastic"  warmup-then-narrow with SR after step 200
    """
    b = base if base is not None else HBFPConfig()
    segs = []
    for i, part in enumerate(p.strip() for p in spec.split(",")):
        rounding = None
        if "~" in part:
            part, rounding = part.split("~", 1)
            if rounding not in ("nearest", "stochastic"):
                raise ValueError(f"bad rounding {rounding!r} in spec {spec!r}")
        start = 0
        if "@" in part:
            part, s = part.split("@", 1)
            if s.endswith("%"):
                if total_steps is None:
                    raise ValueError(
                        f"spec {spec!r} uses %-steps; pass total_steps")
                start = int(round(total_steps * float(s[:-1]) / 100.0))
            else:
                start = int(s)
        elif i > 0:
            raise ValueError(
                f"segment {i + 1} ({part!r}) of spec {spec!r} needs an "
                f"explicit @START (only the first segment defaults to 0)")
        if part == "fp32":
            cfg = None
        else:
            m = int(part)
            cfg = b.with_(mantissa_bits=m,
                          wide_mantissa_bits=max(b.wide_mantissa_bits, m))
            if rounding is not None:
                cfg = cfg.with_(rounding=rounding)
        if i == 0 and start != 0:
            raise ValueError(f"first segment of {spec!r} must start at 0")
        segs.append((start, cfg))
    return PrecisionSchedule(segments=tuple(segs), overrides=tuple(overrides))


# ---------------------------------------------------------------------------
# Serialization helpers shared with formats/checkpointing
# ---------------------------------------------------------------------------

def config_to_dict(cfg: Optional[HBFPConfig]) -> Optional[dict]:
    if cfg is None:
        return None
    d = dataclasses.asdict(cfg)
    d["kind"] = "hbfp"
    return d


def config_from_dict(d: Optional[dict]) -> Optional[HBFPConfig]:
    if d is None:
        return None
    d = {k: v for k, v in d.items() if k != "kind"}
    return HBFPConfig(**d)


def precision_to_dict(spec) -> Optional[dict]:
    """Serialize None / HBFPConfig / PrecisionSchedule / PrecisionPolicy
    (checkpoint meta; anything with `.to_dict` serializes itself)."""
    if spec is None:
        return None
    if isinstance(spec, HBFPConfig):
        return config_to_dict(spec)
    return spec.to_dict()


def precision_from_dict(d: Optional[dict]):
    if d is None:
        return None
    if d.get("kind") == "policy":
        # lazy: precision composes on top of this module (DESIGN.md §11)
        from repro_torch.precision.policy import PrecisionPolicy
        return PrecisionPolicy.from_dict(d)
    if d.get("kind") == "schedule":
        return PrecisionSchedule.from_dict(d)
    return config_from_dict(d)
