"""Closed-loop per-layer precision controller (port of
`repro.numerics.controller`, plain Python; DESIGN.md §9).

Maps measured per-layer fidelity stats (`numerics.stats`) to mantissa-width
decisions along a fixed ladder of widths (the paper's §6 design space:
4/8/12/16 by default):

  * **widen** one rung when the layer's worst-case SQNR falls below
    `sqnr_floor_db`, its tile-saturation rate exceeds `clip_threshold`
    (mantissa clipping — dynamic range not covered), or its flush-to-zero
    rate exceeds `ftz_threshold` (an in-tile outlier crushing the mantissa
    range: SQNR stays high because the outlier dominates signal power, so
    FTZ is the only signal that sees it);
  * **narrow** one rung when the layer holds ≥ `headroom_bits` bits of SQNR
    headroom above the floor (each mantissa bit ≈ 6.02 dB) with clipping
    and flush-to-zero well inside the deadband.

With a non-empty `block_ladder` the controller additionally trades the
*block-size* axis on the same signals (FlexBlock/FAST, DESIGN.md §13):
FTZ-only triggers prefer shrinking the exponent block one rung (finer
scaling attacks the in-tile outlier directly), a widen with the mantissa
ladder exhausted falls back to a block shrink, and headroom with the
mantissa at its floor grows the block instead. Block decisions carry
`"axis": "block"` in the log and ratchet via a per-layer block cap,
mirroring the mantissa floor.

Stability (the hysteresis contract, tested in tests/test_numerics.py):

  * a **deadband** separates the widen and narrow conditions (floor vs
    floor + 6.02·headroom_bits; clip_threshold vs clip_threshold/4;
    ftz_threshold vs ftz_threshold/4);
  * decisions need `patience` *consecutive* out-of-band observations and
    respect a per-layer `cooldown` after every change;
  * a **ratchet**: once a layer widens away from a width because of a
    measured problem, it may never narrow back below the widened-to width.
    Together these guarantee a stationary distribution produces at most one
    direction change per layer before the width pins — no oscillation.

Decisions are emitted as per-layer (name, width) overrides (`overrides()`
/ `resolved()`), consumed by `train.make_step`: each decision merges into
the current policy segment (`ResolvedPolicy.with_controller`, exact-name
match) and starts a new "segment", so the host dispatcher swaps step
variants (DESIGN.md §8/§11). Names may
be role-qualified ("layer@wgrad") to pin a single GEMM role of one layer.
Controller state and the decision log serialize into checkpoint meta
(`to_meta` / `load_meta`), making restarts replay-identical. The meta log
is capped at `meta_log_cap` entries (default 256; "log_dropped" counts
evictions) so long adaptive runs don't grow checkpoints unboundedly —
replay stays bit-identical because decisions depend only on the
widths/floor/votes/cooldown state. With an `obs.Recorder` attached
(`recorder=`, or automatically via `train.make_step(recorder=...)`),
every decision also streams live as a `"precision/decision"` run-log
event (DESIGN.md §12) — the uncapped stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import schedule_precision as sp
from repro_torch.core.formats import HBFPConfig
from repro_torch.core.schedule_precision import ResolvedPrecision

DB_PER_BIT = 6.02  # SQNR gain per mantissa bit (20·log10(2))


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Thresholds and dynamics of the adaptive-precision loop.

    ladder: allowed mantissa widths, ascending (paper §6 design space).
    block_ladder: allowed exponent-block sizes, ascending (FlexBlock's
      multi-mode axis, DESIGN.md §13). Empty (the default) disables block
      control — the controller then behaves exactly as before. Non-empty,
      the controller trades the two axes on the same signals: an FTZ
      trigger (an in-tile outlier crushing small values) prefers
      *shrinking the block* one rung over widening the mantissa — finer
      exponent granularity attacks the outlier directly — and a widen
      trigger with the mantissa already at the top of its ladder falls
      back to a block shrink; symmetric headroom with the mantissa at its
      floor *grows the block* (coarser ⇒ denser/faster).
    sqnr_floor_db: widen when worst-source SQNR drops below this.
    clip_threshold: widen when the tile-saturation rate exceeds this.
    ftz_threshold: widen when the flush-to-zero rate (fraction of nonzero
      inputs quantized to exactly 0) exceeds this — the outlier-crushed-
      tile failure mode SQNR and clipping are both blind to.
    headroom_bits: narrow when SQNR ≥ floor + DB_PER_BIT·headroom_bits
      (and clipping < clip_threshold/4, FTZ < ftz_threshold/4). Keep > the
      largest ladder rung gap so a narrow can never re-trigger a widen via
      the SQNR path.
    patience: consecutive out-of-band observations required to act.
    cooldown: observations to hold a layer after any decision.
    """

    ladder: Tuple[int, ...] = (4, 8, 12, 16)
    sqnr_floor_db: float = 20.0
    clip_threshold: float = 0.05
    ftz_threshold: float = 0.5
    headroom_bits: float = 5.0
    patience: int = 2
    cooldown: int = 2
    block_ladder: Tuple[int, ...] = ()

    def __post_init__(self):
        if tuple(sorted(self.ladder)) != tuple(self.ladder) or \
                len(set(self.ladder)) != len(self.ladder):
            raise ValueError(f"ladder must be strictly ascending: "
                             f"{self.ladder}")
        bl = tuple(self.block_ladder)
        if bl and (tuple(sorted(bl)) != bl or len(set(bl)) != len(bl)):
            raise ValueError(f"block_ladder must be strictly ascending: "
                             f"{bl}")
        if self.patience < 1 or self.cooldown < 0:
            raise ValueError("patience >= 1 and cooldown >= 0 required")


def merge_sources(snapshot: dict) -> Dict[str, dict]:
    """Merge a telemetry snapshot {source: {layer: stats}} (sources:
    "weights"/"grads"/"acts") into per-layer worst-case signals: min SQNR,
    max clip/saturation/FTZ. Activation taps are global (not per-parameter)
    and are skipped here — the controller drives *weight* precision."""
    merged: Dict[str, dict] = {}
    for source in ("weights", "grads"):
        for layer, s in snapshot.get(source, {}).items():
            m = merged.setdefault(layer, {"sqnr_db": float("inf"),
                                          "clip_frac": 0.0,
                                          "sat_tile_frac": 0.0,
                                          "ftz_frac": 0.0})
            m["sqnr_db"] = min(m["sqnr_db"], s["sqnr_db"])
            for k in ("clip_frac", "sat_tile_frac", "ftz_frac"):
                m[k] = max(m[k], s[k])
    return merged


class PrecisionController:
    """Hysteresis controller over per-layer mantissa widths.

    Feed it merged per-layer stats via `observe(step, merged)`; read the
    current per-layer state via `overrides()` (PrecisionSchedule-compatible
    (name, width) pairs) or `resolved(base_cfg)` (a ResolvedPrecision ready
    for `make_train_step`). `self.log` is the append-only decision log.
    """

    def __init__(self, config: Optional[ControllerConfig] = None,
                 base_bits: int = 8, *, base_block: Optional[int] = None,
                 recorder=None, meta_log_cap: int = 256):
        self.config = config or ControllerConfig()
        if base_bits not in self.config.ladder:
            raise ValueError(f"base_bits {base_bits} not on ladder "
                             f"{self.config.ladder}")
        if meta_log_cap < 1:
            raise ValueError(f"meta_log_cap must be >= 1, got "
                             f"{meta_log_cap}")
        self.base_bits = int(base_bits)
        # block control is active iff block_ladder is non-empty; the base
        # block defaults to the ladder's coarsest rung (DESIGN.md §13)
        if self.config.block_ladder:
            bb = base_block if base_block is not None \
                else self.config.block_ladder[-1]
            if bb not in self.config.block_ladder:
                raise ValueError(f"base_block {bb} not on block ladder "
                                 f"{self.config.block_ladder}")
            self.base_block: Optional[int] = int(bb)
        else:
            if base_block is not None:
                raise ValueError("base_block requires a block_ladder")
            self.base_block = None
        self.widths: Dict[str, int] = {}     # only layers that diverged
        self.blocks: Dict[str, int] = {}     # only layers that diverged
        self._floor: Dict[str, int] = {}     # ratchet: min allowed width
        self._block_cap: Dict[str, int] = {}  # ratchet: max allowed block
        self._votes: Dict[str, int] = {}     # +widen / -narrow streak
        self._cooldown: Dict[str, int] = {}
        self.log: List[dict] = []
        # decisions already dropped from the serialized window (see
        # to_meta: the checkpoint carries only the last `meta_log_cap`
        # log entries so long adaptive runs don't grow checkpoints
        # unboundedly; replay stays bit-identical because future
        # decisions depend on widths/floor/votes/cooldown, not the log)
        self.meta_log_cap = int(meta_log_cap)
        self.log_dropped = 0
        # optional obs.Recorder: every decision also streams into the
        # run-log as a "precision/decision" event (DESIGN.md §12);
        # train.make_step attaches its recorder here when none is set
        self.recorder = recorder

    # -- state ------------------------------------------------------------
    def width(self, layer: str) -> int:
        return self.widths.get(layer, self.base_bits)

    def block(self, layer: str) -> Optional[int]:
        """Current block size of `layer` (None ⇒ block control disabled)."""
        return self.blocks.get(layer, self.base_block)

    def overrides(self) -> Tuple[Tuple[str, object], ...]:
        """Per-layer overrides, schedule-compatible, deterministic order.
        A layer whose only divergence is its mantissa emits the bare width
        (the pre-block wire format, so old consumers keep working); a layer
        whose block diverged emits an {"m", "b"} axis dict consumed by
        `schedule_precision._apply_override` (DESIGN.md §13)."""
        out = []
        for name in sorted(set(self.widths) | set(self.blocks)):
            if name in self.blocks:
                out.append((name, {"m": self.widths.get(name),
                                   "b": self.blocks[name]}))
            else:
                out.append((name, self.widths[name]))
        return tuple(out)

    def resolved(self, base_cfg: HBFPConfig) -> ResolvedPrecision:
        """ResolvedPrecision for the *current* controller state (one
        adaptive 'segment'): base_cfg everywhere, per-layer width/block
        overrides merged onto the base grid exactly like schedule
        overrides."""
        ovr = tuple((name, sp._apply_override(base_cfg, v))
                    for name, v in self.overrides())
        return ResolvedPrecision(global_cfg=base_cfg, overrides=ovr,
                                 exact=True)

    # -- the control law ---------------------------------------------------
    def _rung(self, bits: int, direction: int,
              ladder: Optional[Tuple[int, ...]] = None) -> Optional[int]:
        ladder = self.config.ladder if ladder is None else ladder
        i = ladder.index(bits) + direction
        if 0 <= i < len(ladder):
            return ladder[i]
        return None

    def observe(self, step: int, merged: Dict[str, dict]) -> List[dict]:
        """Consume one telemetry collection; returns the decisions made
        (also appended to `self.log`). Pure host logic — deterministic in
        (state, inputs), which is what makes restarts replayable."""
        cfg = self.config
        decisions: List[dict] = []
        for layer in sorted(merged):
            s = merged[layer]
            w = self.width(layer)
            b = self.block(layer)
            if self._cooldown.get(layer, 0) > 0:
                self._cooldown[layer] -= 1
                continue
            clip = s.get("sat_tile_frac", s.get("clip_frac", 0.0))
            ftz = s.get("ftz_frac", 0.0)
            # block-axis moves available from this layer's current state:
            # shrink is unratcheted; grow respects the per-layer cap
            shrink = self._rung(b, -1, cfg.block_ladder) \
                if cfg.block_ladder else None
            grow = self._rung(b, +1, cfg.block_ladder) \
                if cfg.block_ladder else None
            if grow is not None and grow > self._block_cap.get(
                    layer, cfg.block_ladder[-1]):
                grow = None
            widen_wanted = (s["sqnr_db"] < cfg.sqnr_floor_db
                            or clip > cfg.clip_threshold
                            or ftz > cfg.ftz_threshold) \
                and (self._rung(w, +1) is not None or shrink is not None)
            narrow_wanted = (not widen_wanted
                             and s["sqnr_db"] >= cfg.sqnr_floor_db
                             + DB_PER_BIT * cfg.headroom_bits
                             and clip < cfg.clip_threshold / 4.0
                             and ftz < cfg.ftz_threshold / 4.0)
            target = self._rung(w, -1) if narrow_wanted else None
            if target is not None \
                    and target < self._floor.get(layer, cfg.ladder[0]):
                target = None
            narrow_wanted = narrow_wanted \
                and (target is not None or grow is not None)

            v = self._votes.get(layer, 0)
            if widen_wanted:
                v = v + 1 if v > 0 else 1
            elif narrow_wanted:
                v = v - 1 if v < 0 else -1
            else:
                v = 0
            self._votes[layer] = v

            if v >= cfg.patience:
                to = self._rung(w, +1)
                reason = ("clip>thr" if clip > cfg.clip_threshold
                          else "sqnr<floor"
                          if s["sqnr_db"] < cfg.sqnr_floor_db
                          else "ftz>thr")
                # Trade-off law (DESIGN.md §13): an FTZ-only trigger is an
                # in-tile outlier — a block-granularity problem — so a
                # finer block is preferred over a wider mantissa; a widen
                # wanted with the mantissa ladder exhausted also falls
                # back to the block axis.
                if shrink is not None and (reason == "ftz>thr"
                                           or to is None):
                    self._apply(decisions, step, layer, "shrink_block",
                                b, shrink, reason, s, axis="block")
                    self._block_cap[layer] = shrink  # never grow back past
                else:
                    self._apply(decisions, step, layer, "widen", w, to,
                                reason, s)
                    self._floor[layer] = to  # never narrow back past
            elif v <= -cfg.patience:
                if target is not None:
                    self._apply(decisions, step, layer, "narrow", w,
                                target, "headroom", s)
                else:
                    self._apply(decisions, step, layer, "grow_block", b,
                                grow, "headroom", s, axis="block")
        return decisions

    def _apply(self, decisions, step, layer, action, frm, to, reason, s,
               axis: str = "m"):
        if axis == "block":
            if to == self.base_block:
                self.blocks.pop(layer, None)
            else:
                self.blocks[layer] = int(to)
        elif to == self.base_bits:
            self.widths.pop(layer, None)
        else:
            self.widths[layer] = int(to)
        self._votes[layer] = 0
        self._cooldown[layer] = self.config.cooldown
        d = {"step": int(step), "layer": layer, "action": action,
             "axis": axis, "from": int(frm), "to": int(to),
             "reason": reason,
             "sqnr_db": round(float(s["sqnr_db"]), 3),
             "clip_frac": float(s.get("sat_tile_frac",
                                      s.get("clip_frac", 0.0)))}
        self.log.append(d)
        decisions.append(d)
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.emit("precision/decision", step=int(step),
                               **{k: v for k, v in d.items()
                                  if k != "step"})

    # -- persistence (checkpoint meta) ------------------------------------
    def to_meta(self) -> dict:
        """Serializable state. The decision log is capped to the last
        `meta_log_cap` entries ("log_dropped" counts the rest) — the
        retained window round-trips verbatim and restarts still replay
        bit-identically, because the control law reads widths/floor/
        votes/cooldown, never the log. The full stream lives in the
        run-log when a recorder is attached."""
        cap = self.meta_log_cap
        dropped = self.log_dropped + max(0, len(self.log) - cap)
        return {"base_bits": self.base_bits,
                "base_block": self.base_block,
                "config": dataclasses.asdict(self.config),
                "widths": dict(self.widths),
                "blocks": dict(self.blocks),
                "floor": dict(self._floor),
                "block_cap": dict(self._block_cap),
                "votes": dict(self._votes),
                "cooldown": dict(self._cooldown),
                "log": list(self.log[-cap:]),
                "log_dropped": dropped}

    def load_meta(self, meta: dict) -> "PrecisionController":
        """Restore controller state saved by `to_meta` (checkpoint resume).
        The restored state + the deterministic control law make the decision
        stream bit-identical to the uninterrupted run (tested)."""
        self.base_bits = int(meta["base_bits"])
        c = dict(meta["config"])
        c["ladder"] = tuple(c["ladder"])
        c["block_ladder"] = tuple(c.get("block_ladder", ()))
        self.config = ControllerConfig(**c)
        # pre-block metas (.get defaults) restore with block control off
        bb = meta.get("base_block")
        self.base_block = None if bb is None else int(bb)
        self.widths = {k: int(v) for k, v in meta["widths"].items()}
        self.blocks = {k: int(v) for k, v in meta.get("blocks", {}).items()}
        self._floor = {k: int(v) for k, v in meta["floor"].items()}
        self._block_cap = {k: int(v)
                           for k, v in meta.get("block_cap", {}).items()}
        self._votes = {k: int(v) for k, v in meta["votes"].items()}
        self._cooldown = {k: int(v) for k, v in meta["cooldown"].items()}
        self.log = list(meta["log"])
        self.log_dropped = int(meta.get("log_dropped", 0))
        return self

    @classmethod
    def from_meta(cls, meta: dict) -> "PrecisionController":
        c = cls(base_bits=int(meta["base_bits"]))
        return c.load_meta(meta)
