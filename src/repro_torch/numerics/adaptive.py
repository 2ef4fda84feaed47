"""The closed loop's deprecated entry point (port of
`repro.numerics.adaptive`).

The loop lives in `train.make_step(policy, controller=..., tap=...)`
(DESIGN.md §11): variants are cached per (segment ⊕ controller
overrides, telemetry); on cadence steps the telemetry variant runs, its
stats (plus the resolved per-role widths) land in the ring buffer and feed
the controller, and its decisions take effect at the next step. Pair it
with `train.Trainer(..., controller=...)` to keep the decision log in
checkpoint meta so a restart replays identical decisions.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import HBFPConfig
from repro_torch.numerics.collect import TapConfig
from repro_torch.numerics.controller import PrecisionController


def make_adaptive_train_step(arch: ArchConfig, base_cfg: HBFPConfig,
                             schedule, *,
                             controller: PrecisionController,
                             tap: Optional[TapConfig] = None, **kwargs):
    """Deprecated alias of `train.make_step(arch, base_cfg, schedule,
    controller=..., tap=...)`: returns `train_step(state, batch) ->
    (state, metrics)` with `.controller`, `.buffer`, `.tap`, `.variants`;
    metrics gain "n_overrides" and "min_mantissa_bits". Extra kwargs go to
    `make_step`."""
    from repro_torch.train.train_step import make_step

    if base_cfg is None:
        raise ValueError("adaptive precision needs a BFP base config; "
                         "fp32 has nothing to widen or narrow")
    return make_step(arch, base_cfg, schedule, controller=controller,
                     tap=tap, **kwargs)
