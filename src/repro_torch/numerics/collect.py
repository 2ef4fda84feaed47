"""Telemetry tap points and the host-side ring buffer (port of
`repro.numerics.collect`, DESIGN.md §9).

Tap points, each through the conversion kernel B7 (`numerics.stats`):

  * **weights** — `narrow_params_with_stats` derives the narrow compute
    copy exactly like `opt_shell.narrow_params` (bit-identical) and one
    `TensorStats` per BFP weight; the train step does the same per layer
    slice, so the weight tap *is* the narrowing;
  * **gradients** — `grad_stats` measures quantizing each weight gradient
    at its parameter's wgrad width (the gradients are not modified);
  * **activations** — the model taps the residual stream at the stack's
    entry and exit (`Ctx.act_tap` → `loss_fn` aux).

Collection runs on an every-N-steps cadence (`train.make_step` builds a
telemetry variant and a plain one); each collection lands in a bounded
`RingBuffer` and, with an `obs.Recorder`, streams as a
`"numerics/snapshot"` event.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import bfp
from repro_torch.core.opt_shell import (_named_map, is_hbfp_weight,
                                        leaf_slices, param_key,
                                        resolve_param_cfg)
from repro_torch.numerics.stats import (StatsAccumulator, TensorStats,
                                        quantize_with_stats, tensor_stats)
from repro_torch.optim.adamw import named_leaves


@dataclasses.dataclass(frozen=True)
class TapConfig:
    """What to collect and how often.

    cadence: collect every N steps (step % cadence == 0); None disables
      telemetry entirely (every step is the plain variant).
    weights/grads/acts: which tap points to enable on collection steps.
    history: ring-buffer length (collections retained host-side).
    """

    cadence: Optional[int] = 100
    weights: bool = True
    grads: bool = True
    acts: bool = True
    history: int = 64

    def __post_init__(self):
        if self.cadence is not None and self.cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {self.cadence}")

    def collect_at(self, step: int) -> bool:
        return self.cadence is not None and step % self.cadence == 0


def _walk_hbfp_weights(tree, cfg, role: str = "fwd"):
    """Yield (name, leaf, concrete HBFPConfig) for every BFP-eligible weight
    (the shell's name semantics; `role` selects the GEMM-role width when
    `cfg` is a policy segment, DESIGN.md §11)."""
    for name, leaf in named_leaves(tree):
        c = resolve_param_cfg(cfg, name, role)
        if c is None or not is_hbfp_weight(name, leaf):
            continue
        yield name, leaf, c


def narrow_params_with_stats(params, cfg, key: Optional[int] = None
                             ) -> Tuple[Any, Dict[str, TensorStats]]:
    """`opt_shell.narrow_params` + per-parameter fidelity stats: (narrow
    tree, {param_name: TensorStats}), the tree bit-identical to
    `narrow_params(params, cfg, key)` (a stochastic leaf is quantized on
    the shell's per-slice streams)."""
    stats: Dict[str, TensorStats] = {}

    def visit(name, leaf):
        c = resolve_param_cfg(cfg, name)
        if c is None or not is_hbfp_weight(name, leaf):
            return leaf
        k = param_key(key, name, c)
        if k is None:
            q, stats[name] = quantize_with_stats(
                leaf, c.mantissa_bits,
                bfp.weight_tile_shape(leaf.ndim, c.tile))
            return q
        acc = StatsAccumulator(leaf.device)
        q = torch.empty_like(leaf)
        for idx, s, ks, _ in leaf_slices(leaf, k):
            q[idx] = acc.add(s, c.mantissa_bits,
                             bfp.weight_tile_shape(s.ndim, c.tile), key=ks)
        stats[name] = acc.finish()
        return q

    narrow = _named_map(visit, params)
    return narrow, dict(sorted(stats.items()))


def weight_stats(params, cfg) -> Dict[str, TensorStats]:
    """Stats only (nearest rounding): what narrowing each BFP weight at its
    resolved width costs right now."""
    return {name: tensor_stats(leaf, c.mantissa_bits,
                               bfp.weight_tile_shape(leaf.ndim, c.tile))
            for name, leaf, c in _walk_hbfp_weights(params, cfg)}


def grad_stats(grads, cfg, tap=None) -> Dict[str, TensorStats]:
    """Fidelity of quantizing each weight gradient at its parameter's
    resolved *wgrad* width (nearest rounding; measurement only — the
    optimizer sees the unmodified gradients). `tap(name, leaf, c)`, when
    given, measures a leaf instead (a mesh's layout: the stats of the
    whole gradient from this rank's part)."""
    if tap is not None:
        return {name: tap(name, leaf, c) for name, leaf, c in
                _walk_hbfp_weights(grads, cfg, role="wgrad")}
    return {name: tensor_stats(leaf, c.mantissa_bits,
                               bfp.weight_tile_shape(leaf.ndim, c.tile))
            for name, leaf, c in _walk_hbfp_weights(grads, cfg,
                                                    role="wgrad")}


def snapshot_event(snapshot: dict) -> dict:
    """Run-log form of a telemetry snapshot: per-layer scalar signals +
    resolved widths, exponent histograms dropped (they dominate the bytes
    and the live table doesn't render them; post-hoc analysis still has
    the full ring buffer / results dump)."""
    keep = ("sqnr_db", "clip_frac", "sat_tile_frac", "ftz_frac",
            "exp_spread")
    out: Dict[str, Any] = {}
    for source in ("weights", "grads", "acts"):
        layers = snapshot.get(source)
        if not layers:
            continue
        out[source] = {layer: {k: s[k] for k in keep if k in s}
                       for layer, s in layers.items()}
    out["widths"] = snapshot.get("widths", {})
    return out


class RingBuffer:
    """Bounded host-side history of telemetry collections. With a
    `recorder`, every append also streams as a `"numerics/snapshot"`
    run-log event (compacted via `snapshot_event`)."""

    def __init__(self, maxlen: int = 64, *, recorder=None):
        self._buf = collections.deque(maxlen=maxlen)
        self.recorder = recorder

    def append(self, step: int, snapshot: dict):
        self._buf.append((int(step), snapshot))
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.emit("numerics/snapshot", step=int(step),
                               **snapshot_event(snapshot))

    def latest(self) -> Optional[Tuple[int, dict]]:
        return self._buf[-1] if self._buf else None

    def history(self):
        return list(self._buf)

    def __len__(self):
        return len(self._buf)
