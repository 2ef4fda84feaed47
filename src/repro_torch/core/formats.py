"""HBFP format configuration (port of `repro.core.formats`).

`HBFPConfig` carries the same fields, defaults, validation and paper-style
`.name` as the reference, so one format means the same quantization in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Rounding = Literal["nearest", "stochastic"]


@dataclasses.dataclass(frozen=True)
class HBFPConfig:
    """Configuration of the hybrid block-floating-point scheme.

    mantissa_bits: signed mantissa width of compute-path BFP tensors.
    wide_mantissa_bits: mantissa width of the long-lived weight storage.
    tile: exponent-sharing tile edge of 2-D weight tiles (None: one
      exponent per tensor row-block).
    act_block: exponent granularity of activations along the feature axis
      (None: one exponent per row).
    rounding: "nearest" (round-half-even) or "stochastic".
    quantize_attention / quantize_lm_head: run those products in BFP.
    compute_dtype: dtype of the FP side.
    stochastic_seed: base seed of the stochastic-rounding streams.
    requantize_weights: False trusts that weight operands were narrowed
      upstream and skips their in-graph re-quantization (a numeric no-op by
      BFP idempotence).
    """

    mantissa_bits: int = 8
    wide_mantissa_bits: int = 16
    tile: Optional[int] = 128
    act_block: Optional[int] = None
    rounding: Rounding = "nearest"
    quantize_attention: bool = True
    quantize_lm_head: bool = True
    compute_dtype: str = "float32"
    stochastic_seed: int = 0x5EED
    requantize_weights: bool = True

    def __post_init__(self):
        if not (2 <= self.mantissa_bits <= 24):
            raise ValueError(f"mantissa_bits out of range: {self.mantissa_bits}")
        if self.wide_mantissa_bits < self.mantissa_bits:
            raise ValueError("wide storage must be at least as wide as compute")
        if self.tile is not None and self.tile < 1:
            raise ValueError(f"tile must be positive, got {self.tile}")

    @property
    def name(self) -> str:
        """Paper nomenclature: hbfp<m>_<wide>_t<tile>[_b<block>]."""
        t = "none" if self.tile is None else str(self.tile)
        tag = f"hbfp{self.mantissa_bits}_{self.wide_mantissa_bits}_t{t}"
        if self.act_block is not None:
            tag += f"_b{self.act_block}"
        return tag

    def with_(self, **kw) -> "HBFPConfig":
        return dataclasses.replace(self, **kw)

    @property
    def block_size(self) -> Optional[int]:
        """The schedulable exponent-sharing block size (DESIGN.md §13):
        the activation block when set, else the weight tile edge."""
        return self.act_block if self.act_block is not None else self.tile

    def with_block(self, b: Optional[int]) -> "HBFPConfig":
        """Set block size `b` on both exponent-sharing axes; None restores
        tile 128 with whole-row activation exponents."""
        if b is None:
            return self.with_(tile=128, act_block=None)
        b = int(b)
        if b < 1:
            raise ValueError(f"block size must be positive, got {b}")
        return self.with_(tile=b, act_block=b)


HBFP8_16 = HBFPConfig(mantissa_bits=8, wide_mantissa_bits=16)
HBFP12_16 = HBFPConfig(mantissa_bits=12, wide_mantissa_bits=16)
FP32 = None
