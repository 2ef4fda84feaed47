"""Block floating point quantization (port of `repro.core.bfp`): the
simulation path and the packed representation.

    e   = floor(log2 max|tile|)            (IEEE bit-field extraction)
    δ   = 2^(e - m + 2)                    (built from its bit pattern)
    q_i = clip(round(x_i / δ), -(2^(m-1)-1), 2^(m-1)-1)
    x̂_i = q_i * δ

The exponent and 2^e are bit manipulations, never log2/exp2, so nearest
rounding is bit-exact against the reference and idempotent. Stochastic
rounding draws its uniforms from a `torch.Generator`; it cannot replay
jax's threefry bits, so it is held to the reference statistically.

`pack` / `unpack` / `PackedBFP` are the storage format (int mantissas and
int8 per-tile exponents, the paper's "2× more compact models"); `pack`
runs the conversion kernel B7 (`kernels/bfp_quantize.py`) on each 2-D
slice, the plain version for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.bfp_quantize import bfp_quantize

EXP_FLOOR = -100
EXP_CEIL = 126


def _max_exponent(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2(amax)) of amax >= 0 via the f32 bit field (int32)."""
    bits = amax.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return e.clamp(EXP_FLOOR, EXP_CEIL)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e in the normal f32 range."""
    bits = (e.to(torch.int32) + 127) << 23
    return bits.contiguous().view(torch.float32)


def _tile_view(shape: Tuple[int, ...], tile_shape: Sequence[Optional[int]]):
    """(padded_shape, grouped_shape, reduce_axes, needs_pad) of a tile spec:
    None shares one exponent along the whole dim, int t groups by t."""
    if len(tile_shape) != len(shape):
        raise ValueError(f"tile_shape rank {len(tile_shape)} != x rank {len(shape)}")
    padded, grouped, reduce_axes = [], [], []
    for i, (d, t) in enumerate(zip(shape, tile_shape)):
        t = d if t is None else min(t, d) if d > 0 else 1
        n = -(-d // t) if d > 0 else 1
        padded.append(n * t)
        grouped.extend((n, t))
        reduce_axes.append(2 * i + 1)
    needs_pad = tuple(padded) != tuple(shape)
    return tuple(padded), tuple(grouped), tuple(reduce_axes), needs_pad


def _pad_to(x: torch.Tensor, padded: Sequence[int]) -> torch.Tensor:
    pad = []
    for p, d in reversed(list(zip(padded, x.shape))):
        pad.extend((0, p - d))
    return torch.nn.functional.pad(x, pad)


def tile_scales(x: torch.Tensor, mantissa_bits: int,
                tile_shape: Sequence[Optional[int]]) -> torch.Tensor:
    """Per-element quantization step δ, broadcast back to x.shape."""
    padded, grouped, axes, needs_pad = _tile_view(tuple(x.shape), tile_shape)
    ax = x.to(torch.float32).abs()
    if needs_pad:
        ax = _pad_to(ax, padded)
    g = ax.reshape(grouped)
    amax = g.amax(dim=axes, keepdim=True)
    delta = pow2(_max_exponent(amax) - mantissa_bits + 2)
    delta = delta.expand(grouped).reshape(padded)
    if needs_pad:
        delta = delta[tuple(slice(0, d) for d in x.shape)]
    return delta


def _round(v: torch.Tensor, rounding: str,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        u = torch.rand(v.shape, generator=generator, device=v.device,
                       dtype=v.dtype)
        return torch.floor(v + u)
    return torch.round(v)  # round-half-even


def quantize(x: torch.Tensor, mantissa_bits: int,
             tile_shape: Sequence[Optional[int]],
             rounding: str = "nearest",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """FP→BFP→FP simulation: the dequantized tensor, in x's dtype."""
    if mantissa_bits >= 24:
        return x
    dt = x.dtype
    xf = x.to(torch.float32)
    delta = tile_scales(xf, mantissa_bits, tile_shape)
    lim = float(2 ** (mantissa_bits - 1) - 1)
    q = _round(xf / delta, rounding, generator).clamp(-lim, lim)
    return (q * delta).to(dt)


def act_tile_shape(rank: int, act_block: Optional[int]
                   ) -> Tuple[Optional[int], ...]:
    """Activations: one exponent per row, optionally per feature block."""
    return (1,) * (rank - 1) + (act_block,)


def weight_tile_shape(rank: int, tile: Optional[int]
                      ) -> Tuple[Optional[int], ...]:
    """Weights: 2-D tiles on the two trailing dims."""
    if rank == 1:
        return (tile,)
    return (1,) * (rank - 2) + (tile, tile)


def quantize_act(x, cfg, generator=None):
    """Quantize an activation/gradient tensor per the paper's policy."""
    return quantize(x, cfg.mantissa_bits, act_tile_shape(x.ndim, cfg.act_block),
                    cfg.rounding, generator)


def quantize_weight(x, cfg, generator=None, wide: bool = False):
    """Quantize a weight tensor (narrow compute copy, or wide storage)."""
    m = cfg.wide_mantissa_bits if wide else cfg.mantissa_bits
    return quantize(x, m, weight_tile_shape(x.ndim, cfg.tile), cfg.rounding,
                    generator)


# ----------------------------------------------------------------------------
# Packed representation (checkpoint compression), through B7
# ----------------------------------------------------------------------------

def b7_layout(shape: Tuple[int, ...], tile_shape: Sequence[Optional[int]]):
    """How B7 covers a tensor: (lead, R, C, tile_r, tile_c, merged). The
    leading dims (tile 1) are a batch of [R, C] slices with (tile_r,
    tile_c) tiles clipped to the slice; `merged` when the batch goes to B7
    as one [lead·R, C] view (tile_r divides R, so no tile crosses a
    slice), else one launch per slice. A 1-D tensor is one [1, C] row."""
    shape = tuple(shape)
    if len(tile_shape) != len(shape):
        raise ValueError(f"tile_shape rank {len(tile_shape)} != x rank "
                         f"{len(shape)}")
    if len(shape) == 1:
        t = tile_shape[0]
        return (), 1, shape[0], 1, shape[0] if t is None \
            else min(t, shape[0]), True
    lead = shape[:-2]
    if any(t != 1 and d != 1 for d, t in zip(lead, tile_shape[:-2])):
        raise ValueError(f"B7 tiles the two trailing dims only: tile_shape "
                         f"{tuple(tile_shape)} for shape {shape}")
    R, C = shape[-2:]
    a, b = tile_shape[-2:]
    tr = R if a is None else min(a, R)
    tc = C if b is None else min(b, C)
    return lead, R, C, tr, tc, math.prod(lead) == 1 or R % tr == 0


def b7_slices(x: torch.Tensor, tile_shape: Sequence[Optional[int]]):
    """The 2-D operands B7 converts for x under tile_shape (see
    `b7_layout`), with their (tile_r, tile_c)."""
    lead, R, C, tr, tc, merged = b7_layout(tuple(x.shape), tile_shape)
    if merged:
        return [x.reshape(-1, C)], tr, tc
    return list(x.reshape(-1, R, C)), tr, tc


class PackedBFP:
    """Storage format: int mantissas (int8 for m <= 8, else int16) on the
    padded shape and one int8 exponent per tile."""

    def __init__(self, mantissa, exponent, mantissa_bits, tile_shape, shape):
        self.mantissa = mantissa
        self.exponent = exponent
        self.mantissa_bits = int(mantissa_bits)
        self.tile_shape = tuple(tile_shape)
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.mantissa, self.exponent))


def pack(x: torch.Tensor, mantissa_bits: int,
         tile_shape: Sequence[Optional[int]],
         rounding: str = "nearest") -> PackedBFP:
    """Quantize and pack x into (mantissa, per-tile exponent) through B7,
    one launch per `b7_slices` operand. The mantissas take the
    reference's padded shape (the padding is exact zeros)."""
    if rounding == "stochastic":
        raise NotImplementedError(
            "stochastic packing (the reference draws threefry noise) comes "
            "with ROADMAP A5")
    padded, grouped, _, _ = _tile_view(tuple(x.shape), tile_shape)
    parts, tr, tc = b7_slices(x, tile_shape)
    outs = [bfp_quantize(p, 0, mantissa_bits=mantissa_bits, tile_r=tr,
                         tile_c=tc) for p in parts]
    mant = torch.cat([m for m, _ in outs]).reshape(x.shape)
    if tuple(padded) != tuple(x.shape):
        full = torch.zeros(padded, dtype=mant.dtype, device=mant.device)
        full[tuple(slice(0, d) for d in x.shape)] = mant
        mant = full
    expo = torch.cat([e for _, e in outs]).reshape(grouped[0::2])
    return PackedBFP(mant, expo, mantissa_bits, tile_shape, x.shape)


def unpack(p: PackedBFP, dtype=torch.float32) -> torch.Tensor:
    """The dequantized tensor of a PackedBFP, in `dtype`."""
    padded, grouped, _, _ = _tile_view(p.shape, p.tile_shape)
    e = p.exponent.to(torch.int32)
    ones = [1] * len(p.shape)
    e = e.reshape([n for pair in zip(e.shape, ones) for n in pair])
    delta = pow2(e - p.mantissa_bits + 2)
    g = p.mantissa.reshape(grouped).to(torch.float32) * delta
    out = g.reshape(padded)[tuple(slice(0, d) for d in p.shape)]
    return out.to(dtype)
