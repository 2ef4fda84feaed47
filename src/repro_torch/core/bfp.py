"""Block floating point quantization, simulation path (port of
`repro.core.bfp`).

    e   = floor(log2 max|tile|)            (IEEE bit-field extraction)
    δ   = 2^(e - m + 2)                    (built from its bit pattern)
    q_i = clip(round(x_i / δ), -(2^(m-1)-1), 2^(m-1)-1)
    x̂_i = q_i * δ

The exponent and 2^e are bit manipulations, never log2/exp2, so nearest
rounding is bit-exact against the reference and idempotent. Stochastic
rounding draws its uniforms from a `torch.Generator`; it cannot replay
jax's threefry bits, so it is held to the reference statistically.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

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
