"""Block floating point quantization (port of `repro.core.bfp`): the
simulation path and the packed representation.

    e   = floor(log2 max|tile|)            (IEEE bit-field extraction)
    δ   = 2^(e - m + 2)                    (built from its bit pattern)
    q_i = clip(round(x_i / δ), -(2^(m-1)-1), 2^(m-1)-1)
    x̂_i = q_i * δ

The exponent and 2^e are bit manipulations, never log2/exp2, so nearest
rounding is bit-exact against the reference and idempotent. Stochastic
rounding takes an int key (`kernels.common.fold_in`) and draws
u = `uniform_from_index(seed_from_key(key), i)` for the element at
row-major index i of the zero-padded tensor: B7's stream (row-major over
its padded 2-D operand, stream 0), so `quantize` equals B7's plain
version and kernel bit for bit. Torch cannot replay jax's threefry bits,
so this rounding is held to the reference statistically.

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
from repro_torch.kernels.common import (IndexBase, base_rows, index_base,
                                        is_whole, seed_from_key,
                                        uniform_from_index)
from repro_torch.kernels.ref import _wrap_i32

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


def padded_shape(shape: Sequence[int],
                 tile_shape: Sequence[Optional[int]]) -> Tuple[int, ...]:
    """The zero-padded shape a tensor of `shape` is quantized on."""
    return _tile_view(tuple(shape), tile_shape)[0]


def _pad_to(x: torch.Tensor, padded: Sequence[int]) -> torch.Tensor:
    pad = []
    for p, d in reversed(list(zip(padded, x.shape))):
        pad.extend((0, p - d))
    return torch.nn.functional.pad(x, pad)


def _tile_steps(x: torch.Tensor, mantissa_bits: int,
                tile_shape: Sequence[Optional[int]]):
    """(x zero-padded to whole tiles in its grouped view, one step δ a
    tile broadcastable against it, the padded shape)."""
    padded, grouped, axes, needs_pad = _tile_view(tuple(x.shape), tile_shape)
    g = (_pad_to(x, padded) if needs_pad else x).reshape(grouped)
    # |x| and its max are exact in x's dtype
    amax = g.abs().amax(dim=axes, keepdim=True)
    return g, pow2(_max_exponent(amax) - mantissa_bits + 2), padded


def tile_scales(x: torch.Tensor, mantissa_bits: int,
                tile_shape: Sequence[Optional[int]]) -> torch.Tensor:
    """Per-element quantization step δ, broadcast back to x.shape."""
    g, delta, padded = _tile_steps(x, mantissa_bits, tile_shape)
    delta = delta.expand(g.shape).reshape(padded)
    return delta[tuple(slice(0, d) for d in x.shape)]


# elements whose uniforms one pass of stochastic rounding draws at once
# (bounds its index and hash temporaries on a large weight)
_DRAW_CHUNK = 1 << 24


def _round_stochastic(v: torch.Tensor, padded, key: int,
                      base: Optional[IndexBase] = None) -> torch.Tensor:
    """floor(v + u), u drawn at each element's row-major index in the
    padded shape (with `base`, in the padded one-process operand of which
    v is a part: `kernels.common.base_rows`), a chunk of rows at a
    time."""
    if v.ndim == 0:
        return _round_stochastic(v.reshape(1), (1,), key).reshape(())
    seed = seed_from_key(key)
    C = v.shape[-1]
    starts = base_rows(base or index_base(v.shape), v.shape, padded,
                       v.device)
    v2 = v.reshape(-1, C)
    out = torch.empty_like(v2)
    cols = torch.arange(C, dtype=torch.int32, device=v.device)
    step = max(1, _DRAW_CHUNK // max(C, 1))
    for r0 in range(0, v2.shape[0], step):
        # int32 adds wrap, so only the [rows, 1] start is formed in int64
        idx = _wrap_i32(starts[r0:r0 + step, None]) + cols
        out[r0:r0 + step] = torch.floor(v2[r0:r0 + step]
                                        + uniform_from_index(seed, idx))
    return out.reshape(v.shape)


def quantize(x: torch.Tensor, mantissa_bits: int,
             tile_shape: Sequence[Optional[int]],
             rounding: str = "nearest",
             key: Optional[int] = None,
             amax: Optional[torch.Tensor] = None,
             base: Optional[IndexBase] = None) -> torch.Tensor:
    """FP→BFP→FP simulation: the dequantized tensor, in x's dtype.
    Stochastic rounding needs an int `key`. `amax` ([..., 1], f32), for
    row tiles (1, ..., 1, None) only, is each row's group amax taken
    instead of the row's own (the global row max of a row whose features
    are split over tensor-parallel ranks); for column tiles (1, ..., 1,
    None, 1) it is [..., 1, N], each column's (the global amax of a
    column split over the ranks along its rows). `base` (a
    `kernels.common.IndexBase` on the unpadded one-process operand) makes
    x that part of it: its draws are the one-process operand's at the
    part's elements (x's tiles must be whole tiles of that operand, or
    rows on their global `amax`)."""
    if mantissa_bits >= 24:
        return x
    dt = x.dtype
    lim = float(2 ** (mantissa_bits - 1) - 1)
    if amax is None:
        g, delta, padded = _tile_steps(x, mantissa_bits, tile_shape)
    elif tuple(tile_shape) in ((1,) * (x.ndim - 1) + (None,),
                               (1,) * (x.ndim - 2) + (None, 1)):
        g, padded = x, tuple(x.shape)
        delta = pow2(_max_exponent(amax) - mantissa_bits + 2)
    else:
        raise ValueError(f"a given amax needs row or column tiles, got "
                         f"{tuple(tile_shape)}")
    # one f32 copy in the grouped view, rounded in place with one step a
    # tile (never materialized per element): a large activation (a decode
    # ring's kᵀ and v) costs that copy beside the result
    q = g.to(torch.float32, copy=True).div_(delta)
    v = q.reshape(padded)[tuple(slice(0, d) for d in x.shape)]
    if rounding == "stochastic":
        if key is None:
            raise ValueError("stochastic rounding requires a key")
        if is_whole(base, x.shape):
            base = None
        whole = padded_shape(x.shape if base is None else base.shape,
                             tile_shape)
        v.copy_(_round_stochastic(v, whole, key, base))
    else:
        v.round_()  # round-half-even
    q.clamp_(-lim, lim).mul_(delta)
    out = v.to(dt)
    # x's layout where q mirrors it; a view into the padding, densely
    return out if padded == tuple(x.shape) else out.contiguous()


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


def quantize_act(x, cfg, key=None, amax=None, base=None):
    """Quantize an activation/gradient tensor per the paper's policy
    (`amax`: the rows' group amax, `base`: x's part, see `quantize`)."""
    return quantize(x, cfg.mantissa_bits, act_tile_shape(x.ndim, cfg.act_block),
                    cfg.rounding, key, amax, base)


def quantize_weight(x, cfg, key=None, wide: bool = False, base=None):
    """Quantize a weight tensor (narrow compute copy, or wide storage);
    `base`: x's part of the whole weight (see `quantize`)."""
    m = cfg.wide_mantissa_bits if wide else cfg.mantissa_bits
    return quantize(x, m, weight_tile_shape(x.ndim, cfg.tile), cfg.rounding,
                    key, base=base)


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


def b7_slices(x: torch.Tensor, tile_shape: Sequence[Optional[int]],
              whole_rows: bool = False):
    """The 2-D operands B7 converts for x under tile_shape (see
    `b7_layout`), with their (tile_r, tile_c). `whole_rows` (stochastic
    rounding) makes one operand of a batch that is not `merged`: each
    slice zero-padded to whole tile rows, so that B7's row-major index is
    the padded tensor's (`quantize`'s stream); `b7_gather` drops the
    padding rows again."""
    lead, R, C, tr, tc, merged = b7_layout(tuple(x.shape), tile_shape)
    if merged:
        return [x.reshape(-1, C)], tr, tc
    if whole_rows:
        Rp = -(-R // tr) * tr
        xp = torch.nn.functional.pad(x.reshape(-1, R, C), (0, 0, 0, Rp - R))
        return [xp.reshape(-1, C)], tr, tc
    return list(x.reshape(-1, R, C)), tr, tc


def b7_gather(parts, shape: Tuple[int, ...]) -> torch.Tensor:
    """The row-wise outputs of the `b7_slices` operands, concatenated, in
    the tensor's `shape` (padding rows of `whole_rows` dropped)."""
    t = torch.cat(list(parts))
    if len(shape) >= 2:
        t = t.reshape(*shape[:-2], -1, shape[-1])[..., :shape[-2], :]
    return t.reshape(shape)


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
         rounding: str = "nearest", key: Optional[int] = None) -> PackedBFP:
    """Quantize and pack x into (mantissa, per-tile exponent) through B7,
    one launch per `b7_slices` operand. The mantissas take the
    reference's padded shape (the padding is exact zeros). Stochastic
    rounding needs an int `key`; the mantissas are those of
    `quantize(x, ..., "stochastic", key)`."""
    stochastic = rounding == "stochastic"
    if stochastic and key is None:
        raise ValueError("stochastic rounding requires a key")
    padded, grouped, _, _ = _tile_view(tuple(x.shape), tile_shape)
    parts, tr, tc = b7_slices(x, tile_shape, whole_rows=stochastic)
    seed = seed_from_key(key) if stochastic else 0
    outs = [bfp_quantize(p, seed, mantissa_bits=mantissa_bits, tile_r=tr,
                         tile_c=tc, stochastic=stochastic) for p in parts]
    mant = b7_gather([m for m, _ in outs], tuple(x.shape))
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


# ----------------------------------------------------------------------------
# Narrow floating point simulation (paper Table 1 baseline)
# ----------------------------------------------------------------------------

def ste(quantizer):
    """Straight-through estimator wrapper: forward = quantizer(x),
    backward = identity. Used by the narrow-FP training simulation (paper
    Table 1): rounding has zero gradient almost everywhere, so without the
    STE no format would train at all."""
    def f(x):
        return x + (quantizer(x) - x).detach()
    return f


def simulate_narrow_fp(x: torch.Tensor, mantissa_bits: int,
                       exponent_bits: int) -> torch.Tensor:
    """Simulate an FP format with the given mantissa/exponent widths
    (mantissa_bits counts the implicit leading bit, as the paper does for
    FP32 = 24-bit mantissa / 8-bit exponent): round half to even, flush
    below the smallest normal 2^emin to zero, saturate at
    (2 - 2^(1-m))·2^emax, cast back to x.dtype."""
    xf = x.to(torch.float32)
    e = _max_exponent(xf.abs())
    # exponent range of an IEEE-like format with bias 2^(eb-1)-1
    emax = 2 ** (exponent_bits - 1) - 1
    emin = 1 - emax
    delta = pow2(e.clamp(emin, emax) - mantissa_bits + 1)
    q = torch.round(xf / delta) * delta
    q = torch.where(e < emin, 0.0, q)
    maxv = (2.0 - 2.0 ** (1 - mantissa_bits)) * 2.0 ** emax
    return q.clamp(-maxv, maxv).to(x.dtype)
