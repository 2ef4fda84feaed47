"""Per-tensor BFP fidelity statistics (port of `repro.numerics.stats`,
DESIGN.md §9).

`quantize_with_stats` is one composition on both devices: the conversion
kernel B7 (`kernels.bfp_quantize`, with its fused per-tile clip counts and
per-block exponent min and max) on each 2-D slice of the tensor
(`core.bfp.b7_slices`), then a few torch reductions over (x, mantissas,
exponents, clip counts) for the rest. On the card that call is the kernel,
on the CPU its plain version. The dequantized tensor, mantissa · 2^(e-m+2)
cast to x's dtype, equals `bfp.quantize` bit for bit. The stats:

  * `exp_hist`      — histogram of per-tile exponents over EXP_BINS bins;
  * `clip_frac`     — fraction of elements whose rounded mantissa exceeded
                      ±(2^(m-1)-1) and was saturated;
  * `sat_tile_frac` — fraction of tiles with at least one saturated element;
  * `ftz_frac`      — fraction of nonzero inputs that quantized to 0;
  * `sqnr_db`       — 10·log10(Σx² / Σe²), capped at SQNR_CAP_DB; the sums
                      run in float64 here, in f32 in the reference, so the
                      two differ by the reference's summation error;
  * `exp_spread`    — max − min tile exponent;
  * `n`             — element count.

Stochastic rounding takes an int key: B7 draws at `seed_from_key(key)`
on `bfp.quantize`'s stream, so the dequantized tensor equals
`bfp.quantize(x, ..., "stochastic", key)` bit for bit and a telemetry
step stays bit-identical to the plain step (the reference's "same key"
rule, with the port's xorshift draws in place of threefry).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import bfp
from repro_torch.kernels.bfp_quantize import bfp_quantize
from repro_torch.kernels.common import (IndexBase, flat_base, is_whole,
                                        seed_from_key)

EXP_BINS = 32
EXP_BIN_WIDTH = 4
EXP_BIN_LO = -64

SQNR_CAP_DB = 200.0


class TensorStats(NamedTuple):
    exp_hist: torch.Tensor       # [EXP_BINS] f32
    clip_frac: torch.Tensor      # () f32
    sat_tile_frac: torch.Tensor  # () f32
    ftz_frac: torch.Tensor       # () f32
    sqnr_db: torch.Tensor        # () f32
    exp_spread: torch.Tensor     # () f32
    n: torch.Tensor              # () f32


def identity_stats(n: float = 0.0, device=None) -> TensorStats:
    """Stats of a lossless (identity) quantization."""
    z = lambda v: torch.full((), v, dtype=torch.float32, device=device)
    return TensorStats(exp_hist=torch.zeros(EXP_BINS, dtype=torch.float32,
                                            device=device),
                       clip_frac=z(0.0), sat_tile_frac=z(0.0),
                       ftz_frac=z(0.0), sqnr_db=z(SQNR_CAP_DB),
                       exp_spread=z(0.0), n=z(float(n)))


def _expand(grid: torch.Tensor, tr: int, tc: int, R: int, C: int):
    """A per-tile grid broadcast to the elements of an [R, C] slice."""
    return grid.repeat_interleave(tr, 0).repeat_interleave(tc, 1)[:R, :C]


def _b7_base(base: IndexBase, shape, tile_shape) -> IndexBase:
    """The 2-D base of B7's operand for a part (`bfp.b7_slices`, whole
    rows) of the tensor `base.shape`: both laid out as B7 takes them,
    each leading slice's rows padded to whole tiles where the one-process
    operand's are."""
    lead, R, C, tr, _, merged = bfp.b7_layout(tuple(base.shape), tile_shape)
    l_lead, l_r, _, l_tr, _, l_merged = bfp.b7_layout(tuple(shape),
                                                      tile_shape)
    rows = R if merged else -(-R // tr) * tr
    l_rows = l_r if l_merged else -(-l_r // l_tr) * l_tr
    nd = IndexBase(tuple(lead) + (rows, C), tuple(base.offset))
    ld = bfp.padded_shape(base.shape, tile_shape)[-1]
    return flat_base(nd, tuple(l_lead) + (l_rows, shape[-1]), ld)


class StatsAccumulator:
    """Raw sums of one tensor's stats over the B7 operands it is cut into
    (several slices of a stacked weight, or one view), so that a tensor
    narrowed slice by slice still gets the one `TensorStats` of the
    whole."""

    def __init__(self, device):
        i64 = dict(dtype=torch.int64, device=device)
        f64 = dict(dtype=torch.float64, device=device)
        self.n = self.tiles = 0
        self.counts = torch.zeros(4, **i64)  # clip, sat tiles, ftz, nonzero
        self.sig = torch.zeros((), **f64)
        self.err = torch.zeros((), **f64)
        self.hist = torch.zeros(EXP_BINS, **i64)
        self.emin = self.emax = None

    @torch.no_grad()
    def add(self, x: torch.Tensor, mantissa_bits: int,
            tile_shape: Sequence[Optional[int]], want_q: bool = True,
            key: Optional[int] = None, base: Optional[IndexBase] = None):
        """Quantize x through B7 and add its stats; returns the dequantized
        x in its dtype (None unless want_q). An int `key` rounds
        stochastically (`bfp.quantize`'s stream), None to nearest. `base`
        (a 2-D x only: a shard of a weight slice) draws x as that part of
        the whole slice, as `bfp.quantize(..., base=base)` does."""
        stochastic = key is not None
        seed = seed_from_key(key) if stochastic else 0
        b7_base = None
        if stochastic and not is_whole(base, x.shape):
            if x.ndim != 2:
                raise ValueError(f"an index base for B7 needs a 2-D part, "
                                 f"got {tuple(x.shape)}")
            ld = bfp.padded_shape(base.shape, tile_shape)[-1]
            b7_base = flat_base(base, x.shape, ld)
        parts, tr, tc = bfp.b7_slices(x, tile_shape, whole_rows=stochastic)
        qs = []
        self.n += x.numel()
        for p in parts:
            mant, expo, clip, emin, emax = bfp_quantize(
                p, seed, mantissa_bits=mantissa_bits, tile_r=tr, tile_c=tc,
                stochastic=stochastic, with_stats=True, base=b7_base)
            R, C = p.shape
            delta = bfp.pow2(expo.to(torch.int32) - mantissa_bits + 2)
            xf = p.to(torch.float32)
            qd = mant.to(torch.float32) * _expand(delta, tr, tc, R, C)
            err = xf - qd
            nonzero = xf != 0.0
            self.tiles += clip.numel()
            self.counts += torch.stack([
                clip.sum(), (clip > 0).sum(), (nonzero & (mant == 0)).sum(),
                nonzero.sum()])
            self.sig += (xf * xf).sum(dtype=torch.float64)
            self.err += (err * err).sum(dtype=torch.float64)
            e = expo.to(torch.int64).reshape(-1)
            idx = torch.div(e - EXP_BIN_LO, EXP_BIN_WIDTH,
                            rounding_mode="floor").clamp(0, EXP_BINS - 1)
            self.hist += torch.bincount(idx, minlength=EXP_BINS)
            lo, hi = emin.min(), emax.max()
            self.emin = lo if self.emin is None else torch.minimum(self.emin,
                                                                   lo)
            self.emax = hi if self.emax is None else torch.maximum(self.emax,
                                                                   hi)
            if want_q:
                qs.append(qd.to(x.dtype))
        return bfp.b7_gather(qs, tuple(x.shape)) if want_q else None

    def reduce_(self, transport) -> None:
        """Combine this accumulator with the other ranks' of `transport`
        (each holding a distinct part of the tensor), in place: counts,
        histogram, sums, elements and tiles summed, the exponent range's
        min and max. The integer counts stay exact (int64)."""
        if self.emin is None:       # a rank with no part: neutral values
            self.emin = torch.full((), 1 << 30, dtype=torch.int32,
                                   device=self.sig.device)
            self.emax = torch.full((), -(1 << 30), dtype=torch.int32,
                                   device=self.sig.device)
        ints = torch.cat([self.counts, self.hist, torch.tensor(
            [self.n, self.tiles], dtype=torch.int64,
            device=self.counts.device)])
        transport.all_reduce_(ints)
        sums = torch.stack([self.sig, self.err])
        transport.all_reduce_(sums)
        lo = self.emin.reshape(1).to(torch.int64)
        hi = (-self.emax).reshape(1).to(torch.int64)
        rng = torch.cat([lo, hi])
        from torch.distributed import ReduceOp
        transport.all_reduce_(rng, op=ReduceOp.MIN)
        nc, nh = self.counts.numel(), self.hist.numel()
        self.counts = ints[:nc]
        self.hist = ints[nc:nc + nh]
        self.n, self.tiles = (int(v) for v in ints[nc + nh:].tolist())
        self.sig, self.err = sums[0], sums[1]
        self.emin, self.emax = rng[0], -rng[1]

    def finish(self) -> TensorStats:
        clip, sat, ftz, nonzero = self.counts.to(torch.float64)
        sqnr = torch.where(
            self.err > 0.0,
            10.0 * torch.log10(self.sig.clamp_min(1e-30)
                               / self.err.clamp_min(1e-30)),
            torch.full_like(self.sig, SQNR_CAP_DB))
        f32 = lambda v: v.to(torch.float32)
        return TensorStats(
            exp_hist=f32(self.hist), clip_frac=f32(clip / self.n),
            sat_tile_frac=f32(sat / self.tiles),
            ftz_frac=f32(ftz / nonzero.clamp_min(1.0)),
            sqnr_db=f32(sqnr.clamp(-SQNR_CAP_DB, SQNR_CAP_DB)),
            exp_spread=f32(self.emax - self.emin),
            n=torch.full((), float(self.n), dtype=torch.float32,
                         device=self.sig.device))


def quantize_with_stats(x: torch.Tensor, mantissa_bits: int,
                        tile_shape: Sequence[Optional[int]],
                        rounding: str = "nearest", key: Optional[int] = None
                        ) -> Tuple[torch.Tensor, TensorStats]:
    """FP→BFP→FP through B7 plus the fidelity stats of that quantization;
    the tensor equals `bfp.quantize(x, ..., rounding, key)` bit for bit.
    Stochastic rounding needs an int `key`."""
    if mantissa_bits >= 24:
        return x, identity_stats(x.numel(), x.device)
    if rounding == "stochastic" and key is None:
        raise ValueError("stochastic rounding requires a key")
    acc = StatsAccumulator(x.device)
    xq = acc.add(x, mantissa_bits, tile_shape,
                 key=key if rounding == "stochastic" else None)
    return xq, acc.finish()


def tensor_stats(x: torch.Tensor, mantissa_bits: int,
                 tile_shape: Sequence[Optional[int]],
                 reduce=None) -> TensorStats:
    """`quantize_with_stats(...)[1]` without building the dequantized
    tensor (the gradient and activation taps); `reduce(acc)` sums the raw
    accumulator over the ranks that hold other parts of the tensor
    before it is finished."""
    if mantissa_bits >= 24:
        return identity_stats(x.numel(), x.device)
    acc = StatsAccumulator(x.device)
    acc.add(x, mantissa_bits, tile_shape, want_q=False)
    if reduce is not None:
        reduce(acc)
    return acc.finish()


def stats_to_host(stats) -> dict:
    """A TensorStats, or a nested dict of them, as plain-python dicts of
    floats (controller / ring-buffer / JSON form), in one device-to-host
    copy."""
    flat = []

    def collect(s):
        if isinstance(s, TensorStats):
            flat.append(s)
        else:
            for v in s.values():
                collect(v)

    collect(stats)
    rows = iter(torch.stack([torch.cat([torch.stack(list(s[1:])),
                                        s.exp_hist]) for s in flat])
                .cpu().tolist() if flat else [])

    def build(s):
        if not isinstance(s, TensorStats):
            return {k: build(v) for k, v in s.items()}
        r = next(rows)
        return {"clip_frac": r[0], "sat_tile_frac": r[1], "ftz_frac": r[2],
                "sqnr_db": r[3], "exp_spread": r[4], "n": r[5],
                "exp_hist": r[6:]}

    return build(stats)
