"""Public kernel wrappers (port of the conversion part of
`repro.kernels.ops`): `bfp_quantize` packs a 2-D tensor through B7 with
square tiles and, with stats, aggregates the kernel's fused outputs."""
from __future__ import annotations

import torch

from repro_torch.kernels.bfp_quantize import bfp_quantize as _bfp_quantize


def bfp_quantize(x: torch.Tensor, seed=0, *, mantissa_bits: int = 8,
                 tile=128, stochastic: bool = False,
                 with_stats: bool = False):
    """Quantize a 2-D tensor to packed BFP through B7 (the plain version
    for CPU tensors). Returns (mantissa [R, C], exponent grid); with
    stats also a dict of the element clip count and fraction and the
    exponent min, max and spread across tiles (0-d tensors)."""
    if x.ndim != 2:
        raise ValueError(f"bfp_quantize: x must be 2-D, got "
                         f"{tuple(x.shape)}")
    out = _bfp_quantize(x, seed, mantissa_bits=mantissa_bits, tile_r=tile,
                        tile_c=tile, stochastic=stochastic,
                        with_stats=with_stats)
    if not with_stats:
        return out
    m, e, clip_count, emin, emax = out
    total = clip_count.sum()
    stats = {"clip_count": total,
             "clip_frac": total / float(x.numel()),
             "exp_min": emin.min(), "exp_max": emax.max(),
             "exp_spread": emax.max() - emin.min()}
    return m, e, stats
