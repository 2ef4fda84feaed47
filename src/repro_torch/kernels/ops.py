"""Public kernel wrappers (port of `repro.kernels.ops`): padding to the
tiles, leading dims flattened, and tiles resolved from the tuning table.

`bfp_quantize` packs a 2-D tensor through B7 with square tiles and, with
stats, aggregates the kernel's fused outputs. `hbfp_matmul`, `hbfp_dgrad`
and `hbfp_wgrad` run B1, B2 and B3 (`kernels/hbfp_matmul.py`) on any
shape: every dim is padded with zeros to its tile (zero rows and columns
quantize to zero and add nothing) and the result is sliced back. Pass
bm/bk/bn to pin the tiles (they are clipped to the problem), or leave any
of them None and the wrapper resolves it from the tuning table
(`kernels/autotune.py: lookup`; DEFAULT_TILES clipped where the shape is
untuned). CUDA tensors launch the kernels; CPU tensors compute their
plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune
from repro_torch.kernels import hbfp_matmul as _hm
from repro_torch.kernels.bfp_quantize import bfp_quantize as _bfp_quantize


def _pad_to(a: torch.Tensor, mults) -> torch.Tensor:
    """a [R, C] zero-padded to multiples of (mr, mc), contiguous."""
    pr, pc = (-a.shape[0]) % mults[0], (-a.shape[1]) % mults[1]
    if pr or pc:
        return F.pad(a, (0, pc, 0, pr))
    return a.contiguous()


def _tiles(op, bm, bk, bn, M, K, N, mantissa_bits, dtype="float32",
           block=0):
    if bm is None or bk is None or bn is None:
        t = autotune.lookup(op, M, K, N, dtype=dtype,
                            mantissa_bits=mantissa_bits, block=block)
        return (t[0] if bm is None else min(bm, M),
                t[1] if bk is None else min(bk, K),
                t[2] if bn is None else min(bn, N))
    return min(bm, M), min(bk, K), min(bn, N)


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


def hbfp_matmul(x: torch.Tensor, w: torch.Tensor, seed=None, *,
                mantissa_bits: int = 8, stochastic: bool = False,
                quantize_w: bool = True, block: int = 0, bm=None, bk=None,
                bn=None) -> torch.Tensor:
    """B1 for [..., M, K] @ [K, N] (leading dims flattened into M): y f32
    [..., M, N]. `block` (0: whole tiles) sets the exponent groups inside
    each tile and keys its own table cell."""
    lead = x.shape[:-2] if x.ndim > 2 else ()
    M0, K0 = x.shape[-2], x.shape[-1]
    N0 = w.shape[-1]
    x2 = x.reshape(-1, K0)
    bm, bk, bn = _tiles("matmul_fwd", bm, bk, bn, x2.shape[0], K0, N0,
                        mantissa_bits, autotune.dtype_name(x.dtype), block)
    y = _hm.hbfp_matmul_fwd(
        _pad_to(x2, (bm, bk)), _pad_to(w, (bk, bn)), seed,
        mantissa_bits=mantissa_bits, stochastic=stochastic,
        quantize_w=quantize_w, block=block, bm=bm, bk=bk, bn=bn)
    return y[:x2.shape[0], :N0].reshape(*lead, M0, N0)


def hbfp_dgrad(g: torch.Tensor, w: torch.Tensor, seed=None, *,
               mantissa_bits: int = 8, stochastic: bool = False,
               quantize_w: bool = True, block: int = 0, bm=None, bk=None,
               bn=None) -> torch.Tensor:
    """B2, dx[M, K] = Q(g)[M, N] · Q(w)[K, N]ᵀ with pad-and-slice."""
    M0, N0 = g.shape
    K0 = w.shape[0]
    bm, bk, bn = _tiles("matmul_dgrad", bm, bk, bn, M0, K0, N0,
                        mantissa_bits, autotune.dtype_name(g.dtype), block)
    dx = _hm.hbfp_dgrad(
        _pad_to(g, (bm, bn)), _pad_to(w, (bk, bn)), seed,
        mantissa_bits=mantissa_bits, stochastic=stochastic,
        quantize_w=quantize_w, block=block, bm=bm, bk=bk, bn=bn)
    return dx[:M0, :K0]


def hbfp_wgrad(x: torch.Tensor, g: torch.Tensor, seed=None, *,
               mantissa_bits: int = 8, stochastic: bool = False,
               block: int = 0, bm=None, bk=None, bn=None) -> torch.Tensor:
    """B3, dw[K, N] = Q(x)[M, K]ᵀ · Q(g)[M, N] with pad-and-slice."""
    M0, K0 = x.shape
    N0 = g.shape[1]
    bm, bk, bn = _tiles("matmul_wgrad", bm, bk, bn, M0, K0, N0,
                        mantissa_bits, autotune.dtype_name(x.dtype), block)
    dw = _hm.hbfp_wgrad(
        _pad_to(x, (bm, bk)), _pad_to(g, (bm, bn)), seed,
        mantissa_bits=mantissa_bits, stochastic=stochastic, block=block,
        bm=bm, bk=bk, bn=bn)
    return dw[:K0, :N0]
