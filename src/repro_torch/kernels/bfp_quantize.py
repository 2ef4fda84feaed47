"""FP→BFP conversion on Hopper: the wrapper of `csrc/bfp_quantize.cu`
(B7, port of `repro.kernels.bfp_quantize.bfp_quantize_pallas`, the
paper's §5.3 "FP-to-BFP unit").

For x [R, C] and exponent tiles (tile_r, tile_c) on the zero-padded tile
grid it returns the mantissas [R, C] (int8 for m <= 8, else int16) and one
int8 exponent per tile; `with_stats` adds the clip count per tile and the
exponent min and max per fitted (block_r, block_c) block (int32), the
fused outputs the numerics observatory reads. The kernel treats the
padding as zeros without copying x.

Routes (`bfp_quantize_route`), chosen by shape, never by failure:
"banded" (16-byte vectors of x, and a tile within one CTA: `band_plan`;
every tap of the adaptive path and every packed weight) and "split" (the
rest: tiles too large for a CTA, e.g. tile None, and rows or tiles that
are not whole 16-byte vectors; two passes over x). This module owns the
policy and the launch plan; the C side refuses a plan its kernels cannot
run.

For CUDA tensors the wrapper launches the kernel or raises; for CPU
tensors it computes the plain version (`kernels/ref.py`
`bfp_quantize_ref`). `bfp_quantize.launches` counts kernel launches,
`.launches_by_route` the same launches by route, and `.plain_calls` CPU
calls of the plain version; `reset_counts()` zeroes them.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.hbfp_matmul import (_DTYPES, _launch, _ptr,
                                             _seed_int, base_args)
from repro_torch.kernels.ref import bfp_quantize_ref as bfp_quantize_plain
from repro_torch.kernels.ref import bfp_tiles

_LIB = "bfp_quantize"
ROUTES = ("banded", "split")

# the kernels' sizes (csrc/bfp_quantize.cu), which bound a plan
VEC_BYTES = 16       # one vector access
BAND_ITEMS = 8       # vectors a banded thread holds
BAND_THREADS = 512   # most threads of a banded CTA
Q_THREADS = 256      # threads of a split CTA
SPLIT_ITEMS = 8      # vectors a split thread takes per chunk
# the plan's own choices
BAND_FILL = 256      # threads a banded CTA is filled up to
SPLIT_CTAS = 1024    # most CTAs of one split tile


def band_plan(n_tr: int, n_tc: int, tr: int, tc: int, vec: int):
    """Geometry of a banded CTA (the C side's `Band`) for tiles of tr
    rows by tc // vec vectors on an n_tr x n_tc tile grid, or None when
    one tile does not fit a CTA. A CTA covers RB tile rows by T tiles;
    thread (c, h) of its Wt x (Hs · RB) threads takes vector columns
    c + p·Wt (p < P) and rows h % Hs + q·Hs (q < Q) of tile row h // Hs:
    all its vectors lie in one tile."""
    vt = tc // vec
    if vt >= 32:
        T = 1
        P = min(BAND_ITEMS, _cdiv(vt, 32))
        Wt = _cdiv(_cdiv(vt, P), 32) * 32
        P = _cdiv(vt, Wt)
    else:
        T = 32 // math.gcd(vt, 32)       # T·vt a whole number of warps
        if T * vt > 256:
            T = 128 // vt
        T = min(T, n_tc)
        Wt, P = T * vt, 1
    Hs = _cdiv(tr, BAND_ITEMS // P)
    Q = _cdiv(tr, Hs)
    if Wt * Hs > BAND_THREADS:
        return None
    RB = min(max(1, BAND_FILL // (Wt * Hs)), n_tr)
    return dict(vt=vt, T=T, RB=RB, Wt=Wt, P=P, Hs=Hs, Q=Q,
                threads=_cdiv(Wt * Hs * RB, 32) * 32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vec(C: int, tc: int, dtype: torch.dtype, aligned: bool) -> int:
    """Elements of one 16-byte vector when rows and tiles are whole
    vectors and x is aligned, else 0."""
    esize = dtype.itemsize
    v = VEC_BYTES // esize
    return v if aligned and (C * esize) % VEC_BYTES == 0 and tc % v == 0 \
        else 0


def bfp_quantize_route(R: int, C: int, tr, tc, dtype: torch.dtype, m: int,
                       aligned: bool = True) -> str:
    """The route of one B7 launch on x [R, C] of `dtype` at exponent tiles
    (tr, tc) (None: the whole dim; clipped to x) and m mantissa bits;
    `aligned`: x's address is a 16-byte multiple."""
    if dtype not in _DTYPES:
        raise TypeError(f"bfp_quantize: dtype {dtype} not in {_DTYPES}")
    if not 2 <= m <= 16:
        raise ValueError(f"bfp_quantize: 2 <= m <= 16, got {m}")
    tr = R if tr is None else min(tr, R)
    tc = C if tc is None else min(tc, C)
    v = _vec(C, tc, dtype, aligned)
    fits = v and band_plan(_cdiv(R, tr), _cdiv(C, tc), tr, tc, v)
    return "banded" if fits else "split"


def split_ctas(tr: int, tc: int, vec: int) -> int:
    """CTAs of one split tile: chunks of Q_THREADS · SPLIT_ITEMS vectors
    of `vec` elements (1: scalar), taken grid-stride by at most SPLIT_CTAS
    CTAs."""
    per = Q_THREADS * SPLIT_ITEMS
    return min(_cdiv(tr * (tc // vec), per), SPLIT_CTAS)


def bfp_quantize_scratch(route: str, R: int, C: int, tr: int, tc: int,
                         dtype: torch.dtype, with_stats: bool,
                         aligned: bool = True) -> int:
    """uint32 words of scratch one launch needs at the clipped tiles: the
    split route's per-CTA amax (and, with stats, clip counts); none
    otherwise."""
    if route != "split":
        return 0
    n_tiles = _cdiv(R, tr) * _cdiv(C, tc)
    v = _vec(C, tc, dtype, aligned) or 1
    return n_tiles * split_ctas(tr, tc, v) * (2 if with_stats else 1)


@functools.lru_cache(maxsize=256)
def _launch_plan(R: int, C: int, tile_r, tile_c, block_r: int,
                 block_c: int, dtype: torch.dtype, m: int, aligned: bool,
                 with_stats: bool):
    """Tiles, padded shape, stats blocks, route, scratch words and the C
    side's plan arguments (route, V, T, RB, Wt, P, Hs, Q, threads,
    n_split) of one launch (cached: the wrapper's host time bounds B7 on
    small x)."""
    tr, tc, Rp, Cp, br, bc = bfp_tiles(R, C, tile_r, tile_c, block_r,
                                       block_c)
    route = bfp_quantize_route(R, C, tr, tc, dtype, m, aligned)
    words = bfp_quantize_scratch(route, R, C, tr, tc, dtype, with_stats,
                                 aligned)
    v = _vec(C, tc, dtype, aligned) or 1
    if route == "banded":
        p = band_plan(Rp // tr, Cp // tc, tr, tc, v)
        plan = (0, v, *(p[k] for k in ("T", "RB", "Wt", "P", "Hs", "Q",
                                       "threads")), 0)
    else:
        plan = (1, v, 0, 0, 0, 0, 0, 0, 0, split_ctas(tr, tc, v))
    return tr, tc, Rp, Cp, br, bc, route, words, plan


def reset_counts() -> None:
    bfp_quantize.launches = 0
    bfp_quantize.launches_by_route = dict.fromkeys(ROUTES, 0)
    bfp_quantize.plain_calls = 0


def bfp_quantize(x: torch.Tensor, seed=0, *, mantissa_bits: int = 8,
                 tile_r=128, tile_c=128, stochastic: bool = False,
                 block_r: int = 256, block_c: int = 512,
                 with_stats: bool = False, base=None):
    """B7. x: [R, C] f32/bf16 (contiguous on the card); tile_r/tile_c
    None share one exponent along the whole dim. `base` (None, or a 2-D
    `kernels.common.IndexBase` on the padded one-process operand) draws
    the stochastic stream as that part of the operand. Returns (mantissa,
    exponent) or, with stats, (mantissa, exponent, clip, exp_min,
    exp_max)."""
    if x.ndim != 2:
        raise ValueError(f"bfp_quantize: x must be 2-D, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bfp_quantize: dtype {x.dtype} not in {_DTYPES}")
    if not 2 <= mantissa_bits <= 16:
        raise ValueError(f"bfp_quantize: 2 <= m <= 16 (int16 mantissas), "
                         f"got {mantissa_bits}")
    kw = dict(mantissa_bits=mantissa_bits, tile_r=tile_r, tile_c=tile_c,
              stochastic=stochastic, block_r=block_r, block_c=block_c,
              with_stats=with_stats, base=base)
    base_args(base, x.shape[1])                            # checked here
    if x.device.type == "cpu":
        bfp_quantize.plain_calls += 1
        return bfp_quantize_plain(x, seed, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"bfp_quantize: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("bfp_quantize: x must be contiguous")
    R, C = x.shape
    tr, tc, Rp, Cp, br, bc, route, words, plan = _launch_plan(
        R, C, tile_r, tile_c, block_r, block_c, x.dtype, mantissa_bits,
        x.data_ptr() % VEC_BYTES == 0, with_stats)
    dev = dict(device=x.device)
    m16 = mantissa_bits > 8
    mant = torch.empty((R, C), dtype=torch.int16 if m16 else torch.int8,
                       **dev)
    grid, blocks = (Rp // tr, Cp // tc), (Rp // br, Cp // bc)
    expo = torch.empty(grid, dtype=torch.int8, **dev)
    stats = ()
    if with_stats:
        stats = (torch.empty(grid, dtype=torch.int32, **dev),
                 torch.empty(blocks, dtype=torch.int32, **dev),
                 torch.empty(blocks, dtype=torch.int32, **dev))
    ptrs = [t.data_ptr() for t in stats] if stats else [None] * 3
    scratch = torch.empty(words, dtype=torch.int32, **dev) if words else None
    _launch(_LIB, "bfp_quantize", x.device, x.data_ptr(),
            int(x.dtype == torch.bfloat16), mant.data_ptr(), int(m16),
            expo.data_ptr(), *ptrs, _ptr(scratch), R, C, tr, tc, br, bc,
            mantissa_bits, int(stochastic), _seed_int(seed),
            *((0, 0, Cp) if base is None else base_args(base, C)),
            int(with_stats), *plan, words)
    bfp_quantize.launches += 1
    bfp_quantize.launches_by_route[route] += 1
    return (mant, expo, *stats)


reset_counts()
