"""FP→BFP conversion on Hopper: the wrapper of `csrc/bfp_quantize.cu`
(B7, port of `repro.kernels.bfp_quantize.bfp_quantize_pallas`, the
paper's §5.3 "FP-to-BFP unit").

For x [R, C] and exponent tiles (tile_r, tile_c) on the zero-padded tile
grid it returns the mantissas [R, C] (int8 for m <= 8, else int16) and one
int8 exponent per tile; `with_stats` adds the clip count per tile and the
exponent min and max per fitted (block_r, block_c) block (int32), the
fused outputs the numerics observatory reads. The kernel treats the
padding as zeros without copying x.

For CUDA tensors the wrapper launches the kernel or raises; for CPU
tensors it computes the plain version (`kernels/ref.py`
`bfp_quantize_ref`). `bfp_quantize.launches` counts kernel launches and
`.plain_calls` CPU calls of the plain version; `reset_counts()` zeroes
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hbfp_matmul import _DTYPES, _launch, _seed_int
from repro_torch.kernels.ref import bfp_quantize_ref as bfp_quantize_plain
from repro_torch.kernels.ref import bfp_tiles

_LIB = "bfp_quantize"


def reset_counts() -> None:
    bfp_quantize.launches = 0
    bfp_quantize.plain_calls = 0


def bfp_quantize(x: torch.Tensor, seed=0, *, mantissa_bits: int = 8,
                 tile_r=128, tile_c=128, stochastic: bool = False,
                 block_r: int = 256, block_c: int = 512,
                 with_stats: bool = False):
    """B7. x: [R, C] f32/bf16 (contiguous on the card); tile_r/tile_c
    None share one exponent along the whole dim. Returns (mantissa,
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
              with_stats=with_stats)
    if x.device.type == "cpu":
        bfp_quantize.plain_calls += 1
        return bfp_quantize_plain(x, seed, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"bfp_quantize: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("bfp_quantize: x must be contiguous")
    R, C = x.shape
    tr, tc, Rp, Cp, br, bc = bfp_tiles(R, C, tile_r, tile_c, block_r,
                                       block_c)
    dev = dict(device=x.device)
    m16 = mantissa_bits > 8
    mant = torch.empty((R, C), dtype=torch.int16 if m16 else torch.int8,
                       **dev)
    grid = (Rp // tr, Cp // tc)
    expo = torch.empty(grid, dtype=torch.int8, **dev)
    amax = torch.empty(grid[0] * grid[1], dtype=torch.int32, **dev)
    stats = ()
    if with_stats:
        stats = (torch.empty(grid, dtype=torch.int32, **dev),
                 torch.empty((Rp // br, Cp // bc), dtype=torch.int32, **dev),
                 torch.empty((Rp // br, Cp // bc), dtype=torch.int32, **dev))
    ptrs = [t.data_ptr() for t in stats] if stats else [None] * 3
    _launch(_LIB, "bfp_quantize", x.device, x.data_ptr(),
            int(x.dtype == torch.bfloat16), mant.data_ptr(), int(m16),
            expo.data_ptr(), *ptrs, amax.data_ptr(), R, C, tr, tc, br, bc,
            mantissa_bits, int(stochastic), _seed_int(seed),
            int(with_stats))
    bfp_quantize.launches += 1
    return (mant, expo, *stats)


reset_counts()
