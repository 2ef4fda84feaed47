"""Kernel tile sizes (port of the lookup half of
`repro.kernels.autotune`).

Tile sizes are the exponent-block geometry of the HBFP GEMMs (DESIGN.md
§10): the reference's (bm, bk, bn) decide which elements share an
exponent, so the port uses the same tiles whatever CTA tile its kernel
runs. `lookup` returns the clipped defaults; the on-disk tuning table,
keyed additionally on the card's name, comes with ROADMAP A6.
"""
from __future__ import annotations

from typing import Iterable, Tuple

Tiles = Tuple[int, int, int]

DEFAULT_TILES: Tiles = (128, 128, 128)


def clip_tiles(tiles: Iterable[int], M: int, K: int, N: int) -> Tiles:
    bm, bk, bn = tiles
    return (min(int(bm), M), min(int(bk), K), min(int(bn), N))


def align_tiles(tiles: Iterable[int], block: int) -> Tiles:
    """Round each tile edge up to a multiple of the exponent-block size;
    block=0 leaves the tiles unchanged."""
    if not block:
        return tuple(int(t) for t in tiles)
    b = int(block)
    return tuple(-(-int(t) // b) * b for t in tiles)


def lookup(op: str, M: int, K: int, N: int, *, dtype: str = "float32",
           mantissa_bits: int = 8, block: int = 0) -> Tiles:
    """Tiles for one GEMM: DEFAULT_TILES clipped to the problem (what the
    reference returns with an empty tuning table)."""
    return clip_tiles(DEFAULT_TILES, M, K, N)
