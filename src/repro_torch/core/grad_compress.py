"""BFP-compressed data-parallel gradient reduction (port of
`repro.core.grad_compress`, beyond the paper).

The paper's conclusion: BFP "leads to … lower communication bandwidth
requirements for distributed training". This realizes it for the DP
gradient all-reduce: each rank packs its gradients to int8 BFP mantissas
(+1 int8 exponent per 512-element tile) through the conversion kernel B7
(`core.bfp.pack`; its plain version for CPU tensors), all-gathers the
int8 payload over the data-parallel group and dequantizes and sums it
locally, rank by rank in rank order. Wire bytes per rank drop from
≈ 2·4·S·(N-1)/N (f32 ring all-reduce) to ≈ (S + S/tile)·(N-1)/N (int8
all-gather), ~7.5× fewer at N = 16 (a count from those formulas, not a
measurement).

Error feedback (residual accumulation, Karimireddy et al.-style) makes the
compression unbiased across steps: the quantization error of step t is
added back into the gradient at step t+1, so the *sum* of transmitted
gradients tracks the true sum.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bfp
from repro_torch.launch.transport import Transport

COMPRESS_TILE = 512  # exponent-sharing group for gradient vectors


def _flat_tile(g):
    return (COMPRESS_TILE,) if g.ndim == 1 else \
        (1,) * (g.ndim - 1) + (COMPRESS_TILE,)


def compress(g: torch.Tensor, mantissa_bits: int = 8) -> bfp.PackedBFP:
    """g -> (int8/int16 mantissa, int8 exponent per tile), through B7 on a
    CUDA tensor."""
    return bfp.pack(g, mantissa_bits, _flat_tile(g))


def decompress(p: bfp.PackedBFP) -> torch.Tensor:
    return bfp.unpack(p)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compressed_psum_tree(grads, group=None, *, mantissa_bits: int = 8,
                         residual=None, transport=None
                         ) -> Tuple[object, object]:
    """All-reduce a gradient tree (nested dicts of tensors) over the
    process group `group` (the default group when None; the reference's
    `axis_name`) in BFP-compressed form. Returns (mean-reduced grads, new
    residual tree for error feedback). `transport` (a
    `launch.transport.Transport` over `group`) records the collectives;
    one is made when None."""
    tp = transport if transport is not None else Transport(group)
    n = tp.size

    def one(g, r):
        gf = g.to(torch.float32)
        if r is not None:
            gf = gf + r
        p = compress(gf, mantissa_bits)
        new_r = gf - decompress(p)
        # all-gather the packed int8 payload; dequantize + sum locally,
        # one rank at a time (the reference's sum over the stacked axis)
        ms = tp.all_gather(p.mantissa)
        es = tp.all_gather(p.exponent)
        total = None
        for m, e in zip(ms, es):
            d = decompress(bfp.PackedBFP(m, e, p.mantissa_bits,
                                         p.tile_shape, p.shape))
            total = d if total is None else total.add_(d)
        return (total / n).to(g.dtype), new_r

    if residual is None:
        residual = _tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    out = _tree_map(one, grads, residual)
    return _tree_map(lambda t: t[0], out), _tree_map(lambda t: t[1], out)
