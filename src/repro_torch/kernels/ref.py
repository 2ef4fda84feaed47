"""Plain PyTorch versions of the HBFP GEMM kernels (port of
`repro.kernels.ref.hbfp_matmul_ref`, `hbfp_dgrad_ref` and
`hbfp_wgrad_ref`).

They are the oracles the CUDA kernels are held to, and what the kernel
wrappers compute for tensors that lie on the CPU. The reference loops over
(contraction block, output block) tiles; these versions loop over the
contraction blocks in ascending order and handle all output blocks of one
contraction block at once, which computes every output element with the
same dot product. Integral-mantissa dot products run in float64: with at
most 2^(2m-2) per product and the few hundred products of a block the
float64 sum is exact, and its single rounding to f32 is what the kernels'
exact accumulation gives too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (STREAM_G, STREAM_W, STREAM_X,
                                        quantize_block, row_group_amax)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 with the same low 32 bits (int32 wraparound)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _slab_group_amax(ws: torch.Tensor, rb: int, cb: int) -> torch.Tensor:
    """|w| max over (rb, cb) groups of a 2-D slab of w, broadcast back to
    the slab."""
    r, c = ws.shape
    g = ws.abs().reshape(r // rb, rb, c // cb, cb).amax(dim=(1, 3),
                                                       keepdim=True)
    return g.expand(r // rb, rb, c // cb, cb).reshape(r, c)


def _seed_value(seed) -> int:
    return 0 if seed is None else int(torch.as_tensor(seed).reshape(-1)[0])


def _index(r0: int, nr: int, c0: int, nc: int, C: int, stream: int,
           device) -> torch.Tensor:
    """int32 global element indices r * C + c + stream of a slab."""
    r = torch.arange(r0, r0 + nr, dtype=torch.int64, device=device)
    c = torch.arange(c0, c0 + nc, dtype=torch.int64, device=device)
    return _wrap_i32(r[:, None] * C + c[None, :] + stream)


def _quantize_rows(a: torch.Tensor, c0: int, width: int, C: int,
                   mantissa_bits: int, block: int, stochastic: bool,
                   seed: int, stream: int):
    """Columns [c0, c0 + width) of the f32 [R, C] operand `a`, quantized
    per (row, block group): (q, delta) on the operand's stochastic
    stream."""
    s = a[:, c0:c0 + width]
    idx = _index(0, a.shape[0], c0, width, C, stream, a.device) \
        if stochastic else None
    return quantize_block(s, mantissa_bits, row_group_amax(s, block),
                          stochastic=stochastic, seed=seed, idx=idx)


def _quantize_w(ws: torch.Tensor, r0: int, c0: int, N: int, rb: int,
                cb: int, mantissa_bits: int, stochastic: bool, seed: int):
    """A slab of w [K, N] starting at (r0, c0), quantized per (rb, cb)
    group on STREAM_W with w's own element indices (so the forward and
    dgrad draw the same numbers): (q, delta)."""
    idx = _index(r0, ws.shape[0], c0, ws.shape[1], N, STREAM_W, ws.device) \
        if stochastic else None
    return quantize_block(ws, mantissa_bits, _slab_group_amax(ws, rb, cb),
                          stochastic=stochastic, seed=seed, idx=idx)


def hbfp_matmul_ref(x, w, seed=None, *, mantissa_bits=8, stochastic=False,
                    quantize_w=True, block=0, bm=128, bk=128, bn=128,
                    out_dtype=torch.float32):
    """y = Σ_k Q_row(x)·Q_tile(w)·δx·δw with per-(row, K-block) activation
    exponents and per-(bk, bn) weight-tile exponents, f32 accumulation in
    ascending K-block order. quantize_w=False contracts the given
    (pre-narrowed) w in f32; block>0 refines x to per-(row, block) and w to
    (block, block) groups and dequantizes before an f32 dot (DESIGN.md
    §13). Shapes must be divisible by the clipped tiles."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} x {tuple(w.shape)}")
    bm_, bk_, bn_ = min(bm, M), min(bk, K), min(bn, N)
    if M % bm_ or K % bk_ or N % bn_:
        raise ValueError(f"({M},{K})x({K},{N}) not divisible by "
                         f"({bm_},{bk_},{bn_})")
    x_sub = bool(block) and block < bk_
    w_sub = bool(block) and (block < bk_ or block < bn_)
    seed_v = _seed_value(seed)
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    rb, cb = (min(block, bk_), min(block, bn_)) if w_sub else (bk_, bn_)
    for k0 in range(0, K, bk_):
        qx, dx = _quantize_rows(xf, k0, bk_, K, mantissa_bits, block,
                                stochastic, seed_v, STREAM_X)
        ws = wf[k0:k0 + bk_]                                   # [bk, N]
        if not quantize_w:
            if x_sub:
                acc = acc + (qx * dx) @ ws
            else:
                acc = acc + (qx @ ws) * dx
            continue
        qw, dw = _quantize_w(ws, k0, 0, N, rb, cb, mantissa_bits, stochastic,
                             seed_v)
        if x_sub or w_sub:
            acc = acc + (qx * dx) @ (qw * dw)
            continue
        part = (qx.to(torch.float64) @ qw.to(torch.float64)).to(torch.float32)
        acc = acc + part * (dx * dw[:1])       # δw is constant down a column
    return acc.to(out_dtype)


def hbfp_dgrad_ref(g, w, seed=None, *, mantissa_bits=8, stochastic=False,
                   quantize_w=True, block=0, bm=128, bk=128, bn=128,
                   out_dtype=torch.float32):
    """dx[M,K] = Q(g)·Q(w)ᵀ: gradient rows quantized per (row, N-block)
    on STREAM_G, weight tiles per (bk, bn) block of w on STREAM_W (the
    forward's element index), f32 accumulation over N-blocks in ascending
    order. quantize_w=False contracts the given (pre-narrowed) w; block>0
    refines the exponent groups like hbfp_matmul_ref."""
    M, N = g.shape
    K, N2 = w.shape
    if N != N2:
        raise ValueError(f"dgrad: {tuple(g.shape)} vs {tuple(w.shape)}")
    bm_, bk_, bn_ = min(bm, M), min(bk, K), min(bn, N)
    if M % bm_ or K % bk_ or N % bn_:
        raise ValueError(f"dgrad ({M},{N})x({K},{N}) not divisible by "
                         f"({bm_},{bk_},{bn_})")
    g_sub = bool(block) and block < bn_
    w_sub = bool(block) and (block < bk_ or block < bn_)
    seed_v = _seed_value(seed)
    gf = g.to(torch.float32)
    wf = w.to(torch.float32)
    acc = torch.zeros((M, K), dtype=torch.float32, device=g.device)
    rb, cb = (min(block, bk_), min(block, bn_)) if w_sub else (bk_, bn_)
    for n0 in range(0, N, bn_):
        qg, dg = _quantize_rows(gf, n0, bn_, N, mantissa_bits, block,
                                stochastic, seed_v, STREAM_G)
        ws = wf[:, n0:n0 + bn_]                                 # [K, bn]
        if not quantize_w:
            if g_sub:
                acc = acc + (qg * dg) @ ws.T
            else:
                acc = acc + (qg @ ws.T) * dg
            continue
        qw, dw = _quantize_w(ws, 0, n0, N, rb, cb, mantissa_bits, stochastic,
                             seed_v)
        if g_sub or w_sub:
            acc = acc + (qg * dg) @ (qw * dw).T
            continue
        part = (qg.to(torch.float64) @ qw.to(torch.float64).T).to(torch.float32)
        acc = acc + part * (dg * dw[:, 0][None, :])  # δw constant along a row
    return acc.to(out_dtype)


def hbfp_wgrad_ref(x, g, seed=None, *, mantissa_bits=8, stochastic=False,
                   block=0, bm=128, bk=128, bn=128, out_dtype=torch.float32,
                   operands=False):
    """dw[K,N] = (Q(x)·δx)ᵀ·(Q(g)·δg): x rows per (row, K-block) on the
    forward's STREAM_X, g rows per (row, N-block) on STREAM_G, dequantized
    f32 products accumulated over M-blocks in ascending order, as the
    reference does. `operands` also returns the dequantized x̂ [M,K] and
    ĝ [M,N] (what the kernel's scratch holds)."""
    M, K = x.shape
    M2, N = g.shape
    if M != M2:
        raise ValueError(f"wgrad: {tuple(x.shape)} vs {tuple(g.shape)}")
    bm_, bk_, bn_ = min(bm, M), min(bk, K), min(bn, N)
    if M % bm_ or K % bk_ or N % bn_:
        raise ValueError(f"wgrad ({M},{K})x({M},{N}) not divisible by "
                         f"({bm_},{bk_},{bn_})")
    seed_v = _seed_value(seed)

    def dequant(a, C, width, stream):
        out = torch.empty_like(a)
        for c0 in range(0, C, width):
            q, d = _quantize_rows(a, c0, width, C, mantissa_bits, block,
                                  stochastic, seed_v, stream)
            out[:, c0:c0 + width] = q * d
        return out

    xh = dequant(x.to(torch.float32), K, bk_, STREAM_X)
    gh = dequant(g.to(torch.float32), N, bn_, STREAM_G)
    acc = torch.zeros((K, N), dtype=torch.float32, device=x.device)
    for m0 in range(0, M, bm_):
        acc = acc + xh[m0:m0 + bm_].T @ gh[m0:m0 + bm_]
    acc = acc.to(out_dtype)
    return (acc, xh, gh) if operands else acc
