"""Plain PyTorch version of the forward HBFP matmul kernel (port of
`repro.kernels.ref.hbfp_matmul_ref`).

It is the oracle the CUDA kernel is held to, and what the kernel wrapper
computes for a tensor that lies on the CPU. The reference loops over
(K-block, N-block) tiles; this version loops over K-blocks in ascending
order and handles all N-blocks of one K-block at once, which computes
every output element with the same dot product. Integral-mantissa dot
products run in float64: with at most 2^(2m-2) per product and the few
hundred products of a K-block the float64 sum is exact, and its single
rounding to f32 is what the kernel's exact accumulation gives too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (STREAM_W, STREAM_X, quantize_block,
                                        row_group_amax)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 with the same low 32 bits (int32 wraparound)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _slab_group_amax(ws: torch.Tensor, rb: int, cb: int) -> torch.Tensor:
    """|w| max over (rb, cb) groups of a [bk, N] K-block slab, broadcast
    back to the slab."""
    r, c = ws.shape
    g = ws.abs().reshape(r // rb, rb, c // cb, cb).amax(dim=(1, 3),
                                                       keepdim=True)
    return g.expand(r // rb, rb, c // cb, cb).reshape(r, c)


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
    seed_v = 0 if seed is None else int(torch.as_tensor(seed).reshape(-1)[0])
    dev = x.device
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=dev)
    rows = torch.arange(M, dtype=torch.int64, device=dev)[:, None]
    for kk in range(K // bk_):
        k0 = kk * bk_
        xs = xf[:, k0:k0 + bk_]
        idx_x = None
        if stochastic:
            cols = torch.arange(k0, k0 + bk_, dtype=torch.int64, device=dev)
            idx_x = _wrap_i32(rows * K + cols[None, :] + STREAM_X)
        qx, dx = quantize_block(xs, mantissa_bits, row_group_amax(xs, block),
                                stochastic=stochastic, seed=seed_v, idx=idx_x)
        ws = wf[k0:k0 + bk_]                                   # [bk, N]
        if not quantize_w:
            if x_sub:
                acc = acc + (qx * dx) @ ws
            else:
                acc = acc + (qx @ ws) * dx
            continue
        rb, cb = (min(block, bk_), min(block, bn_)) if w_sub else (bk_, bn_)
        idx_w = None
        if stochastic:
            rw = torch.arange(k0, k0 + bk_, dtype=torch.int64, device=dev)
            cw = torch.arange(N, dtype=torch.int64, device=dev)
            idx_w = _wrap_i32(rw[:, None] * N + cw[None, :] + STREAM_W)
        qw, dw = quantize_block(ws, mantissa_bits,
                                _slab_group_amax(ws, rb, cb),
                                stochastic=stochastic, seed=seed_v, idx=idx_w)
        if x_sub or w_sub:
            acc = acc + (qx * dx) @ (qw * dw)
            continue
        part = (qx.to(torch.float64) @ qw.to(torch.float64)).to(torch.float32)
        acc = acc + part * (dx * dw[:1])       # δw is constant down a column
    return acc.to(out_dtype)
