"""HBFP matmul on the kernel backend (port of `repro.kernels.linear`).

`hbfp_matmul_kernel(x, w, cfg)` flattens x's leading dims into M, resolves
the call site's `KernelSpec`, pads the operands with zeros to each GEMM's
tile grid (zero padding quantizes to zero and adds nothing to any of the
three contractions) and slices back. All three training GEMMs are
kernels, under a `torch.autograd.Function` (the reference's custom VJP):

    fwd  : y  = Q_row(x) · Q_tile(w)        hbfp_matmul_fwd (B1)
    dgrad: dx = Q_row(g) · Q_tile(w)ᵀ       hbfp_dgrad      (B2)
    wgrad: dw = Q_row(x)ᵀ ⊙ Q_row(g)        hbfp_wgrad      (B3)

Each GEMM quantizes its operands at its own tiling; x and g draw from the
same stochastic stream in every GEMM they appear in, so matching tilings
re-quantize to identical values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune
from repro_torch.kernels.common import role_stream_salt
from repro_torch.kernels.hbfp_matmul import (hbfp_dgrad, hbfp_matmul_fwd,
                                             hbfp_wgrad)


class KernelSpec(NamedTuple):
    """Static kernel configuration of one matmul call site."""
    mantissa_bits: int
    stochastic: bool
    quantize_w: bool
    fwd: Tuple[int, int, int]     # (bm, bk, bn)
    dgrad: Tuple[int, int, int]
    wgrad: Tuple[int, int, int]
    m_dgrad: int = 0
    m_wgrad: int = 0
    block: int = 0


def _pad2(a: torch.Tensor, mr: int, mc: int) -> torch.Tensor:
    pr, pc = (-a.shape[0]) % mr, (-a.shape[1]) % mc
    if pr or pc:
        return F.pad(a, (0, pc, 0, pr))
    return a


def _tiles(spec_tiles, M: int, K: int, N: int, block: int):
    return autotune.align_tiles(autotune.clip_tiles(spec_tiles, M, K, N),
                                block)


def _fwd_impl(spec: KernelSpec, x2: torch.Tensor, w: torch.Tensor,
              seed) -> torch.Tensor:
    M, K = x2.shape
    N = w.shape[1]
    bm, bk, bn = _tiles(spec.fwd, M, K, N, spec.block)
    y = hbfp_matmul_fwd(
        _pad2(x2, bm, bk).contiguous(), _pad2(w, bk, bn).contiguous(), seed,
        mantissa_bits=spec.mantissa_bits, stochastic=spec.stochastic,
        quantize_w=spec.quantize_w, block=spec.block, bm=bm, bk=bk, bn=bn)
    return y[:M, :N].to(x2.dtype)


def _role_seed(seed: int, role: str, m_bits: int, base_bits: int,
               block: int = 0, base_block: int = 0) -> int:
    """Seed of one backward GEMM: unsalted at the fwd width and block (the
    kernels' element-index streams replay the forward's draws), xor-salted
    when the role runs at its own width or block size."""
    salt = role_stream_salt(role, m_bits, base_bits, block, base_block)
    return seed ^ salt if salt else seed


class _MatmulFn(torch.autograd.Function):
    """y = B1(x2, w); the backward runs B2 and B3 on the saved raw
    operands, as the reference's `_vjp_bwd`."""

    @staticmethod
    def forward(ctx, x2, w, spec: KernelSpec, seed: int):
        y = _fwd_impl(spec, x2, w, seed)
        # saved after the launch: a recomputing checkpoint that stops at
        # its last saved tensor still runs the kernel
        ctx.save_for_backward(x2, w)
        ctx.spec, ctx.seed = spec, seed
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        spec, seed = ctx.spec, ctx.seed
        M, K = x2.shape
        N = w.shape[1]
        m_d = spec.m_dgrad or spec.mantissa_bits
        m_w = spec.m_wgrad or spec.mantissa_bits
        g = g.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            bm, bk, bn = _tiles(spec.dgrad, M, K, N, spec.block)
            dx = hbfp_dgrad(
                _pad2(g, bm, bn).contiguous(), _pad2(w, bk, bn).contiguous(),
                _role_seed(seed, "dgrad", m_d, spec.mantissa_bits,
                           spec.block, spec.block),
                mantissa_bits=m_d, stochastic=spec.stochastic,
                quantize_w=spec.quantize_w, block=spec.block, bm=bm, bk=bk,
                bn=bn)[:M, :K].to(x2.dtype)
        if ctx.needs_input_grad[1]:
            bm, bk, bn = _tiles(spec.wgrad, M, K, N, spec.block)
            dw = hbfp_wgrad(
                _pad2(x2, bm, bk).contiguous(), _pad2(g, bm, bn).contiguous(),
                _role_seed(seed, "wgrad", m_w, spec.mantissa_bits,
                           spec.block, spec.block),
                mantissa_bits=m_w, stochastic=spec.stochastic,
                block=spec.block, bm=bm, bk=bk, bn=bn)[:K, :N].to(w.dtype)
        return dx, dw, None, None


def resolve_spec(cfg, M: int, K: int, N: int, dtype: str = "float32",
                 dgrad_cfg=None, wgrad_cfg=None) -> KernelSpec:
    """The static KernelSpec of one call site: rounding and widths from the
    HBFPConfig, tiles from the autotuner, block size from `act_block`
    (DESIGN.md §13)."""
    m_d = (dgrad_cfg or cfg).mantissa_bits
    m_w = (wgrad_cfg or cfg).mantissa_bits
    block = int(getattr(cfg, "act_block", None) or 0)
    return KernelSpec(
        mantissa_bits=cfg.mantissa_bits,
        stochastic=cfg.rounding == "stochastic",
        quantize_w=cfg.requantize_weights,
        fwd=autotune.lookup("matmul_fwd", M, K, N, dtype=dtype,
                            mantissa_bits=cfg.mantissa_bits, block=block),
        dgrad=autotune.lookup("matmul_dgrad", M, K, N, dtype=dtype,
                              mantissa_bits=m_d, block=block),
        wgrad=autotune.lookup("matmul_wgrad", M, K, N, dtype=dtype,
                              mantissa_bits=m_w, block=block),
        m_dgrad=0 if m_d == cfg.mantissa_bits else m_d,
        m_wgrad=0 if m_w == cfg.mantissa_bits else m_w,
        block=block)


def hbfp_matmul_kernel(x: torch.Tensor, w: torch.Tensor, cfg,
                       seed: Optional[int] = None, *,
                       dgrad_cfg=None, wgrad_cfg=None) -> torch.Tensor:
    """BFP matmul y = Q(x)·Q(w) with kernel backward passes. x: [..., K];
    w: [K, N]. cfg None or >= 24 mantissa bits is a plain matmul, as in
    the reference. Stochastic rounding needs an int `seed`.
    `dgrad_cfg`/`wgrad_cfg` run the backward GEMMs at their own widths."""
    if cfg is None or cfg.mantissa_bits >= 24:
        return torch.matmul(x, w)
    if w.ndim != 2:
        raise ValueError(f"kernel path needs 2-D w, got {tuple(w.shape)}")
    K = x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K)
    if cfg.rounding == "stochastic":
        if seed is None:
            raise ValueError("stochastic rounding requires a seed")
    else:
        seed = 0
    spec = resolve_spec(cfg, x2.shape[0], K, N,
                        dtype=autotune.dtype_name(x.dtype),
                        dgrad_cfg=dgrad_cfg, wgrad_cfg=wgrad_cfg)
    y = _MatmulFn.apply(x2, w, spec, int(seed))
    return y.reshape(*x.shape[:-1], N)
