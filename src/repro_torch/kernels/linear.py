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

Tensor parallelism (`tp`, a `sharding.tensor_parallel.TPCall`): the
call site's tiles are resolved at the product's global shape, so each
rank's part keeps the one-process exponent groups. A row-parallel call
quantizes x (B1, B3) on the global row amax where a K-block spans the
ranks (the whole row is one K-block) and returns B1's f32 partial sums;
a column-parallel call does the same for g (B2, B3) and sums B2's f32
input gradient over the ranks (`reduce_dx`) before its one cast.

Stochastic rounding under a mesh (`x_base`, `w_base`: each operand's
part of the one a single process multiplies, `kernels.common.IndexBase`):
each GEMM gets the 2-D bases of its operands (`flat_base`) on the
one-process operands padded to that GEMM's tiles at the global shape, so
every quantize pass of B1-B3 draws one process's numbers. A part whose
rows are not one contiguous run of the one-process rows is refused.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.hbfp_ops import _fp_matmul
from repro_torch.kernels import autotune
from repro_torch.kernels.common import (IndexBase, flat_base, is_whole,
                                        role_stream_salt)
from repro_torch.kernels.hbfp_matmul import (hbfp_dgrad, hbfp_matmul_fwd,
                                             hbfp_wgrad)
from repro_torch.sharding.tensor_parallel import (local_row_amax,
                                                  row_amax_needed)


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


def _pad_rows(a: Optional[torch.Tensor], mr: int):
    """A row amax [M, 1] as the [Mp] operand of rows padded to mr (zero
    rows quantize to zero on any amax)."""
    if a is None:
        return None
    a = a.reshape(-1)
    pr = (-a.shape[0]) % mr
    return (F.pad(a, (0, pr)) if pr else a).contiguous()


class _Parts(NamedTuple):
    """The parts of one product under a mesh: x's N-d base and w's 2-D
    base (unpadded; None for a whole operand), the local shapes of x and
    w, and the global (K, N) that the one-process operands pad to each
    GEMM's tiles."""
    x: Optional[IndexBase]
    w: Optional[IndexBase]
    x_shape: tuple
    w_shape: tuple
    K: int
    N: int


def _gemm_bases(parts: Optional[_Parts], spec: KernelSpec, op: str,
                M: int) -> dict:
    """The 2-D index bases of one GEMM's operands ({} without parts): the
    one-process operands padded to the GEMM's tiles at the global (K, N)
    (x's rows run along K, g's and w's along N; g's rows are x's)."""
    if parts is None:
        return {}
    _, bk, bn = _tiles(getattr(spec, op), M, parts.K, parts.N, spec.block)
    ldk, ldn = -(-parts.K // bk) * bk, -(-parts.N // bn) * bn
    xb = flat_base(parts.x, parts.x_shape, ldk)
    wb = flat_base(parts.w, parts.w_shape, ldn)
    gb = IndexBase((xb.shape[0], ldn), (xb.offset[0], wb.offset[1]))
    return {"fwd": dict(x_base=xb, w_base=wb),
            "dgrad": dict(g_base=gb, w_base=wb),
            "wgrad": dict(x_base=xb, g_base=gb)}[op]


def _fwd_impl(spec: KernelSpec, x2: torch.Tensor, w: torch.Tensor,
              seed, x_amax=None, out_f32: bool = False,
              parts: Optional[_Parts] = None) -> torch.Tensor:
    M, K = x2.shape
    N = w.shape[1]
    bm, bk, bn = _tiles(spec.fwd, M, K, N, spec.block)
    y = hbfp_matmul_fwd(
        _pad2(x2, bm, bk).contiguous(), _pad2(w, bk, bn).contiguous(), seed,
        mantissa_bits=spec.mantissa_bits, stochastic=spec.stochastic,
        quantize_w=spec.quantize_w, block=spec.block, bm=bm, bk=bk, bn=bn,
        x_amax=_pad_rows(x_amax, bm), **_gemm_bases(parts, spec, "fwd", M))
    y = y[:M, :N]
    return y if out_f32 else y.to(x2.dtype)


class _TPNeeds(NamedTuple):
    """A tensor-parallel call and which of its quantize passes take the
    global row amax (x in B1 and B3, g in B2 and B3)."""
    call: object
    x_fwd: bool
    x_wgrad: bool
    g_dgrad: bool
    g_wgrad: bool


def _tp_needs(tp, spec: KernelSpec, K: int, N: int) -> _TPNeeds:
    """Where the shard of a `tp.kind` product at the global (K, N) tiles
    cuts an activation exponent group (`row_amax_needed` raises on a cut
    group that is not the whole row)."""
    def need(tiles, axis):
        cblk = tiles[axis]
        group = spec.block if spec.block and spec.block < cblk else cblk
        full = K if axis == 1 else N
        return row_amax_needed(group, full // tp.size, full)

    row, col = tp.kind == "row", tp.kind == "col"
    return _TPNeeds(tp, row and need(spec.fwd, 1), row and need(spec.wgrad, 1),
                    col and need(spec.dgrad, 2), col and need(spec.wgrad, 2))


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
    def forward(ctx, x2, w, spec: KernelSpec, seed: int, tp=None,
                parts=None):
        amax = None
        if tp is not None and (tp.x_fwd or tp.x_wgrad):
            amax = tp.call.reduce_max(local_row_amax(x2))
        y = _fwd_impl(spec, x2, w, seed, amax if tp and tp.x_fwd else None,
                      out_f32=tp is not None and tp.call.kind == "row",
                      parts=parts)
        # saved after the launch: a recomputing checkpoint that stops at
        # its last saved tensor still runs the kernel
        ctx.save_for_backward(x2, w)
        ctx.spec, ctx.seed, ctx.tp, ctx.parts = spec, seed, tp, parts
        ctx.x_amax = amax if tp is not None and tp.x_wgrad else None
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
        tp = ctx.tp
        g_amax = None
        if tp is not None and (tp.g_dgrad or tp.g_wgrad):
            g_amax = tp.call.reduce_max(local_row_amax(g))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            bm, bk, bn = _tiles(spec.dgrad, M, K, N, spec.block)
            dx = hbfp_dgrad(
                _pad2(g, bm, bn).contiguous(), _pad2(w, bk, bn).contiguous(),
                _role_seed(seed, "dgrad", m_d, spec.mantissa_bits,
                           spec.block, spec.block),
                mantissa_bits=m_d, stochastic=spec.stochastic,
                quantize_w=spec.quantize_w, block=spec.block, bm=bm, bk=bk,
                bn=bn, g_amax=_pad_rows(g_amax if tp and tp.g_dgrad
                                        else None, bm),
                **_gemm_bases(ctx.parts, spec, "dgrad", M))[:M, :K]
            if tp is not None and tp.call.reduce_dx is not None:
                dx = tp.call.reduce_dx(dx)
            dx = dx.to(x2.dtype)
        if ctx.needs_input_grad[1]:
            bm, bk, bn = _tiles(spec.wgrad, M, K, N, spec.block)
            dw = hbfp_wgrad(
                _pad2(x2, bm, bk).contiguous(), _pad2(g, bm, bn).contiguous(),
                _role_seed(seed, "wgrad", m_w, spec.mantissa_bits,
                           spec.block, spec.block),
                mantissa_bits=m_w, stochastic=spec.stochastic,
                block=spec.block, bm=bm, bk=bk, bn=bn,
                x_amax=_pad_rows(ctx.x_amax, bm),
                g_amax=_pad_rows(g_amax if tp and tp.g_wgrad else None, bm),
                **_gemm_bases(ctx.parts, spec, "wgrad", M)
            )[:K, :N].to(w.dtype)
        return dx, dw, None, None, None, None


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
                       dgrad_cfg=None, wgrad_cfg=None,
                       tp=None, x_base=None, w_base=None) -> torch.Tensor:
    """BFP matmul y = Q(x)·Q(w) with kernel backward passes. x: [..., K];
    w: [K, N]. cfg None or >= 24 mantissa bits is a plain matmul, as in
    the reference. Stochastic rounding needs an int `seed`.
    `dgrad_cfg`/`wgrad_cfg` run the backward GEMMs at their own widths;
    `tp` (a TPCall) runs one rank's part of a tensor-parallel product;
    `x_base` (over x's dims) and `w_base` (2-D) the operands' parts of one
    process's (module doc)."""
    if cfg is None or cfg.mantissa_bits >= 24:
        return _fp_matmul(x, w, tp)
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
    Kg = K * tp.size if tp is not None and tp.kind == "row" else K
    Ng = N * tp.size if tp is not None and tp.kind == "col" else N
    spec = resolve_spec(cfg, x2.shape[0], Kg, Ng,
                        dtype=autotune.dtype_name(x.dtype),
                        dgrad_cfg=dgrad_cfg, wgrad_cfg=wgrad_cfg)
    needs = None if tp is None else _tp_needs(tp, spec, Kg, Ng)
    parts = None
    if spec.stochastic and not (is_whole(x_base, x.shape)
                                and is_whole(w_base, w.shape)):
        parts = _Parts(x_base, w_base, tuple(x.shape), tuple(w.shape), Kg,
                       Ng)
        for op in ("fwd", "dgrad", "wgrad"):     # refuse a part now
            _gemm_bases(parts, spec, op, x2.shape[0])
    y = _MatmulFn.apply(x2, w, spec, int(seed), needs, parts)
    return y.reshape(*x.shape[:-1], N)
