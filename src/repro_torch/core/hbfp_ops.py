"""HBFP dot products on the simulation path (port of `repro.core.hbfp_ops`).

    fwd : y  = Qa(x) @ Qw(w)         Qa: per-row exponents along the
    bwd : dx = Qa(g) @ Qw(w)ᵀ            contraction (paper §5.1)
          dw = Qa(x)ᵀ @ Qa(g)        Qw: square-tile exponents (§4.2), or
                                         per-vector ones when the right
                                         operand is itself an activation

All three GEMMs run in BFP under a `torch.autograd.Function` (the
reference's custom VJP); gradients flow straight through the quantizers.
With uniform role widths the backward reuses the forward's quantized
operands; per-role widths (`dgrad_cfg`/`wgrad_cfg`) re-quantize each
backward GEMM's operands at its own width. Attention's QKᵀ and PV run
here on every backend.

Tensor parallelism (`tp`, a `sharding.tensor_parallel.TPCall`): a
row-parallel call ("row", x holding a part of each row) quantizes x on
the global row amax where its exponent group spans the ranks and returns
the f32 partial product, which the caller sums over the ranks; a
column-parallel call ("col", the output columns a part) quantizes g on
the global row amax likewise and, given `reduce_dx`, sums the f32 input
gradient over the ranks before its one cast.

Stochastic rounding takes the call's int key and, as the reference,
folds the operand into it (0 for x, 1 for w, 2 for g); a backward GEMM
at a diverged role width or block folds a (role, width, block) salt
too (`_role_key`), so it never consumes another role's draws. Under a
mesh each operand is a part of the one a single process quantizes:
`x_base` and `w_base` (`kernels.common.IndexBase`) say which, g's base
follows from them (`grad_base`), and every role of an operand draws at
its part's one-process indices.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bfp
from repro_torch.core.formats import HBFPConfig
from repro_torch.kernels.common import (IndexBase, fold_in,
                                        role_stream_salt)
from repro_torch.sharding.tensor_parallel import (local_row_amax,
                                                  row_amax_needed)


def _fold(key: Optional[int], i: int) -> Optional[int]:
    return None if key is None else fold_in(key, i)


def _role_key(key: Optional[int], i: int, role: str, role_cfg: HBFPConfig,
              base_cfg: HBFPConfig) -> Optional[int]:
    """Operand key of one GEMM role: `_fold(key, i)` at the base width and
    block (the tensor replays its forward draws), folded with the
    (role, width, block) salt otherwise (DESIGN.md §11, §13)."""
    k = _fold(key, i)
    if k is None:
        return None
    salt = role_stream_salt(role, role_cfg.mantissa_bits,
                            base_cfg.mantissa_bits,
                            int(role_cfg.act_block or 0),
                            int(base_cfg.act_block or 0))
    return fold_in(k, salt) if salt else k


def grad_base(x_base: Optional[IndexBase], w_base: Optional[IndexBase],
              x_shape, w_shape) -> Optional[IndexBase]:
    """The base of the output gradient g [..., N] of a product of the
    parts x [..., K] at `x_base` and w [..., K, N] at `w_base`: x's lead
    dims and w's last (None when both are whole)."""
    if x_base is None and w_base is None:
        return None
    xs = IndexBase(tuple(x_shape), (0,) * len(x_shape)) if x_base is None \
        else x_base
    ws = IndexBase(tuple(w_shape), (0,) * len(w_shape)) if w_base is None \
        else w_base
    return IndexBase(xs.shape[:-1] + ws.shape[-1:],
                     xs.offset[:-1] + ws.offset[-1:])


def _q_act(x, cfg: HBFPConfig, key, contract_axis: int, tp=None,
           base: Optional[IndexBase] = None):
    """Per-row exponents along the contraction axis (optionally blocked by
    cfg.act_block); on the global amax along that axis, reduced over `tp`
    (a TPCall whose ranks each hold a part of the contraction: x's last
    axis, or the rows of an activation-kind right operand), where the
    parts cut an exponent group; drawn as the part `base`."""
    tile = [1] * x.ndim
    tile[contract_axis] = cfg.act_block
    amax = None
    k = x.shape[contract_axis]
    if tp is not None and row_amax_needed(cfg.act_block, k, k * tp.size):
        # the call reduces a row amax; a right operand's groups are the
        # columns, the rows of its transpose
        if contract_axis % x.ndim == x.ndim - 1:
            amax = tp.reduce_max(local_row_amax(x))
        else:
            amax = tp.reduce_max(x.transpose(-1, -2)).transpose(-1, -2)
    return bfp.quantize(x, cfg.mantissa_bits, tile, cfg.rounding, key, amax,
                        base)


def _q_w(w, cfg: HBFPConfig, key, base: Optional[IndexBase] = None):
    return bfp.quantize(w, cfg.mantissa_bits,
                        bfp.weight_tile_shape(w.ndim, cfg.tile),
                        cfg.rounding, key, base=base)


def _q_b(b, cfg: HBFPConfig, key, kind: str,
         base: Optional[IndexBase] = None, tp=None):
    """Quantize the right-hand operand b[..., K, N] (the part `base`); an
    activation-kind b of a row-parallel call (`tp`) holds this rank's
    rows of the contraction, each column on its global amax where the
    parts cut its exponent group."""
    if kind == "weight":
        if not cfg.requantize_weights:
            return b
        return _q_w(b, cfg, key, base)
    return _q_act(b, cfg, key, contract_axis=b.ndim - 2, tp=tp, base=base)


def _sum_to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Sum t over the batch dims where `like` has size 1 (broadcast batch
    dims, e.g. GQA's shared K/V)."""
    for ax in range(t.ndim - 2):
        if like.shape[ax] == 1 and t.shape[ax] != 1:
            t = t.sum(dim=ax, keepdim=True)
    return t


class _HBFPMatmulFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, cfg, dgrad_cfg, wgrad_cfg, w_kind, key, tp,
                bases):
        row = tp if tp is not None and tp.kind == "row" else None
        xb, wb = bases
        xq = _q_act(x, cfg, _fold(key, 0), contract_axis=x.ndim - 1, tp=row,
                    base=xb)
        wq = _q_b(w, cfg, _fold(key, 1), w_kind, wb, row)
        if row is not None:
            # the partial product in f32, summed over the ranks outside
            y = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
        else:
            y = torch.matmul(xq, wq)
        uniform = dgrad_cfg is None and wgrad_cfg is None
        # uniform widths: the backward reuses the forward's quantized
        # operands; per-role widths keep the raw ones
        ctx.save_for_backward(*((xq, wq) if uniform else (x, w)))
        ctx.cfgs = (cfg, dgrad_cfg, wgrad_cfg, w_kind, key)
        ctx.tp = tp
        ctx.bases = (xb, wb, grad_base(xb, wb, x.shape, w.shape))
        return y

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        cfg, dgrad_cfg, wgrad_cfg, w_kind, key = ctx.cfgs
        xb, wb, gb = ctx.bases
        tp = ctx.tp
        col = tp if tp is not None and tp.kind == "col" else None
        row = tp if tp is not None and tp.kind == "row" else None
        if row is not None:
            # the gradient of the cast of the summed f32 partials: exact
            # in x's dtype, as one process receives it
            g = g.to(a.dtype)
        if dgrad_cfg is None and wgrad_cfg is None:
            xq, wq = a, b
            gq_d = gq_w = _q_act(g, cfg, _fold(key, 2),
                                 contract_axis=g.ndim - 1, tp=col, base=gb)
        else:
            dcfg = dgrad_cfg if dgrad_cfg is not None else cfg
            wcfg = wgrad_cfg if wgrad_cfg is not None else cfg
            wq = _q_b(b, dcfg, _role_key(key, 1, "dgrad", dcfg, cfg), w_kind,
                      wb)
            gq_d = _q_act(g, dcfg, _role_key(key, 2, "dgrad", dcfg, cfg),
                          contract_axis=g.ndim - 1, tp=col, base=gb)
            xq = _q_act(a, wcfg, _role_key(key, 0, "wgrad", wcfg, cfg),
                        contract_axis=a.ndim - 1, tp=row, base=xb)
            gq_w = _q_act(g, wcfg, _role_key(key, 2, "wgrad", wcfg, cfg),
                          contract_axis=g.ndim - 1, tp=col, base=gb)
        if tp is not None and tp.reduce_dx is not None:
            # the f32 partial input gradient, summed, cast once
            dx = tp.reduce_dx(torch.matmul(
                gq_d.to(torch.float32), wq.to(torch.float32).T))
        else:
            dx = _sum_to(torch.matmul(gq_d, wq.transpose(-1, -2)), xq)
        if wq.ndim == 2:
            dw = torch.matmul(xq.reshape(-1, xq.shape[-1]).T,
                              gq_w.reshape(-1, gq_w.shape[-1]))
        else:
            dw = _sum_to(torch.matmul(xq.transpose(-1, -2), gq_w), wq)
        return (dx.to(xq.dtype), dw.to(wq.dtype), None, None, None, None,
                None, None, None)


def hbfp_matmul(x: torch.Tensor, w: torch.Tensor,
                cfg: Optional[HBFPConfig], key: Optional[int] = None,
                w_kind: str = "weight", *, dgrad_cfg=None,
                wgrad_cfg=None, tp=None, x_base=None,
                w_base=None) -> torch.Tensor:
    """y = Q(x) @ Q(w) with BFP backward passes. x: [..., M, K]; w: [K, N]
    or [..., K, N] with batch dims broadcasting against x. cfg None is a
    plain matmul. Stochastic rounding needs an int `key`. w_kind "act"
    gives the right operand per-vector exponents along the contraction.
    dgrad_cfg/wgrad_cfg (None or equal to cfg: the uniform path) quantize
    the backward GEMMs at their own widths. `tp` (a TPCall, 2-D w only)
    runs it as one rank's part of a tensor-parallel product; `x_base`,
    `w_base` (`kernels.common.IndexBase`, None for a whole operand) the
    operands' parts of one process's (module doc)."""
    if cfg is None:
        return _fp_matmul(x, w, tp)
    if w.ndim != 2 and w.ndim != x.ndim:
        raise ValueError(f"rank mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if cfg.rounding == "stochastic" and key is None:
        raise ValueError("stochastic rounding requires a key")
    if dgrad_cfg == cfg:
        dgrad_cfg = None
    if wgrad_cfg == cfg:
        wgrad_cfg = None
    if cfg.rounding != "stochastic":
        x_base = w_base = None          # nearest rounding draws nothing
    return _HBFPMatmulFn.apply(x, w, cfg, dgrad_cfg, wgrad_cfg, w_kind, key,
                               tp, (x_base, w_base))


class _FPMatmulFn(torch.autograd.Function):
    """A plain tensor-parallel product (fp32 policies): the row-parallel
    partial in f32; a column one's input gradient summed in f32."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        if tp.kind == "row":
            return torch.matmul(x.to(torch.float32), w.to(torch.float32))
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        tp = ctx.tp
        g = g.to(x.dtype)
        if tp.reduce_dx is not None:
            dx = tp.reduce_dx(torch.matmul(g.to(torch.float32),
                                           w.to(torch.float32).T))
        else:
            dx = torch.matmul(g, w.T)
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
        return dx.to(x.dtype), dw.to(w.dtype), None


def _fp_matmul(x, w, tp):
    return torch.matmul(x, w) if tp is None else _FPMatmulFn.apply(x, w, tp)


def hbfp_linear(x, w, b, cfg: Optional[HBFPConfig],
                key: Optional[int] = None) -> torch.Tensor:
    """Linear layer: BFP matmul + FP bias add (a bias add is not a dot
    product)."""
    y = hbfp_matmul(x, w, cfg, key)
    if b is not None:
        y = y + b
    return y


# ----------------------------------------------------------------------------
# Convolution via im2col, for the paper's image models: the conv backward
# passes reduce to the same three BFP matmuls through the im2col view.
# ----------------------------------------------------------------------------

def hbfp_conv2d(x: torch.Tensor, w: torch.Tensor, cfg: Optional[HBFPConfig],
                key: Optional[int] = None, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
    """NHWC conv, HWIO weights, as im2col + hbfp_matmul (the reference's
    layouts, so weights carry across unchanged).

    Weight tiles follow the paper ("for convolutional layers, we tile the
    two outer feature-map dimensions of the weight matrices"): the im2col
    view [cin*kh*kw, cout] makes those the two matrix dims. Patch features
    are ordered (cin, kh, kw), as `jax.lax.conv_general_dilated_patches`
    orders them. "SAME" pads (k//2, (k-1)//2) on each spatial axis at any
    stride, as the reference does; torch's padding="same" would put an
    even kernel's extra row on the other side."""
    kh, kw, cin, cout = w.shape
    n = x.shape[0]
    if padding == "SAME":
        x = F.pad(x, (0, 0, kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    # [n, ho, wo, cin, kh, kw]
    patches = x.unfold(1, kh, stride).unfold(2, kw, stride)
    ho, wo = patches.shape[1], patches.shape[2]
    cols = patches.reshape(n * ho * wo, cin * kh * kw)
    wmat = w.movedim(2, 0).reshape(cin * kh * kw, cout)
    y = hbfp_matmul(cols, wmat, cfg, key)
    return y.reshape(n, ho, wo, cout)
