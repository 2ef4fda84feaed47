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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bfp
from repro_torch.core.formats import HBFPConfig


def _q_act(x, cfg: HBFPConfig, generator, contract_axis: int):
    """Per-row exponents along the contraction axis (optionally blocked by
    cfg.act_block)."""
    tile = [1] * x.ndim
    tile[contract_axis] = cfg.act_block
    return bfp.quantize(x, cfg.mantissa_bits, tile, cfg.rounding, generator)


def _q_w(w, cfg: HBFPConfig, generator):
    return bfp.quantize(w, cfg.mantissa_bits,
                        bfp.weight_tile_shape(w.ndim, cfg.tile),
                        cfg.rounding, generator)


def _q_b(b, cfg: HBFPConfig, generator, kind: str):
    """Quantize the right-hand operand b[..., K, N]."""
    if kind == "weight":
        if not cfg.requantize_weights:
            return b
        return _q_w(b, cfg, generator)
    return _q_act(b, cfg, generator, contract_axis=b.ndim - 2)


def _sum_to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Sum t over the batch dims where `like` has size 1 (broadcast batch
    dims, e.g. GQA's shared K/V)."""
    for ax in range(t.ndim - 2):
        if like.shape[ax] == 1 and t.shape[ax] != 1:
            t = t.sum(dim=ax, keepdim=True)
    return t


class _HBFPMatmulFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, cfg, dgrad_cfg, wgrad_cfg, w_kind, generator):
        xq = _q_act(x, cfg, generator, contract_axis=x.ndim - 1)
        wq = _q_b(w, cfg, generator, w_kind)
        y = torch.matmul(xq, wq)
        uniform = dgrad_cfg is None and wgrad_cfg is None
        # uniform widths: the backward reuses the forward's quantized
        # operands; per-role widths keep the raw ones
        ctx.save_for_backward(*((xq, wq) if uniform else (x, w)))
        ctx.cfgs = (cfg, dgrad_cfg, wgrad_cfg, w_kind, generator)
        return y

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        cfg, dgrad_cfg, wgrad_cfg, w_kind, gen = ctx.cfgs
        if dgrad_cfg is None and wgrad_cfg is None:
            xq, wq = a, b
            gq_d = gq_w = _q_act(g, cfg, gen, contract_axis=g.ndim - 1)
        else:
            dcfg = dgrad_cfg if dgrad_cfg is not None else cfg
            wcfg = wgrad_cfg if wgrad_cfg is not None else cfg
            wq = _q_b(b, dcfg, gen, w_kind)
            gq_d = _q_act(g, dcfg, gen, contract_axis=g.ndim - 1)
            xq = _q_act(a, wcfg, gen, contract_axis=a.ndim - 1)
            gq_w = _q_act(g, wcfg, gen, contract_axis=g.ndim - 1)
        dx = _sum_to(torch.matmul(gq_d, wq.transpose(-1, -2)), xq)
        if wq.ndim == 2:
            dw = torch.matmul(xq.reshape(-1, xq.shape[-1]).T,
                              gq_w.reshape(-1, gq_w.shape[-1]))
        else:
            dw = _sum_to(torch.matmul(xq.transpose(-1, -2), gq_w), wq)
        return (dx.to(xq.dtype), dw.to(wq.dtype), None, None, None, None,
                None)


def hbfp_matmul(x: torch.Tensor, w: torch.Tensor,
                cfg: Optional[HBFPConfig],
                generator: Optional[torch.Generator] = None,
                w_kind: str = "weight", *, dgrad_cfg=None,
                wgrad_cfg=None) -> torch.Tensor:
    """y = Q(x) @ Q(w) with BFP backward passes. x: [..., M, K]; w: [K, N]
    or [..., K, N] with batch dims broadcasting against x. cfg None is a
    plain matmul. w_kind "act" gives the right operand per-vector
    exponents along the contraction. dgrad_cfg/wgrad_cfg (None or equal to
    cfg: the uniform path) quantize the backward GEMMs at their own
    widths."""
    if cfg is None:
        return torch.matmul(x, w)
    if w.ndim != 2 and w.ndim != x.ndim:
        raise ValueError(f"rank mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if cfg.rounding == "stochastic" and generator is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    if dgrad_cfg == cfg:
        dgrad_cfg = None
    if wgrad_cfg == cfg:
        wgrad_cfg = None
    return _HBFPMatmulFn.apply(x, w, cfg, dgrad_cfg, wgrad_cfg, w_kind,
                               generator)
