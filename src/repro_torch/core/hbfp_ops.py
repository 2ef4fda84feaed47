"""HBFP dot products on the simulation path (port of the forward of
`repro.core.hbfp_ops`).

    y = Qa(x) @ Qw(w)     Qa: per-row exponents along the contraction
                          Qw: square-tile exponents (or per-vector ones
                          when the right operand is itself an activation)

The serving path runs the activation x activation contractions of
attention (QK^T, PV) here. The three-GEMM backward comes with ROADMAP A4;
until then a call that autograd would differentiate raises.
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


def hbfp_matmul(x: torch.Tensor, w: torch.Tensor,
                cfg: Optional[HBFPConfig],
                generator: Optional[torch.Generator] = None,
                w_kind: str = "weight", *, dgrad_cfg=None,
                wgrad_cfg=None) -> torch.Tensor:
    """y = Q(x) @ Q(w). x: [..., M, K]; w: [K, N] or [..., K, N] with batch
    dims broadcasting against x. cfg None is a plain matmul. w_kind "act"
    gives the right operand per-vector exponents along the contraction.
    dgrad_cfg/wgrad_cfg only shape the backward, which is not ported."""
    if cfg is None:
        return torch.matmul(x, w)
    if w.ndim != 2 and w.ndim != x.ndim:
        raise ValueError(f"rank mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if cfg.rounding == "stochastic" and generator is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "the HBFP backward (BFP dgrad/wgrad) comes with ROADMAP A4")
    xq = _q_act(x, cfg, generator, contract_axis=x.ndim - 1)
    wq = _q_b(w, cfg, generator, w_kind)
    return torch.matmul(xq, wq)
