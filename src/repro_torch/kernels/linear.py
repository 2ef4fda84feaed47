"""HBFP matmul on the kernel backend (port of the forward half of
`repro.kernels.linear`).

`hbfp_matmul_kernel(x, w, cfg)` flattens x's leading dims into M, resolves
the call site's `KernelSpec`, pads x and w with zeros to the tile grid
(zero padding quantizes to zero and adds nothing), runs the forward kernel
`kernels.hbfp_matmul.hbfp_matmul_fwd` and slices back. The backward GEMMs
come with ROADMAP B2/B3: a call that autograd would have to differentiate
raises instead of returning a result with wrong gradients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune
from repro_torch.kernels.hbfp_matmul import hbfp_matmul_fwd


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


def _fwd_impl(spec: KernelSpec, x2: torch.Tensor, w: torch.Tensor,
              seed) -> torch.Tensor:
    M, K = x2.shape
    N = w.shape[1]
    bm, bk, bn = autotune.align_tiles(
        autotune.clip_tiles(spec.fwd, M, K, N), spec.block)
    y = hbfp_matmul_fwd(
        _pad2(x2, bm, bk).contiguous(), _pad2(w, bk, bn).contiguous(), seed,
        mantissa_bits=spec.mantissa_bits, stochastic=spec.stochastic,
        quantize_w=spec.quantize_w, block=spec.block, bm=bm, bk=bk, bn=bn)
    return y[:M, :N].to(x2.dtype)


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


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def hbfp_matmul_kernel(x: torch.Tensor, w: torch.Tensor, cfg,
                       seed: Optional[int] = None, *,
                       dgrad_cfg=None, wgrad_cfg=None) -> torch.Tensor:
    """BFP matmul y = Q(x)·Q(w) on the forward kernel. x: [..., K];
    w: [K, N]. cfg None or >= 24 mantissa bits is a plain matmul, as in
    the reference. Stochastic rounding needs an int `seed`."""
    if cfg is None or cfg.mantissa_bits >= 24:
        return torch.matmul(x, w)
    if w.ndim != 2:
        raise ValueError(f"kernel path needs 2-D w, got {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "the kernel backend's backward GEMMs come with ROADMAP B2/B3")
    K = x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K)
    if cfg.rounding == "stochastic":
        if seed is None:
            raise ValueError("stochastic rounding requires a seed")
    else:
        seed = 0
    spec = resolve_spec(cfg, x2.shape[0], K, N, dtype=_dtype_name(x.dtype),
                        dgrad_cfg=dgrad_cfg, wgrad_cfg=wgrad_cfg)
    y = _fwd_impl(spec, x2, w, seed)
    return y.reshape(*x.shape[:-1], N)
