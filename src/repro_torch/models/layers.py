"""Shared model layers (port of `repro.models.layers`). Non-dot-product
ops (norms, rotary, softcap, gating) run in FP per the HBFP rule; dot
products route through `ctx_matmul` (DESIGN.md §10, §11)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.hbfp_ops import hbfp_matmul
from repro_torch.precision.policy import as_segment, role_width_for


def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = False):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = (1.0 + scale) if zero_centered else scale
    return (y * s).to(x.dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    if x.dtype != torch.float32:
        return cap * torch.tanh(x.to(torch.float32) / cap).to(x.dtype)
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None):
    t = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (t / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [B, H, S, hd]; positions: [B, S] int."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[:, None, :, None].to(torch.float32) * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_UNSET = object()

# ctx_matmul sites that are one of the named attention roles
_ATTN_ROLE = {"qk": "attn_qk", "pv": "attn_pv"}


def ctx_matmul(x, w, ctx, site: str, cfg=_UNSET, w_kind: str = "weight"):
    """Route one model dot product through the Ctx's resolved policy, with
    the reference's dispatch: attention roles take their role width on the
    sim path; backend "pallas" sends 2-D weight-kind products to the
    forward kernel (`kernels/linear.py`); everything else is the sim path
    (`core/hbfp_ops.py`)."""
    cfg = ctx.cfg if cfg is _UNSET else cfg
    gen = ctx.key_for(site)
    role = _ATTN_ROLE.get(site)
    if role is not None:
        rw = role_width_for(ctx.roles, role)
        if rw is not None:
            cfg = rw.apply(cfg)
        return hbfp_matmul(x, w, cfg, gen, w_kind=w_kind)
    dgrad_cfg = wgrad_cfg = None
    if cfg is not None and ctx.roles:
        dg = role_width_for(ctx.roles, "dgrad")
        wg = role_width_for(ctx.roles, "wgrad")
        dgrad_cfg = dg.apply(cfg) if dg is not None else None
        wgrad_cfg = wg.apply(cfg) if wg is not None else None
        dgrad_cfg = None if dgrad_cfg is cfg else dgrad_cfg
        wgrad_cfg = None if wgrad_cfg is cfg else wgrad_cfg
    if (ctx.backend == "pallas" and cfg is not None and w.ndim == 2
            and w_kind == "weight"):
        from repro_torch.kernels.linear import hbfp_matmul_kernel
        seed = None
        if gen is not None:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                     device=gen.device))
        return hbfp_matmul_kernel(x, w, cfg, seed, dgrad_cfg=dgrad_cfg,
                                  wgrad_cfg=wgrad_cfg)
    return hbfp_matmul(x, w, cfg, gen, w_kind=w_kind, dgrad_cfg=dgrad_cfg,
                       wgrad_cfg=wgrad_cfg)


def swiglu_ffn(x, p, ctx):
    """SwiGLU: (silu(x@wg) * (x@wi)) @ wo — three HBFP matmuls."""
    g = ctx_matmul(x, p["ffn_wg"], ctx, "ffn_g")
    u = ctx_matmul(x, p["ffn_wi"], ctx, "ffn_i")
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return ctx_matmul(h, p["ffn_wo"], ctx, "ffn_o")


def gelu_ffn(x, p, ctx):
    """GeGLU variant (tanh-approximated gelu gating)."""
    g = ctx_matmul(x, p["ffn_wg"], ctx, "ffn_g")
    u = ctx_matmul(x, p["ffn_wi"], ctx, "ffn_i")
    h = F.gelu(g.to(torch.float32), approximate="tanh").to(x.dtype) * u
    return ctx_matmul(h, p["ffn_wo"], ctx, "ffn_o")


class Ctx:
    """Quantization context (DESIGN.md §11): one `ResolvedPolicy` segment
    (global format, per-role widths, backend) plus the stochastic-rounding
    generator and the device the model runs on.

    cfg      — the segment's global activation format (None: FP);
    backend  — "sim" or "pallas" (the kernel backend);
    roles    — the per-GEMM-role width table.
    """

    __slots__ = ("policy", "cfg", "generator", "backend", "roles", "device")

    def __init__(self, cfg=None, generator: Optional[torch.Generator] = None,
                 backend=None, policy=None, device=None):
        if policy is None:
            policy = as_segment(cfg, backend=backend or "sim")
        self.policy = policy
        self.cfg = policy.global_cfg
        self.backend = backend or policy.backend
        self.roles = policy.role_widths
        self.generator = generator
        self.device = device

    def key_for(self, site: str) -> Optional[torch.Generator]:
        """The generator of stochastic rounding at `site` (None unless the
        format rounds stochastically). The port draws every site from one
        generator stream; it does not replay the reference's per-site
        key folding."""
        if self.generator is None or self.cfg is None \
                or self.cfg.rounding != "stochastic":
            return None
        return self.generator
