"""Serving steps (port of `repro.train.serve_step`): prefill and decode on
the narrow BFP weight copy, narrowed once at load time.

Precision specs: None, an HBFPConfig, a PrecisionPolicy (served at its
first segment) or a ResolvedPolicy (DESIGN.md §11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.opt_shell import narrow_params
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.precision.policy import (PrecisionPolicy, ResolvedPolicy,
                                          as_segment)


def _serve_seg(hbfp) -> ResolvedPolicy:
    """Coerce any serving precision spec to its first segment."""
    if isinstance(hbfp, PrecisionPolicy):
        return hbfp.resolve_segment(0)
    return as_segment(hbfp)


def _serve_cfg(hbfp):
    """Serving weights are narrowed once at load time; the per-step
    re-quantization is skipped (requantize_weights=False)."""
    cfg = _serve_seg(hbfp).global_cfg
    return None if cfg is None else cfg.with_(requantize_weights=False)


def _serve_ctx(arch: ArchConfig, hbfp, device=None):
    """Ctx factory of the policy's serving slice: role widths, backend and
    the load-time-narrowed weight contract. `device` None is the CUDA
    device."""
    seg = _serve_seg(hbfp)
    exec_seg = ResolvedPolicy(global_cfg=_serve_cfg(hbfp),
                              role_widths=seg.role_widths,
                              backend=seg.backend)
    dev = resolve_device(device)
    return lambda key=None: Ctx(key=key, policy=exec_seg, device=dev)


def make_prefill_fn(arch: ArchConfig, hbfp, device=None):
    ctx_for = _serve_ctx(arch, hbfp, device)

    def prefill_fn(params, batch, key=None):
        # a serving stage: the reference's jitted prefill sees traced
        # positions and never takes the flash path
        return prefill(params, batch, arch, ctx_for(key),
                       std_pos=False)

    return prefill_fn


def make_decode_fn(arch: ArchConfig, hbfp, device=None):
    """decode_fn(params, batch, cache) -> (logits, cache); `params` must be
    the narrow serving copy (narrow_serving_params)."""
    ctx_for = _serve_ctx(arch, hbfp, device)

    def decode_fn(params, batch, cache, key=None):
        return decode_step(params, batch, cache, arch, ctx_for(key))

    return decode_fn


def narrow_serving_params(params, arch: ArchConfig, hbfp):
    """One-time weight narrowing (per-layer overrides resolve here) and
    cast of the >= 2-D tensors to the compute dtype."""
    compute_dtype = dtype_of(arch.dtype)
    seg = _serve_seg(hbfp)
    p = narrow_params(params, None if seg.is_fp32 else seg)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(compute_dtype) if t.ndim >= 2 else t

    return cast(p)


def prefill_to_decode_cache(cache, arch: ArchConfig, ctx_len: int):
    """Grow a prefill cache (C = prompt length) into a decode cache
    (C = ctx_len ring): k/v mantissas and exponents pad with 0, slot_pos
    with -1. Dispatches on the KVCache type, not on key names: every
    other entry (the ssm, mlstm and slstm states) is length-independent
    and passes through untouched."""
    def grow(leaf, fill, axis):
        if leaf is None or leaf.shape[axis] >= ctx_len:
            return leaf
        pad = [0, 0] * (leaf.ndim - 1 - axis) + [0, ctx_len - leaf.shape[axis]]
        return F.pad(leaf, pad, value=fill)

    def one(c):
        if isinstance(c, KVCache):
            # stacked leaves: k/v/exps [L, B, Hkv, C(, hd)], slot_pos [L, B, C]
            return KVCache(k=grow(c.k, 0, 3), v=grow(c.v, 0, 3),
                           slot_pos=grow(c.slot_pos, -1, 2),
                           k_exp=grow(c.k_exp, 0, 3),
                           v_exp=grow(c.v_exp, 0, 3))
        return c

    return {k: one(v) for k, v in cache.items()}
