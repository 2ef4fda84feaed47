"""Wide-weight-storage optimizer shell (port of `repro.core.opt_shell`,
paper §4.2 + §5.1).

The persistent master params are the wide-BFP copy (16-bit mantissas in
f32 containers); `narrow_params` derives the narrow compute copy and
`hbfp_apply_updates` rounds freshly updated weights back into wide
storage. Parameters are a nested dict of tensors with the reference's
layout, so `param_path_name` gives byte-identical names and per-layer
policy overrides match the same parameters. Dot-product weights are
quantized; everything matching `FP_NAME_FRAGMENTS` stays FP (the hybrid
in HBFP). Nearest rounding only: the crc32 per-parameter stochastic
stream comes with ROADMAP A5.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import bfp
from repro_torch.core.formats import HBFPConfig

FP_NAME_FRAGMENTS = ("embed", "router", "bias", "scale", "norm", "gate_bias",
                     "a_log", "dt_bias", "conv")


def is_hbfp_weight(path: str, leaf) -> bool:
    """True if this parameter participates in BFP dot products."""
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    lname = path.lower()
    return not any(f in lname for f in FP_NAME_FRAGMENTS)


def param_path_name(path: Sequence) -> str:
    """Canonical '/'-joined name of a key path (dict keys, sequence
    indices, or objects with `.key` / `.idx` like jax's path entries)."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _named_map(fn: Callable[[str, Any], Any], tree, path=()):
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_named_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(param_path_name(path), tree)


def resolve_param_cfg(cfg, name: str,
                      role: str = "fwd") -> Optional[HBFPConfig]:
    """Concrete config of one parameter in one GEMM role: an HBFPConfig
    passes through, a ResolvedPolicy is asked per (name, role)."""
    if cfg is None:
        return None
    fp = getattr(cfg, "for_param", None)
    return fp(name, role) if fp is not None else cfg


def _quantize_weight_slices(leaf: torch.Tensor, c: HBFPConfig,
                            wide: bool) -> torch.Tensor:
    """quantize_weight over a stacked [L, ...] tensor one leading slice at a
    time: the tiles never cross the leading axis, so the result is the
    same while the f32 temporaries stay one layer large."""
    if leaf.ndim < 3:
        return bfp.quantize_weight(leaf, c, None, wide=wide)
    out = torch.empty_like(leaf)
    for i in range(leaf.shape[0]):
        out[i] = _quantize_weight_slices(leaf[i], c, wide)
    return out


def _quantize_tree(params, cfg, wide: bool):
    if cfg is None:
        return params

    def q(name, leaf):
        c = _weight_cfg(cfg, name, leaf)
        return leaf if c is None else _quantize_weight_slices(leaf, c, wide)

    return _named_map(q, params)


def _weight_cfg(cfg, name: str, leaf) -> Optional[HBFPConfig]:
    """The config a parameter is quantized at, or None when it stays FP."""
    c = resolve_param_cfg(cfg, name)
    if c is None or not is_hbfp_weight(name, leaf):
        return None
    if c.rounding == "stochastic":
        raise NotImplementedError(
            "stochastic weight narrowing comes with ROADMAP A5")
    return c


def narrow_params(params, cfg):
    """The narrow-mantissa compute copy of `params` (paper §5.1). `cfg`:
    HBFPConfig, ResolvedPolicy (per-layer widths) or None."""
    return _quantize_tree(params, cfg, wide=False)


def widen_params(params, cfg):
    """Round freshly updated weights into the wide-BFP storage format."""
    return _quantize_tree(params, cfg, wide=True)


def apply_update_(name: str, leaf: torch.Tensor, index: Optional[int],
                  update: torch.Tensor, cfg) -> None:
    """leaf ← Q_wide(leaf + update) in place, for the whole leaf (index
    None) or one layer slice of a stacked leaf: f32 update, wide-BFP
    storage."""
    p = leaf if index is None else leaf[index]
    new = (p.to(torch.float32) + update.to(torch.float32)).to(p.dtype)
    c = _weight_cfg(cfg, name, leaf)
    if c is not None:
        new = bfp.quantize_weight(new, c, None, wide=True)
    p.copy_(new)


def hbfp_apply_updates(params, updates, cfg):
    """params ← Q_wide(params + updates), leaf by leaf, in place (the
    reference returns a new tree; the port saves the copy). Returns
    params."""
    def one(name, leaf):
        u = updates
        for k in name.split("/"):
            u = u[k]
        apply_update_(name, leaf, None, u, cfg)
        return leaf

    _named_map(one, params)
    return params
