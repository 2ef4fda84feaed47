"""Wide-weight-storage optimizer shell (port of `repro.core.opt_shell`,
paper §4.2 + §5.1).

The persistent master params are the wide-BFP copy (16-bit mantissas in
f32 containers); `narrow_params` derives the narrow compute copy and
`hbfp_apply_updates` rounds freshly updated weights back into wide
storage. Parameters are a nested dict of tensors with the reference's
layout, so `param_path_name` gives byte-identical names and per-layer
policy overrides match the same parameters. Dot-product weights are
quantized; everything matching `FP_NAME_FRAGMENTS` stays FP (the hybrid
in HBFP).

Stochastic rounding draws each parameter from its own stream,
`param_fold(key, name)` (the reference's crc32 of the name, so a
restarted process derives the same keys). A stacked [L, ...] leaf is
quantized one leading slice at a time, slice i from
`fold_in(param_fold(key, name), i)`: the result is a pure function of
(key, name, slice), whether the leaf is narrowed whole or one layer at a
time.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import bfp
from repro_torch.core.formats import HBFPConfig
from repro_torch.kernels.common import (IndexBase, fold_in, index_base,
                                        shift_base)

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


def param_fold(key: int, name: str) -> int:
    """Per-parameter stream: `key` folded with a process-independent hash
    of the name (crc32, as the reference; Python's hash() is salted per
    process and would break replay across a restart)."""
    return fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def param_key(key: Optional[int], name: str, c: Optional[HBFPConfig],
              index: Optional[int] = None) -> Optional[int]:
    """The stochastic-rounding key of parameter `name` (of its layer slice
    `index` when given) at config `c`; None when `c` rounds to nearest or
    there is no key."""
    if key is None or c is None or c.rounding != "stochastic":
        return None
    k = param_fold(key, name)
    return k if index is None else fold_in(k, index)


def leaf_slices(leaf: torch.Tensor, key: Optional[int],
                base: Optional[IndexBase] = None):
    """(index, slice, key, base) over the leading slices of a stacked
    leaf, each below rank 3, slice i keyed `fold_in(key, i)`; a leaf below
    rank 3 is its own slice, index (). With `base` (the leaf's part in the
    whole leaf, `kernels.common.IndexBase`) the leaf is a shard: slice i
    is the whole leaf's slice i + offset, keyed by that global index and
    given the base of its trailing dims; without one each base is None."""
    if leaf.ndim < 3:
        yield (), leaf, key, base
        return
    for i in range(leaf.shape[0]):
        g = i if base is None else i + base.offset[0]
        k = None if key is None else fold_in(key, g)
        sub = None if base is None else IndexBase(base.shape[1:],
                                                  base.offset[1:])
        for idx, s, ks, bs in leaf_slices(leaf[i], k, sub):
            yield (i,) + idx, s, ks, bs


def resolve_param_cfg(cfg, name: str,
                      role: str = "fwd") -> Optional[HBFPConfig]:
    """Concrete config of one parameter in one GEMM role: an HBFPConfig
    passes through, a ResolvedPolicy is asked per (name, role)."""
    if cfg is None:
        return None
    fp = getattr(cfg, "for_param", None)
    return fp(name, role) if fp is not None else cfg


# elements of a matrix quantized at once (bounds the f32 temporaries of a
# large head to ~256 MB each)
_ROW_BLOCK_ELEMS = 1 << 26


def _quantize_matrix(w: torch.Tensor, c: HBFPConfig, wide: bool,
                     key: Optional[int],
                     base: Optional[IndexBase] = None) -> torch.Tensor:
    """quantize_weight of one slice (`base`: its part in the whole slice).
    A large matrix goes in blocks of whole tile rows: the same tiles, so
    the same result, with block-sized temporaries; under stochastic
    rounding each block is drawn at its rows' index in the whole slice
    (its base), so the draws are the whole slice's too."""
    rows = w.shape[0] if w.ndim == 2 else 0
    block = 0
    if rows and c.tile:
        block = (_ROW_BLOCK_ELEMS // max(w.shape[1], 1)) // c.tile * c.tile
    if not block or block >= rows:
        return bfp.quantize_weight(w, c, key, wide=wide, base=base)
    if base is None:
        base = index_base(w.shape)
    out = torch.empty_like(w)
    for r0 in range(0, rows, block):
        out[r0:r0 + block] = bfp.quantize_weight(
            w[r0:r0 + block], c, key, wide=wide,
            base=shift_base(base, 0, r0))
    return out


def quantize_leaf(leaf: torch.Tensor, c: HBFPConfig, wide: bool,
                  key: Optional[int] = None,
                  base: Optional[IndexBase] = None) -> torch.Tensor:
    """quantize_weight over a stacked [L, ...] tensor one leading slice at a
    time (`leaf_slices`; a MoE leaf [L, E, D, F] one [D, F] slice at a
    time): the tiles never cross the leading axes, so the nearest result
    is the whole tensor's while the f32 temporaries stay one slice large.
    `key` is the leaf's `param_key`; `base` makes the leaf that shard of
    the whole leaf (its slices keyed and drawn as the whole leaf's)."""
    if leaf.ndim < 3:
        return _quantize_matrix(leaf, c, wide, key, base)
    out = torch.empty_like(leaf)
    for idx, s, k, b in leaf_slices(leaf, key, base):
        out[idx] = _quantize_matrix(s, c, wide, k, b)
    return out


def _quantize_tree(params, cfg, key: Optional[int], wide: bool):
    if cfg is None:
        return params

    def q(name, leaf):
        c = _weight_cfg(cfg, name, leaf)
        return leaf if c is None else quantize_leaf(
            leaf, c, wide, param_key(key, name, c))

    return _named_map(q, params)


def _weight_cfg(cfg, name: str, leaf) -> Optional[HBFPConfig]:
    """The config a parameter is quantized at, or None when it stays FP."""
    c = resolve_param_cfg(cfg, name)
    if c is None or not is_hbfp_weight(name, leaf):
        return None
    return c


def narrow_params(params, cfg, key: Optional[int] = None):
    """The narrow-mantissa compute copy of `params` (paper §5.1). `cfg`:
    HBFPConfig, ResolvedPolicy (per-layer widths) or None; `key` (an int)
    for stochastic rounding."""
    return _quantize_tree(params, cfg, key, wide=False)


def widen_params(params, cfg, key: Optional[int] = None):
    """Round freshly updated weights into the wide-BFP storage format."""
    return _quantize_tree(params, cfg, key, wide=True)


def slice_base(base: Optional[IndexBase], index: Optional[int]):
    """(the global layer index, the slice's base) of local slice `index`
    of a leaf that is the part `base` of the whole leaf (index None: the
    leaf itself)."""
    if index is None or base is None:
        return index, base
    return index + base.offset[0], IndexBase(base.shape[1:], base.offset[1:])


def apply_update_(name: str, leaf: torch.Tensor, index: Optional[int],
                  update: torch.Tensor, cfg, key: Optional[int] = None,
                  base: Optional[IndexBase] = None) -> None:
    """leaf ← Q_wide(leaf + update) in place, for the whole leaf (index
    None) or one layer slice of a stacked leaf: f32 update, wide-BFP
    storage, rounded on the slice's stream of `key` (`param_key`). `base`
    makes the leaf a shard of the whole leaf: the slice is keyed by its
    global layer index and drawn at its elements' whole-leaf indices."""
    p = leaf if index is None else leaf[index]
    new = (p.to(torch.float32) + update.to(torch.float32)).to(p.dtype)
    c = _weight_cfg(cfg, name, leaf)
    if c is not None:
        gi, b = slice_base(base, index)
        new = quantize_leaf(new, c, True, param_key(key, name, c, gi), b)
    p.copy_(new)


def hbfp_apply_updates(params, updates, cfg, key: Optional[int] = None):
    """params ← Q_wide(params + updates), leaf by leaf, in place (the
    reference returns a new tree; the port saves the copy). Returns
    params."""
    def one(name, leaf):
        u = updates
        for k in name.split("/"):
            u = u[k]
        apply_update_(name, leaf, None, u, cfg, key)
        return leaf

    _named_map(one, params)
    return params
