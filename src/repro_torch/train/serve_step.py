"""Serving steps (port of `repro.train.serve_step`): prefill and decode on
the narrow BFP weight copy, narrowed once at load time.

Precision specs: None, an HBFPConfig, a PrecisionPolicy (served at its
first segment) or a ResolvedPolicy (DESIGN.md §11).
"""
from __future__ import annotations

from typing import Optional

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


class ServeLayout:
    """Where a served model lives on a ("data", "model") or ("pod",
    "data", "model") mesh (a DeviceMesh): the reference's serving cells,
    `repro/launch/dryrun.py:191-230`, whose sharded prefill and decode
    XLA partitions under `fwd_param_specs(ep_only=)`, `batch_specs` and
    `cache_specs(seq_shard=True)`, here earned by hand.

      * parameters: the tile-aligned "model" layout of
        `sharding.tensor_parallel.tp_layout` (with `ep_only` the experts
        alone; `replicated` lists each leaf the reference's rules shard
        and this layout keeps whole, with its reason); `shard_params`
        gives a rank its part of whole (narrow) weights;
      * batch: each data rank its rows (`local_batch`), the model's
        `Ctx.dp` (`data_part`);
      * cache: `cache_layout` (the batch over the data axes, the kv heads
        or the ring's slots over "model", the recurrent states whole);
        `make_cache` a rank's empty part, `decode_cache` its part of a
        prefill's prompt cache grown to the ring;
      * `ctx(batch_size, ctx_len, prefill)`: the serving context (narrow
        weights, no re-quantization) with the model group, the data rows
        and the cache split. Prefill may take `seq_parallel`; decode
        never does.

    Every collective is one of `launch.transport.Transport`'s, recorded:
    `model` (the "model" axis), `data` (the data axes)."""

    def __init__(self, arch: ArchConfig, mesh, hbfp, device=None, *,
                 ep_only: bool = False, seq_parallel: bool = False):
        from repro_torch.launch.transport import Transport
        from repro_torch.models.transformer import init_params
        from repro_torch.sharding.partitioning import dp_axes, mesh_axes
        from repro_torch.sharding.tensor_parallel import TPGroup, tp_layout
        from repro_torch.train.train_step import layout_tile
        from repro_torch.train.zero import dp_group
        self.arch, self.mesh = arch, mesh
        self.device = resolve_device(device)
        axes = mesh_axes(mesh)
        dp = dp_axes(mesh)
        self.axis = dp if len(dp) > 1 else dp[0]
        self.data = Transport(dp_group(mesh))
        self.n, self.rank = self.data.size, self.data.rank
        self.m = axes.get("model", 1)
        self.model = Transport(mesh.get_group("model")) if self.m > 1 \
            else None
        self.rank_m = 0 if self.model is None else self.model.rank
        self.tp = None if self.model is None else TPGroup(self.model)
        self.tp_sp = None if self.model is None or not seq_parallel else \
            TPGroup(self.model, sp=True)
        self.seg = _serve_seg(hbfp)
        meta = init_params(0, arch, device="meta")
        lay = tp_layout(meta, mesh, layout_tile(self.seg), arch.n_heads,
                        arch.n_kv_heads, ep_only=ep_only)
        self.dims, self.replicated = lay.dims, lay.replicated
        self.attn_sharded = lay.dims.get("layers/attn_wq") is not None
        self._caches = {}

    # -- parameters and batch -------------------------------------------

    def shard_params(self, params):
        """This rank's part of whole (narrow serving) parameters."""
        from repro_torch.sharding.tensor_parallel import shard_params
        if self.model is None:
            return params
        return shard_params(params, self.dims, self.rank_m, self.m)

    def _rows(self, batch_size: int) -> Optional[int]:
        """Rows a data rank takes of a batch of `batch_size` (None: the
        whole batch, where the data axes do not divide it)."""
        if self.n == 1 or batch_size % self.n:
            return None
        return batch_size // self.n

    def local_batch(self, batch):
        """This rank's rows of the global batch, on the dim `batch_specs`
        names (M-RoPE positions [3, B, S] on dim 1)."""
        from repro_torch.sharding.partitioning import batch_specs
        specs = batch_specs(batch, self.mesh)
        out = {}
        for k, v in batch.items():
            d = next((i for i, s in enumerate(specs[k]) if s == self.axis),
                     None)
            if d is None:
                out[k] = v
            else:
                n = v.shape[d] // self.n
                out[k] = v.narrow(d, self.rank * n, n)
        return out

    def data_part(self, batch_size: int):
        """This rank's rows of a global batch as `Ctx.dp`, or None. Where
        the rows cut the MoE groups (a decode tick's few tokens a rank),
        the MoE layer gathers the data ranks' tokens and routes the global
        groups, keeping its rows: the batch and cache stay on the data
        axes as the reference's `batch_specs` and `cache_specs` put them."""
        from repro_torch.sharding.tensor_parallel import DataPart
        rows = self._rows(batch_size)
        return None if rows is None else \
            DataPart(self.rank * rows, batch_size, self.data,
                     gather_groups=True)

    # -- cache --------------------------------------------------------------

    def cache_layout(self, batch_size: int, ctx_len: int):
        """The decode cache's `sharding.partitioning.CacheLayout` for a
        global batch and ring length (from shapes alone)."""
        from repro_torch.models.transformer import init_params, make_cache
        from repro_torch.sharding.partitioning import cache_layout
        key = (batch_size, ctx_len)
        if key not in self._caches:
            meta = init_params(0, self.arch, device="meta")
            whole = make_cache(meta, self.arch, batch_size, ctx_len)
            self._caches[key] = cache_layout(whole, self.mesh,
                                             self.attn_sharded)
        return self._caches[key]

    def make_cache(self, params, batch_size: int, ctx_len: int):
        """This rank's empty part of the decode cache of a global batch:
        its batch rows, and its kv heads or ring slots."""
        from repro_torch.models.transformer import make_cache
        lay = self.cache_layout(batch_size, ctx_len)
        rows = self._rows(batch_size) or batch_size
        return make_cache(params, self.arch, rows, ctx_len, lay.kv_split)

    def decode_cache(self, cache, batch_size: int, ctx_len: int):
        """This rank's part of the decode ring from its prefill cache (its
        batch rows, C = the prompt length S, its kv heads where the
        attention is sharded): the kv heads or ring slots it holds of the
        ring one process would hold (`prefill_to_decode_cache`: max(S,
        ctx_len) slots, prompt token t at slot t, a sliding window's ring
        too), empty slots elsewhere."""
        lay = self.cache_layout(batch_size, ctx_len)
        split = lay.kv_split
        if split is None or self.attn_sharded:
            return prefill_to_decode_cache(cache, self.arch, ctx_len)
        mode, m = split
        r = self.rank_m
        kv = cache["kv"]
        if mode == "heads":
            h = kv.k.shape[2] // m
            cut = lambda t: None if t is None else \
                t.narrow(2, r * h, h).contiguous()
            part = KVCache(cut(kv.k), cut(kv.v), kv.slot_pos, cut(kv.k_exp),
                           cut(kv.v_exp))
            return prefill_to_decode_cache({**cache, "kv": part}, self.arch,
                                           ctx_len)
        S = kv.slot_pos.shape[-1]
        C = max(S, ctx_len)
        if C % m:
            raise ValueError(f"a ring of {C} slots does not split into "
                             f"runs over {m} model ranks")
        c = C // m
        lo, hi = min(S, r * c), min(S, (r + 1) * c)

        def run(t):
            if t is None:
                return None
            shape = list(t.shape)
            shape[3] = c
            out = t.new_zeros(shape)
            if hi > lo:
                out.narrow(3, lo - r * c, hi - lo).copy_(
                    t.narrow(3, lo, hi - lo))
            return out

        part = KVCache(run(kv.k), run(kv.v),
                       F.pad(kv.slot_pos, [0, C - S], value=-1),
                       run(kv.k_exp), run(kv.v_exp))
        return {**cache, "kv": part}

    # -- context ------------------------------------------------------------

    def ctx(self, batch_size: int, ctx_len: Optional[int] = None,
            prefill: bool = False):
        """The serving Ctx of this rank for a global batch: the policy's
        serving segment (narrow weights, no re-quantization), the model
        group (with SP for a prefill when the layout has it), the data
        rows and, for a decode over a ring of `ctx_len`, the cache
        split."""
        seg = ResolvedPolicy(global_cfg=_serve_cfg(self.seg),
                             role_widths=self.seg.role_widths,
                             backend=self.seg.backend)
        tp = self.tp_sp if (prefill and self.tp_sp is not None) else self.tp
        kv = None if ctx_len is None else \
            self.cache_layout(batch_size, ctx_len).kv
        return Ctx(policy=seg, device=self.device, tp=tp,
                   dp=self.data_part(batch_size), kv=kv)
