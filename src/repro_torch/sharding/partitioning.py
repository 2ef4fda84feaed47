"""Logical-axis sharding rules → per-dimension specs (port of
`repro.sharding.partitioning`: DP / TP / EP / SP / ZeRO-1).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
  * batch             → (pod, data)                     [DP]
  * attention heads, FFN hidden, experts, vocab → model [TP / EP]
  * contraction-side weight dims (wo, ffn_wo)   → model [TP row-parallel]
  * master params + Adam moments: additionally sharded over (pod, data) on
    the largest still-replicated dim                    [ZeRO-1]
  * decode KV caches: batch → data, kv-heads → model when divisible,
    else sequence → model (SP, flash-decoding style)    [SP]

Rules are name-based over the port's parameter, optimizer-state, batch
and cache trees (nested dicts, NamedTuples and tuples of tensors, named
as the reference's pytree paths), with the reference's divisibility
guards: a dim is only sharded if the axis size divides it. A spec is a
`Spec`, a tuple with one entry per leading dimension (None, an axis name
or a tuple of axis names), equal element for element to the reference's
`PartitionSpec`. A mesh is anything with `.shape` (a dict of axis sizes)
and `.axis_names`, or a `torch.distributed.device_mesh.DeviceMesh`; the
functions read only its axis names and sizes. `to_shardings` turns specs
into `torch.distributed.tensor` placements on a `DeviceMesh`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional


class Spec(tuple):
    """Per-dimension sharding: Spec(None, "model") shards dim 1 over
    "model"; trailing dims past its length are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a duck-typed mesh or a torch DeviceMesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _axsize(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    axes = mesh_axes(mesh)
    return int(math.prod(axes[n] for n in names))


def _map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a tree of dicts, NamedTuples, tuples and lists
    (None stays None), the path the reference's pytree keys: dict keys,
    NamedTuple field names, sequence indices."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(path).lower()


# name fragment -> (shard_dim_from_end, axis) for 2D weights;
# dims counted from the END so stacked [L, ...] params work unchanged.
_RULES = (
    # attention: column-parallel qkv, row-parallel out
    ("attn_wq", -1), ("attn_wk", -1), ("attn_wv", -1), ("attn_wo", -2),
    # dense FFN: column-parallel in/gate, row-parallel out
    ("ffn_wg", -1), ("ffn_wi", -1), ("ffn_wo", -2),
    ("shared_wg", -1), ("shared_wi", -1), ("shared_wo", -2),
    # lm head: vocab-parallel
    ("head_w", -1),
    # embeddings: vocab-parallel (gather over sharded vocab)
    ("embed_table", -2),
    # ssm / xlstm projections: column-parallel in, row-parallel out
    ("ssm_in_w", -1), ("ssm_out_w", -2),
    ("mlstm_up_w", -1), ("mlstm_qkv_w", -1), ("mlstm_down_w", -2),
    ("slstm_in_w", -1), ("slstm_out_w", -2),
)

# expert-parallel: shard the expert dim (dim 0 of the un-stacked [E,.,.])
_EP_RULES = ("moe_wg", "moe_wi", "moe_wo")


def _spec_for(name: str, leaf, mesh) -> Spec:
    msize = mesh_axes(mesh)["model"]
    nd = leaf.ndim
    for frag in _EP_RULES:
        if frag in name:
            # stacked: [L, E, a, b] -> expert dim is -3
            dim = nd - 3
            if leaf.shape[dim] % msize == 0:
                spec = [None] * nd
                spec[dim] = "model"
                return Spec(*spec)
            return Spec()
    for frag, dim in _RULES:
        if frag in name:
            d = nd + dim
            if d >= 0 and leaf.shape[d] % msize == 0:
                spec = [None] * nd
                spec[d] = "model"
                return Spec(*spec)
            return Spec()
    return Spec()  # norms, biases, routers, gates: replicated


def fwd_param_specs(params, mesh, ep_only: bool = False):
    """TP/EP specs of the narrow compute copy used in fwd/bwd.

    ep_only: MoE-serving layout — ONLY expert weights shard (over model);
    all dense/attention weights replicate, so no row-parallel activation
    all-reduces remain.
    """
    def spec(path, leaf):
        name = _path_str(path)
        if ep_only and not any(f in name for f in _EP_RULES):
            return Spec()
        return _spec_for(name, leaf, mesh)

    return _map_with_path(spec, params)


def master_param_specs(params, mesh, zero1: bool = True):
    """Master (wide-BFP) params: TP/EP plus ZeRO-1 over the DP axes on the
    largest still-replicated dim (divisibility-guarded)."""
    dp = dp_axes(mesh)
    dsize = _axsize(mesh, dp)

    def one(path, leaf):
        spec = list(_spec_for(_path_str(path), leaf, mesh))
        spec += [None] * (leaf.ndim - len(spec))
        if zero1:
            free = [(leaf.shape[i], i) for i in range(leaf.ndim)
                    if spec[i] is None and leaf.shape[i] % dsize == 0]
            if free:
                _, i = max(free)
                spec[i] = dp if len(dp) > 1 else dp[0]
        return Spec(*spec)

    return _map_with_path(one, params)


def opt_state_specs(opt_state, params, mesh, zero1: bool = True):
    """Adam moments follow the master-param layout; the step counter is
    replicated."""
    mspecs = master_param_specs(params, mesh, zero1)
    return type(opt_state)(step=Spec(), mu=mspecs, nu=mspecs)


def batch_specs(batch, mesh):
    """Shard the batch dim over DP axes. mrope positions [3,B,S] put batch
    at dim 1."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    dsize = _axsize(mesh, dp)

    def one(path, leaf):
        name = _path_str(path)
        bdim = 1 if name.endswith("positions") and leaf.ndim == 3 \
            and leaf.shape[0] == 3 else 0
        if leaf.shape[bdim] % dsize != 0:
            return Spec()
        spec = [None] * leaf.ndim
        spec[bdim] = dpa
        return Spec(*spec)

    return _map_with_path(one, batch)


def cache_specs(cache, mesh, seq_shard: bool = False):
    """Decode-cache specs. Stacked leaves are [L, B, ...]:
    batch → DP when divisible; kv-heads (dim 2 of KVCache.k/v) → model when
    divisible; else, optionally, cache sequence dim → model (SP)."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    dsize = _axsize(mesh, dp)
    msize = mesh_axes(mesh)["model"]

    def one(path, leaf):
        name = _path_str(path)
        spec = [None] * leaf.ndim
        if leaf.ndim >= 2 and leaf.shape[1] % dsize == 0:
            spec[1] = dpa                      # batch
        if "kv/k" in name or "kv/v" in name or name.endswith("/k") \
                or name.endswith("/v"):
            # [L, B, Hkv, C, hd]
            if leaf.shape[2] % msize == 0:
                spec[2] = "model"
            elif seq_shard and leaf.shape[3] % msize == 0:
                spec[3] = "model"              # SP over cache length
        elif "ssm" in name and leaf.ndim >= 4:
            # [L, B, H, P, N]: shard head-dim product if divisible
            if leaf.shape[2] % msize == 0:
                spec[2] = "model"
            elif leaf.shape[3] % msize == 0:
                spec[3] = "model"
        elif "mlstm" in name and leaf.ndim >= 3:
            if leaf.shape[2] % msize == 0:
                spec[2] = "model"
        return Spec(*spec)

    return _map_with_path(one, cache)


class CacheLayout(NamedTuple):
    """How a rank holds a decode cache on a mesh (`cache_layout`): `kv`
    the split of the kv leaves over "model" that the attention must know
    (`Ctx.kv`: None, "heads" or "seq"), `specs` {leaf path: the `Spec` of
    the stacked leaf as the port holds it}, `replicated` {leaf path: why
    a leaf that `cache_specs` shards over "model" stays whole}."""
    kv: Optional[str]
    specs: dict
    replicated: dict
    model: int = 1

    @property
    def kv_split(self):
        """(mode, model size) of k and v for `models.make_cache`, or
        None where they are whole over "model"."""
        spec = self.specs.get("kv/k", ())
        if "model" not in spec:
            return None
        return ("heads" if spec.index("model") == 2 else "seq"), self.model


def _flat_specs(specs, path=()):
    if isinstance(specs, Spec):
        return {"/".join(path): specs}
    out = {}
    if specs is None:
        return out
    if isinstance(specs, dict):
        items = [(str(k), v) for k, v in specs.items()]
    elif hasattr(specs, "_fields"):
        items = [(f, getattr(specs, f)) for f in specs._fields]
    else:
        items = [(str(i), v) for i, v in enumerate(specs)]
    for k, v in items:
        out.update(_flat_specs(v, path + (k,)))
    return out


def cache_layout(cache, mesh, attn_sharded: bool,
                 seq_shard: bool = True) -> CacheLayout:
    """The decode cache's layout on `mesh`, `cache_specs` reconciled with
    the compute layout (`tensor_parallel.tp_layout`): the batch over the
    data axes where they divide it; the kv heads over "model" where
    `cache_specs` shards them (which `attn_sharded` implies: the
    attention's own local heads), else, with `seq_shard`, the ring's
    slots (the flash-decoding layout; slot_pos, which `cache_specs`
    leaves whole over "model", stays whole); the recurrent states whole
    over "model", as their mixers are (`tensor_parallel.CONCATENATED`),
    each listed in `replicated` where `cache_specs` shards it."""
    ref = _flat_specs(cache_specs(cache, mesh, seq_shard))
    specs, why, kv = {}, {}, None
    for name, spec in ref.items():
        spec = list(spec)
        if "model" in spec:
            d = spec.index("model")
            if name.startswith("kv/"):
                if d == 2:
                    kv = kv or ("heads" if not attn_sharded else None)
                else:
                    kv = "seq"
            else:
                spec[d] = None
                why[name] = ("its mixer is replicated: the in-projection "
                             "concatenates several parts")
        specs[name] = Spec(*spec)
    if attn_sharded and kv == "seq":
        raise ValueError("a sharded attention holds its own kv heads; the "
                         "sequence split is for a replicated one")
    return CacheLayout(kv=kv, specs=specs, replicated=why,
                       model=mesh_axes(mesh)["model"])


def to_shardings(specs, mesh):
    """Each spec as `torch.distributed.tensor` placements on `mesh` (a
    DeviceMesh): one per mesh dimension, in its order, `Shard(d)` where
    tensor dim d is sharded over that axis, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names

    def one(spec):
        out = []
        for axis in names:
            dims = [d for d, s in enumerate(spec) if s == axis
                    or (isinstance(s, tuple) and axis in s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def walk(tree):
        if isinstance(tree, Spec):
            return one(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(getattr(tree, f))
                                for f in tree._fields))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(specs)
