"""Data-parallel training with ZeRO-1 and tensor parallelism (the
counterpart of the reference's jitted step under `fwd_param_specs`,
`master_param_specs`, `opt_state_specs`, `batch_specs` and its
`fwd_constraint` / `grad_constraint` / `act_constraint` hooks,
`repro/launch/dryrun.py:138-189`).

`ZeroLayout(arch, mesh, device, tile=, seq_parallel=)` is where each leaf
lives on a ("data", "model") mesh:

  * the "model" axis: the tile-aligned layout of
    `sharding.tensor_parallel.tp_layout` (the reference's
    `fwd_param_specs`, with a leaf whose shard would cut a `tile`-edge
    weight tile, or whose group cannot shard whole, kept replicated);
    each model rank holds its part of the narrow compute copy, and the
    model runs on it through `Ctx.tp` (`self.tp`, a `TPGroup`);
  * master params and Adam moments: the model part, then each data rank
    the even shard of the dim `master_param_specs` picks over "data"
    (the largest dim the DP size divides; a leaf with none stays
    replicated over "data");
  * batch: each data rank takes its slice of the global batch along the
    dim `batch_specs` names; the model ranks take the same slice;
  * the narrow compute copy: each rank narrows its shard and the data
    ranks all-gather the narrow (bf16) copy, which equals the one-process
    narrowing's model part bit for bit wherever the shard boundaries
    leave the exponent groups (square weight tiles on the trailing dims)
    whole;
  * gradients: mean-reduced over "data" into the ZeRO layout (a
    reduce-scatter in the gradients' dtype, the mean in f32); under
    sequence parallelism the norm scales of the sequence-sharded
    residual stream (`tensor_parallel.SP_PARTIAL`) hold partial sums over
    the local tokens and are first summed over "model" in f32;
  * clipping: by the global norm, one all-reduce over each axis of the
    shards' sums of squares (a part replicated over an axis counted
    once);
  * the update: AdamW and the wide rounding on the shard.

Where a shard boundary cuts a weight tile (gemma2's D = 2304 over four
data ranks is 576, 4.5 tiles of 128), rounding on the shard would put
another exponent on each part of the tile. The reference's GSPMD rounds
on the global tiles, and so does the port: such a leaf is all-gathered
over the cutting axis in f32, rounded whole, and each rank keeps its part
(the narrowing, and the wide rounding after the update). No other leaf
pays that gather.

The "pod" axis (a ("pod", "data", "model") mesh) is more data
parallelism, as in the reference: the batch, the master and the moments
lie on the flattened ("pod", "data") group, pod-major (the rank order of
the reference's `P(("pod", "data"))`). Its transport runs over one
`dist.new_group` per model index, made alike on every rank, rather than
`DeviceMesh._flatten`: a public call whose rank order is written out.

Stochastic rounding: each shard is keyed and drawn as its part of the
whole leaf (`leaf_base`, an `IndexBase`; a stacked leaf's layer slices by
their global index), the narrowing and the wide rounding alike, so the
narrow copy and the master equal one process's parts bit for bit; a leaf
gathered over a cutting axis is whole along it. `data_part` gives the
model's `Ctx.dp`: this rank's rows of the global batch, on which every
product's operands draw one process's numbers.

Every collective goes through the `launch.transport.Transport` of its
axis (`transport` over the data axes, `model` over "model"), which
records them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import bfp
from repro_torch.core.opt_shell import (_weight_cfg, apply_update_,
                                        param_key, quantize_leaf,
                                        slice_base)
from repro_torch.kernels.common import IndexBase, fold_in
from repro_torch.launch.transport import Transport
from repro_torch.models.transformer import init_params
from repro_torch.numerics.stats import StatsAccumulator
from repro_torch.optim.adamw import clip_scale, grad_sq_sum, named_leaves
from repro_torch.sharding.partitioning import (batch_specs, dp_axes,
                                               master_param_specs, mesh_axes)
from repro_torch.sharding.tensor_parallel import (SP_PARTIAL, DataPart,
                                                  TPGroup, tp_layout)


def _unflatten(flat: dict):
    """{"a/b": leaf} -> nested dicts."""
    out = {}
    for name, leaf in flat.items():
        *head, last = name.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = leaf
    return out


def _dim_of(spec, axis):
    """The dim a spec shards over `axis`, or None."""
    return next((d for d, s in enumerate(spec) if s == axis), None)


def dp_group(mesh):
    """The process group of this rank's data-parallel axes: "data", or
    under a "pod" axis the flattened ("pod", "data") ranks of its model
    index, pod-major. Every rank makes every such group, in one order (as
    `dist.new_group` needs)."""
    if "pod" not in mesh_axes(mesh):
        return mesh.get_group("data")
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    # [pod, data, model] global ranks, read on the host (outside the dry
    # run's fake-tensor mode, which would fake them)
    with unset_fake_temporarily():
        ranks = mesh.mesh.tolist()
    me = dist.get_rank()
    mine = None
    for m in range(len(ranks[0][0])):
        members = [r[m] for pod in ranks for r in pod]
        g = dist.new_group(members)
        if me in members:
            mine = g
    return mine


def sp_partial(name: str) -> bool:
    """Whether a leaf takes partial gradients under sequence parallelism:
    a norm scale of the sequence-sharded residual stream."""
    return name.rsplit("/", 1)[-1] in SP_PARTIAL


class ZeroLayout:
    """ZeRO-1 placement of an arch's training state on a ("data",
    "model") or ("pod", "data", "model") mesh (a DeviceMesh), the model
    axis on the tile-aligned tensor-parallel layout for weight tiles of
    edge `tile`, and the collectives that move between the layouts."""

    def __init__(self, arch: ArchConfig, mesh, device, tile: Optional[int]
                 = 128, seq_parallel: bool = False):
        axes = mesh_axes(mesh)
        self.mesh = mesh
        self.device = device
        dp = dp_axes(mesh)
        # the spec entry of the data axes (`master_param_specs`)
        self.axis = dp if len(dp) > 1 else dp[0]
        self.transport = Transport(dp_group(mesh))
        self.n = self.transport.size
        self.rank = self.transport.rank
        m = axes.get("model", 1)
        self.model = Transport(mesh.get_group("model")) if m > 1 else None
        self.m = m
        self.rank_m = 0 if self.model is None else self.model.rank
        self.sp = bool(seq_parallel) and m > 1
        self.tp = None if m == 1 else TPGroup(self.model, self.sp)
        full = init_params(0, arch, device="meta")
        specs = dict(named_leaves(master_param_specs(full, mesh)))
        self.shapes = {n: tuple(t.shape) for n, t in named_leaves(full)}
        # a data axis of one rank shards nothing and moves nothing
        self.dims = {n: None if self.n == 1 else _dim_of(sp, self.axis)
                     for n, sp in specs.items()}
        lay = tp_layout(full, mesh, tile, arch.n_heads, arch.n_kv_heads)
        self.replicated = lay.replicated
        # the model dim of each leaf, counted from its front (None: whole)
        self.tp_dims = {n: None if d is None else len(self.shapes[n]) + d
                        for n, d in lay.dims.items()}

    # -- placement ---------------------------------------------------------

    def _axes(self, name: str, shift: int = 0):
        """(dim, transport, group size, rank) of each axis that shards leaf
        `name` ("model" first), dims shifted by `shift` (-1: a layer slice
        of a stacked leaf)."""
        out = []
        d = self.tp_dims[name]
        if d is not None:
            out.append((d + shift, self.model, self.m, self.rank_m))
        d = self.dims[name]
        if d is not None:
            out.append((d + shift, self.transport, self.n, self.rank))
        return out

    def part(self, name: str, t: torch.Tensor, shift: int = 0):
        """This rank's part of the full leaf `t` (or of a layer slice,
        `shift` -1): its model part, then its data shard."""
        for d, _, n, r in self._axes(name, shift):
            k = t.shape[d] // n
            t = t.narrow(d, r * k, k)
        return t

    def shard(self, tree):
        """A full tree (master-param or moment layout) as this rank's f32
        shards on the layout's device."""
        return _unflatten({n: self.part(n, t).to(self.device, torch.float32,
                                                 copy=True)
                           for n, t in named_leaves(tree)})

    @property
    def is_root(self) -> bool:
        """Global rank 0: the rank that writes checkpoints."""
        return self.rank == 0 and self.rank_m == 0

    def gather(self, tree):
        """The full tree of a shard tree as host numpy arrays (f32) on
        rank 0, gathered leaf by leaf over "data" and then, among the
        data-rank-0 ranks, over "model"; None on the other ranks."""
        out = {}
        for n, t in named_leaves(tree):
            d = self.dims[n]
            full = t.detach().to("cpu", copy=True) if d is None else \
                self.transport.gather_to_host(t, d)
            if self.rank != 0:
                continue
            if self.tp_dims[n] is not None:
                if self.model.backend == "nccl":
                    full = full.to(self.device)
                full = self.model.gather_to_host(full, self.tp_dims[n])
            if self.is_root:
                out[n] = full.to(torch.float32).numpy()
        return _unflatten(out) if self.is_root else None

    def shard_state(self, state):
        """A whole TrainState (a loaded checkpoint, on any device) as this
        rank's: master params and moments sharded."""
        opt = state.opt
        return type(state)(params=self.shard(state.params),
                           opt=type(opt)(step=opt.step, mu=self.shard(opt.mu),
                                         nu=self.shard(opt.nu)),
                           step=state.step)

    def gather_state(self, state):
        """The whole TrainState on rank 0's host (numpy leaves); None on
        the other ranks."""
        opt = state.opt
        parts = [self.gather(t) for t in (state.params, opt.mu, opt.nu)]
        if not self.is_root:
            return None
        return type(state)(params=parts[0],
                           opt=type(opt)(step=opt.step, mu=parts[1],
                                         nu=parts[2]),
                           step=state.step)

    def _cut(self, name: str, c, shift: int = 0):
        """The axes (as `_axes` gives them) whose shard boundary cuts the
        square weight tiles of config `c` (they lie on the two trailing
        dims; a tile of None spans its whole dim)."""
        shape = self.shapes[name]
        nd = len(shape)
        cut = []
        for d, tr, n, r in self._axes(name):
            if d < nd - 2:
                continue
            if c.tile is None or (shape[d] // n) % c.tile:
                cut.append((d + shift, tr, n, r))
        return cut

    def whole_tiles(self, name: str, c) -> bool:
        """True when no shard boundary of leaf `name` cuts a square weight
        tile of config `c`."""
        return not self._cut(name, c)

    def local_batch(self, batch, grad_accum: int = 1):
        """This rank's slice of the global batch (leaves [A, ...] with
        grad_accum > 1): the dim `batch_specs` names, or the whole leaf
        where the DP size does not divide the batch."""
        lead = 1 if grad_accum > 1 else 0
        micro = {k: v[0] if lead else v for k, v in batch.items()}
        specs = batch_specs(micro, self.mesh)
        out = {}
        for k, v in batch.items():
            d = _dim_of(specs[k], self.axis)
            if d is None:
                out[k] = v
            else:
                n = micro[k].shape[d] // self.n
                out[k] = v.narrow(d + lead, self.rank * n, n)
        return out

    def data_part(self, batch, grad_accum: int = 1):
        """This rank's rows of the global batch (of each microbatch, with
        grad_accum > 1) as the model's `Ctx.dp` (`DataPart`), or None
        when the data axes hold one rank or every rank takes the whole
        batch (a batch the DP size does not divide)."""
        labels = batch["labels"]
        micro = labels[0] if grad_accum > 1 else labels
        if self.n == 1 or _dim_of(batch_specs({"labels": micro}, self.mesh)
                                  ["labels"], self.axis) is None:
            return None
        rows = micro.shape[0] // self.n
        return DataPart(self.rank * rows, micro.shape[0], self.transport)

    def leaf_base(self, name: str, gathered=()) -> IndexBase:
        """This rank's part of the whole leaf `name` as an `IndexBase`:
        the offset of each axis that shards it, but along the dims in
        `gathered` (gathered whole over a cutting axis first)."""
        full = self.shapes[name]
        off = [0] * len(full)
        for d, _, n, r in self._axes(name):
            if d not in gathered:
                off[d] = r * (full[d] // n)
        return IndexBase(full, tuple(off))

    # -- the step ------------------------------------------------------------

    def _reduce_stats(self, acc: StatsAccumulator, axes) -> None:
        for _, tr, n, _ in axes:
            if n > 1:
                acc.reduce_(tr)

    def _narrow(self, n: str, w: torch.Tensor, c, key, acc, gathered):
        """One leaf part narrowed at config `c` on its one-process stream
        of the narrowing `key` (through B7 into `acc` when given, a layer
        slice at a time as `train_step._narrow_leaf` does)."""
        base = self.leaf_base(n, gathered)
        for a in gathered:          # gathered whole: no offset to carry
            assert w.shape[a] == base.shape[a] and base.offset[a] == 0
        k = param_key(key, n, c)
        if acc is None:
            return quantize_leaf(w, c, False, k, base)
        tile = lambda t: bfp.weight_tile_shape(t.ndim, c.tile)
        if w.ndim < 3:
            return acc.add(w, c.mantissa_bits, tile(w), key=k, base=base)
        out = torch.empty_like(w)
        for i in range(w.shape[0]):
            gi, b = slice_base(base, i)
            out[i] = acc.add(w[i], c.mantissa_bits, tile(w[i]),
                             key=None if k is None else fold_in(k, gi),
                             base=b)
        return out

    def narrow_copy(self, master, cfg, dtype: torch.dtype, stats=None,
                    key: Optional[int] = None):
        """The compute copy of the master shards (`_narrow_copy`'s layout:
        "layers" a list of per-layer dicts of fresh autograd leaves; each
        model-sharded tensor carries its `tp_dim`, counted from the end):
        narrowed on the shards and all-gathered over the data axes, or
        gathered over a cutting axis first. With a `stats` dict every BFP
        weight is narrowed through B7 and the `TensorStats` of the whole
        leaf (its parts' raw sums reduced over the ranks) lands in
        stats[name]. `key` (an int) rounds stochastically: each shard on
        its part of the whole leaf's stream."""
        full = {}
        for n, t in named_leaves(master):
            c = _weight_cfg(cfg, n, t)
            d = self.dims[n]
            cast = dtype if t.ndim >= 2 else t.dtype
            acc = None if stats is None or c is None else \
                StatsAccumulator(t.device)
            cut = [] if c is None else self._cut(n, c)
            w = t
            for a, tr, _, _ in cut:
                w = tr.all_gather_dim(w, a)
            if c is not None:
                w = self._narrow(n, w, c, key, acc, [a for a, *_ in cut])
            w = w.to(cast, copy=w is t)
            if acc is not None:
                self._reduce_stats(acc, [x for x in self._axes(n)
                                         if x[0] not in [y[0] for y in cut]])
                stats[n] = acc.finish()
            for a, tr, k, r in cut:
                if tr is self.model:
                    w = w.narrow(a, r * (w.shape[a] // k), w.shape[a] // k)
            if d is not None and not any(tr is self.transport
                                         for _, tr, _, _ in cut):
                w = self.transport.all_gather_dim(w, d)
            full[n] = w
        out = {}
        for k, v in _unflatten(full).items():
            if k == "layers":
                L = next(iter(v.values())).shape[0]
                out[k] = [{n: self._leaf(f"layers/{n}", t[i])
                           for n, t in v.items()} for i in range(L)]
            else:
                out[k] = self._leaf(k, v)
        return out

    def _leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A fresh autograd leaf of the compute copy, tagged with its
        model dim counted from the end (`ctx_matmul` reads it)."""
        t = t.detach().requires_grad_()
        d = self.tp_dims[name]
        if d is not None:
            t.tp_dim = d - len(self.shapes[name])
        return t

    def reduce_grads(self, grads):
        """The mean over the data ranks of each local gradient as this
        rank's ZeRO shard (a leaf replicated over "data" whole), in f32.
        The sum runs in the gradient's dtype (bf16 for a bf16 model), as
        the reference's all-reduce of its bf16 gradients; the division in
        f32. Under sequence parallelism a partial leaf is first summed over
        "model" in f32."""
        out = {}
        for n, g in named_leaves(grads):
            if self.sp and self.tp_dims[n] is None and sp_partial(n):
                g = self.model.all_reduce_(g.to(torch.float32, copy=True))
            d = self.dims[n]
            if self.n == 1:
                s = g
            elif d is None:
                s = self.transport.all_reduce_(g.clone())
            else:
                s = self.transport.reduce_scatter(g.clone(), d)
            out[n] = s.to(torch.float32, copy=True).div_(self.n)
        return _unflatten(out)

    def clip_(self, grads, grad_clip: float) -> None:
        """Scale the gradient shards in place by the global-norm clip
        factor (`optim.adamw.clip_scale`): this rank's sum of squares, a
        part replicated over an axis counted on that axis's rank 0 only,
        completed by one all-reduce over each axis."""
        names = [n for n, _ in named_leaves(grads)
                 if (self.rank == 0 or self.dims[n] is not None)
                 and (self.rank_m == 0 or self.tp_dims[n] is not None)]
        g_leaves = dict(named_leaves(grads))
        total = grad_sq_sum(g_leaves, names) + torch.zeros(
            (1,), dtype=torch.float32, device=self.device)
        if self.n > 1:
            total = self.transport.all_reduce_(total)
        if self.model is not None:
            total = self.model.all_reduce_(total)
        scale = clip_scale(total.reshape(()), grad_clip)
        for g in g_leaves.values():
            g.mul_(scale)

    def apply_update(self, name, leaf, index, update, cfg, key=None):
        """`opt_shell.apply_update_` on a shard, keyed and drawn as its
        part of the whole leaf; where the shard cuts a tile, p + u is
        gathered over the cutting axes, rounded whole along them and this
        rank keeps its part."""
        c = _weight_cfg(cfg, name, leaf)
        if c is None or self.whole_tiles(name, c):
            apply_update_(name, leaf, index, update, cfg, key,
                          self.leaf_base(name))
            return
        p = leaf if index is None else leaf[index]
        shift = 0 if index is None else -1
        cut = self._cut(name, c, shift)
        w = (p.to(torch.float32) + update.to(torch.float32)).to(p.dtype)
        for a, tr, _, _ in cut:
            w = tr.all_gather_dim(w, a)
        gi, base = slice_base(self.leaf_base(name, [a - shift for a, *_ in
                                                     cut]), index)
        for a, *_ in cut:           # gathered whole: no offset to carry
            assert w.shape[a] == base.shape[a] and base.offset[a] == 0
        w = quantize_leaf(w, c, True, param_key(key, name, c, gi), base)
        for a, _, k, r in cut:
            w = w.narrow(a, r * (w.shape[a] // k), w.shape[a] // k)
        p.copy_(w)

    def grad_tap(self, name: str, g: torch.Tensor, c):
        """The `TensorStats` of the whole reduced gradient of `name` at
        config `c` from this rank's part: gathered over a cutting axis,
        the raw sums reduced over the others."""
        cut = self._cut(name, c)
        for a, tr, _, _ in cut:
            g = tr.all_gather_dim(g, a)
        acc = StatsAccumulator(g.device)
        acc.add(g, c.mantissa_bits, bfp.weight_tile_shape(g.ndim, c.tile),
                want_q=False)
        self._reduce_stats(acc, [x for x in self._axes(name)
                                 if x[0] not in [y[0] for y in cut]])
        return acc.finish()

    def act_reduce(self, acc: StatsAccumulator) -> None:
        """Sum an activation tap's raw stats over the ranks that hold other
        tokens: the data ranks, and the model ranks under sequence
        parallelism (a replica counts once)."""
        if self.n > 1:
            acc.reduce_(self.transport)
        if self.sp:
            acc.reduce_(self.model)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data ranks of a scalar (the loss: equal token
        counts per rank make the mean of rank means the global mean; the
        model ranks hold the same loss)."""
        t = x.detach().to(torch.float32).reshape(1).clone()
        if self.n == 1:
            return t.reshape(())
        return self.transport.all_reduce_(t).reshape(()) / self.n

    def barrier(self) -> None:
        """Every rank of the mesh."""
        dist.barrier()


def host_like(state):
    """A tree like `state` whose tensors are empty CPU tensors of the same
    dtype: the `like` that loads a whole checkpoint onto the host."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return torch.empty(0, dtype=t.dtype)
        return t

    return type(state)(params=conv(state.params),
                       opt=type(state.opt)(step=state.opt.step,
                                           mu=conv(state.opt.mu),
                                           nu=conv(state.opt.nu)),
                       step=state.step)

