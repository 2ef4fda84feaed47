"""Data-parallel training with ZeRO-1 (the counterpart of the reference's
jitted step under `master_param_specs`, `opt_state_specs`, `batch_specs`
and its `fwd_constraint` / `grad_constraint` hooks,
`repro/launch/dryrun.py:138-189`).

`ZeroLayout(arch, mesh, device)` is where each leaf lives on a
("data", "model") mesh whose "model" axis is 1:

  * master params and Adam moments: each rank holds the even shard of
    the dim `master_param_specs` picks (the largest dim the DP size
    divides; a leaf with none stays replicated);
  * batch: each rank takes its slice of the global batch along the dim
    `batch_specs` names;
  * the narrow compute copy: each rank narrows its shard and the ranks
    all-gather the narrow (bf16) copy, which equals the one-process
    narrowing bit for bit wherever the shard boundary leaves the
    exponent groups (square weight tiles on the trailing dims) whole;
  * gradients: mean-reduced into the ZeRO layout (a reduce-scatter in
    the gradients' dtype, the mean in f32);
  * clipping: by the global norm, one all-reduce of the shards' sums of
    squares (a replicated leaf counted once);
  * the update: AdamW and the wide rounding on the shard.

Where a shard boundary cuts a weight tile (gemma2's D = 2304 over four
ranks is 576, 4.5 tiles of 128), rounding on the shard would put another
exponent on each part of the tile. The reference's GSPMD rounds on the
global tiles, and so does the port: such a leaf is all-gathered in f32,
rounded whole, and each rank keeps its part (the narrowing, and the wide
rounding after the update). No other leaf pays that gather.

Every collective goes through one `launch.transport.Transport` over the
data-parallel group, which records them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.opt_shell import (_weight_cfg, apply_update_,
                                        param_key, quantize_leaf)
from repro_torch.launch.transport import Transport
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import clip_scale, grad_sq_sum, named_leaves
from repro_torch.sharding.partitioning import (batch_specs,
                                               master_param_specs, mesh_axes)

SLICE_18 = ("ROADMAP slice 18 (tensor, expert and sequence parallelism "
            "with tile-aligned shards; telemetry and stochastic keys under "
            "DP)")


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
    """The dim a spec shards over the data-parallel `axis`, or None (the
    "model" entries of a model-1 mesh shard nothing)."""
    return next((d for d, s in enumerate(spec) if s == axis), None)


class ZeroLayout:
    """ZeRO-1 placement of an arch's training state on a data-parallel
    mesh (a DeviceMesh with "model" of size 1), and the collectives that
    move between the layouts."""

    def __init__(self, arch: ArchConfig, mesh, device):
        axes = mesh_axes(mesh)
        if axes.get("model", 1) > 1 or "pod" in axes:
            raise NotImplementedError(
                f"a mesh {axes}: tensor parallelism and the pod axis are "
                f"{SLICE_18}")
        self.mesh = mesh
        self.device = device
        self.axis = "data"
        self.transport = Transport(mesh.get_group("data"))
        self.n = self.transport.size
        self.rank = self.transport.rank
        full = init_params(0, arch, device="meta")
        specs = dict(named_leaves(master_param_specs(full, mesh)))
        self.shapes = {n: tuple(t.shape) for n, t in named_leaves(full)}
        self.dims = {n: _dim_of(sp, self.axis) for n, sp in specs.items()}

    # -- placement ---------------------------------------------------------

    def part(self, name: str, t: torch.Tensor, dim: Optional[int] = None):
        """This rank's even part of the full leaf `t` along its shard dim
        (`dim`, default the leaf's own; a replicated leaf whole)."""
        d = self.dims[name] if dim is None else dim
        if d is None:
            return t
        n = t.shape[d] // self.n
        return t.narrow(d, self.rank * n, n)

    def shard(self, tree):
        """A full tree (master-param or moment layout) as this rank's f32
        shards on the layout's device."""
        return _unflatten({n: self.part(n, t).to(self.device, torch.float32,
                                                 copy=True)
                           for n, t in named_leaves(tree)})

    def gather(self, tree):
        """The full tree of a shard tree as host numpy arrays (f32) on
        rank 0, gathered leaf by leaf; None on the other ranks."""
        out = {}
        for n, t in named_leaves(tree):
            d = self.dims[n]
            full = t.detach().to("cpu", copy=True) if d is None else \
                self.transport.gather_to_host(t, d)
            if self.rank == 0:
                out[n] = full.to(torch.float32).numpy()
        return _unflatten(out) if self.rank == 0 else None

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
        if self.rank:
            return None
        return type(state)(params=parts[0],
                           opt=type(opt)(step=opt.step, mu=parts[1],
                                         nu=parts[2]),
                           step=state.step)

    def whole_tiles(self, name: str, c) -> bool:
        """True when the shard boundary of leaf `name` cuts none of the
        square weight tiles of config `c` (they lie on the two trailing
        dims; a tile of None spans its whole dim)."""
        d, shape = self.dims[name], self.shapes[name]
        if d is None or d < len(shape) - 2:
            return True
        return c.tile is not None and (shape[d] // self.n) % c.tile == 0

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

    # -- the step ------------------------------------------------------------

    def narrow_copy(self, master, cfg, dtype: torch.dtype):
        """The compute copy of the master shards (`_narrow_copy`'s layout:
        "layers" a list of per-layer dicts of fresh autograd leaves),
        narrowed on the shards and all-gathered, or gathered first where
        the shard boundary cuts a tile."""
        full = {}
        for n, t in named_leaves(master):
            c = _weight_cfg(cfg, n, t)
            d = self.dims[n]
            cast = dtype if t.ndim >= 2 else t.dtype
            if c is not None and not self.whole_tiles(n, c):
                w = self.transport.all_gather_dim(t, d)
                w = quantize_leaf(w, c, False).to(cast)
            else:
                w = t if c is None else quantize_leaf(t, c, False)
                w = w.to(cast, copy=w is t)
                if d is not None:
                    w = self.transport.all_gather_dim(w, d)
            full[n] = w
        out = {}
        for k, v in _unflatten(full).items():
            if k == "layers":
                L = next(iter(v.values())).shape[0]
                out[k] = [{n: t[i].detach().requires_grad_()
                           for n, t in v.items()} for i in range(L)]
            else:
                out[k] = v.requires_grad_()
        return out

    def reduce_grads(self, grads):
        """The mean over ranks of each full local gradient as this rank's
        ZeRO shard (a replicated leaf whole), in f32. The sum runs in the
        gradient's dtype (bf16 for a bf16 model), as the reference's
        all-reduce of its bf16 gradients; the division in f32."""
        out = {}
        for n, g in named_leaves(grads):
            d = self.dims[n]
            s = self.transport.all_reduce_(g.clone()) if d is None \
                else self.transport.reduce_scatter(g.clone(), d)
            out[n] = s.to(torch.float32).div_(self.n)
        return _unflatten(out)

    def clip_(self, grads, grad_clip: float) -> None:
        """Scale the gradient shards in place by the global-norm clip
        factor (`optim.adamw.clip_scale`): this rank's sum of squares,
        replicated leaves on rank 0 only, completed by one all-reduce."""
        names = [n for n, _ in named_leaves(grads)
                 if self.rank == 0 or self.dims[n] is not None]
        g_leaves = dict(named_leaves(grads))
        total = grad_sq_sum(g_leaves, names) + torch.zeros(
            (1,), dtype=torch.float32, device=self.device)
        scale = clip_scale(self.transport.all_reduce_(total).reshape(()),
                           grad_clip)
        for g in g_leaves.values():
            g.mul_(scale)

    def apply_update(self, name, leaf, index, update, cfg, key=None):
        """`opt_shell.apply_update_` on a shard; where the shard cuts a
        tile, p + u is gathered, rounded whole and this rank keeps its
        part."""
        c = _weight_cfg(cfg, name, leaf)
        if c is None or self.whole_tiles(name, c):
            apply_update_(name, leaf, index, update, cfg, key)
            return
        p = leaf if index is None else leaf[index]
        d = self.dims[name] - (0 if index is None else 1)
        new = (p.to(torch.float32) + update.to(torch.float32)).to(p.dtype)
        w = self.transport.all_gather_dim(new, d)
        w = quantize_leaf(w, c, True, param_key(key, name, c, index))
        p.copy_(self.part(name, w, d))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of a scalar (the loss: equal token counts
        per rank make the mean of rank means the global mean)."""
        t = x.detach().to(torch.float32).reshape(1).clone()
        return self.transport.all_reduce_(t).reshape(()) / self.n


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

