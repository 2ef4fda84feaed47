"""HBFP training step (port of `repro.train.train_step`, paper §5.1):

  1. narrow  = Q_narrow(master), cast to the arch dtype (bf16: exact for
     m <= 8), one autograd leaf per weight and per layer;
  2. grads   = ∇ loss(narrow, batch): every dot product in BFP, on the
     sim path or, under backend "pallas", on the B1/B2/B3 kernels;
  3. updates = AdamW(grads) in f32;
  4. master  = Q_wide(master + updates), 16-bit wide weight storage.

`make_step(arch, policy, lr_schedule, controller=, tap=)` is the entry
point: a host dispatcher over step variants, one per distinct (policy
segment ⊕ controller overrides, telemetry), chosen by the step counter.
A telemetry variant (`make_train_step(..., taps=)`) narrows the weights
through the conversion kernel B7 with their stats (the weight tap *is*
the narrowing, bit-identical to the plain one), measures the grads at the
wgrad width and the residual stream, and feeds the controller. Unlike the
reference's functional step, the port updates the state's master params
and moments in place, one layer slice at a time, so the optimizer adds
only one layer's f32 temporaries to the training state.

Data, tensor, sequence and expert parallelism (`mesh=`, a ("data",
"model") or ("pod", "data", "model") DeviceMesh; `seq_parallel=`):
ZeRO-1 over the data axes as the reference lays it out and the
tile-aligned tensor-parallel layout over "model" (`train/zero.py`,
`sharding/tensor_parallel.py`): each rank holds
its shard of its model part of the master params and moments and takes
its data slice of the global batch; the shards are narrowed and the
narrow copy all-gathered over "data", the model runs on each rank's part
(`Ctx.tp`), the gradients are mean-reduced into the shards, clipped by
the global norm and applied on the shards. The state from
`init_train_state(..., mesh=)` holds the shards; the Trainer checkpoints
it whole. Telemetry reduces its raw sums over the ranks that hold other
parts of a tensor (the weight tap on the shards' narrowing, the grad tap
on the reduced gradients, the act taps over the data ranks' and, under
sequence parallelism, the model ranks' tokens), and every rank feeds the
controller rank 0's snapshot. Under stochastic rounding every rank
draws one process's numbers at its parts: the narrowing and the wide
rounding on each shard's part of the whole leaf, every product's
operands at their rows of the global batch (`Ctx.dp`) and their model
block.

Stochastic rounding: the step is `train_step(state, batch, key)` with an
int key (`kernels.common.fold_in`; the Trainer folds its seed with the
step). As the reference, the narrowing draws from
`fold_in(key, 0x5EED)`, the loss's dot products and the wide update from
`key`, each parameter on its `opt_shell.param_fold` stream. Every key is
a host int, so the remat recompute and a resumed run draw what the
first run drew.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import bfp
from repro_torch.core.opt_shell import (_weight_cfg, apply_update_,
                                        param_key, quantize_leaf)
from repro_torch.device import dtype_of, resolve_device
from repro_torch.kernels import autotune
from repro_torch.kernels.common import fold_in
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.numerics.collect import (RingBuffer, TapConfig, grad_stats,
                                          snapshot_event)
from repro_torch.numerics.controller import merge_sources
from repro_torch.numerics.stats import StatsAccumulator, stats_to_host
from repro_torch.obs import NULL_RECORDER
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.precision.policy import (ResolvedPolicy, as_policy,
                                          as_segment)
from repro_torch.train.zero import ZeroLayout


class TrainState(NamedTuple):
    params: Any    # master weights (wide-BFP values in f32 containers)
    opt: OptState
    step: int


def _to_f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_f32_tree(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def layout_tile(policy) -> Optional[int]:
    """The weight-tile edge a mesh layout keeps whole for a precision
    policy (anything `as_policy` takes, or a resolved segment): the
    narrowing tile, the activation block, and on the kernel path the
    kernels' default tile (their exponent groups); 1 for fp32 (nothing
    quantized); None when a tile spans its whole dim."""
    seg = policy if isinstance(policy, ResolvedPolicy) else \
        as_policy(policy).resolve_segment(0)
    cfg = seg.global_cfg
    if cfg is None:
        return 1
    if cfg.tile is None:
        return None
    t = math.lcm(cfg.tile, cfg.act_block or 1)
    if seg.backend == "pallas":
        t = math.lcm(t, autotune.DEFAULT_TILES[1])
    return t


def init_train_state(seed: int, arch: ArchConfig, init_params_fn=init_params,
                     device=None, mesh=None) -> TrainState:
    """Seeded params (`init_params_fn(seed, arch, device=...)`) as f32
    master weights, zero moments, step 0, on `device` (the CUDA device by
    default). Under a `mesh` every rank draws the whole init and keeps
    its shard: pass the step's `.layout` (a `train.zero.ZeroLayout`,
    laid out for its policy's tiles); a bare DeviceMesh is laid out for
    128-tiles."""
    dev = resolve_device(device)
    params = init_params_fn(seed, arch, device=dev)
    if mesh is None:
        params = _to_f32_tree(params)
    else:
        layout = mesh if isinstance(mesh, ZeroLayout) else \
            ZeroLayout(arch, mesh, dev)
        params = layout.shard(params)
    return TrainState(params=params, opt=adamw_init(params), step=0)


def from_jax_train_state(state, device=None) -> TrainState:
    """The reference's TrainState (params, opt=(step, mu, nu), step) with
    numpy leaves, as the port's TrainState on `device`."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, np.float32)).to(dev)

    return TrainState(params=conv(state.params),
                      opt=OptState(step=int(state.opt.step),
                                   mu=conv(state.opt.mu),
                                   nu=conv(state.opt.nu)),
                      step=int(state.step))


def _narrow_leaf(name: str, leaf: torch.Tensor, index, cfg,
                 dtype: torch.dtype, acc=None, key=None) -> torch.Tensor:
    """One leaf (or layer slice) of the compute copy: narrowed at its
    config (through B7 with its stats into `acc` when given) on the
    slice's stream of `key`, cast to the compute dtype when the leaf is a
    matrix (as the reference casts: stacked [L, D] norm scales too), a
    fresh autograd leaf."""
    p = leaf if index is None else leaf[index]
    c = _weight_cfg(cfg, name, leaf)
    if c is not None:
        k = param_key(key, name, c, index)
        p = quantize_leaf(p, c, False, k) if acc is None else acc.add(
            p, c.mantissa_bits, bfp.weight_tile_shape(p.ndim, c.tile),
            key=k)
    return p.to(dtype if leaf.ndim >= 2 else p.dtype,
                copy=True).requires_grad_()


def _narrow_copy(master, cfg, dtype, stats=None, key=None):
    """The compute copy with "layers" as a list of per-layer dicts, so each
    layer's weights get their own gradients. With a `stats` dict, every
    BFP weight is narrowed through B7 and its `TensorStats` (over all its
    layer slices) lands in stats[name]. `key` (an int) rounds the
    stochastic weights, slice i of a stacked leaf on its own stream."""
    accs = {}

    def acc(name, leaf):
        if stats is None or _weight_cfg(cfg, name, leaf) is None:
            return None
        return accs.setdefault(name, StatsAccumulator(leaf.device))

    out = {}
    for k, v in master.items():
        if k == "layers":
            L = next(iter(v.values())).shape[0]
            out[k] = [{n: _narrow_leaf(f"layers/{n}", t, i, cfg, dtype,
                                       acc(f"layers/{n}", t), key)
                       for n, t in v.items()} for i in range(L)]
        else:
            out[k] = _narrow_leaf(k, v, None, cfg, dtype, acc(k, v), key)
    if stats is not None:
        stats.update((n, accs[n].finish()) for n in sorted(accs))
    return out


def _leaves(narrow):
    """(key path, tensor) of the compute copy, layers per layer."""
    for k, v in narrow.items():
        if k == "layers":
            for i, lp in enumerate(v):
                for n, t in lp.items():
                    yield (k, n, i), t
        else:
            yield (k,), v


def _stack_grads(paths, grads: list):
    """Grads of the compute copy's leaves (at `paths`) in the master's
    layout, each stacked [L, ...] weight's layer grads stacked back. The
    list is consumed, so each layer grad is freed once stacked."""
    out, layers = {}, {}
    for path, g in zip(paths, grads):
        if path[0] == "layers":
            layers.setdefault(path[1], []).append(g)
        else:
            out[path[0]] = g
    grads.clear()
    if layers:
        out["layers"] = {n: torch.stack(layers.pop(n)) for n in list(layers)}
    return out


def _grads(loss, leaves):
    """d loss / d leaves; a leaf the loss does not use (the inactive
    branch of an xLSTM layer) gets a zero gradient, as the reference's
    `jnp.where` gives it, so weight decay still moves it."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def make_train_step(arch: ArchConfig, hbfp, schedule, *, grad_accum: int = 1,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    taps=None, device=None, mesh=None,
                    seq_parallel: bool = False):
    """Returns train_step(state, batch, key=None) -> (state, metrics) for
    one static precision segment (None, an HBFPConfig or a
    ResolvedPolicy); a stochastic segment needs an int `key`. With
    grad_accum > 1 the batch leaves are [A, ...] microbatches and the mean
    grads accumulate in f32. `taps` (a `numerics.TapConfig`) makes this
    the telemetry variant: metrics gain "numerics", per-parameter
    `TensorStats` of the weight narrowing ("weights") and the grads at the
    wgrad width ("grads") and the activation taps ("acts"), all through
    B7; the training values are bit-identical to taps=None.
    `train_step.grads(state, batch, key=None)` -> (loss, metrics, grads)
    runs steps 1 and 2 alone and returns the grads in the master's
    layout. Under a `mesh` (or the `train.zero.ZeroLayout` built over
    one; `.layout`) the state holds each rank's shards, the batch is the
    global one, metrics["loss"] is the global mean and `grads` returns
    this rank's unreduced grads of its batch slice and model part;
    `seq_parallel` shards the residual stream over the sequence on
    "model" (the counterpart of the reference's `act_constraint`)."""
    dev = resolve_device(device)
    compute_dtype = dtype_of(arch.dtype)
    seg = as_segment(hbfp, backend=arch.kernel_backend)
    backend = seg.backend
    # the reference's split of the segment into the in-graph activation
    # config and the weight-tree config (repro/train/train_step.py)
    if seg.is_fp32:
        act_cfg = param_cfg = None
        stochastic = False
    elif seg.has_overrides or seg.global_cfg is None:
        # per-layer widths are resolved by the narrowing: the matmuls must
        # not re-quantize a widened layer at the global width
        act_cfg = None if seg.global_cfg is None else \
            seg.global_cfg.with_(requantize_weights=False)
        param_cfg = seg
        stochastic = seg.any_stochastic
    else:
        # uniform precision: the sim path skips the idempotent weight
        # re-quantization, the kernel path keeps it (integral mantissas)
        act_cfg = seg.global_cfg.with_(
            requantize_weights=(backend == "pallas"))
        param_cfg = seg.global_cfg.with_(requantize_weights=False)
        if seg.role_widths:
            # the role table stays visible so the grad tap measures at the
            # wgrad width
            param_cfg = ResolvedPolicy(global_cfg=param_cfg,
                                       role_widths=seg.role_widths,
                                       backend=backend)
        stochastic = seg.global_cfg.rounding == "stochastic"
    zero = None
    if mesh is not None:
        zero = mesh if isinstance(mesh, ZeroLayout) else \
            ZeroLayout(arch, mesh, dev, tile=layout_tile(seg),
                       seq_parallel=seq_parallel)
    exec_seg = ResolvedPolicy(global_cfg=act_cfg,
                              role_widths=seg.role_widths, backend=backend)
    if taps is not None and param_cfg is None:
        taps = None     # a true fp32 step: nothing to measure
    act_tap = taps is not None and taps.acts and grad_accum == 1 \
        and act_cfg is not None

    def step_keys(key):
        """(narrowing key, loss and update key) of a step, as the
        reference's: the narrowing folds 0x5EED."""
        if not stochastic:
            return None, None
        if key is None:
            raise ValueError("stochastic rounding requires a key: "
                             "train_step(state, batch, key)")
        return fold_in(key, 0x5EED), key

    act_reduce = act_tap and zero is not None and (zero.n > 1 or zero.sp)

    def loss_and_grads(narrow, batch, key, dp=None):
        ctx = Ctx(policy=exec_seg, key=key, device=dev,
                  act_tap=zero.act_reduce if act_reduce else act_tap,
                  tp=None if zero is None else zero.tp, dp=dp)
        leaves = [t for _, t in _leaves(narrow)]
        if grad_accum == 1:
            loss, metrics = loss_fn(narrow, batch, arch, ctx, device=dev)
            grads = list(_grads(loss, leaves))
            acts = metrics.pop("act_stats", None)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if acts is not None:
                metrics["act_stats"] = acts
            return loss.detach(), metrics, grads
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
               for t in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(grad_accum):
            mb = {k: v[a] for k, v in batch.items()}
            la, _ = loss_fn(narrow, mb, arch, ctx, device=dev)
            ga = _grads(la, leaves)
            acc = [s + g.to(torch.float32) / grad_accum
                   for s, g in zip(acc, ga)]
            loss = loss + la.detach() / grad_accum
        return loss, {"loss": loss}, acc

    def grads(state: TrainState, batch, key=None, weight_stats=None):
        nkey, key = step_keys(key)
        dp = None
        if zero is None:
            narrow = _narrow_copy(state.params, param_cfg, compute_dtype,
                                  weight_stats, nkey)
        else:
            narrow = zero.narrow_copy(state.params, param_cfg, compute_dtype,
                                      weight_stats, nkey)
            dp = zero.data_part(batch, grad_accum)
            batch = zero.local_batch(batch, grad_accum)
        loss, metrics, gs = loss_and_grads(narrow, batch, key, dp)
        paths = [p for p, _ in _leaves(narrow)]
        del narrow
        return loss, metrics, _stack_grads(paths, gs)

    def train_step(state: TrainState, batch, key=None):
        numerics = {}
        if taps is not None and taps.weights:
            numerics["weights"] = {}
        _, metrics, gs = grads(state, batch, key, numerics.get("weights"))
        ukey = step_keys(key)[1]
        if "act_stats" in metrics:
            numerics["acts"] = metrics.pop("act_stats")
        if zero is not None:
            gs = zero.reduce_grads(gs)
        if taps is not None and taps.grads:
            numerics["grads"] = grad_stats(
                gs, param_cfg, tap=None if zero is None else zero.grad_tap)
        metrics = dict(metrics)
        clip, apply = grad_clip, apply_update_
        if zero is not None:
            if grad_clip is not None:
                zero.clip_(gs, grad_clip)
            clip, apply = None, zero.apply_update
            metrics["loss"] = zero.mean(metrics["loss"])
        _, opt = adamw_update(
            gs, state.opt, state.params, lr=schedule,
            weight_decay=weight_decay, grad_clip=clip,
            apply=lambda n, leaf, i, u: apply(n, leaf, i, u, param_cfg,
                                              ukey))
        metrics["lr"] = schedule(opt.step) if callable(schedule) \
            else torch.tensor(schedule, dtype=torch.float32)
        if numerics:
            metrics["numerics"] = numerics
        return TrainState(state.params, opt, state.step + 1), metrics

    train_step.grads = grads
    train_step.layout = zero
    return train_step


def _tap_widths(seg: ResolvedPolicy, snapshot: dict) -> dict:
    """Resolved mantissa widths of every tapped tensor (0: FP): the weight
    tap quantizes at the fwd width, the grad tap at the wgrad width."""
    out = {}
    for source, role in (("weights", "fwd"), ("grads", "wgrad")):
        if source not in snapshot:
            continue
        widths = {}
        for name in snapshot[source]:
            c = seg.for_param(name, role)
            widths[name] = 0 if c is None else c.mantissa_bits
        out[source] = widths
    return out


def make_step(arch: ArchConfig, policy, schedule, *, controller=None,
              tap=None, recorder=None, device=None, mesh=None,
              seq_parallel: bool = False, **kwargs):
    """The train-step entry point (DESIGN.md §11): one precision policy (a
    PrecisionPolicy, a spec string, a PrecisionSchedule, an HBFPConfig or
    None; the legacy kinds pick up `arch.kernel_backend`) drives format,
    schedule, per-layer and per-role widths, the controller loop and the
    kernel backend.

    Returns train_step(state, batch, key=None) -> (state, metrics), a
    host dispatcher over step variants cached per (resolved segment ⊕
    controller overrides, telemetry); the int `key` reaches every variant
    and is needed by a stochastic one:

      * `tap` (a `numerics.TapConfig`) runs the telemetry variant on its
        cadence; metrics gain the "numerics" stats (kept in metrics when
        there is no controller);
      * `controller` (a `numerics.PrecisionController`) closes the loop:
        snapshots (with their resolved widths) land in `.buffer`, feed
        `controller.observe`, and its overrides merge into the segment
        of the next step;
      * `recorder` (an `obs.Recorder`) gets "train/recompile" for every
        new variant, "numerics/snapshot" for every collection and the
        controller's "precision/decision" events.

    metrics gain "mantissa_bits" (the segment's global width, 0 for fp32)
    and, with a controller, "n_overrides" and "min_mantissa_bits".
    `mesh` (a ("data", "model") or ("pod", "data", "model") DeviceMesh)
    makes every variant a data- and tensor-parallel step over one `train.zero.ZeroLayout`
    (`.layout`, laid out for the policy's first segment; see
    `make_train_step`), `seq_parallel` shards the residual stream over the
    sequence; under a mesh every rank observes rank 0's telemetry
    snapshot, so the ranks take the same controller decisions.
    Attributes: `.policy`, `.variants`, `.controller`, `.buffer`, `.tap`,
    `.layout` (None without a mesh) and `.grads(state, batch, key=None)`
    (steps 1-2 of the variant at state.step).
    Extra kwargs go to `make_train_step`."""
    rec = recorder if recorder is not None else NULL_RECORDER
    pol = as_policy(policy, backend=arch.kernel_backend)
    buffer = None
    if controller is not None:
        if pol.format(0) is None:
            raise ValueError("adaptive precision needs a BFP base format; "
                             "fp32 has nothing to widen or narrow")
        tap = tap if tap is not None else TapConfig()
        buffer = RingBuffer(tap.history, recorder=rec)
        if rec.enabled and getattr(controller, "recorder", None) is None:
            controller.recorder = rec
    dev = resolve_device(device)       # raise now when the card is missing
    layout = None
    if mesh is not None:
        layout = ZeroLayout(arch, mesh, dev, tile=layout_tile(pol),
                            seq_parallel=seq_parallel)
    segments = {i: pol.resolve_segment(i) for i in range(pol.num_segments)}
    variants = {}

    def segment(step: int) -> ResolvedPolicy:
        seg = segments[pol.segment_index(step)]
        if controller is not None:
            # the controller's overrides name the current adaptive
            # "segment"; decisions take effect at the next step
            seg = seg.with_controller(controller.overrides())
        return seg

    def variant(seg: ResolvedPolicy, telemetry: bool, step: int):
        fn = variants.get((seg, telemetry))
        if fn is None:
            fn = make_train_step(arch, seg, schedule,
                                 taps=tap if telemetry else None,
                                 device=device, mesh=layout, **kwargs)
            variants[(seg, telemetry)] = fn
            gcfg = seg.global_cfg
            rec.emit("train/recompile", step=step,
                     mantissa_bits=0 if gcfg is None else gcfg.mantissa_bits,
                     n_overrides=len(seg.layer_overrides)
                     + len(seg.controller_overrides),
                     backend=seg.backend, telemetry=telemetry,
                     n_variants=len(variants))
        return fn

    def train_step(state: TrainState, batch, key=None):
        step = int(state.step)
        seg = segment(step)
        telemetry = tap is not None and tap.collect_at(step)
        state, metrics = variant(seg, telemetry, step)(state, batch, key)
        if telemetry and (controller is not None or rec.enabled):
            numerics = (metrics.pop("numerics", None)
                        if controller is not None
                        else metrics.get("numerics"))
            if numerics is not None:
                snapshot = stats_to_host(numerics)
                if layout is not None and dist.get_world_size() > 1:
                    # the stats are reduced alike on every rank; rank 0's
                    # copy makes the decisions equal by construction
                    box = [snapshot]
                    dist.broadcast_object_list(box, src=0)
                    snapshot = box[0]
                snapshot["widths"] = _tap_widths(seg, snapshot)
                if controller is not None:
                    buffer.append(step, snapshot)
                    controller.observe(step, merge_sources(snapshot))
                else:
                    rec.emit("numerics/snapshot", step=step,
                             **snapshot_event(snapshot))
        gcfg = seg.global_cfg
        metrics["mantissa_bits"] = torch.tensor(
            float(0 if gcfg is None else gcfg.mantissa_bits))
        if controller is not None:
            ovr = controller.overrides()
            # bare widths or {"m", "b"} axis dicts (block decisions)
            widths = [w.get("m") if isinstance(w, dict) else w
                      for _, w in ovr]
            widths = [w for w in widths if w is not None]
            widths.append(controller.base_bits)
            metrics["n_overrides"] = torch.tensor(float(len(ovr)))
            metrics["min_mantissa_bits"] = torch.tensor(float(min(widths)))
        return state, metrics

    def grads(state: TrainState, batch, key=None):
        step = int(state.step)
        return variant(segment(step), False, step).grads(state, batch, key)

    train_step.policy = pol
    train_step.variants = variants
    train_step.controller = controller
    train_step.buffer = buffer
    train_step.tap = tap
    train_step.grads = grads
    train_step.layout = layout
    return train_step
