"""HBFP training step (port of `repro.train.train_step`, paper §5.1):

  1. narrow  = Q_narrow(master), cast to the arch dtype (bf16: exact for
     m <= 8), one autograd leaf per weight and per layer;
  2. grads   = ∇ loss(narrow, batch): every dot product in BFP, on the
     sim path or, under backend "pallas", on the B1/B2/B3 kernels;
  3. updates = AdamW(grads) in f32;
  4. master  = Q_wide(master + updates), 16-bit wide weight storage.

`make_step(arch, policy, lr_schedule)` is the entry point for a constant
(single-segment) policy; schedules (ROADMAP A9), numerics taps and the
controller (A10) and stochastic weight narrowing (A5) raise. Unlike the
reference's functional step, the port updates the state's master params
and moments in place, one layer slice at a time, so the optimizer adds
only one layer's f32 temporaries to the training state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import bfp
from repro_torch.core.opt_shell import _weight_cfg, apply_update_
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.precision.policy import (ResolvedPolicy, as_policy,
                                          as_segment)


class TrainState(NamedTuple):
    params: Any    # master weights (wide-BFP values in f32 containers)
    opt: OptState
    step: int


def _to_f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_f32_tree(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def init_train_state(seed: int, arch: ArchConfig, init_params_fn=init_params,
                     device=None) -> TrainState:
    """Seeded params (`init_params_fn(seed, arch, device=...)`) as f32
    master weights, zero moments, step 0, on `device` (the CUDA device by
    default)."""
    dev = resolve_device(device)
    params = _to_f32_tree(init_params_fn(seed, arch, device=dev))
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
                 dtype: torch.dtype) -> torch.Tensor:
    """One leaf (or layer slice) of the compute copy: narrowed at its
    config, cast to the compute dtype when the leaf is a matrix (as the
    reference casts: stacked [L, D] norm scales too), a fresh autograd
    leaf."""
    p = leaf if index is None else leaf[index]
    c = _weight_cfg(cfg, name, leaf)
    if c is not None:
        p = bfp.quantize_weight(p, c)
    return p.to(dtype if leaf.ndim >= 2 else p.dtype,
                copy=True).requires_grad_()


def _narrow_copy(master, cfg, dtype):
    """The compute copy with "layers" as a list of per-layer dicts, so each
    layer's weights get their own gradients."""
    out = {}
    for k, v in master.items():
        if k == "layers":
            L = next(iter(v.values())).shape[0]
            out[k] = [{n: _narrow_leaf(f"layers/{n}", t, i, cfg, dtype)
                       for n, t in v.items()} for i in range(L)]
        else:
            out[k] = _narrow_leaf(k, v, None, cfg, dtype)
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


def make_train_step(arch: ArchConfig, hbfp, schedule, *, grad_accum: int = 1,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    device=None):
    """Returns train_step(state, batch) -> (state, metrics) for one static
    precision segment (None, an HBFPConfig or a ResolvedPolicy). With
    grad_accum > 1 the batch leaves are [A, ...] microbatches and the mean
    grads accumulate in f32. `train_step.grads(state, batch)` -> (loss,
    metrics, grads) runs steps 1 and 2 alone and returns the grads in the
    master's layout."""
    dev = resolve_device(device)
    compute_dtype = dtype_of(arch.dtype)
    seg = as_segment(hbfp, backend=arch.kernel_backend)
    backend = seg.backend
    # the reference's split of the segment into the in-graph activation
    # config and the weight-tree config (repro/train/train_step.py)
    if seg.is_fp32:
        act_cfg = param_cfg = None
    elif seg.has_overrides or seg.global_cfg is None:
        act_cfg = None if seg.global_cfg is None else \
            seg.global_cfg.with_(requantize_weights=False)
        param_cfg = seg
    else:
        # uniform precision: the sim path skips the idempotent weight
        # re-quantization, the kernel path keeps it (integral mantissas)
        act_cfg = seg.global_cfg.with_(
            requantize_weights=(backend == "pallas"))
        param_cfg = seg.global_cfg.with_(requantize_weights=False)
        if seg.role_widths:
            param_cfg = ResolvedPolicy(global_cfg=param_cfg,
                                       role_widths=seg.role_widths,
                                       backend=backend)
    if not seg.is_fp32 and seg.any_stochastic:
        raise NotImplementedError(
            "stochastic rounding in training (per-parameter narrowing "
            "streams) comes with ROADMAP A5")
    exec_seg = ResolvedPolicy(global_cfg=act_cfg,
                              role_widths=seg.role_widths, backend=backend)

    def loss_and_grads(narrow, batch):
        ctx = Ctx(policy=exec_seg, device=dev)
        leaves = [t for _, t in _leaves(narrow)]
        if grad_accum == 1:
            loss, metrics = loss_fn(narrow, batch, arch, ctx, device=dev)
            grads = list(torch.autograd.grad(loss, leaves))
            return loss.detach(), {k: v.detach() for k, v in
                                   metrics.items()}, grads
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
               for t in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(grad_accum):
            mb = {k: v[a] for k, v in batch.items()}
            la, _ = loss_fn(narrow, mb, arch, ctx, device=dev)
            ga = torch.autograd.grad(la, leaves)
            acc = [s + g.to(torch.float32) / grad_accum
                   for s, g in zip(acc, ga)]
            loss = loss + la.detach() / grad_accum
        return loss, {"loss": loss}, acc

    def grads(state: TrainState, batch):
        narrow = _narrow_copy(state.params, param_cfg, compute_dtype)
        loss, metrics, gs = loss_and_grads(narrow, batch)
        paths = [p for p, _ in _leaves(narrow)]
        del narrow
        return loss, metrics, _stack_grads(paths, gs)

    def train_step(state: TrainState, batch):
        _, metrics, gs = grads(state, batch)
        _, opt = adamw_update(
            gs, state.opt, state.params, lr=schedule,
            weight_decay=weight_decay, grad_clip=grad_clip,
            apply=lambda n, leaf, i, u: apply_update_(n, leaf, i, u,
                                                      param_cfg))
        metrics = dict(metrics)
        metrics["lr"] = schedule(opt.step) if callable(schedule) \
            else torch.tensor(schedule, dtype=torch.float32)
        return TrainState(state.params, opt, state.step + 1), metrics

    train_step.grads = grads
    return train_step


def make_step(arch: ArchConfig, policy, schedule, *, controller=None,
              tap=None, device=None, **kwargs):
    """The train-step entry point for a constant precision policy (a
    PrecisionPolicy, a spec string, an HBFPConfig or None; the legacy
    kinds pick up `arch.kernel_backend`). Returns train_step(state, batch
    ) -> (state, metrics); metrics gains "mantissa_bits" (0 for fp32).
    Extra kwargs go to `make_train_step`."""
    if controller is not None or tap is not None:
        raise NotImplementedError(
            "numerics taps and the precision controller come with ROADMAP "
            "A10")
    pol = as_policy(policy, backend=arch.kernel_backend)
    seg = pol.resolve_segment(0)
    step_fn = make_train_step(arch, seg, schedule, device=device, **kwargs)
    bits = 0 if seg.global_cfg is None else seg.global_cfg.mantissa_bits

    def train_step(state: TrainState, batch):
        state, metrics = step_fn(state, batch)
        metrics["mantissa_bits"] = torch.tensor(float(bits))
        return state, metrics

    train_step.policy = pol
    train_step.grads = step_fn.grads
    return train_step
