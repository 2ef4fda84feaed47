"""AdamW with f32 moments (port of `repro.optim.adamw`).

The arithmetic per element is the reference's, in the same order of f32
operations. Unlike the reference's functional update, the port updates the
moments in place and walks stacked [L, ...] leaves one layer slice at a
time, so the f32 temporaries stay one layer large; within a slice the
update's chain runs in place where that keeps the reference's operations
(at most three slice-sized temporaries, not seven: a 1-B-parameter
embedding or head is 4 GB a temporary). Leaves are visited in
the reference's `jax.tree.leaves` order (dict keys sorted), which is also
the order of the global grad-norm sum.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    step: int      # number of updates taken
    mu: Any        # first moment tree (f32)
    nu: Any        # second moment tree (f32)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def named_leaves(tree, prefix: str = ""):
    """(name, leaf) pairs in the reference's leaf order (sorted keys),
    named like `core.opt_shell.param_path_name`."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}" if prefix
                                    else str(k))
    else:
        yield prefix, tree


def slices(t: torch.Tensor):
    """A stacked [L, ...] leaf (ndim >= 3) as its L layer views; any other
    leaf whole."""
    return list(t.unbind(0)) if t.ndim >= 3 else [t]


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(step=0, mu=_tree_map(zeros, params),
                    nu=_tree_map(zeros, params))


def _f32(v) -> float:
    """A scalar rounded to f32 (the reference computes its scalars in f32)."""
    return float(torch.as_tensor(v, dtype=torch.float32))


def grad_sq_sum(g_leaves: dict, names):
    """The f32 sum of squares of the named gradient leaves, leaf by leaf
    and layer slice by layer slice in `names`' order (0 when empty)."""
    total = 0
    for n in names:
        for g in slices(g_leaves[n]):
            gf = g.to(torch.float32)
            total = total + torch.sum(gf * gf)
    return total


def clip_scale(total, grad_clip: float) -> torch.Tensor:
    """The global-norm clip factor of a sum of squares."""
    gnorm = torch.sqrt(total)
    return torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)


def adamw_update(grads, state: OptState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: Optional[float] = 1.0,
                 apply: Optional[Callable] = None):
    """One AdamW step. `lr` is a scalar or schedule(step). The moments in
    `state` are updated in place. Without `apply` returns (updates,
    new_state) with an updates tree shaped like params; with it, each
    update goes to apply(name, leaf, index, update) as soon as it is
    computed (index: the layer slice of a stacked leaf, else None) and
    (None, new_state) is returned."""
    step = state.step + 1
    lr_t = _f32(lr(step) if callable(lr) else lr)
    g_leaves = dict(named_leaves(grads))
    mu, nu = dict(named_leaves(state.mu)), dict(named_leaves(state.nu))
    names = [n for n, _ in named_leaves(params)]
    scale = None
    if grad_clip is not None:
        scale = clip_scale(grad_sq_sum(g_leaves, names), grad_clip)
    s = torch.tensor(float(step), dtype=torch.float32)
    bc1 = _f32(1 - torch.tensor(b1, dtype=torch.float32) ** s)
    bc2 = _f32(1 - torch.tensor(b2, dtype=torch.float32) ** s)
    out = {}
    for n, p in named_leaves(params):
        decay = bool(weight_decay) and p.ndim >= 2   # matrices only
        parts = []
        many = p.ndim >= 3
        for i, (g, m, v, ps) in enumerate(zip(
                slices(g_leaves[n]), slices(mu[n]), slices(nu[n]),
                slices(p))):
            gf = g.to(torch.float32)
            if scale is not None:
                gf = gf * scale
            m.mul_(b1).add_(gf * (1 - b1))
            sq = gf * (1 - b2)
            v.mul_(b2).add_(sq.mul_(gf))
            del gf, sq
            # u = (m / bc1) / (sqrt(v / bc2) + eps), op for op
            den = v / bc2
            den.sqrt_().add_(eps)
            u = m / bc1
            u.div_(den)
            del den
            if decay:
                u.add_(weight_decay * ps.to(torch.float32))
            u.mul_(-lr_t)
            if apply is not None:
                apply(n, p, i if many else None, u)
            else:
                parts.append(u)
        if apply is None:
            out[n] = torch.stack(parts) if many else parts[0]
    new_state = OptState(step=step, mu=state.mu, nu=state.nu)
    if apply is not None:
        return None, new_state
    return _unflatten(out, params), new_state


def _unflatten(flat: dict, like, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    return flat[prefix]
