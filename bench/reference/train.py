"""The reference's training steps: the family module's `loss`, its
gradient by autograd, a global-norm clip and AdamW, all float32.

AdamW (decoupled weight decay): m <- b1 m + (1 - b1) g,
v <- b2 v + (1 - b2) g^2, p <- p - lr ((m / (1 - b1^t)) /
(sqrt(v / (1 - b2^t)) + eps) + wd p), the decay on leaves of two or more
dimensions as the weights hold them (stacked layers count a dimension),
after g <- g min(1, clip / (|g| + 1e-9)) over all leaves together.
Stacked leaves are updated one layer slice at a time, so the update's
temporaries stay one layer large.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from reference import for_model


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _slices(t):
    return list(t.unbind(0)) if t.ndim >= 3 else [t]


def run_steps(m: dict, params: Dict, batches: List[dict], opt: Adam,
              leaf_fn: Callable[[str], torch.Tensor]) -> dict:
    """Train `params` (converted to float32 and updated in place) over
    `batches`, one step each. Returns the loss of each step, each leaf's
    gradient norm at the first step as the optimizer takes it (clipped),
    and each leaf's change from its initial value (`leaf_fn(path)`, drawn
    again) after the last."""
    ref = for_model(m)
    with ref.exact_fp32():
        return _run(ref, m, ref.to_f32(params), batches, opt, leaf_fn)


def _run(ref, m, params, batches, opt, leaf_fn):
    leaves = list(_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    mom = {n: torch.zeros_like(p) for n, p in leaves}
    vel = {n: torch.zeros_like(p) for n, p in leaves}
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches, start=1):
        loss = ref.loss(params, batch["tokens"], batch["labels"], m)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            total = torch.sqrt(sum(p.grad.pow(2).sum() for _, p in leaves))
            scale = torch.clamp(opt.clip / (total + 1e-9), max=1.0)
            bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
            for n, p in leaves:
                g = p.grad.mul_(scale)
                if t == 1:
                    grad_norms[n] = float(g.norm())
                for gs, ms, vs, ps in zip(_slices(g), _slices(mom[n]),
                                          _slices(vel[n]), _slices(p)):
                    ms.mul_(opt.b1).add_(gs, alpha=1 - opt.b1)
                    vs.mul_(opt.b2).addcmul_(gs, gs, value=1 - opt.b2)
                    u = (ms / bc1).div_((vs / bc2).sqrt_().add_(opt.eps))
                    if p.ndim >= 2:
                        u.add_(ps, alpha=opt.weight_decay)
                    ps.sub_(u, alpha=opt.lr)
                    del u
                p.grad = None
    del mom, vel
    changes = {}
    with torch.no_grad():
        for n, p in leaves:
            changes[n] = float((p - leaf_fn(n).float()).norm())
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes}
