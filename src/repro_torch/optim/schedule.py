"""LR schedules (port of `repro.optim.schedule`): cosine, WSD
(warmup-stable-decay) and constant, computed in f32 as the reference does.
"""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str, *, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1,
                  decay_frac: float = 0.1):
    """Returns schedule(step) -> lr as an f32 0-dim CPU tensor.

    kind: "cosine" | "wsd" | "constant"."""
    wu = max(warmup_steps, 1)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32)

    def cos_tail(prog):
        return final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))

    def cosine(step):
        s = f32(step)
        warm = s / wu
        prog = torch.clamp((s - wu) / max(total_steps - wu, 1), 0.0, 1.0)
        return base_lr * torch.where(s < wu, warm, cos_tail(prog))

    def wsd(step):
        s = f32(step)
        warm = s / wu
        decay_steps = max(int(total_steps * decay_frac), 1)
        decay_start = total_steps - decay_steps
        prog = torch.clamp((s - decay_start) / decay_steps, 0.0, 1.0)
        stable = torch.where(s < decay_start, f32(1.0), cos_tail(prog))
        return base_lr * torch.where(s < wu, warm, stable)

    def constant(step):
        s = f32(step)
        return base_lr * torch.clamp(s / wu, max=1.0)

    return {"cosine": cosine, "wsd": wsd, "constant": constant}[kind]
