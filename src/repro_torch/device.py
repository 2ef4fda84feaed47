"""Device resolution for the port's entry points.

An entry point called with `device=None` runs on the CUDA device and
raises when there is none: a run that asked for the card never falls back
to the CPU silently. Tests and CPU callers pass `device="cpu"`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a `torch.device`; None means the CUDA device, which
    must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """True when two devices name the same placement (`cuda` == `cuda:0`
    on a one-card process)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless tensor `t` lies on `device`."""
    if not same_device(t.device, device):
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def dtype_of(name: Optional[str]) -> torch.dtype:
    """torch dtype for an `ArchConfig.dtype` string."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]
