"""The weights of a run, made on the device from its seed.

One tree serves the port and the reference alike, in the port's
parameter layout: a "layers" dict of leaves stacked on a leading L axis,
"embed_table", "head_w" and "final_norm_scale". Each stacked leaf is one
`torch.randn` call of a `torch.Generator` on the device seeded from
(seed, the leaf's index), so any leaf can be drawn again alone (`leaf`)
to compare with. Matrices are normals at the usual fan-in scale (the
embedding at 0.02) in the configuration's dtype, as they are served and
as the port's own init makes them; the per-layer vectors are the
standard constants in float32. The reference takes the same tree and
computes in float32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from reference import for_model

_MIX = 0x9E3779B97F4A7C15
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def matrix_dtype(model: dict) -> torch.dtype:
    return DTYPES[model.get("dtype", "float32")]


def leaf_specs(model: dict) -> List[Tuple[str, tuple, object]]:
    """(path, full shape, init) of every leaf, stacked layers first, in a
    fixed order: a leaf's index seeds its draw."""
    L, D, V = model["n_layers"], model["d_model"], model["vocab_size"]
    out = [(f"layers/{n}", (L, *s), init) for n, s, init in
           for_model(model).layer_specs(model)]
    out += [("final_norm_scale", (D,), "ones"),
            ("embed_table", (V, D), 0.02), ("head_w", (D, V), D ** -0.5)]
    return out


def _seed(seed: int, index: int) -> int:
    return (int(seed) * _MIX + 1 + index) & 0x7FFFFFFFFFFFFFFF


def _constant(init: str, shape, device) -> torch.Tensor:
    if init == "ones":
        return torch.ones(shape, device=device)
    raise ValueError(f"unknown init {init!r}")


def _make(shape, init, seed, index, device, dtype):
    if isinstance(init, str):
        return _constant(init, shape, device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, index))
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(init)


def leaf(model: dict, seed: int, path: str, device) -> torch.Tensor:
    """Leaf `path` of the run's weights, drawn alone."""
    for i, (p, shape, init) in enumerate(leaf_specs(model)):
        if p == path:
            return _make(shape, init, seed, i, device, matrix_dtype(model))
    raise KeyError(path)


def make_weights(model: dict, seed: int, device) -> Dict:
    """The whole tree: {"layers": {name: [L, ...]}, "final_norm_scale",
    "embed_table", "head_w"}; matrices in the configuration's dtype,
    vectors in float32."""
    out: Dict = {"layers": {}}
    dt = matrix_dtype(model)
    for i, (path, shape, init) in enumerate(leaf_specs(model)):
        t = _make(shape, init, seed, i, device, dt)
        if path.startswith("layers/"):
            out["layers"][path[7:]] = t
        else:
            out[path] = t
    return out

