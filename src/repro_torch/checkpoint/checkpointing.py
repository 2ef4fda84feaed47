"""Checkpoints (port of `repro.checkpoint.checkpointing`, DESIGN.md §6).

The on-disk format is the reference's, so either package loads the
other's checkpoints: a directory `step_XXXXXXXX/` per checkpoint with
`meta.json` and one `<name>.npy` per leaf, or `<name>.npz` (mantissa,
exponent, mantissa_bits, tile_shape, shape) for a packed HBFP weight.
Leaf names are the reference's: the "."-joined key path, a NamedTuple
field written ".field" as jax prints it (".params.head_w", ".opt..step").

  * **atomic**: written to `step_XXXXXXXX.tmp/`, then `os.replace`d;
  * **compact**: `packed=True` packs HBFP weights at the step-resolved
    wide widths (`core.bfp.pack`, the conversion kernel B7 on the tensor's
    device);
  * **precision-aware**: `hbfp` (HBFPConfig, PrecisionSchedule or
    PrecisionPolicy) is serialized into meta ("precision"), and
    `load_precision` reads it back;
  * **background**: `background=True` snapshots (and packs) to host
    memory synchronously and writes in a thread;
  * retention of the last `keep` checkpoints, and "ckpt/save" /
    "ckpt/load" events with duration and bytes on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bfp
from repro_torch.core.opt_shell import is_hbfp_weight, resolve_param_cfg
from repro_torch.core.schedule_precision import (precision_from_dict,
                                                 precision_to_dict)
from repro_torch.obs import NULL_RECORDER

_SEP = "."


def _resolved_at(hbfp, step: int):
    """Concrete per-parameter precision at `step`: an HBFPConfig passes
    through; a schedule or policy resolves to its segment at `step`."""
    if hasattr(hbfp, "resolve_segment"):
        return hbfp.resolve_segment(hbfp.segment_index(step))
    return hbfp


def load_precision(meta: dict):
    """The meta.json "precision" entry as what was saved: None,
    HBFPConfig, PrecisionSchedule or PrecisionPolicy."""
    return precision_from_dict(meta.get("precision"))


def _flatten(tree, path=()):
    """(name, leaf) in the reference's flatten order: NamedTuple fields in
    order, dict keys sorted, sequences by index."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), path + ("." + f,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _rebuild(like, values: dict, path=()):
    """`like`'s structure with its leaves taken from values[name]."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), values,
                                     path + ("." + f,))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(v, values, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, path + (str(i),))
                          for i, v in enumerate(like))
    return values[_SEP.join(path)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array the training loop cannot change: a copy of
    a tensor (bf16 as f32), an int as int32 (the reference's step
    counters)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf, np.float32)


def _from_host(arr: np.ndarray, like):
    """A loaded array as the type, dtype and device of `like`'s leaf. The
    reference snapshots a bf16 leaf with `np.asarray`, which numpy saves
    as 2-byte void (`|V2`): its bytes are bf16 bits, read through int16."""
    if isinstance(like, torch.Tensor):
        if isinstance(arr, torch.Tensor):
            t = arr
        elif arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
                and like.dtype == torch.bfloat16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int)):
        return type(like)(np.asarray(arr).item())
    return float(np.asarray(arr).item())


def _tree_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    hbfp=None, packed: bool = False,
                    keep: int = 3, background: bool = False,
                    extra_meta: Optional[dict] = None,
                    recorder=None):
    """Write `state` (nested NamedTuples, dicts, lists of tensors and
    ints) at `step`. Returns the final path, or the writer Thread when
    background=True. `hbfp` is serialized into meta and, with
    packed=True, packs HBFP weights at this step's resolved widths.
    `recorder` gets one "ckpt/save" event per completed write."""
    recorder = recorder if recorder is not None else NULL_RECORDER
    os.makedirs(ckpt_dir, exist_ok=True)
    resolved = _resolved_at(hbfp, int(step))
    host = {}
    for name, leaf in _flatten(state):
        c = resolve_param_cfg(resolved, name)
        if packed and c is not None and getattr(leaf, "ndim", 0) >= 2 \
                and is_hbfp_weight(name, leaf):
            p = bfp.pack(leaf, c.wide_mantissa_bits,
                         bfp.weight_tile_shape(leaf.ndim, c.tile))
            host[name] = dict(
                mantissa=p.mantissa.cpu().numpy(),
                exponent=p.exponent.cpu().numpy(),
                mantissa_bits=p.mantissa_bits,
                tile_shape=np.array([-1 if t is None else t
                                     for t in p.tile_shape]),
                shape=np.array(p.shape))
        else:
            host[name] = _to_host(leaf)
    meta = {"step": int(step), "keys": sorted(host.keys()),
            "packed": bool(packed),
            "precision": precision_to_dict(hbfp)}
    if extra_meta:
        meta.update(extra_meta)

    def write():
        t0 = recorder.clock.perf()
        tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, arr in host.items():
            if isinstance(arr, dict):
                np.savez(os.path.join(tmp, name + ".npz"), **arr)
            else:
                np.save(os.path.join(tmp, name + ".npy"), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for s in sorted(latest_steps(ckpt_dir))[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
        recorder.emit("ckpt/save", step=int(step),
                      dur_s=recorder.clock.perf() - t0,
                      bytes=_tree_bytes(final), packed=bool(packed),
                      background=bool(background), path=final)
        return final

    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    return write()


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, like, step: Optional[int] = None,
                    recorder=None):
    """Restore into the structure of `like` (tensors keep like's dtype and
    device, ints stay ints); packed leaves unpack on like's device.
    Returns (state, meta). `recorder` gets one "ckpt/load" event."""
    recorder = recorder if recorder is not None else NULL_RECORDER
    t0 = recorder.clock.perf()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    loaded = {}
    for name, leaf in _flatten(like):
        npz = os.path.join(d, name + ".npz")
        if os.path.exists(npz):
            z = np.load(npz)
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            ts = tuple(None if t < 0 else int(t) for t in z["tile_shape"])
            p = bfp.PackedBFP(torch.from_numpy(z["mantissa"]).to(dev),
                              torch.from_numpy(z["exponent"]).to(dev),
                              int(z["mantissa_bits"]), ts,
                              tuple(int(s) for s in z["shape"]))
            arr = bfp.unpack(p)
        else:
            arr = np.load(os.path.join(d, name + ".npy"))
        loaded[name] = _from_host(arr, leaf)
    recorder.emit("ckpt/load", step=int(step),
                  dur_s=recorder.clock.perf() - t0,
                  bytes=_tree_bytes(d), packed=bool(meta.get("packed")),
                  path=d)
    return _rebuild(like, loaded), meta
