"""Kernel tile sizes and the tuning table (port of
`repro.kernels.autotune`, DESIGN.md §10).

A tile here is an exponent group, not a CTA tile: the reference's (bm,
bk, bn) decide which elements share an exponent, so the port quantizes on
the same tiles whatever CTA tile its kernel runs. A tuned entry therefore
changes the numbers, in both packages alike, and it changes the route
(`kernels/hbfp_matmul.py: gemm_route`, `wgrad_route`): int8 `wgmma` takes
contraction blocks of 128-multiples, bf16 of 64-multiples, and any other
tile runs on the CUDA cores.

  * `candidates(M, K, N)` — the search space: the reference's power-of-two
    menu clipped to the problem and deduplicated, in the reference's
    order. The reference also filters by a TPU VMEM estimate, which drops
    no menu triple at its budget, so the lists are equal;
  * `TuningTable` — a JSON table mapping `op/MxKxN/dtype/m<bits>/b<block>`
    keys (the reference's key, no device in it) to the winning tiles and
    their timings; the card that measured them is in the entry's
    `backend`;
  * `lookup(op, M, K, N, ...)` — what `kernels/linear.py: resolve_spec`
    and `kernels/ops.py` call: the tuned tiles when the table has the
    cell, else DEFAULT_TILES, always clipped to the problem. The table is
    loaded once per path (`get_table`), not once per call;
  * `autotune_op(...)` — time every candidate of one op and shape and
    record the winner.

The table is `$REPRO_AUTOTUNE_TABLE` (the reference's variable, so one
table can drive both packages), else `results/autotune_kernels_torch.json`,
the port's own file: tiles tuned on the card never change the reference's
numbers unless the variable points both packages at one table.

Tiles are resolved when a call site runs. A graphed serving tick keeps the
tiles it was captured with; a table change takes effect at its next
capture, as it does at the reference's next trace.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.obs import NULL_RECORDER
from repro_torch.obs.trace import time_fn

Tiles = Tuple[int, int, int]

DEFAULT_TILES: Tiles = (128, 128, 128)
TILE_MENU: Tuple[int, ...] = (32, 64, 128, 256)
TABLE_ENV = "REPRO_AUTOTUNE_TABLE"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_TABLE_PATH = os.path.join(_ROOT, "results",
                                  "autotune_kernels_torch.json")


def table_path() -> str:
    return os.environ.get(TABLE_ENV, DEFAULT_TABLE_PATH)


def dtype_name(dt: torch.dtype) -> str:
    """A tensor dtype as the key spells it: the reference's `str(x.dtype)`
    ("float32", "bfloat16")."""
    return str(dt).replace("torch.", "")


def cache_key(op: str, M: int, K: int, N: int, dtype: str,
              mantissa_bits: int, block: int = 0) -> str:
    """Table key: one entry per (op, logical shape, dtype, mantissa width,
    exponent-block size), as the reference spells it. The shape is the
    logical (M, K, N) of the GEMM, before padding to the tiles; `block`
    (0: whole tiles) changes the dataflow, so tiles do not transfer
    across block sizes."""
    return f"{op}/{M}x{K}x{N}/{dtype}/m{mantissa_bits}/b{int(block)}"


def clip_tiles(tiles: Iterable[int], M: int, K: int, N: int) -> Tiles:
    bm, bk, bn = tiles
    return (min(int(bm), M), min(int(bk), K), min(int(bn), N))


def align_tiles(tiles: Iterable[int], block: int) -> Tiles:
    """Round each tile edge up to a multiple of the exponent-block size;
    block=0 leaves the tiles unchanged."""
    if not block:
        return tuple(int(t) for t in tiles)
    b = int(block)
    return tuple(-(-int(t) // b) * b for t in tiles)


def candidates(M: int, K: int, N: int, *,
               menu: Tuple[int, ...] = TILE_MENU) -> Tuple[Tiles, ...]:
    """Distinct (bm, bk, bn) triples: the menu clipped to the problem
    dims, deduplicated (clipping collapses oversized entries), in menu
    order."""
    out = []
    seen = set()
    for bm in menu:
        for bk in menu:
            for bn in menu:
                t = clip_tiles((bm, bk, bn), M, K, N)
                if t not in seen:
                    seen.add(t)
                    out.append(t)
    return tuple(out)


class TuningTable:
    """On-disk tile-tuning table, the reference's JSON: {key: entry} where
    entry is {"tiles": [bm, bk, bn], "us": winner_us, "default_us": us at
    DEFAULT_TILES, "speedup": default_us/us, "backend": ...,
    "n_candidates": ...}. Unknown extra fields are preserved."""

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.path = path or table_path()

    @classmethod
    def load(cls, path: Optional[str] = None) -> "TuningTable":
        """The table at `path`; a missing, unreadable or corrupt file is
        an empty (untuned) table."""
        path = path or table_path()
        entries: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    entries = json.load(f)
            except (OSError, ValueError):
                entries = {}
            if not isinstance(entries, dict):
                entries = {}
        return cls(entries, path)

    def get(self, key: str) -> Optional[Tiles]:
        e = self.entries.get(key)
        if not isinstance(e, dict) or len(e.get("tiles") or ()) != 3:
            return None
        return tuple(int(t) for t in e["tiles"])

    def put(self, key: str, tiles: Iterable[int], **meta) -> None:
        self.entries[key] = {"tiles": [int(t) for t in tiles], **meta}

    def save(self, path: Optional[str] = None) -> str:
        """Write the table with an atomic replace; returns the path."""
        path = path or self.path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.entries, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path


_CACHED: Optional[TuningTable] = None
_CACHED_PATH: Optional[str] = None


def get_table(refresh: bool = False) -> TuningTable:
    """The process-wide table, loaded once per path: `resolve_spec` runs
    three lookups per linear call."""
    global _CACHED, _CACHED_PATH
    p = table_path()
    if refresh or _CACHED is None or _CACHED_PATH != p:
        _CACHED = TuningTable.load(p)
        _CACHED_PATH = p
    return _CACHED


def invalidate_cache() -> None:
    global _CACHED, _CACHED_PATH
    _CACHED = None
    _CACHED_PATH = None


def lookup(op: str, M: int, K: int, N: int, *, dtype: str = "float32",
           mantissa_bits: int = 8, block: int = 0) -> Tiles:
    """Tiles for one GEMM: the tuned tiles if the table has this (op,
    shape, dtype, m, b) cell, else DEFAULT_TILES, clipped to the problem
    so small shapes stay single-block."""
    t = get_table().get(cache_key(op, M, K, N, dtype, mantissa_bits, block))
    return clip_tiles(t or DEFAULT_TILES, M, K, N)


def _out_device(out) -> torch.device:
    while isinstance(out, (tuple, list)) and out:
        out = out[0]
    return out.device if isinstance(out, torch.Tensor) \
        else torch.device("cpu")


def _time_us(fn, n: int = 3, warmup: int = 1, devices=None) -> float:
    """Min-of-n microbenchmark of `fn()` through `obs.trace.time_fn`
    (each call synced, reduce=min), the sync waiting for the device of
    fn's output; that device is added to `devices` when given."""
    def sync(out):
        dev = _out_device(out)
        if devices is not None:
            devices.add(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return time_fn(fn, n=n, warmup=warmup, sync=sync, reduce="min",
                   sync_each=True)


def autotune_op(op: str, run_fn, M: int, K: int, N: int, *,
                dtype: str = "float32", mantissa_bits: int = 8,
                block: int = 0,
                table: Optional[TuningTable] = None,
                menu: Tuple[int, ...] = TILE_MENU,
                n: int = 3, save: bool = True, log=None,
                recorder=None):
    """Search tiles for one GEMM. `run_fn(tiles)` runs the kernel once
    with those tiles and returns its output; each candidate is timed
    min-of-n. Records the winner into the table (and saves it, then
    invalidates the cache so later lookups see it) and returns
    (best_tiles, report): the winner's tiles and time, the default tiles'
    time, the speedup, the backend (the card's name, or "cpu") and the
    number of candidates. `recorder` (an `obs.Recorder`) gets
    "autotune/search" when the sweep starts and "autotune/winner" with the
    report."""
    rec = recorder if recorder is not None else NULL_RECORDER
    table = table or get_table()
    cands = candidates(M, K, N, menu=menu)
    default = clip_tiles(DEFAULT_TILES, M, K, N)
    if default not in cands:
        cands = (default,) + cands
    key = cache_key(op, M, K, N, dtype, mantissa_bits, block)
    rec.emit("autotune/search", op=op, key=key, shape=[M, K, N],
             n_candidates=len(cands), n=n)
    timings, devices = {}, set()
    for t in cands:
        timings[t] = _time_us(lambda t=t: run_fn(t), n=n, devices=devices)
        if log:
            log(f"    {op} {M}x{K}x{N} tiles={t}: {timings[t]:9.1f} us")
    best = min(timings, key=timings.get)
    cuda = sorted((d for d in devices if d.type == "cuda"), key=str)
    report = {
        "tiles": list(best), "us": round(timings[best], 1),
        "default_tiles": list(default),
        "default_us": round(timings[default], 1),
        "speedup": round(timings[default] / timings[best], 3),
        "backend": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
        "n_candidates": len(cands),
    }
    rec.emit("autotune/winner", op=op, key=key, **report)
    table.put(key, best,
              **{k: v for k, v in report.items() if k != "tiles"})
    if save:
        table.save()
        invalidate_cache()
    return best, report
