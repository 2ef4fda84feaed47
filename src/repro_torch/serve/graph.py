"""A serving stage captured once as a CUDA graph and replayed after: the
port's counterpart of the reference's `jax.jit` over its static-shape
generate stage (`repro.serve.engine`).

`GraphedStage(body)` wraps a body that reads only tensors whose
addresses stay fixed (the engine's tick buffers, its KV cache and the
weights) and returns its outputs. The first call runs the body eagerly:
it builds the kernels (each library compiles at first use) and warms the
allocator. The second call captures the body into a `torch.cuda.CUDAGraph`
and replays it; every later call is one replay. Capture launches nothing,
so each call runs the body's work on the card exactly once. The outputs
live in the graph's private memory pool and are overwritten by the next
replay: a caller copies what it keeps before calling again.

The kernel wrappers count their launches in Python, so their counters
move while the body is captured and never when the graph replays. The
stage takes the counters' change over the capture back out and adds it
once per replay (`per_replay`): the counts stay counts of launches on the
card.

Capture runs with `torch.cuda.set_sync_debug_mode("error")`, so a host
sync inside the body raises and names its op, and with Python's cyclic
garbage collector off, after one collection: a dead engine whose graph
or pinned buffers were freed inside another engine's capture would
invalidate it. A failed capture or replay raises; nothing falls back to
the eager body.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import bfp_quantize as _bq
from repro_torch.kernels import hbfp_flash_attn as _fa
from repro_torch.kernels import hbfp_matmul as _hm

# every kernel wrapper with launch counters
COUNTED = (_hm.hbfp_matmul_fwd, _hm.hbfp_dgrad, _hm.hbfp_wgrad,
           _fa.hbfp_flash_fwd, _fa.hbfp_flash_dq, _fa.hbfp_flash_dkv,
           _bq.bfp_quantize)

Counts = Dict[str, Tuple[int, Dict[str, int]]]


def _launch_counts() -> Counts:
    """{wrapper name: (launches, launches by route)} of every counted
    kernel."""
    return {fn.__name__: (fn.launches, dict(fn.launches_by_route))
            for fn in COUNTED}


def _add(delta: Counts, sign: int) -> None:
    for fn in COUNTED:
        n, routes = delta[fn.__name__]
        fn.launches += sign * n
        for r, k in routes.items():
            fn.launches_by_route[r] += sign * k


class GraphedStage:
    """One captured stage (see the module docstring). `calls` counts
    calls, `replays` graph replays; `per_replay` holds the kernel launches
    of one replay, {wrapper name: (launches, by route)}, once captured."""

    def __init__(self, body: Callable):
        self.body = body
        self.graph = None
        self.out = None
        self.per_replay: Counts = {}
        self.calls = 0
        self.replays = 0

    def __call__(self):
        self.calls += 1
        if self.calls == 1:
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        _add(self.per_replay, +1)
        return self.out

    def _capture(self) -> None:
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        # dead engines (a stage and its engine hold each other) are
        # collected now, not inside the capture
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self.body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:
            if gc_on:
                gc.enable()
        after = _launch_counts()
        self.per_replay = {
            k: (after[k][0] - n,
                {r: after[k][1][r] - c for r, c in routes.items()})
            for k, (n, routes) in before.items()}
        _add(self.per_replay, -1)       # the capture launched nothing
        self.graph, self.out = graph, out
