"""Reading the device from `torch.profiler`'s trace.

Copied from `chip_smoke.py`, which first ran them on the H100:
`PROFILE_PAD` and its spin kernels (a profiler session can drop the
records of the first kernels it sees, so the traced window opens after
them), `Regions` (its `_Regions`: program functions wrapped in profiler
ranges by their module and global name for the length of a `with`), and
`read_trace` (its `_step_kernels`: one pass over the raw kineto
events, each device operation attributed to the region whose range, or
whose forward op's autograd node, launched it). Added here: the window's
busy time as the union of the device operations' intervals, and the idle
gaps named by the host operation that ran across them.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Callable, Dict, List, Optional, Tuple

PROFILE_PAD = 4000          # spin kernels before a traced window
WINDOW = "bench/window"     # the profiler range around the traced window
TOP = 10                    # entries of each breakdown list


class Regions:
    """Wrap program functions ({region: (module, function)}) in profiler
    ranges named after the region while the `with` lasts. The modules
    call them by their global names, so the wrapped function is the one
    that runs; the originals are put back on exit."""

    def __init__(self, regions: Dict[str, Tuple[str, str]]):
        self.fns = [(n, importlib.import_module(m), f)
                    for n, (m, f) in regions.items()]
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function
        for name, mod, fn in self.fns:
            f = getattr(mod, fn)
            self.saved.append((mod, fn, f))

            def wrapped(*a, _f=f, _n=name, **k):
                with record_function(_n):
                    return _f(*a, **k)
            setattr(mod, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, fn, f in reversed(self.saved):
            setattr(mod, fn, f)
        self.saved = []


def traced(fn: Callable, regions: Dict[str, Tuple[str, str]]):
    """Run fn() under torch.profiler (CPU and CUDA activities) inside the
    WINDOW range, after PROFILE_PAD spin kernels, with the `regions`
    marked; synchronized at both ends. Returns the profiler (fn's result
    is dropped, so nothing it holds outlives the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with Regions(regions), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    return prof


@dataclasses.dataclass
class Trace:
    """The traced window: every device operation in it as (name, seconds,
    region or None), its busy and wall seconds, and the breakdown."""
    ops: List[Tuple[str, float, Optional[str]]]
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    analysis_s: float

    @property
    def device_s(self) -> float:
        return sum(s for _, s, _ in self.ops)


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def read_trace(prof, regions=()) -> Trace:
    """The Trace of a `traced` profile; `regions` the names it marked."""
    t_start = time.perf_counter()
    names = set(regions) | {WINDOW}
    cpu, dev, win = {}, [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU":
            if e.is_async():
                continue
            n = e.name()
            if n == WINDOW:
                win = (e.start_ns(), e.end_ns(), e.start_thread_id())
            cpu.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), n, e.correlation_id(),
                 e.sequence_nr(), e.fwd_thread_id()))
        elif e.name() not in names:          # not a range's device mirror
            s = e.start_ns()
            dev.append((e.name(), s, s + e.duration_ns(),
                        e.linked_correlation_id()))
    if win is None:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1, main_tid = win
    dev = [d for d in dev if d[2] > w0 and d[1] < w1]
    # each op's nearest marker: a region range or an evaluate_function
    marker_of, fwd = {}, {}
    for tid, evs in cpu.items():
        evs.sort()
        stack = []                           # (end, marker id)
        for start, neg_end, n, cid, seq, fwd_tid in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            mark = stack[-1][1] if stack else None
            if n in regions:
                mark = ("range", n)
            elif n.startswith("autograd::engine::evaluate_function"):
                mark = ("eval", fwd_tid, seq)
            elif seq >= 0 and mark is not None and mark[0] == "range":
                fwd[(tid, seq)] = mark[1]
            marker_of[cid] = mark
            stack.append((-neg_end, mark))
    region = lambda m: None if m is None else (
        m[1] if m[0] == "range" else fwd.get((m[1], m[2])))
    ops = [(n, (min(b, w1) - max(a, w0)) / 1e9, region(marker_of.get(link)))
           for n, a, b, link in dev]
    busy = _union((max(a, w0), min(b, w1)) for _, a, b, _ in dev)
    busy_s = sum(b - a for a, b in busy) / 1e9
    # idle gaps, named by the innermost host op of the window's thread
    # that spans the gap's middle
    host = sorted((s, -ne, n) for s, ne, n, *_ in cpu.get(main_tid, ())
                  if n != WINDOW)
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    gaps: Dict[str, float] = {}
    stack, i = [], 0                  # the open host ops, outermost first
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "no host op"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    by_name: Dict[str, float] = {}
    for n, s, _ in ops:
        by_name[n] = by_name.get(n, 0.0) + s
    top = lambda d: sorted(([k[:160], v] for k, v in d.items()),
                           key=lambda r: -r[1])[:TOP]
    return Trace(ops=ops, busy_s=busy_s, window_s=(w1 - w0) / 1e9,
                 device_ops=top(by_name), idle_gaps=top(gaps),
                 analysis_s=time.perf_counter() - t_start)
