"""One run of one cell: the cell's traffic generator runs the program and
the check, the metric readers read the traced window, and `run_cell`
assembles the line the run prints last."""
from __future__ import annotations

import dataclasses
import gc
import re
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from harness import checks
from harness.cells import Cell, load_cell, patterns_of
from harness.profiling import Trace

# top-level module names no run may hold, compared whole: `repro` is the
# JAX package, `repro_torch` the port under test
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunContext:
    """What a traffic generator gets: the cell, the run's arguments, the
    device, the precision the program runs at (the configuration's, or
    its control's in a calibration), and hooks that a test or a
    calibration uses to break the timed path (none in a benchmark run)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    precision: str = ""
    hooks: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", flush=True)

    def hook(self, name: str, obj):
        """obj as the run's hook of that name leaves it: unchanged in a
        benchmark run."""
        h = self.hooks.get(name)
        return obj if h is None else h(obj)


@dataclasses.dataclass
class Reading:
    """What the per-layer readers read: the cell, the window's counts,
    the traced sub-window's counts and its Trace (None off the card), and
    the spans the program recorded in the window."""
    cell: Cell
    window: Dict[str, Any]
    sub: Dict[str, Any]
    trace: Optional[Trace]
    spans: List[dict] = dataclasses.field(default_factory=list)

    def kernel_s(self, patterns) -> float:
        """Device seconds of the traced operations whose name matches any
        of the regex `patterns`."""
        rx = re.compile("|".join(patterns))
        return sum(s for n, s, _ in self.trace.ops if rx.search(n))

    def region_s(self, names) -> float:
        """Device seconds of the traced operations launched inside any of
        the program regions `names`."""
        return sum(s for _, s, r in self.trace.ops if r in names)


@dataclasses.dataclass
class Outcome:
    """What a generator hands back: end-to-end values, the Reading (trace
    runs), the check's numbers, counts and the device memory peak."""
    e2e: Dict[str, float]
    reading: Optional[Reading]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    """Give the program's freed memory back before the reference runs."""
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that no run may hold, compared
    whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def make_context(root: str, workload: str, seed: int, seconds: float,
                 trace: bool, device=None, hooks=None, precision=None,
                 t_start: Optional[float] = None) -> RunContext:
    import torch
    cell = load_cell(root, workload)
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    return RunContext(cell=cell, seed=int(seed), seconds=float(seconds),
                      trace=bool(trace), device=dev,
                      t_start=time.perf_counter() if t_start is None
                      else t_start,
                      precision=precision or cell.config.precision,
                      hooks=dict(hooks or {}))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device=None, hooks=None,
             t_start: Optional[float] = None):
    """Run the cell once; returns (result dict, check lines)."""
    ctx = make_context(root, workload, seed, seconds, trace, device, hooks,
                       t_start=t_start)
    out = ctx.cell.generator.run(ctx)
    return result_line(ctx, out)


def result_line(ctx: RunContext, out: Outcome):
    import torch
    cell, dev = ctx.cell, ctx.device
    correct, checked = checks.judge(out.numbers, cell.limits)
    metrics = {}
    if ctx.trace:
        r = out.reading
        if r.trace is not None:
            rx = patterns_of(cell.per_layer)
            dev_s = r.trace.device_s
            seen = r.kernel_s(rx) if rx else 0.0
            ctx.log(f"traced window {r.trace.window_s:.6f} s, busy "
                    f"{r.trace.busy_s:.6f} s, device ops {dev_s:.6f} s, of "
                    f"it {100 * (1 - seen / dev_s) if dev_s else 0:.4f}% "
                    f"matched by no metric's kernel pattern; analysis "
                    f"{r.trace.analysis_s:.1f} s")
        for m in cell.per_layer:
            v = m.reader.read(r)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            v = out.e2e.get(m.name)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    on_gpu = dev.type == "cuda"
    device_info = {"platform": "gpu" if on_gpu else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_gpu
                   else dev.type,
                   "count": cell.chips, "memory_peak_bytes": out.peak_bytes}
    res = {"correct": bool(correct), "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": device_info}
    if ctx.trace and out.reading.trace is not None:
        t = out.reading.trace
        device_info["busy_s"] = t.busy_s
        device_info["window_s"] = t.window_s
        res["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
    res["checks"] = checked
    lines = [f"check {n}: {c['value']!r} limit {c['limit']!r}"
             for n, c in checked.items()]
    return res, lines
