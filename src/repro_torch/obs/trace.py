"""Nestable span timing + the shared benchmark timer (DESIGN.md §12); a
copy of `repro.obs.trace` kept in the port.

**Spans.** `Span` is a context manager opened via `Recorder.span(name)`:
it reads the recorder's injected clock at entry/exit and emits one
`"span"` event carrying the duration, its parent span's name, and the
nesting depth (the stack is per-recorder and thread-local, so a
background checkpoint thread nests independently of the training loop).

**Timing device work.** CUDA dispatch is asynchronous: wall-clocking a
kernel launch measures enqueue time, not device time. A span that wraps
device work must force completion before it closes — call
`span.sync(out)`, which routes `out` through the recorder's injected
`sync` callable (`torch.cuda.synchronize` in the port) and
marks the span `synced`. Unsynced spans are still emitted (cheap
dispatch-time spans every step are useful) but carry `synced: false` so
a reader knows the duration excludes device time.

**`time_fn`.** The one benchmark timing loop (`benchmarks/common.timer`,
`kernels/autotune`, and the bench suites all delegate here): warmup
iterations each synced, then either per-iteration timing reduced by
min/mean (`sync_each=True`, robust microbenchmark form) or one timing of
the whole batch with a single trailing sync (`sync_each=False`, amortized
mean — the historical `common.timer` semantics). Returns microseconds.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Span:
    """One timed region. Construct via `Recorder.span(...)`; use as a
    context manager. `annotate(**kv)` attaches data fields to the emitted
    event; `sync(obj)` forces device completion (see module docstring)
    and returns `obj` so it can wrap the producing expression inline."""

    def __init__(self, recorder, name: str, *, step: Optional[int] = None,
                 data: Optional[Dict[str, Any]] = None):
        self.recorder = recorder
        self.name = name
        self.step = step
        self.data = dict(data or {})
        self.synced = False
        self._t0 = None

    def __enter__(self) -> "Span":
        self._t0 = self.recorder.clock.perf()
        self.recorder._stack().append(self)
        return self

    def sync(self, obj: Any) -> Any:
        if self.recorder.sync_fn is not None:
            self.recorder.sync_fn(obj)
            self.synced = True
        return obj

    def annotate(self, **kv: Any) -> "Span":
        self.data.update(kv)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = self.recorder.clock.perf() - self._t0
        stack = self.recorder._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if not self.recorder.enabled:
            return
        parent = stack[-1].name if stack else None
        data = {"name": self.name, "dur_us": dur * 1e6,
                "depth": len(stack), "synced": self.synced}
        if parent is not None:
            data["parent"] = parent
        if exc is not None:
            data["error"] = repr(exc)
        data.update(self.data)
        self.recorder.emit("span", step=self.step, **data)


def time_fn(fn: Callable, *args, n: int = 10, warmup: int = 2,
            sync: Optional[Callable[[Any], Any]] = None,
            reduce: str = "mean", sync_each: bool = False,
            clock=None) -> float:
    """Time `fn(*args)` and return microseconds per call.

    warmup: untimed calls first (each synced — compile + cache warm).
    sync: completion barrier applied to fn's result (a device synchronize
      for device work; None for host-only functions).
    sync_each / reduce: `sync_each=True` times each call individually
      (sync inside the timed region) and reduces by `"min"` (robust to
      contention — the autotuner's choice) or `"mean"`;
      `sync_each=False` times the whole n-call batch with one trailing
      sync and returns the amortized mean (keeps async dispatch
      pipelined — the step-benchmark choice; requires reduce="mean").
    clock: injectable Clock (tests); defaults to the system clock.
    """
    if reduce not in ("mean", "min"):
        raise ValueError(f"reduce must be 'mean' or 'min', got {reduce!r}")
    if not sync_each and reduce != "mean":
        raise ValueError("reduce='min' requires sync_each=True (individual "
                         "timings)")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if clock is None:
        from repro_torch.obs.events import SystemClock
        clock = SystemClock()
    for _ in range(warmup):
        out = fn(*args)
        if sync is not None:
            sync(out)
    if sync_each:
        best, total = float("inf"), 0.0
        for _ in range(n):
            t0 = clock.perf()
            out = fn(*args)
            if sync is not None:
                sync(out)
            dt = clock.perf() - t0
            best = min(best, dt)
            total += dt
        return (best if reduce == "min" else total / n) * 1e6
    t0 = clock.perf()
    for _ in range(n):
        out = fn(*args)
    if sync is not None:
        sync(out)
    return (clock.perf() - t0) / n * 1e6
