"""Typed, versioned event records + the Recorder hub (DESIGN.md §12);
a copy of `repro.obs.events` kept in the port, which imports nothing of
the reference package.

An `Event` is one structured record in a run-log: a `kind` (namespaced
`"category/name"`), a schema version, a wall-clock timestamp, an optional
training/serving step, and a flat JSON-serializable `data` dict. Events are
produced exclusively through a `Recorder`, which stamps the clock and fans
each record out to its sinks (any object with write/flush/close; the
port has not copied the reference's `obs.sinks` yet).

Two properties make this layer safe to thread through the training stack:

  * **injected clocks** — the Recorder reads time from a `Clock` object it
    was constructed with, never from module-global `time.*` at the call
    site, so tests drive a `ManualClock` and every timestamp/duration in
    the run-log is deterministic;
  * **cheap when disabled** — a Recorder with no sinks is the no-op
    recorder: `emit` returns immediately and spans skip event
    construction, so instrumented code paths cost a truthiness check when
    observability is off (the train step itself is bit-identical either
    way — all emission is host-side).

This module is dependency-free (stdlib only): anything that needs to sync
device work injects a `sync` callable (`torch.cuda.synchronize` in the
port's serving engine), see `obs.trace`.
"""
from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Callable, Dict, Iterable, Optional

import time as _time

SCHEMA_VERSION = 1

# Namespaced event kinds emitted by the repo's own instrumentation. The
# registry is documentation + validation seed, not a closed set: any kind
# matching _KIND_RE may be emitted (downstream consumers must ignore kinds
# they don't know — that is what the schema version is for).
KINDS: Dict[str, str] = {
    "span": "a timed region closed (name, dur_us, parent, depth)",
    "train/progress": "periodic scalar metrics from the Trainer loop",
    "train/recompile": "a new train-step jit variant was compiled",
    "numerics/snapshot": "per-layer fidelity stats + resolved widths",
    "precision/decision": "controller widen/narrow decision + signals",
    "autotune/search": "kernel tile search started for one op/shape",
    "autotune/winner": "kernel tile search winner + speedup",
    "ckpt/save": "checkpoint written (step, dur_s, bytes, packed)",
    "ckpt/load": "checkpoint restored (step, dur_s, bytes)",
    "serve/admit": "request admitted into a lane (prefill done)",
    "serve/complete": "request finished (ttft_s, tokens_per_sec)",
    "serve/queue": "request entered the overload queue",
    "serve/preempt": "lane evicted on page exhaustion (re-queued at front)",
    "serve/truncate": "request force-completed (pool cannot grow its lane)",
}

_KIND_RE = re.compile(r"^[a-z0-9_.]+(/[a-z0-9_.]+)?$")


class Clock:
    """Injectable time source. `time()` is wall-clock seconds (event
    timestamps); `perf()` is a monotonic high-resolution counter (span
    durations). The default `SystemClock` reads the stdlib; tests inject a
    `ManualClock` so run-log content is deterministic."""

    def time(self) -> float:
        raise NotImplementedError

    def perf(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    def time(self) -> float:
        return _time.time()

    def perf(self) -> float:
        return _time.perf_counter()


class ManualClock(Clock):
    """Deterministic clock for tests: starts at `t0`, moves only via
    `advance(dt)` / `set(t)`. `time()` and `perf()` read the same value,
    so asserted durations equal the advanced amounts exactly."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def time(self) -> float:
        return self._t

    def perf(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t

    def set(self, t: float) -> float:
        self._t = float(t)
        return self._t


@dataclasses.dataclass(frozen=True)
class Event:
    """One run-log record. `data` must be JSON-serializable (plain dicts,
    lists, strings, numbers, bools) — sinks serialize it verbatim."""

    kind: str
    t: float                      # wall-clock seconds (recorder clock)
    step: Optional[int] = None    # training/serving step, when meaningful
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    v: int = SCHEMA_VERSION

    def to_json(self) -> Dict[str, Any]:
        d = {"v": self.v, "kind": self.kind, "t": self.t}
        if self.step is not None:
            d["step"] = self.step
        d["data"] = self.data
        return d


class Recorder:
    """The emission hub: stamps events with the injected clock and fans
    them out to sinks. With no sinks it is the no-op recorder (`enabled`
    is False; `emit` returns None without building an Event).

    `sync` is the optional device-synchronization callable spans use to
    time device work correctly (the serving engine passes a wrapper of
    `torch.cuda.synchronize`; obs itself imports no accelerator stack).
    Thread-safe fan-out: sinks guard their own writes;
    the span stack is thread-local so a background checkpoint thread's
    spans don't corrupt the training loop's nesting.
    """

    def __init__(self, sinks: Iterable = (), *, clock: Optional[Clock] = None,
                 sync: Optional[Callable[[Any], Any]] = None,
                 run_id: Optional[str] = None):
        self.sinks = list(sinks)
        self.clock = clock or SystemClock()
        self.sync_fn = sync
        self.run_id = run_id
        self._local = threading.local()

    @property
    def enabled(self) -> bool:
        return bool(self.sinks)

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def emit(self, kind: str, *, step: Optional[int] = None,
             **data) -> Optional[Event]:
        """Record one event. Returns the Event, or None when disabled.
        `kind` must match `category[/name]` (lowercase, [a-z0-9_.])."""
        if not self.sinks:
            return None
        if not _KIND_RE.match(kind):
            raise ValueError(f"bad event kind {kind!r} (want "
                             f"'category/name', lowercase)")
        if self.run_id is not None:
            data.setdefault("run", self.run_id)
        ev = Event(kind=kind, t=self.clock.time(),
                   step=None if step is None else int(step), data=data)
        for s in self.sinks:
            s.write(ev)
        return ev

    def span(self, name: str, *, step: Optional[int] = None, **data):
        """Open a nestable timed region (see `obs.trace.Span`); use as a
        context manager. Emits a `"span"` event at exit."""
        from repro_torch.obs.trace import Span
        return Span(self, name, step=step, data=data)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


#: Shared no-op recorder: instrumented call sites default to this so the
#: un-observed path costs one truthiness check.
NULL_RECORDER = Recorder()
