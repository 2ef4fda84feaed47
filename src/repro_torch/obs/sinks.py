"""Event sinks: where a Recorder's events land (DESIGN.md §12); a copy of
`repro.obs.sinks` kept in the port, which imports nothing of the
reference package.

  * `JSONLSink` — the run-log: one JSON object per line, size-based
    rotation (`run.jsonl` → `run.jsonl.1` → … up to `backups`), flushed
    per write so `analysis/report.py --follow` can tail a live run;
  * `PrometheusTextfileSink` — node-exporter textfile-collector
    exposition: atomically rewrites a `.prom` file from a
    `metrics.MetricsRegistry` every `every` events (and on flush/close);
  * `MemorySink` — in-memory event list for tests.

All sinks serialize writes under a lock: the background checkpoint thread
and the training loop may emit concurrently.
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

from repro_torch.obs.events import Event


class Sink:
    def write(self, event: Event) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class MemorySink(Sink):
    """Test sink: retains every event in order."""

    def __init__(self):
        self.events: List[Event] = []
        self._lock = threading.Lock()

    def write(self, event: Event) -> None:
        with self._lock:
            self.events.append(event)

    def kinds(self) -> List[str]:
        return [e.kind for e in self.events]

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]


class JSONLSink(Sink):
    """Append-only JSONL run-log with size-based rotation.

    When the file exceeds `max_bytes` after a write, it rotates:
    `path` → `path.1`, `path.1` → `path.2`, …; anything beyond `backups`
    rotated files is deleted. `max_bytes=None` disables rotation. Writes
    are line-buffered and flushed per event so a follower (`report.py
    --follow`) sees complete lines promptly; rotation never splits a line.
    `mode="w"` truncates an existing log (fresh-run semantics); the
    default `"a"` appends.
    """

    def __init__(self, path: str, *, max_bytes: Optional[int] = None,
                 backups: int = 3, mode: str = "a"):
        if mode not in ("a", "w"):
            raise ValueError(f"mode must be 'a' or 'w', got {mode!r}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.path = path
        self.max_bytes = max_bytes
        self.backups = int(backups)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, mode)
        self._size = self._f.tell() if mode == "a" else 0

    def write(self, event: Event) -> None:
        line = json.dumps(event.to_json(), sort_keys=True) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()
            self._size += len(line)
            if self.max_bytes is not None and self._size > self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.backups, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                if i == self.backups:
                    os.remove(src)
                else:
                    os.replace(src, f"{self.path}.{i + 1}")
        if self.backups > 0:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._f = open(self.path, "w")
        self._size = 0

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class PrometheusTextfileSink(Sink):
    """Exposition for the node-exporter textfile collector: rewrites
    `path` (atomic tmp+rename, the collector's required discipline) from
    `registry.render_prometheus()` every `every` events and on
    flush/close. Events themselves are not serialized — this sink exists
    to publish the *metrics* registry (counters/gauges/histograms) that
    instrumented components update out-of-band of the event stream."""

    def __init__(self, path: str, registry, *, every: int = 50):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = path
        self.registry = registry
        self.every = int(every)
        self._n = 0
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, event: Event) -> None:
        with self._lock:
            self._n += 1
            if self._n % self.every == 0:
                self._dump()

    def _dump(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.registry.render_prometheus())
        os.replace(tmp, self.path)

    def flush(self) -> None:
        with self._lock:
            self._dump()
