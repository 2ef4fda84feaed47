"""Counters, gauges, and histograms with label support (DESIGN.md §12);
a copy of `repro.obs.metrics` kept in the port.

A `MetricsRegistry` is the process-local metrics plane the serve engine
(and any other component) updates in-band: `registry.counter(name)`
returns a metric *family*; `family.labels(lane="3")` returns the child
series for one label set (the Prometheus data model). Families with no
declared labels act directly as their single unlabeled series.

Exposition: `registry.render_prometheus()` produces the text format the
node-exporter textfile collector ingests (`sinks.PrometheusTextfileSink`
writes it atomically); `registry.to_dict()` is the JSON-friendly snapshot
tests and benchmarks consume. Stdlib-only and thread-safe (one lock per
series; the registry dict is guarded too).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

# TTFT/latency-shaped default buckets (seconds): sub-ms to minutes.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0)

_VALID_TYPES = ("counter", "gauge", "histogram")


class _Series:
    """One (metric, label-values) time series."""

    def __init__(self, kind: str, buckets: Tuple[float, ...] = ()):
        self.kind = kind
        self._lock = threading.Lock()
        self._value = 0.0
        if kind == "histogram":
            self.buckets = tuple(sorted(buckets))
            self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf
            self._sum = 0.0
            self._n = 0

    # counter / gauge -----------------------------------------------------
    def inc(self, v: float = 1.0) -> None:
        if self.kind == "counter" and v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        if self.kind != "gauge":
            raise ValueError("dec() is gauge-only")
        with self._lock:
            self._value -= v

    def set(self, v: float) -> None:
        if self.kind != "gauge":
            raise ValueError("set() is gauge-only")
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    # histogram -----------------------------------------------------------
    def observe(self, v: float) -> None:
        if self.kind != "histogram":
            raise ValueError("observe() is histogram-only")
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[int]:
        """Cumulative counts per bucket boundary (Prometheus `le`
        semantics), ending with the +Inf bucket (== count)."""
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out


class Metric:
    """A metric family: name, help text, declared label names, and one
    `_Series` per observed label-value combination. With no declared
    labels the family proxies its single series, so
    `registry.counter("x").inc()` just works."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        if kind not in _VALID_TYPES:
            raise ValueError(f"kind must be one of {_VALID_TYPES}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = buckets if kind == "histogram" else ()
        self._series: Dict[Tuple[str, ...], _Series] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._series[()] = _Series(kind, self._buckets)

    def labels(self, **kv: str) -> _Series:
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kv)} != declared "
                             f"{sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series(self.kind, self._buckets)
            return s

    def _only(self) -> _Series:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             f"use .labels(...)")
        return self._series[()]

    # unlabeled-family proxies
    def inc(self, v: float = 1.0) -> None:
        self._only().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._only().dec(v)

    def set(self, v: float) -> None:
        self._only().set(v)

    def observe(self, v: float) -> None:
        self._only().observe(v)

    @property
    def value(self) -> float:
        return self._only().value

    @property
    def count(self) -> int:
        return self._only().count

    @property
    def sum(self) -> float:
        return self._only().sum

    def series(self) -> Dict[Tuple[str, ...], _Series]:
        with self._lock:
            return dict(self._series)


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_val(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Named collection of metric families. Re-registering the same name
    with the same kind returns the existing family (idempotent); a kind
    mismatch is an error."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str,
             labelnames: Iterable[str],
             buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(f"{name} already registered as "
                                     f"{m.kind}, not {kind}")
                return m
            m = Metric(name, kind, help, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Metric:
        return self._get(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Metric:
        return self._get(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Metric:
        return self._get(name, "histogram", help, labelnames, buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- exposition -------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4): HELP/TYPE headers,
        one line per series; histograms expose cumulative `_bucket{le=}`
        plus `_sum`/`_count`."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for lv, s in sorted(m.series().items()):
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{m.name}{_fmt_labels(m.labelnames, lv)} "
                                 f"{_fmt_val(s.value)}")
                else:
                    cum = s.bucket_counts()
                    edges = [*(str(b) for b in s.buckets), "+Inf"]
                    for le, c in zip(edges, cum):
                        lab = _fmt_labels(m.labelnames, lv, f'le="{le}"')
                        lines.append(f"{m.name}_bucket{lab} {c}")
                    lab = _fmt_labels(m.labelnames, lv)
                    lines.append(f"{m.name}_sum{lab} {_fmt_val(s.sum)}")
                    lines.append(f"{m.name}_count{lab} {s.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> dict:
        """JSON-friendly snapshot {name: {kind, series: {label_repr:
        value-or-histogram-summary}}} for tests and BENCH_* records."""
        out = {}
        for m in self.metrics():
            series = {}
            for lv, s in m.series().items():
                key = ",".join(f"{n}={v}"
                               for n, v in zip(m.labelnames, lv)) or ""
                if m.kind == "histogram":
                    series[key] = {"count": s.count, "sum": s.sum}
                else:
                    series[key] = s.value
            out[m.name] = {"kind": m.kind, "series": series}
        return out
