"""Run-log and metrics plane of the port (DESIGN.md §12): stdlib-only
copies of the reference's `obs.events`, `obs.metrics` and `obs.trace`."""
from repro_torch.obs.events import (KINDS, NULL_RECORDER, SCHEMA_VERSION,
                                    Clock, Event, ManualClock, Recorder,
                                    SystemClock)
from repro_torch.obs.metrics import DEFAULT_BUCKETS, Metric, MetricsRegistry
from repro_torch.obs.trace import Span, time_fn

__all__ = ["Clock", "DEFAULT_BUCKETS", "Event", "KINDS", "ManualClock",
           "Metric", "MetricsRegistry", "NULL_RECORDER", "Recorder",
           "SCHEMA_VERSION", "Span", "SystemClock", "time_fn"]
