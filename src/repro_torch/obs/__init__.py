"""Run-log and metrics plane of the port (DESIGN.md §12): stdlib-only
copies of the reference's `obs.events`, `obs.metrics`, `obs.sinks` and
`obs.trace`."""
from repro_torch.obs.events import (KINDS, NULL_RECORDER, SCHEMA_VERSION,
                                    Clock, Event, ManualClock, Recorder,
                                    SystemClock)
from repro_torch.obs.metrics import DEFAULT_BUCKETS, Metric, MetricsRegistry
from repro_torch.obs.sinks import (JSONLSink, MemorySink,
                                   PrometheusTextfileSink, Sink)
from repro_torch.obs.trace import Span, time_fn

__all__ = ["Clock", "DEFAULT_BUCKETS", "Event", "JSONLSink", "KINDS",
           "ManualClock", "MemorySink", "Metric", "MetricsRegistry",
           "NULL_RECORDER", "PrometheusTextfileSink", "Recorder",
           "SCHEMA_VERSION", "Sink", "Span", "SystemClock", "time_fn"]
