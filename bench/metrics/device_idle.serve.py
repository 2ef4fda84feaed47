"""The device's idle share of the profiled sub-window: the part of it in
which no device operation ran (the union of the operations' intervals
from torch.profiler, `harness.profiling.read_trace`)."""


def read(r):
    t = r.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
