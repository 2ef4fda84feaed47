"""The port's run-log and Prometheus sinks (`repro_torch.obs.sinks`)
against the reference's (`repro.obs.sinks`): the same events, recorded
through each package's Recorder on a ManualClock, give the same bytes.

* JSONL lines byte for byte, appended and truncated;
* size-based rotation at the same sizes and `backups` counts (every
  rotated file byte-equal);
* the `.prom` text for the same registry operations, at the same event
  counts;
* `MemorySink` keeps each writer's events in order under two threads;
* both packages refuse the same bad arguments.

Both packages are stdlib-only here, so nothing runs on a device.
"""
import os
import sys
import threading

import pytest

from repro import obs as jobs
from repro_torch import obs as tobs


def _drive(obs, sinks, n=12):
    """A fixed event stream: spans, serve events, one with a step, unicode
    and nested data, on a ManualClock."""
    clock = obs.ManualClock(t0=1000.0)
    rec = obs.Recorder(sinks, clock=clock, run_id="r1")
    for i in range(n):
        clock.advance(0.125)
        with rec.span("serve/step", active=i % 3, lanes=8):
            clock.advance(0.0625 * (i + 1))
        rec.emit("serve/admit", rid=i, lane=i % 4, plen=17 + i,
                 ttft_s=0.001 * i, queued=0, resumed=bool(i % 2))
        if i % 4 == 0:
            rec.emit("train/progress", step=i, loss=2.5 - i / 10,
                     note="α≈β", nested={"a": [1, 2, {"b": None}]})
    return rec


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _files(d):
    return {n: _read(os.path.join(d, n)) for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("mode", ["a", "w"])
def test_jsonl_lines_match_reference(tmp_path, mode):
    out = {}
    for name, obs in (("ref", jobs), ("port", tobs)):
        path = tmp_path / name / "run.jsonl"
        path.parent.mkdir()
        path.write_text('{"stale": true}\n')
        sink = obs.JSONLSink(str(path), mode=mode)
        _drive(obs, [sink]).close()
        out[name] = _read(path)
    assert out["port"] == out["ref"]
    assert out["port"].count(b"\n") == 12 * 2 + 3 + (mode == "a")


@pytest.mark.parametrize("max_bytes,backups", [(300, 0), (300, 2),
                                               (700, 3), (1, 1)])
def test_rotation_matches_reference(tmp_path, max_bytes, backups):
    got = {}
    for name, obs in (("ref", jobs), ("port", tobs)):
        d = tmp_path / name
        sink = obs.JSONLSink(str(d / "run.jsonl"), max_bytes=max_bytes,
                             backups=backups, mode="w")
        _drive(obs, [sink]).close()
        got[name] = _files(d)
    assert got["port"] == got["ref"]
    names = set(got["port"])
    assert names <= {"run.jsonl", *(f"run.jsonl.{i}"
                                    for i in range(1, backups + 1))}
    if backups:
        assert f"run.jsonl.{backups}" in names     # rotation happened
    # rotation never splits a line
    for blob in got["port"].values():
        assert not blob or blob.endswith(b"\n")


def _registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("serve_tokens_total", "tokens generated").inc(7)
    g = reg.gauge("serve_active_lanes", "lanes occupied",
                  labelnames=("engine",))
    g.labels(engine="paged").set(3)
    g.labels(engine="slab").set(0.5)
    h = reg.histogram("serve_ttft_seconds", "submit-to-first-token")
    for v in (0.004, 0.03, 0.2, 1.5, 40.0):
        h.observe(v)
    return reg


@pytest.mark.parametrize("every", [1, 5, 50])
def test_prometheus_text_matches_reference(tmp_path, every):
    got = {}
    for name, obs in (("ref", jobs), ("port", tobs)):
        reg = _registry(obs)
        path = tmp_path / name / "serve.prom"
        sink = obs.PrometheusTextfileSink(str(path), reg, every=every)
        _drive(obs, [sink], n=2)          # 2·2 + 1 = 5 events
        dumped = path.exists()
        reg.counter("serve_tokens_total").inc(1)
        sink.flush()
        got[name] = (dumped, _read(path))
        assert not os.path.exists(str(path) + ".tmp")
    assert got["port"] == got["ref"]
    assert got["port"][0] == (every <= 5)
    assert b"serve_tokens_total 8" in got["port"][1]


def test_memory_sink_keeps_order_under_two_writers():
    sink = tobs.MemorySink()
    rec = tobs.Recorder([sink], clock=tobs.ManualClock())
    n = 2000
    start = threading.Barrier(2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def writer(w):
            start.wait(timeout=10)
            for i in range(n):
                rec.emit("serve/queue", rid=i, depth=w)

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(sink.events) == 2 * n
    assert sink.kinds() == ["serve/queue"] * (2 * n)
    for w in range(2):
        seq = [e.data["rid"] for e in sink.events if e.data["depth"] == w]
        assert seq == list(range(n))
    assert len(sink.of_kind("serve/queue")) == 2 * n


@pytest.mark.parametrize("make", [
    lambda obs, p: obs.JSONLSink(p, mode="x"),
    lambda obs, p: obs.JSONLSink(p, max_bytes=0),
    lambda obs, p: obs.PrometheusTextfileSink(p, obs.MetricsRegistry(),
                                              every=0),
])
def test_bad_arguments_refused_like_reference(tmp_path, make):
    for obs in (jobs, tobs):
        with pytest.raises(ValueError):
            make(obs, str(tmp_path / "x"))


def test_closed_jsonl_sink_flushes_quietly(tmp_path):
    """Both packages: close is idempotent and flush after close is a
    no-op, so a Recorder closed twice (a Trainer's finally) never
    raises."""
    for obs in (jobs, tobs):
        sink = obs.JSONLSink(str(tmp_path / f"{obs.__name__}.jsonl"))
        sink.close()
        sink.close()
        sink.flush()
        assert isinstance(sink, obs.Sink)
