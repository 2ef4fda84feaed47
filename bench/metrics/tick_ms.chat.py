"""tick_ms.chat: the median of the engine's synced "serve/step" spans in
the window (one generate tick each: host bookkeeping, the graphed
decode, sampling and the host read of the tokens)."""
import statistics


def read(r):
    d = [s["dur_us"] for s in r.spans
         if s.get("name") == "serve/step" and s.get("synced")
         and s["t"] <= r.window["close"]]
    return statistics.median(d) / 1e3 if d else None
