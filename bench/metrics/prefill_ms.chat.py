"""prefill_ms.chat: the median of the engine's "serve/admit" spans in the
window: one request's admission, its one-shot prefill, the insert into
its lane and the host read of its first token, with which the span
ends."""
import statistics


def read(r):
    d = [s["dur_us"] for s in r.spans if s.get("name") == "serve/admit"
         and s["t"] <= r.window["close"]]
    return statistics.median(d) / 1e3 if d else None
