"""queue_ms.chat: the median, over the requests due in the window that
were admitted by the end of the run-on, of the wait from when a request
was due to the start of its first "serve/admit" span (a lane takes it:
the wait for a free lane and for the harness to submit it between
engine steps)."""
import statistics


def read(r):
    due, start = r.window.get("due", {}), {}
    for s in r.spans:
        if s.get("name") == "serve/admit" and s.get("rid") in due:
            start.setdefault(s["rid"], s["t"] - s["dur_us"] / 1e6)
    d = [t - due[rid] for rid, t in start.items()]
    return 1e3 * statistics.median(d) if d else None
