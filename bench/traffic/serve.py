"""Serving traffic through the port's `ServeEngine.submit` / `step`.

A mix draws a pool of requests: prompt and output lengths lognormal
(median, sigma, clipped to [min, max]) and the arrival gaps, in one
order, all from the mix's own `sizes_seed`, so every run replays the same
schedule of sizes and arrivals; the run's seed draws the prompts' token
ids (uniform over the vocabulary), the weights and the check's sample.
(Dealt out in another order a seed, the same set moved the chat mix's
ITL p95 by 27% and its TTFT p95 by 17%: which long prompts arrive
together decides the stalls.) Every request is greedy and runs to its
output length (no EOS), so the work is the schedule.

Two loops ("loop" in the mix):
  closed  `clients` clients, each submitting its next request when its
          last completes. The window opens once `warmup_completions`
          requests have completed.
  open    one short request warms the engine (its first prefill and
          the captured tick), then Poisson arrivals at `rate`
          requests/s. The window opens after `warmup_s` of arrivals
          and lasts `--seconds`; arrivals go on after it closes until
          every request due in the window has its first token.
Set-up (`setup_s`) is everything before the window opens: the weights,
the engine, the kernels' first use and the warm-up traffic.

Times are the host's clock when the harness holds a token: at the return
of `submit` (a request admitted at once has its first token then) or of
`step`. Per request: due time, first token, and every token's time.

End-to-end: `serve_tokens_per_s`, output tokens delivered in the window
over the window; `ttft_p50_ms`, the median over the requests due in the
window of first token minus due time (its 90th and 95th percentiles are
logged beside it); `itl_p95_ms`, the 95th percentile of every gap between
successive tokens whose later token lands in the window, all requests
pooled.

With `--trace 1` the window runs with a recorder (the engine's spans,
kept from the window's open to the end of the run-on), then
`trace_steps` more engine steps run under the profiler.

The check: once the window has closed and the engine is freed, a sample
drawn from the seed of the finished requests, the one with the most
served tokens in it, `check.requests` in all; the reference runs once
over each prompt and its served tokens, and `logit_gap` is the widest gap
by which a served token's reference logit lies below the reference's best
at its position.

Mix keys: kind "serve", loop, lanes, ctx_len, pool, sizes_seed, prompt
and output ({median, sigma, min, max}), clients and warmup_completions
(closed), rate and warmup_s (open), trace_steps.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import profiling, weights, yardstick
from harness.cells import regions_of
from harness.runner import Outcome, Reading, free

MIX_SEED = 0x5E7E


class Pool:
    """The mix's requests: plen[i], olen[i] and the arrival offset due[i]
    (seconds from the start of traffic) of request i, cycling over `pool`
    entries, all from the mix's `sizes_seed`; prompt(i) its token ids,
    from the run's seed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        n = mix["pool"]
        rs = np.random.default_rng([mix["sizes_seed"], MIX_SEED])

        def lengths(spec):
            x = np.exp(math.log(spec["median"])
                       + spec["sigma"] * rs.standard_normal(n))
            return np.clip(np.rint(x), spec["min"], spec["max"]).astype(int)

        plen, olen = lengths(mix["prompt"]), lengths(mix["output"])
        gaps = np.zeros(n)
        if mix["loop"] == "open":
            gaps = rs.exponential(1.0 / float(mix["rate"]), n)
        self.plen, self.olen = plen, olen
        self.cum = np.cumsum(gaps)
        self.n, self.vocab, self.seed = n, vocab, int(seed)

    def due(self, i: int) -> float:
        """Arrival offset of request i."""
        laps, j = divmod(i, self.n)
        return laps * float(self.cum[-1]) + float(self.cum[j])

    def lengths(self, i: int):
        return int(self.plen[i % self.n]), int(self.olen[i % self.n])

    def prompt(self, i: int) -> List[int]:
        g = np.random.default_rng([self.seed & (2**63 - 1), i])
        return g.integers(0, self.vocab, self.lengths(i)[0]).tolist()


@dataclasses.dataclass
class Req:
    i: int
    due: float
    prompt: List[int]
    olen: int
    toks: List[int] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.toks) >= self.olen


class PerfClock:
    """The recorder's clock: events stamped on the harness's own host
    clock (time.perf_counter), so a span's start is its stamp minus its
    duration."""

    def time(self) -> float:
        return time.perf_counter()

    def perf(self) -> float:
        return time.perf_counter()


class Clients:
    """The engine and the requests it serves, with each token's host
    time."""

    def __init__(self, ctx, eng, pool: Pool):
        self.ctx, self.eng, self.pool = ctx, eng, pool
        self.reqs: Dict[int, Req] = {}
        self.step_out = ctx.hook("step_out", lambda out: out)
        self.late = 0.0
        self.log_steps: Optional[list] = None   # (prefills, decoded) a step

    def submit(self, i: int, due: float) -> int:
        eng = self.eng
        plen, olen = self.pool.lengths(i)
        prompt = self.pool.prompt(i)
        t = time.perf_counter()
        self.late = max(self.late, t - due)
        rid = eng.submit(prompt, max_new_tokens=olen)
        now = time.perf_counter()
        r = self.reqs[rid] = Req(i, due, prompt, olen)
        if not (eng.pending and eng.pending[-1][0] == rid):
            # admitted at once: its prefill gave the first token
            s = next(s for s in eng.slots if s is not None and s.rid == rid)
            self._got(r, self.step_out({rid: s.tokens[0]})[rid], now)
            if self.log_steps is not None:
                self.log_steps.append(([plen], 0))
        return rid

    def _got(self, r: Req, tok: int, now: float) -> None:
        r.toks.append(int(tok))
        r.times.append(now)

    def step(self) -> List[int]:
        """One engine step; returns the rids it completed."""
        out = self.step_out(self.eng.step())
        now = time.perf_counter()
        done, prefills, decoded = [], [], 0
        for rid, tok in out.items():
            r = self.reqs[rid]
            if r.toks:
                decoded += 1
            else:
                prefills.append(len(r.prompt))
            self._got(r, tok, now)
            if r.done:
                done.append(rid)
        if self.log_steps is not None:
            self.log_steps.append((prefills, decoded))
        return done

    def busy(self) -> bool:
        return any(s is not None for s in self.eng.slots) or \
            bool(self.eng.pending)


def pct(values, q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _closed(d: Clients, mix: dict, seconds: float, t0: float):
    """Closed loop; returns (t_open, t_close, advance)."""
    nxt = 0
    for _ in range(mix["clients"]):
        d.submit(nxt, time.perf_counter())
        nxt += 1
    done = 0

    def advance():
        nonlocal nxt, done
        for _ in d.step():
            done += 1
            d.submit(nxt, time.perf_counter())
            nxt += 1

    while done < mix["warmup_completions"]:
        advance()
    t_open = time.perf_counter()
    while True:
        advance()
        if time.perf_counter() - t_open >= seconds:
            break
    return t_open, time.perf_counter(), advance


def warm(eng, pool: Pool, n_new: int = 4) -> None:
    """Build and load what the first prefill and the first ticks use (the
    kernel libraries, the captured tick) before the traffic starts: one
    request of the pool's first prompt, `n_new` tokens, not counted."""
    eng.submit(pool.prompt(0), max_new_tokens=n_new)
    while any(s is not None for s in eng.slots) or eng.pending:
        eng.step()


def _open(d: Clients, mix: dict, seconds: float, t0: float,
          run_on: bool = True):
    """Open loop; returns (t_open, t_close, advance). With `run_on` the
    arrivals go on after the close until every request due in the window
    has its first token."""
    pool = d.pool
    state = {"i": 0}
    t_open = t0 + mix["warmup_s"]
    t_close = t_open + seconds

    def advance():
        now = time.perf_counter()
        while t0 + pool.due(state["i"]) <= now:
            d.submit(state["i"], t0 + pool.due(state["i"]))
            state["i"] += 1
        if d.busy():
            d.step()
        else:
            time.sleep(max(0.0, min(t0 + pool.due(state["i"]) - now, 1e-3)))

    while time.perf_counter() < t_open:
        advance()
    while time.perf_counter() < t_close:
        advance()
    while run_on and any(not r.toks for r in d.reqs.values()
                         if t_open <= r.due < t_close):
        advance()
    return t_open, t_close, advance


def _window_numbers(d: Clients, t_open: float, t_close: float, model: dict):
    """(tokens delivered, FLOPs processed, ITL gaps) in the window."""
    toks, flops, gaps = 0, 0.0, []
    for r in d.reqs.values():
        plen = len(r.prompt)
        for j, t in enumerate(r.times):
            if not t_open < t <= t_close:
                continue
            toks += 1
            flops += yardstick.prefill_flops(model, plen) if j == 0 else \
                yardstick.decode_flops(model, plen + j - 1)
            if j > 0:
                gaps.append(t - r.times[j - 1])
    return toks, flops, gaps


def _sample(d: Clients, seed: int, n: int) -> List[Req]:
    """n finished requests drawn from the seed, the one with the most
    served tokens among them."""
    done = sorted((r for r in d.reqs.values() if r.done),
                  key=lambda r: (r.i, r.due))
    if not done:
        return []
    longest = max(done, key=lambda r: (r.olen, len(r.prompt)))
    rest = [r for r in done if r is not longest]
    g = np.random.default_rng([int(seed) & (2**63 - 1), 0xC0DE])
    pick = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[k] for k in sorted(pick)]


def served_positions(r: Req):
    """(sequence [plen + olen - 1], rows): the prompt and the served
    tokens but the last, and the rows whose logits chose each served
    token."""
    seq = r.prompt + r.toks[:-1]
    plen = len(r.prompt)
    return seq, list(range(plen - 1, plen - 1 + len(r.toks)))


def reference_gaps(model: dict, seed: int, dev, sample: List[Req],
                   choose=None) -> float:
    """The widest gap, over the sample's served tokens, by which the
    reference's logit of the token lies below its best at that position;
    `choose(r)` gives other tokens to judge in place of the served ones
    (the control's)."""
    from reference import for_model
    ref = for_model(model)
    params = ref.to_f32(weights.make_weights(model, seed, dev))
    worst = 0.0
    for r in sample:
        seq, rows = served_positions(r)
        toks = r.toks if choose is None else choose(r)
        lg = ref.logits_at(params, torch.tensor(seq, device=dev), rows, model)
        t = torch.tensor(toks, device=dev)
        gap = lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0]
        g = float(gap.max())
        worst = max(worst, g if math.isfinite(g) else math.inf)
        del lg
    del params
    free(dev)
    return worst


def build_engine(ctx, recorder=None):
    from repro_torch.precision import parse_policy
    from repro_torch.serve import ServeEngine
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    params = weights.make_weights(cfg.model, ctx.seed, dev)
    eng = ServeEngine(cfg.arch(), params, parse_policy(ctx.precision),
                      max_batch=mix["lanes"], ctx_len=mix["ctx_len"],
                      recorder=recorder, device=dev)
    del params
    free(dev)
    return eng


def run(ctx) -> Outcome:
    from repro_torch.obs import MemorySink, Recorder
    cell, mix, dev = ctx.cell, ctx.cell.mix, ctx.device
    model = cell.config.model
    sink = MemorySink() if ctx.trace else None
    rec = Recorder([sink], clock=PerfClock()) if ctx.trace else None
    eng = build_engine(ctx, rec)
    pool = Pool(mix, model["vocab_size"], ctx.seed)
    d = Clients(ctx, eng, pool)
    if mix["loop"] == "open":
        warm(eng, pool)
    t0 = time.perf_counter()
    loop = _closed if mix["loop"] == "closed" else _open
    t_open, t_close, advance = loop(d, mix, ctx.seconds, t0)
    setup_s = t_open - ctx.t_start
    window_s = t_close - t_open
    toks, flops, gaps = _window_numbers(d, t_open, t_close, model)
    due = [r for r in d.reqs.values() if t_open <= r.due < t_close]
    ttft = [r.times[0] - r.due for r in due if r.toks]
    completed = sum(1 for r in d.reqs.values()
                    if r.done and t_open < r.times[-1] <= t_close)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.log(f"set-up {setup_s:.4f} s; window {window_s:.4f} s: {toks} "
            f"tokens, {completed} requests completed, {len(due)} due, "
            f"{len(gaps)} gaps; generator late by at most "
            f"{1e3 * d.late:.3f} ms; peak {peak / 2**30:.3f} GiB")
    e2e = {"setup_s": setup_s, "serve_tokens_per_s": toks / window_s}
    if ttft:
        q = {f"ttft_p{p}_ms": 1e3 * pct(ttft, p) for p in (50, 90, 95)}
        ctx.log("TTFT " + ", ".join(f"{k} {v:.4f}" for k, v in q.items()))
        e2e["ttft_p50_ms"] = q["ttft_p50_ms"]
    if gaps:
        e2e["itl_p95_ms"] = 1e3 * pct(gaps, 95)
    reading = None
    if ctx.trace:
        spans = [dict(e.data, t=e.t) for e in sink.events
                 if e.kind == "span" and t_open <= e.t]
        trace, sub = None, {}
        if dev.type == "cuda":
            k = mix["trace_steps"]
            d.log_steps = []

            def steps():
                for _ in range(k):
                    advance()
            sink.events.clear()
            prof = profiling.traced(steps, regions_of(cell.per_layer))
            trace = profiling.read_trace(prof, regions_of(cell.per_layer))
            del prof
            prefills = [p for ps, _ in d.log_steps for p in ps]
            decoded = [n for _, n in d.log_steps if n]
            sub = {"prefills": prefills, "ticks": decoded,
                   "gemm_least_s": yardstick.serve_gemm_least_s(
                       model, prefills, decoded)}
        reading = Reading(
            cell=cell, trace=trace, spans=spans, sub=sub,
            window={"seconds": window_s, "close": t_close, "tokens": toks,
                    "flops": flops,
                    "due": {rid: r.due for rid, r in d.reqs.items()
                            if t_open <= r.due < t_close}})
    sample = _sample(d, ctx.seed, cell.check.get("requests", 6))
    # an open loop's requests due in the window are its attempts, and one
    # that never got a token failed; a closed loop's are its completions
    attempted = len(due) if mix["loop"] == "open" else completed
    failed = sum(1 for r in due if not r.toks) \
        if mix["loop"] == "open" else 0
    del eng, d.eng
    free(dev)
    t_ref = time.perf_counter()
    numbers = {"logit_gap": reference_gaps(model, ctx.seed, dev, sample)
               if sample else math.inf}
    ctx.log(f"reference {time.perf_counter() - t_ref:.4f} s over "
            f"{len(sample)} requests, "
            f"{sum(len(r.toks) for r in sample)} served tokens")
    ctx.extra["sample"] = sample
    return Outcome(e2e=e2e, reading=reading, numbers=numbers,
                   attempted=attempted, failed=failed, peak_bytes=peak)
