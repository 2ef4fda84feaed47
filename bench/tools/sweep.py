"""Find the highest arrival rate an open-loop serving cell sustains.

    python3 bench/tools/sweep.py --workload yi9b-serve-chat \
        --rates 1.0 1.5 2.0 2.5 3.0 [--seconds 30] [--seed 7]

Run from the root of a checkout on the chip. For each rate it builds the
cell's engine afresh, offers the cell's mix at that rate (the same pool
of sizes, Poisson gaps scaled to the rate) for the mix's `warmup_s` and
then `--seconds`, and reports, over the requests due in that window:
output tokens a second, TTFT p50 and p95 (a request still without a
first token at the close counts its wait so far), ITL p95, the queue at
the close, and the p95 TTFT of the window's first and second halves. A
rate is sustained when no queue is left at the close and the second
half's TTFT is not far above the first's. Lines go to standard output
and to chiprun_out/sweep-<cell>.jsonl.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.getcwd()
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), BENCH]


def one_rate(ctx, rate, seconds):
    import numpy as np
    gen = ctx.cell.generator
    mix = dict(ctx.cell.mix, rate=rate)
    eng = gen.build_engine(ctx)
    pool = gen.Pool(mix, ctx.cell.config.model["vocab_size"], ctx.seed)
    d = gen.Clients(ctx, eng, pool)
    gen.warm(eng, pool)
    t_open, t_close, _ = gen._open(d, mix, seconds, time.perf_counter(),
                                   run_on=False)
    end = time.perf_counter()
    wait = lambda r: (r.times[0] if r.toks else end) - r.due
    due = [r for r in d.reqs.values() if t_open <= r.due < t_close]
    half = t_open + seconds / 2
    toks, _, gaps = gen._window_numbers(d, t_open, t_close,
                                        ctx.cell.config.model)
    pct = lambda v, q: 1e3 * float(np.percentile(v, q)) if v else None
    out = {"rate": rate, "due": len(due), "tokens_per_s": toks / seconds,
           "ttft_p50_ms": pct([wait(r) for r in due], 50),
           "ttft_p95_ms": pct([wait(r) for r in due], 95),
           "itl_p95_ms": pct(gaps, 95),
           "ttft_p95_first_half_ms": pct([wait(r) for r in due
                                          if r.due < half], 95),
           "ttft_p95_second_half_ms": pct([wait(r) for r in due
                                           if r.due >= half], 95),
           "queue_close": len(eng.pending),
           "unserved": sum(1 for r in due if not r.toks),
           "late_ms": 1e3 * d.late}
    del d, eng
    gen.free(ctx.device)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    from harness.runner import make_context
    out_dir = os.path.join(ROOT, "chiprun_out")
    for rate in a.rates:
        ctx = make_context(a.root, a.workload, a.seed, a.seconds, False,
                           device=a.device)
        line = json.dumps(dict(one_rate(ctx, rate, a.seconds),
                               cell=a.workload, seed=a.seed))
        print(line, flush=True)
        if os.path.isdir(out_dir):
            with open(os.path.join(out_dir, f"sweep-{a.workload}.jsonl"),
                      "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
