"""Run one cell several times, each run a fresh process as the check runs
it, and summarize the spread of each metric.

    python3 bench/tools/runs.py --workload <cell> --seeds 11 12 13 \
        [--seconds 30] [--trace 0] [--tag set1]

Run from the root of a checkout on the chip. Each run's last line (the
result) is appended to chiprun_out/runs-<cell>-<tag>.jsonl with its seed
and exit code, and the end of its standard error (the check's numbers)
is kept beside it. The summary gives, for each metric, the median, the
quartiles (`statistics.quantiles(values, n=4)`) and their distance as a
share of the median, and the numbers the check compared with the largest
reading of each.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    """(median, q1, q3, (q3 - q1) / median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, med, med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / abs(med) if med else float("inf")


def summarize(rows):
    by = {}
    for r in rows:
        for k, m in r.get("metrics", {}).items():
            by.setdefault(k, []).append(m["value"])
    out = {k: dict(zip(("median", "q1", "q3", "spread"), spread(v)),
                   n=len(v)) for k, v in by.items()}
    checks = {}
    for r in rows:
        for k, c in r.get("checks", {}).items():
            checks.setdefault(k, []).append(c["value"])
    out["checks_max"] = {k: max(v) for k, v in checks.items()}
    out["correct"] = sum(bool(r.get("correct")) for r in rows)
    out["runs"] = len(rows)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--tag", default="runs")
    a = p.parse_args(argv)
    secs = a.seconds
    if secs is None:
        secs = json.load(open("BENCHMARK.json"))["run_seconds"]
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"runs-{a.workload}-{a.tag}.jsonl")
    rows = []
    for s in a.seeds:
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                            a.workload, "--seed", str(s), "--seconds",
                            str(secs), "--trace", str(a.trace)],
                           capture_output=True, text=True)
        wall = time.perf_counter() - t
        last = r.stdout.strip().splitlines()[-1:] if r.stdout else []
        try:
            res = json.loads(last[0]) if last else {}
        except json.JSONDecodeError:
            res = {}
        rec = {"seed": s, "rc": r.returncode, "wall_s": wall,
               "result": res, "stdout_tail": r.stdout[-3000:],
               "stderr_tail": r.stderr[-3000:]}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({"seed": s, "rc": r.returncode, "wall_s": wall,
                          **{k: res.get(k) for k in ("correct", "metrics",
                                                     "checks")}}),
              flush=True)
        if res:
            rows.append(res)
        else:
            print(r.stderr[-3000:], flush=True)
    print("SUMMARY " + json.dumps(summarize(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
