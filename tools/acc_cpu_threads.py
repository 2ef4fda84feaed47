#!/usr/bin/env python3
"""How chip_smoke.py's accuracy CPU half behaves on this host.

    python3 tools/acc_cpu_threads.py [--steps 40] [--no-spin]

Runs two rows of the accuracy phase's smoke grid (fp32 and hbfp8_b16,
`chip_smoke._acc_smoke_losses` on the CPU) in a fresh process at the
default thread count and at 1, 2, 4, 6 and 7 threads, then one row in
four processes at once, first at the default count and then at one
thread each. Prints each run's seconds and whether its losses equal the
default's bit for bit. A spinning process keeps one core busy
throughout, as the card's own process does while the CPU half runs
(`--no-spin` leaves it out). Needs no card.
"""
import argparse
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(names, threads, steps):
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke as cs
    if threads:
        torch.set_num_threads(threads)
    cs.ACC_STEPS = steps
    t0 = time.perf_counter()
    out = cs._acc_smoke_losses("cpu", names)
    return out, time.perf_counter() - t0, torch.get_num_threads()


def _spin():
    while True:
        pass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--no-spin", action="store_true")
    args = ap.parse_args()
    import torch
    print(f"cpu_count {os.cpu_count()}, this process's threads "
          f"{torch.get_num_threads()}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    busy = ctx.Process(target=_spin, daemon=True)
    if not args.no_spin:
        busy.start()
    try:
        base = None
        for th in (0, 1, 2, 4, 6, 7):
            with ProcessPoolExecutor(1, mp_context=ctx) as pool:
                out, s, n = pool.submit(_rows, ("fp32", "hbfp8_b16"), th,
                                        args.steps).result()
            base = out if base is None else base
            print(f"threads {n}{' (default)' if not th else ''}: 2 rows x "
                  f"{args.steps} steps {s:.1f} s; losses equal to the "
                  f"default's: {out == base}; fp32 tail "
                  f"{sum(out['fp32'][-5:]) / 5:.6f}", flush=True)
        for th in (0, 1):
            with ProcessPoolExecutor(4, mp_context=ctx) as pool:
                t0 = time.perf_counter()
                rs = [f.result() for f in [
                    pool.submit(_rows, ("fp32",), th, args.steps)
                    for _ in range(4)]]
            print(f"4 processes of {rs[0][2]} threads, one fp32 row each: "
                  f"wall {time.perf_counter() - t0:.1f} s, each "
                  f"{[round(r[1], 1) for r in rs]} s; equal to the "
                  f"default's: {all(r[0]['fp32'] == base['fp32'] for r in rs)}",
                  flush=True)
    finally:
        if busy.is_alive():
            busy.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
