"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json`, `bench/`
and the port under `src/repro_torch`. With `--trace 0` the last line of
standard output is the result with the cell's end-to-end metrics, with
`--trace 1` with its per-layer metrics (a second, profiled sub-window
after the timed one); the check's numbers and their limits are the last
lines of standard error. The run exits non-zero, with no result, where
there is no CUDA device or fewer than the cell asks for, where a file is
missing, or where JAX or the JAX package was loaded.

Every build and kernel cache stays in fixed directories of the checkout:
the port's nvcc libraries in build/repro_torch/ (its own choice), and
here CUDA's and Triton's caches and PyTorch's extension directory under
build/cache/.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
BENCH = os.path.dirname(os.path.abspath(__file__))
THREADS = 2         # host threads of PyTorch's CPU ops (the data's draws)


def _cache_dirs() -> None:
    cache = os.path.join(ROOT, "build", "cache")
    for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _cache_dirs()
    for need in (os.path.join(ROOT, "BENCHMARK.json"),
                 os.path.join(ROOT, "src", "repro_torch")):
        if not os.path.exists(need):
            print(f"missing {need}: run from the root of a checkout of "
                  f"the repository", file=sys.stderr)
            return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), BENCH]
    import torch
    torch.set_num_threads(THREADS)
    from harness.cells import load_cell
    from harness.runner import forbidden_modules, run_cell
    chips = load_cell(ROOT, a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    res, lines = run_cell(ROOT, a.workload, a.seed, a.seconds,
                          bool(a.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
