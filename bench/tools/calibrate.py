"""Readings that the limits of a cell's output check are set from.

    python3 bench/tools/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--variants sound control half_batch] [--seconds 5]

Run from the root of a checkout, on the chip, at the cell's own size,
several seeds in one process. For each seed it prints one JSON line per
variant with the check's numbers (and writes them to
chiprun_out/calibrate-<cell>.jsonl when that directory exists):

  sound       the program as the configuration states it;
  control     the program at the configuration's `control_precision`,
              the next lower precision (HBFP4 for HBFP8): its numbers
              set the upper readings;
  half_batch  (training) the timed path with half of each batch left
              out, the mean taken over the rest: a fault the check has
              to catch.

A training seed runs the reference once and each variant's first
`check_steps` steps against it. A serving seed drives the cell for a
short window (`--seconds`) at its own load, compares the sampled
requests' served tokens (sound), and then reads, at each position of the
same prompts and tokens, the reference's gap of the token that the
control's forward pass puts first (control).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.getcwd()
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), BENCH]


def half_batch(data_fn):
    """The batch with its second half left out: rows, or with one row
    the second half of its tokens."""
    def fn(step):
        b = data_fn(step)
        B, S = b["tokens"].shape
        if B > 1:
            return {k: v[:B // 2] for k, v in b.items()}
        return {k: v[:, :S // 2] for k, v in b.items()}
    return fn


def train_seed(root, cell, seed, variants, emit, device=None):
    from harness.runner import free, make_context
    ctx = make_context(root, cell, seed, 0, False, device=device)
    gen = ctx.cell.generator
    t = time.perf_counter()
    ref = gen.reference_readings(ctx)
    free(ctx.device)
    emit(seed, "reference", {"seconds": time.perf_counter() - t,
                             "losses": ref["losses"]})
    from harness import checks
    for v in variants:
        hooks = {"data_fn": half_batch} if v == "half_batch" else {}
        prec = ctx.cell.config.control if v == "control" else None
        c = make_context(root, cell, seed, 0, False, device=device,
                         hooks=hooks, precision=prec)
        trainer, prog = gen.program_readings(c, c.precision)
        del trainer
        free(c.device)
        where = {}
        numbers = checks.train_numbers(prog, ref, where)
        emit(seed, v, dict(numbers, losses=prog["losses"],
                           worst=where))


def serve_seed(root, cell, seed, seconds, variants, emit, device=None):
    import torch
    from harness import weights
    from harness.runner import free, make_context
    from repro_torch.models import forward
    from repro_torch.precision import parse_policy
    from repro_torch.train.serve_step import (_serve_ctx,
                                              narrow_serving_params)
    ctx = make_context(root, cell, seed, seconds, False, device=device)
    gen = ctx.cell.generator
    out = gen.run(ctx)
    sample = ctx.extra["sample"]
    emit(seed, "sound", dict(out.numbers, requests=len(sample),
                             served=sum(len(r.toks) for r in sample)))
    if "control" not in variants:
        return
    cfg, dev = ctx.cell.config, ctx.device
    arch = cfg.arch()
    pol = parse_policy(cfg.control)
    params = narrow_serving_params(
        weights.make_weights(cfg.model, seed, dev), arch, pol)
    fctx = _serve_ctx(arch, pol, dev)()
    firsts = {}
    with torch.no_grad():
        for r in sample:
            seq, rows = gen.served_positions(r)
            lg, _ = forward(params, {"tokens": torch.tensor([seq],
                                                            device=dev)},
                            arch, fctx)
            firsts[id(r)] = lg[0, rows].argmax(-1).tolist()
            del lg
    del params
    free(dev)
    gap = gen.reference_gaps(cfg.model, seed, dev, sample,
                             choose=lambda r: firsts[id(r)])
    emit(seed, "control", {"logit_gap": gap})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+",
                   default=["sound", "control", "half_batch"])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--device", default=None,
                   help="another device than the CUDA card (tests)")
    a = p.parse_args(argv)
    import torch
    if a.device is None and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from harness.cells import load_cell
    kind = load_cell(a.root, a.workload).kind
    out_dir = os.path.join(ROOT, "chiprun_out")
    path = os.path.join(out_dir, f"calibrate-{a.workload}.jsonl")

    def emit(seed, variant, numbers):
        line = json.dumps({"cell": a.workload, "seed": seed,
                           "variant": variant, **numbers})
        print(line, flush=True)
        if os.path.isdir(out_dir):
            with open(path, "a") as f:
                f.write(line + "\n")

    for s in a.seeds:
        if kind == "train":
            train_seed(a.root, a.workload, s, a.variants, emit, a.device)
        else:
            serve_seed(a.root, a.workload, s, a.seconds, a.variants, emit,
                       a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
