"""Training traffic: markov batches of `batch` x `seq_len` tokens a step,
no accumulation, a constant learning rate, through the port's `Trainer`
over `make_step(arch, precision, schedule)`.

Set-up builds one Trainer from the run's weights and drives it through
its first `check_steps` steps with the window's own call and feed (which
builds and warms every kernel): those steps give the check's readings,
each step's loss, the first gradient as AdamW holds it after one step
(m / (1 - b1)) and each leaf's change after the last. The same Trainer
then runs one step at a time until `--seconds` have passed, synchronized
only at both ends of the window. With `--trace 1`, `trace_steps` more
steps run under the profiler. The program is then freed and the
reference trains the same weights on the same batches.

Mix keys: kind "train", batch, seq_len, lr, check_steps, trace_steps.
"""
from __future__ import annotations

import time

import torch

from harness import checks, markov, profiling, weights, yardstick
from harness.cells import regions_of
from harness.runner import Outcome, Reading, free, sync

B1 = 0.9            # AdamW's first-moment decay, the port's default


class Probe:
    """The train step with the loss of each of its first `n` calls
    kept."""

    def __init__(self, step, n: int):
        self.step = step
        self.n = n
        self.losses = []

    def __call__(self, state, batch, key=None):
        state, metrics = self.step(state, batch, key)
        if len(self.losses) < self.n:
            self.losses.append(metrics["loss"].detach())
        return state, metrics


def data_for(ctx):
    cfg, mix = ctx.cell.config, ctx.cell.mix
    return markov.MarkovLM(cfg.model["vocab_size"], mix["seq_len"],
                           mix["batch"], ctx.seed, device=ctx.device)


def program_readings(ctx, precision: str):
    """Build the Trainer, run the check's steps and read them. Returns
    (trainer, readings)."""
    from repro_torch.optim import make_schedule
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, init_train_state, make_step
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    n = mix["check_steps"]
    arch = cfg.arch()
    data = data_for(ctx)
    params = weights.make_weights(cfg.model, ctx.seed, dev)
    state = init_train_state(ctx.seed, arch, device=dev,
                             init_params_fn=lambda *a, **k: params)
    del params
    sched = make_schedule("constant", base_lr=mix["lr"], warmup_steps=0,
                          total_steps=1)
    probe = Probe(ctx.hook("train_step",
                           make_step(arch, precision, sched, device=dev)), n)
    trainer = Trainer(train_step=probe, init_state=state,
                      data_fn=ctx.hook("data_fn", data.batch), seed=ctx.seed,
                      device=dev)
    del state
    trainer.run(1, log_every=0)
    grads = {p: float(m.norm()) / (1 - B1)
             for p, m in named_leaves(trainer.state.opt.mu)}
    trainer.run(n, log_every=0)
    with torch.no_grad():
        changes = {p: float((t - weights.leaf(cfg.model, ctx.seed, p, dev)
                             .float()).norm())
                   for p, t in named_leaves(trainer.state.params)}
    return trainer, {"losses": [float(x) for x in probe.losses],
                     "grad_norms": grads, "changes": changes}


def reference_readings(ctx) -> dict:
    """The reference's steps on the same weights and batches."""
    from reference.train import Adam, run_steps
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    m = cfg.model
    data = data_for(ctx)
    params = weights.make_weights(m, ctx.seed, dev)
    return run_steps(m, params,
                     [data.batch(i) for i in range(mix["check_steps"])],
                     Adam(lr=mix["lr"]),
                     lambda p: weights.leaf(m, ctx.seed, p, dev))


def run(ctx) -> Outcome:
    cell, mix, dev = ctx.cell, ctx.cell.mix, ctx.device
    model = cell.config.model
    B, S = mix["batch"], mix["seq_len"]
    trainer, prog = program_readings(ctx, ctx.precision)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.4f} s; losses {prog['losses']}")
    t0 = time.perf_counter()
    n = 0
    while True:
        trainer.run(trainer.start_step + 1, log_every=0)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    step_flops = yardstick.train_flops(model, B, S)
    ctx.log(f"window {window_s:.4f} s, {n} steps, {window_s / n:.4f} s a "
            f"step, peak {peak / 2**30:.3f} GiB")
    reading = None
    if ctx.trace:
        regions = regions_of(cell.per_layer)
        k = mix["trace_steps"]
        trace = None
        if dev.type == "cuda":
            prof = profiling.traced(
                lambda: trainer.run(trainer.start_step + k, log_every=0),
                regions)
            trace = profiling.read_trace(prof, regions)
            del prof
        reading = Reading(
            cell=cell, trace=trace,
            window={"steps": n, "seconds": window_s, "tokens": n * B * S,
                    "flops": n * step_flops},
            sub={"steps": k, "tokens": k * B * S,
                 "gemm_least_s": k * yardstick.train_gemm_least_s(
                     model, B * S),
                 "flash_least_s": k * yardstick.flash_least_s(model, B, S)})
    del trainer
    free(dev)
    t_ref = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ref = reference_readings(ctx)
    where = {}
    numbers = checks.train_numbers(prog, ref, where)
    ctx.log(f"numbers {numbers}")
    ref_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    ctx.log(f"reference {time.perf_counter() - t_ref:.4f} s, peak "
            f"{ref_peak / 2**30:.3f} GiB; losses {ref['losses']}; worst "
            f"leaves {where}")
    return Outcome(e2e={"train_tokens_per_s": n * B * S / window_s,
                        "setup_s": setup_s},
                   reading=reading, numbers=numbers, attempted=n, failed=0,
                   peak_bytes=peak)
