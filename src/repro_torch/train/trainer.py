"""Training loop (port of the loop of `repro.train.trainer`).

`Trainer.run` drives a train step over `data_fn(step)` batches: every step
runs inside a `"train/step"` span (synchronized with
`torch.cuda.synchronize` on log steps, so the span covers the device
work), and log steps emit `"train/progress"` and print a progress line.
Checkpoints and auto-resume come with ROADMAP A8.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.obs import NULL_RECORDER
from repro_torch.train.train_step import TrainState


def _sync(_obj) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Trainer:
    def __init__(self, *, train_step: Callable, init_state: TrainState,
                 data_fn: Callable[[int], Any],
                 ckpt_dir: Optional[str] = None, recorder=None,
                 device=None):
        if ckpt_dir is not None:
            raise NotImplementedError(
                "checkpoints and auto-resume come with ROADMAP A8")
        self.device = resolve_device(device)
        check_on(init_state.params["head_w"], self.device, "init_state")
        self.train_step = train_step
        self.data_fn = data_fn
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        if self.recorder.enabled and self.recorder.sync_fn is None:
            self.recorder.sync_fn = _sync
        self.state = init_state
        self.start_step = init_state.step

    def run(self, num_steps: int, *, log_every: int = 10, log_fn=print):
        """Run to global step `num_steps` (absolute)."""
        rec = self.recorder
        metrics = {}
        t0 = rec.clock.perf()
        for step in range(self.start_step, num_steps):
            batch = self.data_fn(step)
            log_now = bool(log_every) and step % log_every == 0
            scalars = {}
            with rec.span("train/step", step=step) as sp:
                self.state, metrics = self.train_step(self.state, batch)
                if log_now:
                    # float() waits for the step's outputs, so the span
                    # covers the device time on log steps
                    scalars = {k: float(v) for k, v in metrics.items()
                               if isinstance(v, (int, float))
                               or getattr(v, "ndim", None) == 0}
                    sp.sync(self.state.params)
            if log_now:
                elapsed = rec.clock.perf() - t0
                rec.emit("train/progress", step=step, elapsed_s=elapsed,
                         **scalars)
                if log_fn is not None:
                    log_fn(f"step {step:6d} "
                           + " ".join(f"{k}={v:.4f}"
                                      for k, v in scalars.items())
                           + f" ({elapsed:.1f}s)")
        self.start_step = max(self.start_step, num_steps)
        return self.state, metrics
