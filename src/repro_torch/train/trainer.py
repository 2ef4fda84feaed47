"""Fault-tolerant training loop (port of `repro.train.trainer`).

  * auto-resume: with `ckpt_dir`, a new Trainer restores the latest
    checkpoint and resumes the data at the checkpointed step (the
    pipeline is a pure function of the step, so the resume is bit-exact);
  * checkpoints every `ckpt_every` steps and at the end of `run`, keeping
    the last `keep`, atomic, optionally written in a background thread;
    a step saved by the cadence is not written a second time at the end
    (the reference writes it twice);
  * preemption: `run(fail_at_step=...)` raises before that step, and the
    next Trainer over the same directory resumes losslessly;
  * precision: `hbfp` (HBFPConfig, PrecisionSchedule or PrecisionPolicy)
    is stored in checkpoint meta; pair a policy with `train.make_step`,
    which dispatches on state.step, so a resume lands in its segment;
  * stochastic rounding: step s gets the key
    `fold_in(fold_in(0, seed), s)`, a pure function of (seed, step), so
    a resumed run draws exactly what the uninterrupted run drew;
  * adaptive precision: `controller=` (the one passed to `make_step`)
    has its state and decision log stored under "numerics_controller" and
    restored on resume, so the restarted run replays its decisions;
  * data and tensor parallelism: with a `make_step(..., mesh=)` step
    (its `.layout`), the state holds ZeRO-1 shards of each rank's model
    part; a checkpoint is gathered
    whole to rank 0's host and written there in the reference's format
    (so it loads in one process and in `repro.checkpoint`), every rank
    loads it whole onto its host and keeps its shards, and the ranks meet
    at a barrier wherever a write may be pending;
  * observability: every step runs in a "train/step" span (synchronized
    with `torch.cuda.synchronize` on log steps, so the span covers the
    device work), log steps emit "train/progress", and checkpoints emit
    "ckpt/save" / "ckpt/load".
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels.common import fold_in
from repro_torch.obs import NULL_RECORDER
from repro_torch.train.train_step import TrainState
from repro_torch.train.zero import host_like


def _sync(_obj) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Trainer:
    def __init__(self, *, train_step: Callable, init_state: TrainState,
                 data_fn: Callable[[int], Any],
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, hbfp=None, controller=None, recorder=None,
                 seed: int = 0, background_ckpt: bool = False, device=None):
        self.device = resolve_device(device)
        check_on(init_state.params["head_w"], self.device, "init_state")
        self.train_step = train_step
        self.layout = getattr(train_step, "layout", None)
        self.data_fn = data_fn
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        if self.recorder.enabled and self.recorder.sync_fn is None:
            self.recorder.sync_fn = _sync
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.hbfp = hbfp
        self.controller = controller
        self.seed = seed
        self.background_ckpt = background_ckpt
        self.state = init_state
        self.start_step = init_state.step
        self._pending = None
        self._saved = None
        if ckpt_dir is not None and latest_step(ckpt_dir) is not None:
            like = init_state if self.layout is None else \
                host_like(init_state)
            self.state, meta = load_checkpoint(ckpt_dir, like,
                                               recorder=self.recorder)
            if self.layout is not None:
                self.state = self.layout.shard_state(self.state)
            self.start_step = self._saved = int(meta["step"])
            if controller is not None and "numerics_controller" in meta:
                controller.load_meta(meta["numerics_controller"])

    def _join(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self.layout is not None:
            self.layout.barrier()

    def _maybe_ckpt(self, step: int, force: bool = False) -> None:
        if self.ckpt_dir is None or step == self._saved:
            return
        if force or (step > 0 and step % self.ckpt_every == 0):
            self._join()
            extra = None
            if self.controller is not None:
                extra = {"numerics_controller": self.controller.to_meta()}
            state = self.state
            if self.layout is not None:
                state = self.layout.gather_state(state)
            if state is not None:
                r = save_checkpoint(self.ckpt_dir, step, state,
                                    hbfp=self.hbfp, keep=self.keep,
                                    background=self.background_ckpt,
                                    extra_meta=extra, recorder=self.recorder)
                if self.background_ckpt:
                    self._pending = r
            self._saved = step

    def run(self, num_steps: int, *, fail_at_step: Optional[int] = None,
            log_every: int = 10, log_fn=print):
        """Run to global step `num_steps` (absolute, resume-aware)."""
        rec = self.recorder
        metrics = {}
        t0 = rec.clock.perf()
        for step in range(self.start_step, num_steps):
            if fail_at_step is not None and step == fail_at_step:
                self._join()
                raise RuntimeError(f"simulated preemption at step {step}")
            batch = self.data_fn(step)
            key = fold_in(fold_in(0, self.seed), step)
            log_now = bool(log_every) and step % log_every == 0
            scalars = {}
            with rec.span("train/step", step=step) as sp:
                self.state, metrics = self.train_step(self.state, batch,
                                                      key)
                if log_now:
                    # scalars only (a telemetry step's "numerics" is a
                    # nested stats dict); float() waits for the step's
                    # outputs, so the span covers the device time
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
            self._maybe_ckpt(step + 1)
        self._maybe_ckpt(num_steps, force=True)
        self._join()
        self.start_step = max(self.start_step, num_steps)
        return self.state, metrics
