"""Atomic, BFP-packable checkpoints of the port, in the reference's
on-disk format (DESIGN.md §6)."""
from repro_torch.checkpoint.checkpointing import (latest_step, latest_steps,
                                                  load_checkpoint,
                                                  load_precision,
                                                  save_checkpoint)

__all__ = ["latest_step", "latest_steps", "load_checkpoint",
           "load_precision", "save_checkpoint"]
