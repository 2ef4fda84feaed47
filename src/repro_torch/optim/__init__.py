"""Optimizer of the port: AdamW with f32 moments and the LR schedules."""
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.schedule import make_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "make_schedule"]
