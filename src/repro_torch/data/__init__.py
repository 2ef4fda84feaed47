"""Synthetic training data of the port."""
from repro_torch.data.pipeline import SyntheticLM, batch_for_arch

__all__ = ["SyntheticLM", "batch_for_arch"]
