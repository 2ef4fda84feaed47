"""Architecture configs of the ported slices."""
from repro_torch.configs.base import ArchConfig, arch_ids, get_arch

__all__ = ["ArchConfig", "arch_ids", "get_arch"]
