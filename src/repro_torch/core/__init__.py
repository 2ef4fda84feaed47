"""BFP core of the port: formats, quantization, HBFP ops, weight shell."""
from repro_torch.core.formats import HBFP8_16, HBFP12_16, HBFPConfig

__all__ = ["HBFP8_16", "HBFP12_16", "HBFPConfig"]
