"""BFP core of the port: formats, quantization, HBFP ops, weight shell."""
from repro_torch.core import bfp
from repro_torch.core.formats import HBFP8_16, HBFP12_16, HBFPConfig
from repro_torch.core.hbfp_ops import hbfp_conv2d, hbfp_linear, hbfp_matmul

__all__ = ["HBFP8_16", "HBFP12_16", "HBFPConfig", "bfp", "hbfp_conv2d",
           "hbfp_linear", "hbfp_matmul"]
