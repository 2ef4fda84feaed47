"""BFP core of the port: formats, quantization, HBFP ops, weight shell
and precision schedules."""
from repro_torch.core import bfp
from repro_torch.core.formats import (FP32, HBFP8_16, HBFP8_16_T24,
                                      HBFP12_16, HBFPConfig, resolve)
from repro_torch.core.hbfp_ops import hbfp_conv2d, hbfp_linear, hbfp_matmul
from repro_torch.core.opt_shell import (hbfp_apply_updates, is_hbfp_weight,
                                        narrow_params, resolve_param_cfg,
                                        widen_params)
from repro_torch.core.schedule_precision import (PrecisionSchedule,
                                                 ResolvedPrecision,
                                                 as_schedule, constant,
                                                 from_spec,
                                                 precision_from_dict,
                                                 precision_to_dict,
                                                 staircase,
                                                 warmup_then_narrow)

__all__ = ["FP32", "HBFP8_16", "HBFP8_16_T24", "HBFP12_16", "HBFPConfig",
           "PrecisionSchedule", "ResolvedPrecision", "as_schedule", "bfp",
           "constant", "from_spec", "hbfp_apply_updates", "hbfp_conv2d",
           "hbfp_linear", "hbfp_matmul", "is_hbfp_weight", "narrow_params",
           "precision_from_dict", "precision_to_dict", "resolve",
           "resolve_param_cfg", "staircase", "warmup_then_narrow",
           "widen_params"]
