"""Numerics observatory and closed-loop adaptive precision of the port
(DESIGN.md §9): fidelity stats through the conversion kernel B7
(`stats`), weight / gradient / activation taps and the ring buffer
(`collect`), the hysteresis controller (`controller`) and the deprecated
loop alias (`adaptive`); the loop itself is `train.make_step(policy,
controller=..., tap=...)`."""
from repro_torch.numerics.stats import (EXP_BIN_LO, EXP_BIN_WIDTH, EXP_BINS,
                                        TensorStats, quantize_with_stats,
                                        stats_to_host)
from repro_torch.numerics.collect import (RingBuffer, TapConfig, grad_stats,
                                          narrow_params_with_stats,
                                          weight_stats)
from repro_torch.numerics.controller import (DB_PER_BIT, ControllerConfig,
                                             PrecisionController)
from repro_torch.numerics.adaptive import make_adaptive_train_step

__all__ = ["DB_PER_BIT", "EXP_BINS", "EXP_BIN_LO", "EXP_BIN_WIDTH",
           "ControllerConfig", "PrecisionController", "RingBuffer",
           "TapConfig", "TensorStats", "grad_stats",
           "make_adaptive_train_step", "narrow_params_with_stats",
           "quantize_with_stats", "stats_to_host", "weight_stats"]
