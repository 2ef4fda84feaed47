"""Training and serving steps of the port: the HBFP train step, its loop,
and the serving stages."""
from repro_torch.train.serve_step import make_decode_fn, make_prefill_fn
from repro_torch.train.train_step import (TrainState, from_jax_train_state,
                                          init_train_state, make_step,
                                          make_train_step)
from repro_torch.train.trainer import Trainer

__all__ = ["TrainState", "Trainer", "from_jax_train_state",
           "init_train_state", "make_decode_fn", "make_prefill_fn",
           "make_step", "make_train_step"]
