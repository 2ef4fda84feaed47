"""mfu.train: the model FLOPs of the window's training steps (counted
from the configuration's shapes by `harness.yardstick.train_flops`) over
the window's host-clock seconds, as a share of the chip's peak for
HBFP's fixed-point products (`yardstick.PEAK_OPS_S`)."""
from harness.yardstick import PEAK_OPS_S


def read(r):
    w = r.window
    if not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / PEAK_OPS_S
