"""mfu.serve: the FLOPs of every prompt token prefilled and every output
token decoded in the window (`harness.yardstick.prefill_flops`,
`decode_flops`) over the window's host-clock seconds, as a share of the
chip's peak (`yardstick.PEAK_OPS_S`)."""
from harness.yardstick import PEAK_OPS_S


def read(r):
    w = r.window
    if not w.get("seconds") or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / PEAK_OPS_S
