"""flash_roofline.train: the least time of the traced steps' causal
attention (B4 forward, B5 dq, B6 dk/dv: QK^T and PV and the backward's
four products over the pairs the causal mask keeps, at the int8 rate,
q, k, v, o and their gradients read or written once:
`harness.yardstick.flash_least_s`) over the device time of the flash
kernels and their pre-passes, matched by name below (`chip_smoke.py`'s
KERNEL_GROUPS). B4's second run in each layer's recompute is kernel time
and no work."""
PATTERNS = (
    r"flash_fwd_kernel|flash_tc_kernel",
    r"flash_dq_kernel|flash_dq_tc_kernel",
    r"flash_dkv_kernel|flash_dkv_tc_kernel",
    r"flash_(rows|vt)_prepass",
)


def read(r):
    if r.trace is None or not r.sub.get("flash_least_s"):
        return None
    t = r.kernel_s(PATTERNS)
    return 100.0 * r.sub["flash_least_s"] / t if t > 0 else None
