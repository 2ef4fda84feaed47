"""gemm_roofline.serve: the least time of B1's products in the traced
engine steps (every layer's products at M = the prompt for each one-shot
prefill and at M = the tokens each generate tick decoded, and the head's:
`harness.yardstick.serve_gemm_least_s`) over the device time of B1's
kernels, matched by name below (`chip_smoke.py`'s KERNEL_GROUPS). The
yardstick counts the weights as 8-bit mantissas; a bf16-stored weight
read shows as a share below 100%."""
PATTERNS = (
    r"(^|[^_])gemm_kernel<",
    r"tc_gemm_kernel<",
    r"fold_kernel",
    r"quantize_(rows|w)_kernel<",
)


def read(r):
    if r.trace is None or not r.sub.get("gemm_least_s"):
        return None
    t = r.kernel_s(PATTERNS)
    return 100.0 * r.sub["gemm_least_s"] / t if t > 0 else None
