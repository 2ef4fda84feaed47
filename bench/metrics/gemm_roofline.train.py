"""gemm_roofline.train: the least time of the traced steps' HBFP
products (B1 forward, B2 dgrad, B3 wgrad of every linear and the head,
counted from the model's shapes: `harness.yardstick.train_gemm_least_s`)
over the device time of the kernels B1-B3 launch, matched by name below
(their GEMMs, split-K folds and quantize passes; `chip_smoke.py`'s
KERNEL_GROUPS). The remat recompute's forward products are kernel time
and no work, so they lower the share."""
PATTERNS = (
    r"(^|[^_])gemm_kernel<",            # cuda-core B1/B2, B3's wgrad_gemm
    r"tc_gemm_kernel<",                 # tensor-core B1/B2/B3
    r"wgrad_gemm_kernel",
    r"fold_kernel",                     # split-K folds
    r"quantize_(rows|w)_kernel<",       # B1-B3's quantize passes
)


def read(r):
    if r.trace is None or not r.sub.get("gemm_least_s"):
        return None
    t = r.kernel_s(PATTERNS)
    return 100.0 * r.sub["gemm_least_s"] / t if t > 0 else None
