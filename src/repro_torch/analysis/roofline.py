"""Three-term roofline (port of `repro.analysis.roofline`, H100 target).

    compute    = FLOPs            / (989e12 FLOP/s bf16 per card)
    memory     = HBM bytes        / (3.35e12 B/s HBM per card)
    collective = collective bytes / (450e9 B/s NVLink, one direction)

The inputs are per-device numbers, as the reference's: each term divides
by one card's peak (NVIDIA's H100 SXM data sheet, dense rates, at the
full 700 W power limit; PERF.md §3). The reference reads its FLOPs,
bytes and collective bytes from XLA's compiled dry-run artifacts
(`cost_analysis_dict`, `collective_bytes_from_text` over the TPU's ICI).
The port's dry run (`launch/dryrun.py`) runs rank 0's program on fake
tensors and reads instead: the FLOPs of
`torch.utils.flop_counter.FlopCounterMode` (the products only, where
XLA also counts elementwise FLOPs), the sum of each non-view aten op's
input and output bytes, and the collectives its transports record
(`collective_bytes_from_records`).

MODEL_FLOPS = 6·N·D for training (N params, D tokens), 2·N·D for inference
forward passes (2·N_active·D for MoE) — the useful-work yardstick; the
MODEL/measured ratio exposes remat recompute and quantization overhead.
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM constants (per card, data sheet)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_INT8 = 1979e12
HBM_BW = 3.35e12
NVLINK_BW_PER_DIR = 450e9   # NVLink 4: 900 GB/s both directions


# all-reduce = reduce-scatter + all-gather ≈ 2× payload over the ring (the
# reference's multipliers, by its HLO names)
_KIND_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}
# a transport record's kind -> (the HLO name, the result's bytes per
# payload byte as a multiple of the group size g, else 1)
_RECORD_KIND = {"all_reduce": ("all-reduce", False),
                "all_reduce_max": ("all-reduce", False),
                "all_reduce_min": ("all-reduce", False),
                # the transport's reduce-scatter issues an all-reduce of
                # the whole tensor (`launch.transport`): counted as issued
                "reduce_scatter": ("all-reduce", False),
                "all_gather": ("all-gather", True),
                "gather": ("all-gather", True)}


def collective_bytes_from_records(records) -> Dict:
    """Per-device collective wire bytes from `launch.transport.Transport`
    records (kind, payload bytes, group size, seconds), the port's
    counterpart of `collective_bytes_from_text`: each collective's
    result-shape bytes (a gather's payload times its group size g) ×
    `_KIND_MULT` × (g − 1)/g, by the reference's kind names."""
    by_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for kind, payload, g, *_ in records:
        name, gathered = _RECORD_KIND[kind]
        result = payload * g if gathered else payload
        frac = (g - 1) / g if g > 1 else 0.0
        by_kind[name] = by_kind.get(name, 0.0) + \
            result * _KIND_MULT[name] * frac
        count[name] = count.get(name, 0) + 1
    return {"total_bytes": float(sum(by_kind.values())),
            "by_kind": by_kind, "op_counts": count}


def model_flops(arch, shape_name: str) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = arch.n_active_params()
    if shape_name.startswith("train"):
        seq, batch = 4096, 256
        return 6.0 * n * seq * batch
    if shape_name.startswith("prefill"):
        seq, batch = 32768, 32
        return 2.0 * n * seq * batch
    if shape_name.startswith("decode"):
        return 2.0 * n * 128          # one token × batch 128
    if shape_name.startswith("long"):
        return 2.0 * n * 1
    return 0.0


def roofline_terms(*, flops: float, bytes_hbm: float, bytes_coll: float,
                   n_chips: int, arch=None, shape_name: str = "",
                   peak_flops: float = PEAK_FLOPS_BF16) -> Dict:
    """All three terms in seconds + bottleneck + useful-work ratio.

    `flops`/`bytes_hbm`/`bytes_coll` are PER-DEVICE numbers, so each term
    divides by a single card's peak.
    """
    t_compute = flops / peak_flops
    t_memory = bytes_hbm / HBM_BW
    t_coll = bytes_coll / NVLINK_BW_PER_DIR
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    out = {
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "step_time_lower_bound_s": max(terms.values()),
        "hlo_flops_per_device": flops, "hlo_bytes_per_device": bytes_hbm,
        "collective_bytes_per_device": bytes_coll,
        "n_chips": n_chips,
    }
    if arch is not None and shape_name:
        mf = model_flops(arch, shape_name)
        out["model_flops"] = mf
        global_flops = flops * n_chips
        out["useful_flops_ratio"] = (mf / global_flops) if global_flops \
            else 0.0
        # roofline fraction: useful FLOP/s achieved at the bound, vs peak
        bound = max(terms.values())
        out["roofline_fraction"] = \
            (mf / (n_chips * peak_flops)) / bound if bound else 0.0
    return out


def summarize(results: dict, shape_filter: Optional[str] = None):
    """Pretty table from a dryrun.json dict."""
    rows = []
    for cell, rec in sorted(results.items()):
        if rec.get("status") != "ok" or "roofline" not in rec:
            continue
        if shape_filter and rec["shape"] != shape_filter:
            continue
        r = rec["roofline"]
        rows.append((rec["arch"], rec["shape"], rec["mesh"],
                     r["compute_s"], r["memory_s"], r["collective_s"],
                     r["bottleneck"], r.get("useful_flops_ratio", 0.0),
                     r.get("roofline_fraction", 0.0)))
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':6s} {'compute_s':>11s} "
           f"{'memory_s':>11s} {'collect_s':>11s} {'bound':>10s} "
           f"{'useful':>7s} {'roofline':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(f"{r[0]:24s} {r[1]:12s} {r[2]:6s} {r[3]:11.4g} "
                     f"{r[4]:11.4g} {r[5]:11.4g} {r[6]:>10s} "
                     f"{r[7]:7.2%} {r[8]:8.2%}")
    return "\n".join(lines)
