"""The yardstick: the chip's peaks, and the work and least time of a cell
counted from the configuration's shapes and the cell's tokens, whatever
kernel the program runs.

Peaks: NVIDIA's H100 SXM data sheet at 700 W, dense, as
`src/repro_torch/analysis/roofline.py` states them (`PEAK_FLOPS_INT8`,
`HBM_BW`). HBFP does every dot product in fixed point, so every product
is held to the int8 rate, 1,979 TOP/s; a bf16 route shows as a share
below 100%.

Work: 2·M·K·N for the forward product, the dgrad and the wgrad of every
linear and of the head; causal or windowed attention's QKᵀ and PV (and,
in training, the four products of their backward) over the key
positions the mask leaves; recomputation is not counted.

Bytes, for the least times: as the HBFP format needs them, each read or
written once: weights as 8-bit mantissas with one exponent per 128 × 128
tile, activations and gradients bf16 in and out. `least_s` is
`chip_smoke.py`'s `_bound` (the larger of operations over the peak and
bytes over the memory rate), `gemm_least_s` its `_bound_ms` with these
bytes, `flash_least_s` its `_flash_bounds` at the int8 rate.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

PEAK_OPS_S = 1979e12          # H100 SXM int8 dense, data sheet, 700 W
HBM_BYTES_S = 3.35e12         # H100 SXM HBM3
TILE = 128                    # weight exponent tile edge

FWD, DGRAD, WGRAD = "fwd", "dgrad", "wgrad"


def hd(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def window(model: dict) -> Optional[int]:
    """The attention window of every layer (None: full causal)."""
    return model.get("window") if model.get("attn_pattern") == "sliding" \
        else None


def layer_products(model: dict) -> List[Tuple[str, int, int]]:
    """(name, K, N) of the weight products of one layer."""
    from reference import for_model
    return [(n, s[0], s[1]) for n, s, init in
            for_model(model).layer_specs(model)
            if len(s) == 2 and isinstance(init, float)]


def product_params(model: dict, head: bool = True) -> int:
    """Weights that take part in a product a token: every layer's and,
    with `head`, the head's (the embedding is a lookup)."""
    n = model["n_layers"] * sum(k * n for _, k, n in layer_products(model))
    return n + (model["d_model"] * model["vocab_size"] if head else 0)


def attn_pairs(S: int, w: Optional[int]) -> int:
    """(query, key) pairs a causal mask of window w leaves in S tokens."""
    if w is None or w >= S:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_OPS_S, nbytes / HBM_BYTES_S)


def gemm_least_s(M: int, K: int, N: int, op: str = FWD) -> float:
    """Least time of one HBFP product [M,K]·[K,N] (`op` the forward
    product, its dgrad or its wgrad)."""
    w = K * N + K * N / (TILE * TILE)            # mantissas + exponents
    nbytes = {FWD: 2 * M * K + w + 2 * M * N,
              DGRAD: 2 * M * N + w + 2 * M * K,
              WGRAD: 2 * M * K + 2 * M * N + 2 * K * N}[op]
    return least_s(2.0 * M * K * N, nbytes)


def _all_products(model: dict):
    L = model["n_layers"]
    for _, k, n in layer_products(model):
        yield L, k, n
    yield 1, model["d_model"], model["vocab_size"]


def train_gemm_least_s(model: dict, tokens: int) -> float:
    """Least time of one training step's products (B1-B3) over `tokens`."""
    return sum(c * gemm_least_s(tokens, k, n, op)
               for c, k, n in _all_products(model)
               for op in (FWD, DGRAD, WGRAD))


def flash_least_s(model: dict, B: int, S: int) -> float:
    """Least time of one training step's attention (B4-B6): the forward's
    QKᵀ and PV and the backward's four products over the causal pairs;
    q, k, v, o (and do, dq, dk, dv) bf16 and the f32 row statistics,
    each read or written once."""
    H, Hkv, d, L = model["n_heads"], model["n_kv_heads"], hd(model), \
        model["n_layers"]
    mac = B * H * d * attn_pairs(S, window(model))
    q = 2 * B * H * S * d
    kv = 2 * B * Hkv * S * d
    r = 4 * B * H * S
    fwd = least_s(4.0 * mac, 2 * q + 2 * kv + r)
    bwd = least_s(8.0 * mac, 4 * q + 4 * kv + 2 * r)
    return L * (fwd + bwd)


def attn_flops(model: dict, pairs: int, train: bool) -> float:
    """QKᵀ and PV over `pairs` (query, key) pairs of every head and layer;
    three times that with the backward."""
    f = 4.0 * model["n_layers"] * model["n_heads"] * hd(model) * pairs
    return 3 * f if train else f


def train_flops(model: dict, B: int, S: int) -> float:
    """Model FLOPs of one training step of B × S tokens."""
    return 6.0 * B * S * product_params(model) + \
        attn_flops(model, B * attn_pairs(S, window(model)), train=True)


def prefill_flops(model: dict, P: int) -> float:
    """A one-shot prefill of P prompt tokens and its first token's head."""
    return 2.0 * P * product_params(model, head=False) + \
        2.0 * model["d_model"] * model["vocab_size"] + \
        attn_flops(model, attn_pairs(P, window(model)), train=False)


def decode_flops(model: dict, pos: int) -> float:
    """One decoded token at position `pos` (it attends pos + 1 keys)."""
    w = window(model)
    keys = pos + 1 if w is None else min(pos + 1, w)
    return 2.0 * product_params(model) + attn_flops(model, keys, False)


def serve_gemm_least_s(model: dict, prefills: Iterable[int],
                       ticks: Iterable[int]) -> float:
    """Least time of B1 over one-shot prefills (every layer's products at
    M = the prompt, the head at M = 1) and generate ticks (every product
    at M = the tokens the tick decoded)."""
    L, D, V = model["n_layers"], model["d_model"], model["vocab_size"]
    lp = layer_products(model)
    t = 0.0
    for P in prefills:
        t += L * sum(gemm_least_s(P, k, n) for _, k, n in lp) + \
            gemm_least_s(1, D, V)
    for M in ticks:
        t += L * sum(gemm_least_s(M, k, n) for _, k, n in lp) + \
            gemm_least_s(M, D, V)
    return t
