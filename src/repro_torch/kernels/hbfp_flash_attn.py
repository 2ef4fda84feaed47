"""HBFP flash attention on Hopper: the wrappers of
`csrc/hbfp_flash_attn.cu` (port of `repro.kernels.hbfp_flash_attn`).

    B4 `hbfp_flash_fwd`  (`hbfp_flash_attention` / `_flash_kernel`):
        o = softmax(Q(q·α)·Q(k)ᵀ) · v with the PV product in BFP and the
        online softmax in f32, and the per-row logsumexp lse;
    B5 `hbfp_flash_dq`   (`_flash_dq_kernel`): dq from p = exp(s − lse),
        dp = Q(do)·Q(v)ᵀ, ds = p∘(dp − D), dq = Σ Q(ds)·k̂ · α;
    B6 `hbfp_flash_dkv`  (`_flash_dkv_kernel`): dv = Σ Q(p)ᵀ·Q(do),
        dk = Σ Q(ds)ᵀ·q̂.

q, k, v, do are [BH, S, hd] (batch × heads flattened); α = 1/√hd in f32.

Routes (`flash_route` for B4 and `flash_bwd_route` for B5 and B6, which
the C side's `flash_tc_route` and `flash_bwd_tc_route` mirror):
"int8_wgmma" where m_qk, m_pv <= 8, hd a multiple of 32 up to 128, the
blocks multiples of 64 and S of 128 (yi-9b's training attention and the
adaptive path at m 4); "cuda_core" takes every other call. On the int8
route a pre-pass writes int8 q·α and k (B4 also vᵀ; B5 and B6 do and v)
with their steps (`flash_scratch`, `flash_bwd_scratch`), and the main
kernel runs the integral products (QKᵀ, PV; dp = Q(do)·Q(v)ᵀ) as int8
wgmma, bit-equal to the plain version's, and B5's and B6's f32
contractions (dq, dk, dv) as bf16 wgmma over the dequantized operands,
exact in bf16, so only their order of f32 additions differs from the
plain version. A route is chosen by the call's arithmetic and shape,
never retried on another.
D = rowsum(do ∘ o) is an elementwise torch op outside the kernels, on the
saved o, as in the reference. `FlashAttention` is the autograd Function
of the training path (the reference's `flash_attention_vjp`): its forward
runs B4 with lse and saves (q, k, v, o, lse), its backward runs B5 and B6.

The library is built with `nvcc` at first use (`hbfp_matmul.build`), never
at import. A wrapper launches its kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes the plain version (`kernels/ref.py`).
Nothing falls back from the card to the plain version. Each wrapper's
`.launches` counts kernel launches (a route's pre-pass and main kernel
count as one), `.launches_by_route` the same launches by route, and
`.plain_calls` CPU calls of its plain version; `reset_counts()` zeroes
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.hbfp_matmul import _launch, _ptr
from repro_torch.kernels.ref import NEG_INF  # noqa: F401  (masked score)
from repro_torch.kernels.ref import _flash_blocks, _flash_scale, flash_delta
from repro_torch.kernels.ref import hbfp_flash_attn_ref as hbfp_flash_fwd_plain
from repro_torch.kernels.ref import hbfp_flash_dkv_ref as hbfp_flash_dkv_plain
from repro_torch.kernels.ref import hbfp_flash_dq_ref as hbfp_flash_dq_plain

_LIB = "hbfp_flash_attn"
_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("int8_wgmma", "cuda_core")
HP = 128          # the int8 route pads hd to one 128-byte row


def _check(what: str, *ts: torch.Tensor) -> None:
    """[BH, S, hd] operands of one shape, dtype (f32/bf16) and device,
    contiguous."""
    q = ts[0]
    if q.ndim != 3:
        raise ValueError(f"{what}: q must be [BH, S, hd], got {tuple(q.shape)}")
    for t in ts:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: operands differ: {tuple(t.shape)} "
                             f"{t.dtype} {t.device} vs {tuple(q.shape)} "
                             f"{q.dtype} {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not in {_DTYPES}")


def _check_rows(what: str, q: torch.Tensor, *ts: torch.Tensor) -> None:
    """lse / D: f32 [BH, S] on q's device, contiguous."""
    for t in ts:
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: lse/delta must be contiguous f32 "
                             f"{tuple(q.shape[:2])} on {q.device}")


def _cuda_args(what: str, q: torch.Tensor, m_qk: int, m_pv: int, bq: int,
               bk: int):
    """What the CUDA kernels take; raises on anything else. Returns the
    (BH, S, hd) ints and α as a Python float (exactly the f32 value)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    BH, S, hd = q.shape
    for b in (bq, bk):
        if b > 128 or b & (b - 1):
            raise ValueError(f"{what}: the CUDA kernel takes power-of-two "
                             f"blocks <= 128, got ({bq}, {bk})")
    if hd > 128:
        raise ValueError(f"{what}: the CUDA kernel takes hd <= 128, got {hd}")
    for m in (m_qk, m_pv):
        if not 2 <= m <= 12:
            raise ValueError(f"{what}: the CUDA kernel takes 2 <= m <= 12, "
                             f"got {m}")
    return BH, S, hd, float(_flash_scale(hd, "cpu"))


def reset_counts() -> None:
    for fn in (hbfp_flash_fwd, hbfp_flash_dq, hbfp_flash_dkv):
        fn.launches = 0
        fn.plain_calls = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_route(*, m_qk: int, m_pv: int, S: int, hd: int, bq: int,
                bk: int) -> str:
    """The route of one B4 launch at the clipped blocks, as the C side's
    `flash_tc_route` takes it: int8 wgmma where both contractions are
    integral at m <= 8, hd fits one padded 128-byte row in multiples of
    32, the blocks are whole 64-row warpgroup tiles and S whole 128-row
    CTAs; else the CUDA cores."""
    if m_qk <= 8 and m_pv <= 8 and hd % 32 == 0 and hd <= HP \
            and bq % 64 == 0 and bk % 64 == 0 and S % 128 == 0:
        return "int8_wgmma"
    return "cuda_core"


def flash_scratch(route: str, BH: int, S: int, bk: int) -> dict:
    """Scratch of one B4 launch, {name: (shape, dtype) or None}, in the C
    entry point's argument order: int8 q·α and k mantissas [BH·S, 128], vᵀ
    mantissas [BH·128, S] (quantized per column over each k-block), and
    their f32 steps; none on the CUDA cores."""
    names = ("q8", "k8", "vt8", "qsc", "ksc", "vsc")
    if route == "cuda_core":
        return dict.fromkeys(names)
    i8, f32 = torch.int8, torch.float32
    return dict(zip(names, (((BH * S, HP), i8), ((BH * S, HP), i8),
                            ((BH * HP, S), i8), ((BH * S,), f32),
                            ((BH * S,), f32), ((BH, S // bk, HP), f32))))


def flash_bwd_route(*, m_qk: int, m_pv: int, S: int, hd: int, bq: int,
                    bk: int) -> str:
    """The route of one B5 or B6 launch, as the C side's
    `flash_bwd_tc_route` takes it: B4's tiles (B6's 64-row q chunks then
    lie in one q-block, and its 128 k rows hold one or two whole
    k-blocks)."""
    return flash_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq, bk=bk)


_BWD_SCRATCH = {"hbfp_flash_dq": ("kh",), "hbfp_flash_dkv": ("qh", "doh")}


def flash_bwd_scratch(route: str, entry: str, BH: int, S: int) -> dict:
    """Scratch of one B5 (`entry` "hbfp_flash_dq") or B6 ("hbfp_flash_dkv")
    launch, {name: (shape, dtype) or None}, in the C entry point's
    argument order: int8 q·α, k, do, v mantissas [BH·S, 128], their f32
    row steps, and the dequantized operands in bf16 [BH·S, 128] that the
    bf16 products read (B5: k̂; B6: q̂, dô); none on the CUDA cores."""
    names = ("q8", "k8", "do8", "v8", "qsc", "ksc", "dosc", "vsc",
             *_BWD_SCRATCH[entry])
    if route == "cuda_core":
        return dict.fromkeys(names)
    rows = BH * S
    return {n: ((rows, HP), torch.int8) if n.endswith("8") else
            ((rows,), torch.float32) if n.endswith("sc") else
            ((rows, HP), torch.bfloat16) for n in names}


def _alloc(spec: dict, device) -> list:
    return [None if v_ is None else torch.empty(v_[0], dtype=v_[1],
                                                device=device)
            for v_ in spec.values()]


def hbfp_flash_fwd(q, k, v, *, m_bits: int = 8, m_qk: int = 0,
                   m_pv: int = 0, bq: int = 128, bk: int = 128,
                   causal: bool = True, with_lse: bool = False):
    """B4. q, k, v: [BH, S, hd] f32/bf16, contiguous. Returns o [BH, S, hd]
    in q's dtype, or (o, lse [BH, S] f32) when with_lse. m_qk/m_pv (0:
    m_bits) are the QKᵀ and PV widths; blocks clip to S and must divide
    it."""
    _check("hbfp_flash_fwd", q, k, v)
    m_qk, m_pv = m_qk or m_bits, m_pv or m_bits
    bq, bk = _flash_blocks(q.shape[1], bq, bk)
    kw = dict(m_bits=m_bits, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk,
              causal=causal, with_lse=with_lse)
    if q.device.type == "cpu":
        hbfp_flash_fwd.plain_calls += 1
        return hbfp_flash_fwd_plain(q, k, v, **kw)
    BH, S, hd, scale = _cuda_args("hbfp_flash_fwd", q, m_qk, m_pv, bq, bk)
    route = flash_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq, bk=bk)
    scratch = _alloc(flash_scratch(route, BH, S, bk), q.device)
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    _launch(_LIB, "hbfp_flash_fwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), int(q.dtype == torch.bfloat16), o.data_ptr(),
            _ptr(lse), *(_ptr(t) for t in scratch), BH, S, hd, bq, bk, m_qk,
            m_pv, int(causal), scale)
    hbfp_flash_fwd.launches += 1
    hbfp_flash_fwd.launches_by_route[route] += 1
    return (o, lse) if with_lse else o


# the reference's name for B4's entry
hbfp_flash_attention = hbfp_flash_fwd


def _bwd_launch(entry: str, q, k, v, do, lse, delta, outs, m_qk, m_pv, bq,
                bk, causal) -> str:
    """Launch B5 or B6 on its route; returns the route."""
    BH, S, hd, scale = _cuda_args(entry, q, m_qk, m_pv, bq, bk)
    route = flash_bwd_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq, bk=bk)
    scratch = _alloc(flash_bwd_scratch(route, entry, BH, S), q.device)
    _launch(_LIB, entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in outs),
            *(_ptr(t) for t in scratch), BH, S, hd, bq, bk, m_qk, m_pv,
            int(causal), scale)
    return route


def hbfp_flash_dq(q, k, v, do, lse, delta, *, m_bits: int = 8,
                  m_qk: int = 0, m_pv: int = 0, bq: int = 128,
                  bk: int = 128, causal: bool = True):
    """B5. q, k, v, do: [BH, S, hd] of one dtype; lse, delta: [BH, S] f32.
    Returns dq [BH, S, hd] in q's dtype."""
    _check("hbfp_flash_dq", q, k, v, do)
    _check_rows("hbfp_flash_dq", q, lse, delta)
    m_qk, m_pv = m_qk or m_bits, m_pv or m_bits
    bq, bk = _flash_blocks(q.shape[1], bq, bk)
    if q.device.type == "cpu":
        hbfp_flash_dq.plain_calls += 1
        return hbfp_flash_dq_plain(q, k, v, do, lse, delta, m_qk=m_qk,
                                   m_pv=m_pv, bq=bq, bk=bk, causal=causal)
    dq = torch.empty_like(q)
    route = _bwd_launch("hbfp_flash_dq", q, k, v, do, lse, delta, (dq,),
                        m_qk, m_pv, bq, bk, causal)
    hbfp_flash_dq.launches += 1
    hbfp_flash_dq.launches_by_route[route] += 1
    return dq


def hbfp_flash_dkv(q, k, v, do, lse, delta, *, m_bits: int = 8,
                   m_qk: int = 0, m_pv: int = 0, bq: int = 128,
                   bk: int = 128, causal: bool = True):
    """B6. Same inputs as B5. Returns (dk, dv) [BH, S, hd] in q's dtype."""
    _check("hbfp_flash_dkv", q, k, v, do)
    _check_rows("hbfp_flash_dkv", q, lse, delta)
    m_qk, m_pv = m_qk or m_bits, m_pv or m_bits
    bq, bk = _flash_blocks(q.shape[1], bq, bk)
    if q.device.type == "cpu":
        hbfp_flash_dkv.plain_calls += 1
        return hbfp_flash_dkv_plain(q, k, v, do, lse, delta, m_qk=m_qk,
                                    m_pv=m_pv, bq=bq, bk=bk, causal=causal)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    route = _bwd_launch("hbfp_flash_dkv", q, k, v, do, lse, delta, (dk, dv),
                        m_qk, m_pv, bq, bk, causal)
    hbfp_flash_dkv.launches += 1
    hbfp_flash_dkv.launches_by_route[route] += 1
    return dk, dv


def hbfp_flash_attention_bwd(q, k, v, o, lse, do, *, m_bits: int = 8,
                             m_qk: int = 0, m_pv: int = 0, bq: int = 128,
                             bk: int = 128, causal: bool = True):
    """The flash backward from the forward's saved o and lse: D from o,
    then B5 (dq) and B6 (dk, dv). Returns (dq, dk, dv)."""
    delta = flash_delta(o, do)
    kw = dict(m_bits=m_bits, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk,
              causal=causal)
    dq = hbfp_flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = hbfp_flash_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashSpec(NamedTuple):
    """Static flash configuration; m_qk/m_pv (0: m_bits) are the per-role
    widths of the two attention contractions (DESIGN.md §11)."""
    m_bits: int
    bq: int
    bk: int
    causal: bool
    m_qk: int = 0
    m_pv: int = 0


class FlashAttention(torch.autograd.Function):
    """Training flash attention: forward B4 with lse, backward B5 + B6."""

    @staticmethod
    def forward(ctx, spec: FlashSpec, q, k, v):
        kw = dict(m_bits=spec.m_bits, m_qk=spec.m_qk, m_pv=spec.m_pv,
                  bq=spec.bq, bk=spec.bk, causal=spec.causal)
        o, lse = hbfp_flash_fwd(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = hbfp_flash_attention_bwd(q, k, v, o, lse,
                                              do.contiguous(), **ctx.kw)
        return None, dq, dk, dv


def flash_attention_vjp(spec: FlashSpec, q, k, v):
    """Training flash attention under the reference's name: o from B4,
    with B5 and B6 as its backward (`FlashAttention`)."""
    return FlashAttention.apply(spec, q, k, v)


reset_counts()
