"""The port's flash attention (B4 forward, B5 dq, B6 dk/dv) against the JAX
package on the CPU.

The port's wrappers compute their plain versions for CPU tensors
(`repro_torch.kernels.ref`); the reference runs its oracles
(`repro.kernels.ref`) and its Pallas kernels in interpret mode. Inputs are
numpy draws from a seed, at BH 2, hd 32, S 64 and 96, bq = bk = 32.

Tolerances, with their reasons:
- f32 forward: o and lse within 2e-6 of the reference (a few ulps). The
  CPU `exp` of torch and XLA differ in the last ulps, and the port sums
  each row of p in its kernel's order; an ulp can also move a p across a
  BFP rounding boundary (ROADMAP C6), which would change o by one step of
  p (2^-7 relative) and does not happen on these draws. Above m = 8 the
  reference's f32 dot rounds the scores' partial sums past 2^24 where the
  port sums exactly (ROADMAP C4): 2e-5 there.
- bf16 forward: o within one bf16 rounding of each side (2^-8 relative
  each) of the reference, lse as in f32.
- Gradients: dq, dk, dv are f32 sums of exact products with varying
  scales, summed in other orders (the B3-style bound, 2·S·2^-24 relative
  to the largest |grad| here): within 1e-4 of the largest |grad| in f32,
  plus one bf16 rounding of each side for bf16. Above m = 8 the C4
  difference in the scores reaches p and ds: 1e-3 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.hbfp_flash_attn import FlashSpec as JFlashSpec
from repro.kernels.hbfp_flash_attn import flash_attention_vjp
from repro.kernels.hbfp_flash_attn import \
    hbfp_flash_attention as jflash_fwd
from repro.kernels.hbfp_flash_attn import \
    hbfp_flash_attention_bwd as jflash_bwd
from repro.models import attention as jattention
from repro.models.layers import Ctx as JCtx
from repro.precision import parse_policy as jparse_policy
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattention
from repro_torch.models.layers import Ctx
from repro_torch.precision import parse_policy

HD = 32
BLK = 32
# (S, m_bits, m_qk, m_pv, causal, dtype)
CASES = [
    (64, 8, 0, 0, True, "float32"),
    (96, 8, 0, 0, True, "float32"),
    (64, 8, 0, 0, False, "float32"),
    (96, 12, 0, 0, False, "float32"),
    (64, 12, 0, 0, True, "float32"),
    (64, 8, 10, 0, True, "float32"),
    (64, 8, 0, 6, True, "float32"),
    (96, 8, 12, 6, True, "float32"),
    (64, 8, 0, 0, True, "bfloat16"),
    (96, 8, 0, 0, False, "bfloat16"),
    (64, 12, 0, 0, True, "bfloat16"),
    (64, 8, 12, 6, False, "bfloat16"),
]
BF16_ROUND = 2.0 ** -8 / (1 - 2.0 ** -8)


def _draw(seed, S, n=4, BH=2, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BH, S, hd)).astype(np.float32)
            for _ in range(n)]


def _jx(a, dtype):
    return jnp.asarray(a, dtype=getattr(jnp, dtype))


def _tx(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32), np.float32)


def _close(ref, got, dtype, atol):
    """|Δ| <= atol (+ one bf16 rounding of each side for bf16)."""
    ref, got = _np(ref), _np(got)
    tol = atol + (BF16_ROUND * (np.abs(ref) + np.abs(got))
                  if dtype == "bfloat16" else 0.0)
    d = np.abs(ref - got)
    assert (d <= tol).all(), (float(d.max()), float((d - tol).max()))
    return float(d.max())


def _fwd_atol(m, m_qk=0, m_pv=0):
    return 2e-6 if max(m_qk or m, m_pv or m) <= 8 else 2e-5


def _grad_atol(ref, m, m_qk=0, m_pv=0):
    rel = 1e-4 if max(m_qk or m, m_pv or m) <= 8 else 1e-3
    return rel * float(np.abs(_np(ref)).max())


def _kw(m, m_qk, m_pv, causal):
    return dict(m_bits=m, m_qk=m_qk, m_pv=m_pv, bq=BLK, bk=BLK, causal=causal)


@pytest.mark.parametrize("S,m,m_qk,m_pv,causal,dtype", CASES)
def test_forward_plain_matches_oracle_and_pallas(S, m, m_qk, m_pv, causal,
                                                 dtype):
    q, k, v = _draw(S + m + m_qk, S, 3)
    kw = _kw(m, m_qk, m_pv, causal)
    jq, jk, jv = (_jx(a, dtype) for a in (q, k, v))
    oracle = jref.hbfp_flash_attn_ref(jq, jk, jv, with_lse=True, **kw)
    pallas = jflash_fwd(jq, jk, jv, with_lse=True, interpret=True, **kw)
    fa.reset_counts()
    o, lse = fa.hbfp_flash_fwd(*(_tx(a, dtype) for a in (q, k, v)),
                               with_lse=True, **kw)
    assert fa.hbfp_flash_fwd.plain_calls == 1
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert o.shape == (2, S, HD) and lse.shape == (2, S)
    atol = _fwd_atol(m, m_qk, m_pv)
    for jo, jl in (oracle, pallas):
        _close(jo, o, dtype, atol)
        _close(jl, lse, "float32", atol)
    # without lse: the same o
    o2 = fa.hbfp_flash_fwd(*(_tx(a, dtype) for a in (q, k, v)), **kw)
    assert torch.equal(o, o2)


@pytest.mark.parametrize("S,m,m_qk,m_pv,causal,dtype", CASES)
def test_backward_plain_matches_oracle_and_pallas(S, m, m_qk, m_pv, causal,
                                                  dtype):
    """B5/B6's plain versions from the same saved o and lse as the Pallas
    backward, and the full VJP composition against the JAX oracle."""
    q, k, v, do = _draw(S + m + m_pv + 1, S)
    do = do * 1e-2
    kw = _kw(m, m_qk, m_pv, causal)
    jq, jk, jv, jdo = (_jx(a, dtype) for a in (q, k, v, do))
    jo, jl = jflash_fwd(jq, jk, jv, with_lse=True, interpret=True, **kw)
    pallas = jflash_bwd(jq, jk, jv, jo, jl, jdo, interpret=True, **kw)
    oracle = jref.hbfp_flash_attn_vjp_ref(jq, jk, jv, jdo, **kw)
    tq, tk, tv, tdo = (_tx(a, dtype) for a in (q, k, v, do))
    to = torch.from_numpy(_np(jo)).to(tq.dtype)
    tl = torch.from_numpy(np.asarray(jl))
    fa.reset_counts()
    got = fa.hbfp_flash_attention_bwd(tq, tk, tv, to, tl, tdo, **kw)
    assert fa.hbfp_flash_dq.plain_calls == fa.hbfp_flash_dkv.plain_calls == 1
    composed = tref.hbfp_flash_attn_vjp_ref(tq, tk, tv, tdo, **kw)
    for ref, port in ((pallas, got), (oracle, composed)):
        for r, g in zip(ref, port):
            assert g.dtype == tq.dtype
            _close(r, g, dtype, _grad_atol(r, m, m_qk, m_pv))


def test_autograd_function_matches_reference_vjp():
    """`FlashAttention` through torch.autograd.grad against the JAX
    oracle's VJP and the reference's custom VJP (Pallas, interpret), with
    per-role widths (12, 6)."""
    S = 64
    q, k, v, do = _draw(7, S)
    kw = _kw(8, 12, 6, True)
    spec = fa.FlashSpec(m_bits=8, bq=BLK, bk=BLK, causal=True, m_qk=12,
                        m_pv=6)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = fa.FlashAttention.apply(spec, tq, tk, tv)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    oracle = jref.hbfp_flash_attn_vjp_ref(*map(jnp.asarray, (q, k, v, do)),
                                          **kw)
    jspec = JFlashSpec(m_bits=8, bq=BLK, bk=BLK, causal=True,
                       interpret=True, m_qk=12, m_pv=6)
    jo, vjp = jax.vjp(lambda a, b, c: flash_attention_vjp(jspec, a, b, c),
                      *map(jnp.asarray, (q, k, v)))
    pallas = vjp(jnp.asarray(do))
    _close(jo, o.detach(), "float32", _fwd_atol(8, 12, 6))
    for ref in (oracle, pallas):
        for r, g in zip(ref, grads):
            _close(r, g, "float32", _grad_atol(r, 8, 12, 6))
    # the Function is exactly the port's own oracle composition
    mine = tref.hbfp_flash_attn_vjp_ref(
        *(torch.from_numpy(a) for a in (q, k, v, do)), **kw)
    assert all(torch.equal(a, b) for a, b in zip(mine, grads))


@pytest.mark.parametrize("spec", ["8; backend=pallas",
                                  "8; attn_qk=12; attn_pv=6; backend=pallas"])
def test_flash_mha_gqa_grads_match_reference(spec):
    """flash_mha with GQA (4 query heads on 2 kv heads): the port's
    repeat_interleave pairs each kv head with its own query group, as the
    reference's jnp.repeat(axis=1) does, and autograd sums the group grads;
    role widths resolve into the spec like the reference's."""
    B, H, Hkv, S = 1, 4, 2, 64
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, S, HD)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, HD)).astype(np.float32)
            for _ in range(2))
    do = (rng.standard_normal((B, H, S, HD)) * 1e-2).astype(np.float32)
    jctx = JCtx(policy=jparse_policy(spec).resolve_segment(0))
    tctx = Ctx(policy=parse_policy(spec).resolve_segment(0), device="cpu")
    jo, vjp = jax.vjp(lambda a, b, c: jattention.flash_mha(a, b, c, jctx),
                      *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tattention.flash_mha(tq, tk, tv, tctx)
    tg = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    widths = (12, 6) if "attn_qk" in spec else (0, 0)
    _close(jo, o.detach(), "float32", _fwd_atol(8, *widths))
    for r, g in zip(jg, tg):
        assert g.shape == r.shape
        _close(r, g, "float32", _grad_atol(r, 8, *widths))


def test_wrappers_check_and_count():
    """Shapes and types are checked; a non-CPU tensor never runs the plain
    version (here a `meta` tensor: the wrapper raises instead of falling
    back); the counters count plain calls on the CPU."""
    q = torch.zeros((2, 64, HD))
    with pytest.raises(ValueError):
        fa.hbfp_flash_fwd(q, q, torch.zeros((2, 64, 16)))
    with pytest.raises(TypeError):
        fa.hbfp_flash_fwd(*(q.to(torch.float16),) * 3)
    with pytest.raises(ValueError):
        fa.hbfp_flash_fwd(q, q, q, bq=48, bk=48)        # 48 does not divide 64
    with pytest.raises(ValueError):
        fa.hbfp_flash_dq(q, q, q, q, torch.zeros((2, 64), dtype=torch.float64),
                         torch.zeros((2, 64)))
    m = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.hbfp_flash_fwd(m, m, m)
    lse = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.hbfp_flash_dkv(m, m, m, m, lse, lse)
    fa.reset_counts()
    fa.hbfp_flash_fwd(q, q, q, bq=32, bk=32)
    assert (fa.hbfp_flash_fwd.plain_calls, fa.hbfp_flash_fwd.launches) == (1, 0)
    fa.reset_counts()
    assert fa.hbfp_flash_fwd.plain_calls == 0


def test_row_sum_order_is_the_kernels():
    """The plain version's row sum adds columns lane + 16·j per lane and
    then halves across 16 lanes; for widths that are not multiples of 16
    the missing columns are zeros. It agrees with a plain sum to f32
    rounding and equals the explicit order bit for bit."""
    rng = np.random.default_rng(5)
    for n in (8, 32, 128):
        p = torch.from_numpy(rng.random((3, n)).astype(np.float32))
        got = tref._row_sum(p)
        for r in range(3):
            lanes = [np.float32(0)] * 16
            for c in range(n):
                lanes[c % 16] = np.float32(lanes[c % 16] + p[r, c].item())
            for off in (8, 4, 2, 1):
                lanes = [np.float32(lanes[i] + lanes[i + off])
                         for i in range(off)]
            assert got[r, 0].item() == lanes[0]
        assert torch.allclose(got[:, 0], p.sum(-1), rtol=1e-6)


def test_flash_spec_matches_reference_fields():
    """FlashSpec carries the reference's fields except `interpret` (the
    port has no interpret mode: the CPU runs the plain versions)."""
    ref = set(JFlashSpec._fields) - {"interpret"}
    assert set(fa.FlashSpec._fields) == ref
    assert fa.hbfp_flash_attention is fa.hbfp_flash_fwd
