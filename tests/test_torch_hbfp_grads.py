"""The backward HBFP GEMMs of the port against the JAX package.

* B2: the port's `hbfp_dgrad_ref` (the CUDA dgrad kernel's plain version)
  against the reference's oracle `repro.kernels.ref.hbfp_dgrad_ref` and
  its Pallas kernel `hbfp_dgrad_pallas` in interpret mode, over
  m in {4, 8, 12} x {nearest, stochastic} x quantize_w x block in {0, 32}:
  bit for bit (integral mantissas give exact N-block sums, the stochastic
  stream is the same counter hash, and at block 32 each N-block's f32 dot
  of dequantized operands is summed alike by torch and XLA at this size).
* B3: the port's `hbfp_wgrad_ref` against `hbfp_wgrad_ref` /
  `hbfp_wgrad_pallas`: its dequantized operands x̂, ĝ equal the
  reference's quantizer bit for bit; dw adds the M-blocks in the oracle's
  order, but each block's f32 dot over tokens with varying scales is
  summed in another order by torch and XLA, so dw is held to
  |Δ| <= 2^-20 · (|x̂|ᵀ|ĝ|) elementwise (inside the f32 rounding bound
  2·M·2^-24 of an M = 64 term sum) and the bit-equal share is reported.
* The autograd Functions: `kernels.linear.hbfp_matmul_kernel` (B1/B2/B3
  behind pad-and-slice, per-role widths and stochastic seeds included)
  against `jax.vjp` of the reference's custom VJP in interpret mode (y and
  dx bit for bit at block 0, else within 1e-6 · max|ref|; dw within
  1e-6 · max|ref|), and
  `core.hbfp_ops.hbfp_matmul` (the sim path, GQA broadcast dims included)
  against `jax.vjp` of the reference's: within 1e-6 · max|ref| (f32 sums
  over varying scales in another order).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jfmt
from repro.core import hbfp_ops as jops
from repro.kernels import common as jcommon
from repro.kernels import linear as jlinear
from repro.kernels import ref as jref
from repro.kernels.hbfp_matmul import hbfp_dgrad_pallas, hbfp_wgrad_pallas
from repro_torch.core import HBFP8_16, HBFPConfig, hbfp_ops as tops
from repro_torch.core.opt_shell import narrow_params
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.kernels import linear as tlinear

SEED = 0x1234567
DGRAD_CASES = list(itertools.product([4, 8, 12], [False, True],
                                     [True, False], [0, 32]))
WGRAD_CASES = list(itertools.product([4, 8, 12], [False, True], [0, 32]))
# (M, K, N) and tiles (bm, bk, bn): several blocks on every axis
SHAPE, TILES = (64, 256, 192), dict(bm=32, bk=128, bn=64)
WGRAD_TOL = 2.0 ** -20


def _rn(st):
    return "st" if st else "rn"


def _tolerance_check(got, ref, block):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if block == 0:
        assert np.array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _narrow(w, m):
    cfg = HBFPConfig(mantissa_bits=m, wide_mantissa_bits=16)
    return narrow_params({"w": torch.from_numpy(w)}, cfg)["w"].numpy()


@pytest.mark.parametrize(
    "m,st,qw,block", DGRAD_CASES,
    ids=[f"m{m}-{_rn(st)}-qw{int(qw)}-b{b}" for m, st, qw, b in DGRAD_CASES])
def test_dgrad_plain_matches_oracle_and_pallas(m, st, qw, block):
    M, K, N = SHAPE
    rng = np.random.default_rng(m * 7 + block + qw)
    g = (rng.standard_normal((M, N)) * 3).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(N)).astype(np.float32)
    if not qw:
        w = _narrow(w, m)
    seed = np.array([[SEED]], np.int32)
    kw = dict(mantissa_bits=m, stochastic=st, quantize_w=qw, block=block,
              **TILES)
    ref = jref.hbfp_dgrad_ref(jnp.asarray(g), jnp.asarray(w),
                              jnp.asarray(seed), **kw)
    pal = hbfp_dgrad_pallas(jnp.asarray(g), jnp.asarray(w),
                            jnp.asarray(seed), interpret=True, **kw)
    hm.reset_counts()
    got = hm.hbfp_dgrad(torch.from_numpy(g), torch.from_numpy(w),
                        torch.from_numpy(seed), **kw)
    assert hm.hbfp_dgrad.plain_calls == 1 and hm.hbfp_dgrad.launches == 0
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), np.asarray(pal))


def _jax_dequant(a, width, m, block, st, stream):
    """The reference's quantizer over [R, C] in (row, width) tiles."""
    R, C = a.shape
    out = []
    for c0 in range(0, C, width):
        s = jnp.asarray(a[:, c0:c0 + width])
        idx = None
        if st:
            r = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
            c = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
            idx = r * C + (c0 + c) + jnp.int32(stream)
        q, d = jcommon.quantize_block(
            s, m, jcommon.row_group_amax(s, block), stochastic=st,
            seed=jnp.int32(SEED), idx=idx)
        out.append(np.asarray(q * d))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize(
    "m,st,block", WGRAD_CASES,
    ids=[f"m{m}-{_rn(st)}-b{b}" for m, st, b in WGRAD_CASES])
def test_wgrad_plain_matches_oracle_and_pallas(m, st, block):
    M, K, N = SHAPE
    rng = np.random.default_rng(100 + m * 7 + block)
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    g = (rng.standard_normal((M, N)) * 1e-2).astype(np.float32)
    seed = np.array([[SEED]], np.int32)
    kw = dict(mantissa_bits=m, stochastic=st, block=block, **TILES)
    ref = np.asarray(jref.hbfp_wgrad_ref(jnp.asarray(x), jnp.asarray(g),
                                         jnp.asarray(seed), **kw))
    pal = np.asarray(hbfp_wgrad_pallas(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(seed), interpret=True,
                                       **kw))
    dw, xh, gh = hm.hbfp_wgrad(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(seed), operands=True, **kw)
    xh_ref = _jax_dequant(x, TILES["bk"], m, block, st, jcommon.STREAM_X)
    gh_ref = _jax_dequant(g, TILES["bn"], m, block, st, jcommon.STREAM_G)
    assert np.array_equal(xh.numpy(), xh_ref)
    assert np.array_equal(gh.numpy(), gh_ref)
    bound = WGRAD_TOL * (np.abs(xh_ref).T @ np.abs(gh_ref))
    for other in (ref, pal):
        assert np.all(np.abs(dw.numpy() - other) <= bound)
    share = float(np.mean(dw.numpy() == ref))
    print(f"wgrad m={m} {_rn(st)} b={block}: bit-equal share {share:.4f}")


def _pair_cfgs(m, st, block, qw=True):
    rounding = "stochastic" if st else "nearest"
    j = jfmt.HBFPConfig(mantissa_bits=m, wide_mantissa_bits=16,
                        rounding=rounding, requantize_weights=qw,
                        act_block=block or None)
    t = HBFPConfig(mantissa_bits=m, wide_mantissa_bits=16, rounding=rounding,
                   requantize_weights=qw, act_block=block or None)
    return j, t


LINEAR_CASES = [(st, block, roles) for st in (False, True)
                for block in (0, 32) for roles in (False, True)]


@pytest.mark.parametrize(
    "st,block,roles", LINEAR_CASES,
    ids=[f"{_rn(st)}-b{b}-{'wgrad+4' if r else 'uniform'}"
         for st, b, r in LINEAR_CASES])
def test_kernel_autograd_matches_reference_vjp(st, block, roles):
    """B1/B2/B3 under the autograd Function on a shape that pads M (150 ->
    256) and clips K, N to single tiles, against `jax.vjp` of the
    reference's custom VJP with the Pallas kernels in interpret mode.
    roles: the "8; wgrad+4" policy's per-role wgrad width."""
    M, K, N = 150, 96, 64
    rng = np.random.default_rng(5 + block + 2 * st + roles)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((M, N)).astype(np.float32)
    jcfg, tcfg = _pair_cfgs(8, st, block)
    jw = tw = None
    if roles:
        jw = jcfg.with_(mantissa_bits=12)
        tw = tcfg.with_(mantissa_bits=12)
    key = jax.random.key(11) if st else None
    y, vjp = jax.vjp(lambda a, b: jlinear.hbfp_matmul_kernel(
        a, b, jcfg, key, wgrad_cfg=jw), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gy))
    seed = int(np.asarray(jlinear.seed_from_key(key))[0, 0]) if st else None
    tx = torch.from_numpy(x).requires_grad_()
    tw_ = torch.from_numpy(w).requires_grad_()
    ty = tlinear.hbfp_matmul_kernel(tx, tw_, tcfg, seed, wgrad_cfg=tw)
    ty.backward(torch.from_numpy(gy))
    _tolerance_check(ty.detach().numpy(), y, block)
    _tolerance_check(tx.grad.numpy(), jdx, block)
    np.testing.assert_allclose(tw_.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=1e-6 * float(np.abs(jdw).max()))


SIM_CASES = [("weight", False), ("weight", True), ("act", False),
             ("act", True)]


@pytest.mark.parametrize("kind,roles", SIM_CASES,
                         ids=[f"{k}-{'roles' if r else 'uniform'}"
                              for k, r in SIM_CASES])
def test_sim_autograd_matches_reference_vjp(kind, roles):
    """The sim path's Function against `jax.vjp` of the reference's
    `hbfp_matmul`: a [B,S,K] x [K,N] projection, and the attention shape
    qb [B,Hkv,G,C,hd] x kᵀ [B,Hkv,1,hd,S] whose size-1 GQA dim sums in the
    backward; roles: dgrad at 6 and wgrad at 12 bits."""
    rng = np.random.default_rng(17 + roles)
    if kind == "weight":
        x = rng.standard_normal((2, 24, 160)).astype(np.float32)
        w = (rng.standard_normal((160, 96)) * 0.1).astype(np.float32)
    else:
        x = rng.standard_normal((2, 2, 3, 8, 32)).astype(np.float32)
        w = rng.standard_normal((2, 2, 1, 32, 16)).astype(np.float32)
    jcfg = jfmt.HBFPConfig(8, 16)
    tcfg = HBFP8_16
    jd = jw = td = tw = None
    if roles:
        jd, jw = jcfg.with_(mantissa_bits=6), jcfg.with_(mantissa_bits=12)
        td, tw = tcfg.with_(mantissa_bits=6), tcfg.with_(mantissa_bits=12)
    y, vjp = jax.vjp(lambda a, b: jops.hbfp_matmul(
        a, b, jcfg, None, w_kind=kind, dgrad_cfg=jd, wgrad_cfg=jw),
        jnp.asarray(x), jnp.asarray(w))
    gy = rng.standard_normal(y.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    tw_ = torch.from_numpy(w).requires_grad_()
    ty = tops.hbfp_matmul(tx, tw_, tcfg, w_kind=kind, dgrad_cfg=td,
                          wgrad_cfg=tw)
    ty.backward(torch.from_numpy(gy))
    for got, ref in ((ty.detach(), y), (tx.grad, jdx), (tw_.grad, jdw)):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_backward_wrappers_check_and_count():
    hm.reset_counts()
    g = torch.randn(8, 256)
    w = torch.randn(128, 256)
    dx = hm.hbfp_dgrad(g, w)
    dw = hm.hbfp_wgrad(torch.randn(8, 128), g)
    assert dx.shape == (8, 128) and dw.shape == (128, 256)
    assert hm.hbfp_dgrad.plain_calls == 1 and hm.hbfp_wgrad.plain_calls == 1
    assert hm.hbfp_dgrad.launches == 0 and hm.hbfp_wgrad.launches == 0
    with pytest.raises(ValueError):
        hm.hbfp_dgrad(g, torch.randn(128, 200))              # N differs
    with pytest.raises(ValueError):
        hm.hbfp_wgrad(torch.randn(8, 200), torch.randn(8, 256))  # 200 % 128
    with pytest.raises(TypeError):
        hm.hbfp_dgrad(g.double(), w.double())
    with pytest.raises(ValueError):
        hm.hbfp_wgrad(torch.randn(128, 8).t(), g)            # not contiguous
    hm.reset_counts()
