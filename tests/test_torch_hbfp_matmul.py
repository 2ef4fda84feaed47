"""The forward HBFP matmul of the port against the JAX package.

`hbfp_matmul_plain` (the CUDA kernel's plain version) is held to
`repro.kernels.ref.hbfp_matmul_ref`, and the kernel-backend entry
`repro_torch.kernels.linear.hbfp_matmul_kernel` (CPU: the plain version
behind pad-and-slice) to the reference's `hbfp_matmul_kernel` running the
Pallas kernel in interpret mode, over quantize_w x m in {8, 12} x
block in {0, 32} x {nearest, stochastic} and non-divisible M/K/N.

Tolerances: block = 0 is bit-exact — integral mantissas against
quantized or narrowed weights give exact K-block sums, and the stochastic
stream is the same counter hash. block > 0 dequantizes operands whose
exponents vary along the contraction, so the f32 sums may round in
another order: rtol 1e-6 of the output's largest magnitude. The
quantize_w=False cases feed weights narrowed by the port's shell.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jfmt
from repro.kernels import linear as jlinear
from repro.kernels import ref as jref
from repro_torch.core import HBFP8_16, HBFP12_16, bfp
from repro_torch.core.opt_shell import narrow_params
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.kernels import linear as tlinear

CASES = list(itertools.product([True, False], [8, 12], [0, 32],
                               [False, True]))


def _ids(c):
    qw, m, b, st = c
    return f"qw{int(qw)}-m{m}-b{b}-{'st' if st else 'rn'}"


def _check(got, ref, block):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if block == 0:
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * float(np.abs(ref).max()))


def _operands(M, K, N, m, quantize_w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    if not quantize_w:
        cfg = HBFP8_16 if m == 8 else HBFP12_16
        w = narrow_params({"w": torch.from_numpy(w)}, cfg)["w"].numpy()
    return x, w


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_matches_reference_oracle(case):
    quantize_w, m, block, stochastic = case
    M, K, N = 16, 256, 384
    x, w = _operands(M, K, N, m, quantize_w, 10 + m + block)
    seed = np.array([[0x1234567]], np.int32)
    kw = dict(mantissa_bits=m, stochastic=stochastic, quantize_w=quantize_w,
              block=block, bm=128, bk=128, bn=128)
    ref = jref.hbfp_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(seed), **kw)
    got = hm.hbfp_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(seed), **kw)
    _check(got.numpy(), ref, block)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_kernel_entry_matches_reference_kernel(case):
    """Non-divisible M, K, N through pad-and-slice on both sides; the
    reference runs the Pallas kernel in interpret mode."""
    quantize_w, m, block, stochastic = case
    M, K, N = 19, 200, 72
    x, w = _operands(M, K, N, m, quantize_w, 30 + m + block)
    jcfg = jfmt.HBFPConfig(mantissa_bits=m, wide_mantissa_bits=16,
                           rounding="stochastic" if stochastic
                           else "nearest", requantize_weights=quantize_w,
                           act_block=block or None)
    tcfg = (HBFP8_16 if m == 8 else HBFP12_16).with_(
        rounding=jcfg.rounding, requantize_weights=quantize_w,
        act_block=block or None)
    key = jax.random.key(7) if stochastic else None
    ref = jlinear.hbfp_matmul_kernel(jnp.asarray(x), jnp.asarray(w), jcfg,
                                     key)
    seed = int(np.asarray(jlinear.seed_from_key(key))[0, 0]) \
        if stochastic else None
    got = tlinear.hbfp_matmul_kernel(torch.from_numpy(x),
                                     torch.from_numpy(w), tcfg, seed)
    _check(got.numpy(), ref, block)


def test_wrapper_counts_and_checks():
    hm.reset_counts()
    x = torch.randn(8, 128)
    w = torch.randn(128, 256)
    y = hm.hbfp_matmul_fwd(x, w, None, quantize_w=True)
    assert y.shape == (8, 256) and y.dtype == torch.float32
    assert hm.hbfp_matmul_fwd.plain_calls == 1
    assert hm.hbfp_matmul_fwd.launches == 0
    with pytest.raises(ValueError):
        hm.hbfp_matmul_fwd(x, w.t().contiguous().t())     # not contiguous
    with pytest.raises(ValueError):
        hm.hbfp_matmul_fwd(torch.randn(8, 200), torch.randn(200, 256))
    with pytest.raises(TypeError):
        hm.hbfp_matmul_fwd(x.double(), w.double())
    with pytest.raises(NotImplementedError):
        tlinear.hbfp_matmul_kernel(x.requires_grad_(), w, HBFP8_16)
    hm.reset_counts()


def test_narrowed_weights_exact_in_bf16():
    """The served operands: narrow m=8 weights survive the bf16 cast, so the
    bf16-weight kernel path computes the same function as the f32 one."""
    w = torch.randn(256, 384) / 16
    wn = bfp.quantize_weight(w, HBFP8_16)
    assert torch.equal(wn.to(torch.bfloat16).float(), wn)
    x = torch.randn(4, 256)
    a = hm.hbfp_matmul_fwd(x, wn, quantize_w=False)
    b = hm.hbfp_matmul_fwd(x, wn.to(torch.bfloat16), quantize_w=False)
    assert torch.equal(a, b)
