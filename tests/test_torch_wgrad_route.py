"""Routes of the port's B3 (wgrad) and the arithmetic that keeps its bf16
tensor-core route within B3's stated bound of the plain version.

On the card a B3 call takes one of two routes (`hbfp_matmul.wgrad_route`,
mirrored by `wgrad_route` in `csrc/hbfp_matmul_bwd.cu`): bf16 wgmma
over the dequantized operands x̂ and ĝ written in bf16, one f32 fragment
per M-block of bm tokens promoted in ascending M-block order, or the
CUDA-core f32 GEMM. Here, on the CPU:

- the route table: every main-path wgrad call (gemma2-2b and yi-9b
  training at "8; backend=pallas", the adaptive "4; wgrad+4" path, block
  32) takes bf16 wgmma; m 12 and tiles the tensor-core kernel does not
  take stay on the CUDA cores;
- bf16 holds x̂ and ĝ exactly at m 2-8, for extreme exponents, block > 0
  and stochastic rounding; the quantizer's step floor keeps every nonzero
  operand a normal bf16 (never below 2^-126, let alone bf16's subnormal
  floor 2^-133);
- a torch emulation of the kernel's order (an M-block's f32 product,
  added in ascending M-block order) stays within 2·M·2^-24·(|x̂|ᵀ|ĝ|) of
  `hbfp_wgrad_plain` and of the JAX oracle;
- the wrapper's scratch per route.

The `gpu`-marked cases hold the kernel to its plain version per route on
the card; they skip where there is no CUDA device:
    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_wgrad_route.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HBFPConfig
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.kernels import linear as tlinear
from repro_torch.kernels.common import EXP_CEIL, EXP_FLOOR
from repro_torch.precision import parse_policy
from repro_torch.precision.policy import role_width_for

BF16, F32 = torch.bfloat16, torch.float32
F32_UNIT = 2.0 ** -24
ADAPT_BASE = HBFPConfig(4, 16, tile=24)

# (name, policy, base, M, K, N, expected route); shapes are the layers'
# (K, N) at full width, M the training tokens
MAIN_PATH = [
    ("gemma2_wq", "8; backend=pallas", None, 4096, 2304, 2048,
     "bf16_wgmma"),
    ("gemma2_ffn_wo", "8; backend=pallas", None, 4096, 9216, 2304,
     "bf16_wgmma"),
    ("gemma2_head", "8; backend=pallas", None, 4096, 2304, 256000,
     "bf16_wgmma"),
    ("yi9b_wk", "8; backend=pallas", None, 4096, 4096, 512, "bf16_wgmma"),
    ("yi9b_head", "8; backend=pallas", None, 4096, 4096, 64000,
     "bf16_wgmma"),
    ("adaptive_ffn_wg", "4; wgrad+4; backend=pallas", ADAPT_BASE, 4096,
     4096, 11008, "bf16_wgmma"),
    ("block32", "8; b=32; backend=pallas", None, 4096,
     2304, 2048, "bf16_wgmma"),
]


def _wgrad_spec(policy, base, M, K, N):
    """The KernelSpec of one projection's wgrad, resolved as the training
    step resolves it (wgrad at its role width)."""
    pol = parse_policy(policy, base=base) if base else parse_policy(policy)
    seg = pol.resolve_segment(0)
    cfg = seg.global_cfg
    rw = role_width_for(seg.role_widths, "wgrad")
    return tlinear.resolve_spec(cfg, M, K, N, dtype="bfloat16",
                                wgrad_cfg=None if rw is None else
                                rw.apply(cfg))


@pytest.mark.parametrize("case", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
def test_route_table_main_path(case):
    name, policy, base, M, K, N, want = case
    spec = _wgrad_spec(policy, base, M, K, N)
    bm, bk, bn = tlinear._tiles(spec.wgrad, M, K, N, spec.block)
    m = spec.m_wgrad or spec.mantissa_bits
    assert m <= 8 and spec.block == (32 if name == "block32" else 0)
    assert hm.wgrad_route(mantissa_bits=m, M=M, K=K, N=N, bm=bm) == want


@pytest.mark.parametrize("m,M,K,N,bm,want", [
    (12, 4096, 2304, 2048, 128, "cuda_core"),     # m 9-12: f32 GEMM
    (9, 4096, 2304, 2048, 128, "cuda_core"),
    (8, 4096, 2304, 2048, 64, "bf16_wgmma"),      # one 64-token stage
    (8, 4096, 2304, 2048, 256, "bf16_wgmma"),
    (8, 96, 2304, 2048, 96, "cuda_core"),         # not whole stages
    (8, 4096, 2300, 2048, 128, "cuda_core"),      # x̂ rows not 16 bytes
    (8, 4096, 2304, 2044, 128, "cuda_core"),      # ĝ rows not 16 bytes
    (8, 256, 64, 512, 128, "bf16_wgmma"),         # K <= 64: split M-blocks
])
def test_route_table_off_path(m, M, K, N, bm, want):
    assert hm.wgrad_route(mantissa_bits=m, M=M, K=K, N=N, bm=bm) == want


def _extreme(rng, shape, lo, hi):
    """Normal draws scaled by 2^e, e uniform in [lo, hi] per element."""
    e = rng.integers(lo, hi + 1, size=shape)
    return (rng.standard_normal(shape) * np.exp2(e)).astype(np.float32)


@pytest.mark.parametrize("m", [2, 4, 6, 8])
@pytest.mark.parametrize("block", [0, 32])
@pytest.mark.parametrize("stochastic", [False, True])
def test_dequantized_operands_exact_in_bf16(m, block, stochastic):
    """x̂ = q·δ with |q| <= 2^(m-1) - 1 and δ a power of two between
    2^(EXP_FLOOR - m + 2) and 2^(EXP_CEIL - m + 2): seven significant bits
    at most and a normal bf16 exponent, so the bf16 scratch holds it
    exactly, with rows whose magnitudes span the whole f32 range."""
    rng = np.random.default_rng(10 * m + block + stochastic)
    M, K, N = 128, 256, 128
    x = _extreme(rng, (M, K), -140, 126)
    x[0] = 0.0
    x[1] = np.float32(1e-42)                        # f32 subnormals
    x[2, :] = np.float32(3.0e38)                    # near f32's top
    g = _extreme(rng, (M, N), -120, 100)
    _, xh, gh = hm.hbfp_wgrad_plain(
        torch.from_numpy(x), torch.from_numpy(g), 0x5EED,
        mantissa_bits=m, stochastic=stochastic, block=block, bm=128, bk=128,
        bn=128, operands=True)
    for a in (xh, gh):
        assert torch.equal(a.to(BF16).float(), a)
        nz = a[a != 0].abs()
        assert float(nz.min()) >= 2.0 ** (EXP_FLOOR - m + 2)
        assert float(nz.max()) < 2.0 ** (EXP_CEIL + 1)


def test_step_floor_keeps_operands_normal_in_bf16():
    """The subnormal edge, from the quantizer's arithmetic: the smallest
    step at m <= 8 is 2^(EXP_FLOOR - 8 + 2) = 2^-106, so a nonzero
    dequantized operand is at least 2^-106, above bf16's smallest normal
    2^-126 and far above its subnormal floor 2^-133; no call needs the
    CUDA cores for it. An operand whose every value is a subnormal f32
    quantizes on that floor and rounds to zero."""
    smallest_step = 2.0 ** (EXP_FLOOR - 8 + 2)
    assert smallest_step == 2.0 ** -106
    assert smallest_step >= torch.finfo(BF16).tiny          # 2^-126
    assert smallest_step > 2.0 ** -133
    tiny = torch.full((64, 128), 1e-40, dtype=F32)
    _, xh, _ = hm.hbfp_wgrad_plain(tiny, tiny, mantissa_bits=8, bm=64,
                                   bk=128, bn=128, operands=True)
    assert torch.count_nonzero(xh) == 0
    # the largest: 127 * 2^(EXP_CEIL - 8 + 2) < 2^127 < bf16's max
    assert 127 * 2.0 ** (EXP_CEIL - 6) < float(torch.finfo(BF16).max)


def _promoted(xh, gh, bm, order):
    """B3's bf16 route emulated: each M-block's product in its own f32
    accumulator (its internal order `order`: the tensor core's is its
    own), added to dw with one f32 add per block in ascending order."""
    M = xh.shape[0]
    acc = torch.zeros((xh.shape[1], gh.shape[1]), dtype=F32)
    for m0 in range(0, M, bm):
        xb, gb = xh[m0:m0 + bm], gh[m0:m0 + bm]
        if order == "exact":
            part = (xb.double().T @ gb.double()).float()
        else:
            rows = range(bm) if order == "forward" else reversed(range(bm))
            part = torch.zeros_like(acc)
            for r in rows:
                part = part + torch.outer(xb[r], gb[r])
        acc = acc + part
    return acc


@pytest.mark.parametrize("order", ["exact", "forward", "reverse"])
@pytest.mark.parametrize("m,block", [(8, 0), (4, 0), (8, 32)])
def test_promotion_within_bound_of_plain_and_oracle(order, m, block):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    M, K, N, bm = 256, 128, 128, 128
    rng = np.random.default_rng(3 * m + block)
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    g = (rng.standard_normal((M, N)) * 1e-3).astype(np.float32)
    kw = dict(mantissa_bits=m, block=block, bm=bm, bk=128, bn=128)
    want, xh, gh = hm.hbfp_wgrad_plain(torch.from_numpy(x),
                                       torch.from_numpy(g), operands=True,
                                       **kw)
    # the bf16 scratch the kernel reads
    got = _promoted(xh.to(BF16).float(), gh.to(BF16).float(), bm, order)
    bound = 2 * M * F32_UNIT * (xh.abs().T @ gh.abs())
    oracle = torch.from_numpy(np.array(jref.hbfp_wgrad_ref(
        jnp.asarray(x), jnp.asarray(g), **kw)))
    for other in (want, oracle):
        assert bool(((got - other).abs() <= bound).all())


@pytest.mark.parametrize("route", hm.ROUTES[1:])
def test_scratch_per_route(route):
    M, K, N = 4096, 2304, 2048
    s = hm.wgrad_scratch(route, M, K, N, bm=128, bk=128, bn=128, block=0)
    assert list(s) == ["xq", "sx", "gq", "sg", "xh", "gh", "part"]
    assert s["sx"] == ((M, K // 128), F32)
    assert s["sg"] == ((M, N // 128), F32)
    assert s["part"] is None
    if route == "cuda_core":
        assert s["xq"] == ((M, K), F32) and s["gq"] == ((M, N), F32)
        assert s["xh"] is None and s["gh"] is None
    else:
        # half the former f32 scratch
        assert s["xh"] == ((M, K), BF16) and s["gh"] == ((M, N), BF16)
        assert s["xq"] is None and s["gq"] is None
        small = hm.wgrad_scratch(route, 4096, 64, 512, bm=128, bk=64,
                                 bn=128, block=0)
        assert small["part"] == ((32, 64, 512), F32)
    b32 = hm.wgrad_scratch(route, M, K, N, bm=128, bk=128, bn=128,
                           block=32)
    assert b32["sx"] == ((M, K // 32), F32)


def test_launches_by_route_counts_only_card_launches():
    hm.reset_counts()
    x = torch.randn(128, 128)
    hm.hbfp_wgrad(x, x)
    assert hm.hbfp_wgrad.plain_calls == 1
    assert hm.hbfp_wgrad.launches_by_route == dict.fromkeys(hm.ROUTES, 0)
    hm.reset_counts()


# (route, m, stochastic, block, M, K, N) of the card cases
GPU_CASES = [("bf16_wgmma", m, st, b, M, K, N)
             for m, st in ((8, False), (4, True))
             for b in (0, 32)
             for M, K, N in ((256, 512, 512), (128, 64, 512))] + \
            [("cuda_core", 12, False, 0, 256, 512, 512),
             ("cuda_core", 8, False, 0, 96, 512, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES,
                         ids=["-".join(map(str, c)) for c in GPU_CASES])
def test_kernel_within_bound_of_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    route, m, st, block, M, K, N = case
    dev = torch.device("cuda")
    rng = np.random.default_rng(M + K + m)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((M, N)) * 1e-3).astype(
        np.float32))
    x, g = x.to(BF16).to(dev), g.to(dev)
    bm = min(128, M)
    kw = dict(mantissa_bits=m, stochastic=st, block=block, bm=bm,
              bk=min(128, K), bn=128)
    assert hm.wgrad_route(mantissa_bits=m, M=M, K=K, N=N, bm=bm) == route
    hm.reset_counts()
    got, xh, gh = hm.hbfp_wgrad(x, g, 0x5EED, operands=True, **kw)
    want, xhp, ghp = hm.hbfp_wgrad_plain(x, g, 0x5EED, operands=True, **kw)
    torch.cuda.synchronize()
    assert hm.hbfp_wgrad.launches_by_route[route] == 1
    assert torch.equal(xh, xhp) and torch.equal(gh, ghp)
    bound = 2 * M * F32_UNIT * (xh.abs().T @ gh.abs())
    assert bool(((got - want).abs() <= bound).all())
