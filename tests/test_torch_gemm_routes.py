"""Routes of the port's B1 (forward) and B2 (dgrad) GEMMs and the
arithmetic that keeps each route bit for bit equal to the plain versions.

On the card a call takes one of three routes (`hbfp_matmul.gemm_route`,
mirrored by `tc_route` in `csrc/hbfp_gemm_sm90.cuh`): int8 wgmma with an
int32 sum per K-block, bf16 wgmma with an f32 sum per K-block, or the
CUDA-core f32 GEMM. Here, on the CPU:

- the route table: every main-path call (gemma2-2b and yi-9b training at
  "8; backend=pallas", the adaptive "4; wgrad+4" path before and after a
  widen, yi-9b serving) and the off-path cases (m 12, block 32, f32 raw
  weights), with the kernel spec resolved from the policy as the model
  code resolves it;
- the int32 dataflow: an exact integer sum of a K-block's mantissas,
  rounded once to f32, equals the plain versions' float64 partial bit for
  bit, also where the sum passes 2^24 (bk 4096), and a kernel-order
  emulation of the whole product equals `hbfp_matmul_plain` /
  `hbfp_dgrad_plain` and, at bk 512, the JAX reference's Pallas kernel in
  interpret mode;
- the decode fold: per-K-block scaled partials computed in K-range splits
  and folded in ascending order equal the plain version bit for bit;
- the wrapper's scratch per route.

JAX is imported inside the one test that runs the reference, so the
card cases run where JAX is not installed. The `gpu`-marked cases hold the kernels to their plain versions per route
at small shapes with `torch.equal` (block = 0 is exact on every route);
they skip where there is no CUDA device. Run them on the card:
    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gemm_routes.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HBFP8_16, HBFPConfig, bfp
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.kernels import linear as tlinear
from repro_torch.kernels.common import STREAM_G, STREAM_X
from repro_torch.kernels.ref import _quantize_rows, _quantize_w
from repro_torch.precision import parse_policy
from repro_torch.precision.policy import role_width_for

BF16, F32 = torch.bfloat16, torch.float32
ADAPT_BASE = HBFPConfig(4, 16, tile=24)

# (name, policy, base, weights requantized in the kernel, op, M, K, N,
# w dtype, expected route); shapes are the layers' (K, N) at full width
MAIN_PATH = [
    ("gemma2_fwd_wq", "8; backend=pallas", None, True, "fwd", 4096, 2304,
     2048, BF16, "int8_wgmma"),
    ("gemma2_dgrad_ffn_wo", "8; backend=pallas", None, True, "dgrad", 4096,
     9216, 2304, BF16, "int8_wgmma"),
    ("gemma2_fwd_head", "8; backend=pallas", None, True, "fwd", 4096, 2304,
     256000, BF16, "int8_wgmma"),
    ("yi9b_fwd_wk", "8; backend=pallas", None, True, "fwd", 4096, 4096, 512,
     BF16, "int8_wgmma"),
    ("yi9b_dgrad_ffn_wg", "8; backend=pallas", None, True, "dgrad", 4096,
     4096, 11008, BF16, "int8_wgmma"),
    ("adaptive_before_widen_fwd", "4; wgrad+4; backend=pallas", ADAPT_BASE,
     True, "fwd", 4096, 4096, 11008, BF16, "int8_wgmma"),
    ("adaptive_before_widen_dgrad", "4; wgrad+4; backend=pallas",
     ADAPT_BASE, True, "dgrad", 4096, 4096, 11008, BF16, "int8_wgmma"),
    ("adaptive_after_widen_fwd", "4; wgrad+4; backend=pallas", ADAPT_BASE,
     False, "fwd", 4096, 4096, 11008, BF16, "bf16_wgmma"),
    ("adaptive_after_widen_dgrad", "4; wgrad+4; backend=pallas",
     ADAPT_BASE, False, "dgrad", 4096, 4096, 11008, BF16, "bf16_wgmma"),
    ("yi9b_serve_decode_wq", "8; backend=pallas", None, False, "fwd", 8,
     4096, 4096, BF16, "bf16_wgmma"),
    ("yi9b_serve_decode_head", "8; backend=pallas", None, False, "fwd", 8,
     4096, 64000, BF16, "bf16_wgmma"),
    ("yi9b_serve_prefill_ffn_wo", "8; backend=pallas", None, False, "fwd",
     512, 11008, 4096, BF16, "bf16_wgmma"),
]
# off the main paths: (name, op, m, quantize_w, block, w dtype)
OFF_PATH = [
    ("m12_fwd", "fwd", 12, True, 0, BF16),
    ("m12_dgrad", "dgrad", 12, True, 0, BF16),
    ("block32_fwd", "fwd", 8, True, 32, BF16),
    ("block32_dgrad", "dgrad", 8, True, 32, BF16),
    ("block32_raw_w_fwd", "fwd", 8, False, 32, BF16),
    ("f32_raw_w_fwd", "fwd", 8, False, 0, F32),
    ("f32_raw_w_dgrad", "dgrad", 8, False, 0, F32),
]


def _call_spec(policy, base, requantize, M, K, N):
    """The KernelSpec of one projection, resolved as `ctx_matmul` and the
    train/serve steps resolve it: the segment's activation config with
    the weights requantized in the kernel (uniform training) or taken as
    narrowed upstream (serving, a widened layer), dgrad/wgrad at their
    role widths."""
    pol = parse_policy(policy, base=base) if base else parse_policy(policy)
    seg = pol.resolve_segment(0)
    cfg = seg.global_cfg.with_(requantize_weights=requantize)
    roles = {}
    for role in ("dgrad", "wgrad"):
        rw = role_width_for(seg.role_widths, role)
        roles[role + "_cfg"] = None if rw is None else rw.apply(cfg)
    return tlinear.resolve_spec(cfg, M, K, N, dtype="bfloat16", **roles)


@pytest.mark.parametrize("case", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
def test_route_table_main_path(case):
    _, policy, base, requantize, op, M, K, N, wdt, want = case
    spec = _call_spec(policy, base, requantize, M, K, N)
    bm, bk, bn = tlinear._tiles(spec.fwd if op == "fwd" else spec.dgrad,
                                M, K, N, spec.block)
    m = spec.mantissa_bits if op == "fwd" else \
        (spec.m_dgrad or spec.mantissa_bits)
    assert m <= 8 and spec.quantize_w == requantize
    assert hm.gemm_route(op, mantissa_bits=m, quantize_w=spec.quantize_w,
                         block=spec.block, bk=bk, bn=bn, N=N,
                         w_dtype=wdt) == want


@pytest.mark.parametrize("case", OFF_PATH, ids=[c[0] for c in OFF_PATH])
def test_route_table_off_path(case):
    _, op, m, qw, block, wdt = case
    assert hm.gemm_route(op, mantissa_bits=m, quantize_w=qw, block=block,
                         bk=128, bn=128, N=2048,
                         w_dtype=wdt) == "cuda_core"


def test_route_table_tile_shapes():
    """A contraction block that is not a whole number of the tensor-core
    kernel's 128-byte stages (128 int8 or 64 bf16 values), or a forward
    bf16 w whose rows are not 16-byte multiples, stays on the CUDA
    cores."""
    r = lambda op, qw, bk, bn, N=4096: hm.gemm_route(
        op, mantissa_bits=8, quantize_w=qw, block=0, bk=bk, bn=bn, N=N,
        w_dtype=BF16)
    assert r("fwd", True, 256, 128) == "int8_wgmma"
    assert r("fwd", True, 96, 128) == "cuda_core"
    assert r("dgrad", True, 128, 64) == "cuda_core"
    assert r("fwd", False, 64, 128) == "bf16_wgmma"
    assert r("fwd", False, 32, 128) == "cuda_core"
    assert r("fwd", False, 128, 100, N=100 * 41) == "cuda_core"
    assert r("dgrad", False, 128, 64) == "bf16_wgmma"


def _operands(M, K, N, seed, positive=False):
    rng = np.random.default_rng(seed)
    if positive:
        # every mantissa near the top of its range: K-block sums of
        # 127^2-sized products pass 2^24 once bk > 1040
        x = rng.uniform(1.9, 1.99, (M, K)).astype(np.float32)
        w = rng.uniform(1.9, 1.99, (K, N)).astype(np.float32)
    else:
        x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
        w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _kernel_order_fwd(x, w, m, bk, bn):
    """B1 on the int8 route, emulated: per K-block the int64 (exact, as
    wgmma's int32 on the card) sum of integral mantissas, rounded once,
    scaled by s_x * s_w and added in ascending order. Also returns the
    largest |partial|."""
    M, K = x.shape
    N = w.shape[1]
    acc = torch.zeros((M, N), dtype=F32)
    big = 0
    for k0 in range(0, K, bk):
        qx, dx = _quantize_rows(x, k0, bk, K, m, 0, False, 0, STREAM_X)
        qw, dw = _quantize_w(w[k0:k0 + bk], k0, 0, N, bk, bn, m, False, 0)
        part64 = qx.long() @ qw.long()
        big = max(big, int(part64.abs().max()))
        part = part64.float()
        assert torch.equal(part, (qx.double() @ qw.double()).float())
        acc = acc + part * (dx * dw[:1])
    return acc, big


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("bk", [24, 128, 1024, 4096])
def test_int32_partials_equal_plain_float64(m, bk):
    positive = bk == 4096 and m == 8
    K = {24: 1032, 128: 1024, 1024: 2048, 4096: 4096}[bk]
    x, w = _operands(8, K, 256, 50 + bk + m, positive=positive)
    got, big = _kernel_order_fwd(x, w, m, bk, 128)
    kw = dict(mantissa_bits=m, quantize_w=True, bm=8, bk=bk, bn=128)
    assert torch.equal(got, hm.hbfp_matmul_plain(x, w, **kw))
    if positive:
        assert 2 ** 24 < big < 2 ** 31
    # dgrad: the same arithmetic contracted over N (here x's K columns)
    g, wt = x, w.T.contiguous()                      # [8, K], [256, K]
    acc = torch.zeros((8, 256), dtype=F32)
    for n0 in range(0, K, bk):
        qg, dg = _quantize_rows(g, n0, bk, K, m, 0, False, 0, STREAM_G)
        qw, dw = _quantize_w(wt[:, n0:n0 + bk], 0, n0, K, 128, bk, m,
                             False, 0)
        part = (qg.long() @ qw.long().T).float()
        assert torch.equal(part, (qg.double() @ qw.double().T).float())
        acc = acc + part * (dg * dw[:, 0][None, :])
    assert torch.equal(acc, hm.hbfp_dgrad_plain(
        g, wt, mantissa_bits=m, quantize_w=True, bm=8, bk=128, bn=bk))


@pytest.mark.parametrize("m", [4, 8])
def test_int32_partials_equal_reference_kernel(m):
    """The reference contracts int8 mantissas with int32 sums
    (`_matmul_kernel`); its Pallas kernel in interpret mode equals the
    int32 emulation at bk 512, mantissas near the top of their range."""
    import jax.numpy as jnp
    from repro.kernels import hbfp_matmul as jhm
    x, w = _operands(16, 1024, 256, 70 + m, positive=True)
    got, _ = _kernel_order_fwd(x, w, m, 512, 128)
    ref = jhm.hbfp_matmul_pallas(jnp.asarray(x.numpy()),
                                 jnp.asarray(w.numpy()), mantissa_bits=m,
                                 bm=16, bk=512, bn=128, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(ref, np.float32))


def _split_fold(t_kb, splits):
    """The decode scheme: CTAs of K-range splits write their K-blocks'
    scaled partials to scratch [nkb, M, N]; the fold adds them in
    ascending kb from zero."""
    nkb = len(t_kb)
    per = -(-nkb // splits)
    scratch = torch.empty((nkb,) + t_kb[0].shape, dtype=F32)
    for z in reversed(range(splits)):          # any CTA order
        for kb in range(z * per, min(nkb, (z + 1) * per)):
            scratch[kb] = t_kb[kb]
    acc = torch.zeros(t_kb[0].shape, dtype=F32)
    for kb in range(nkb):
        acc = acc + scratch[kb]
    return acc


@pytest.mark.parametrize("route", ["int8_wgmma", "bf16_wgmma"])
@pytest.mark.parametrize("M", [1, 8])
def test_decode_fold_equals_plain(route, M):
    K, N, bk = 4096, 512, 128
    x, w = _operands(M, K, N, 90 + M)
    qw = route == "int8_wgmma"
    if not qw:
        w = bfp.quantize_weight(w, HBFP8_16)
    splits = hm.decode_splits(M, N, K // bk)
    assert splits > 1
    t_kb = []
    for k0 in range(0, K, bk):
        qx, dx = _quantize_rows(x, k0, bk, K, 8, 0, False, 0, STREAM_X)
        if qw:
            q, dw = _quantize_w(w[k0:k0 + bk], k0, 0, N, bk, 128, 8, False,
                                0)
            t_kb.append((qx.long() @ q.long()).float() * (dx * dw[:1]))
        else:
            t_kb.append((qx @ w[k0:k0 + bk]) * dx)
    got = _split_fold(t_kb, splits)
    assert torch.equal(got, hm.hbfp_matmul_plain(
        x, w, mantissa_bits=8, quantize_w=qw, bm=M, bk=bk, bn=128))


def test_decode_splits_fill_the_card():
    # yi-9b's serving projections at M = 8: (N, K-blocks) -> splits
    got = {n: hm.decode_splits(8, n, nkb) for n, nkb in
           ((512, 32), (4096, 32), (11008, 32), (64000, 32))}
    assert got == {512: 32, 4096: 8, 11008: 4, 64000: 1}
    assert hm.decode_splits(65, 512, 32) == 1
    for n, nkb in ((512, 32), (4096, 86), (1024, 7)):
        s = hm.decode_splits(64, n, nkb)
        per = -(-nkb // s)
        assert (s - 1) * per < nkb <= s * per       # no empty split


@pytest.mark.parametrize("op", ["fwd", "dgrad"])
@pytest.mark.parametrize("route", hm.ROUTES)
def test_scratch_per_route(op, route):
    M, K, N = 256, 2304, 2048
    qw = route != "bf16_wgmma"
    s = hm.gemm_scratch(op, route, M, K, N, bk=128, bn=128, block=0,
                        quantize_w=qw)
    C = K if op == "fwd" else N
    assert list(s) == ["xq", "sx", "wq", "sw", "xq8", "wq8", "part"]
    assert s["sx"] == ((M, C // 128), F32)
    assert s["part"] is None
    if route == "cuda_core":
        assert s["xq"] == ((M, C), F32) and s["wq"] == ((K, N), F32)
        assert s["xq8"] is None and s["wq8"] is None
    elif route == "int8_wgmma":
        assert s["xq"] is None and s["xq8"] == ((M, C), torch.int8)
        # the forward's weights transposed to [N, K]: K-major for wgmma
        assert s["wq8"] == (((N, K) if op == "fwd" else (K, N)), torch.int8)
        assert s["sw"] == ((K // 128, N // 128), F32)
    else:
        assert s["xq8"] == ((M, C), BF16)
        assert s["wq8"] is None and s["sw"] is None
    small = hm.gemm_scratch(op, route, 8, K, N, bk=128, bn=128, block=0,
                            quantize_w=qw)
    if route == "cuda_core":
        assert small["part"] is None
    else:
        O = N if op == "fwd" else K
        assert small["part"] == ((C // 128, 8, O), F32)


def test_launches_by_route_counts_only_card_launches():
    hm.reset_counts()
    x, w = _operands(8, 256, 128, 3)
    hm.hbfp_matmul_fwd(x, w)
    hm.hbfp_dgrad(x[:, :128].contiguous(), w)
    assert hm.hbfp_matmul_fwd.plain_calls == 1
    assert hm.hbfp_matmul_fwd.launches_by_route == dict.fromkeys(hm.ROUTES,
                                                                 0)
    assert hm.hbfp_dgrad.launches_by_route == dict.fromkeys(hm.ROUTES, 0)
    hm.reset_counts()


# (op, route, M, m, stochastic, bk) of the card cases
GPU_CASES = [(op, route, M, m, st, bk)
             for op in ("fwd", "dgrad")
             for route in hm.ROUTES
             for M in (1, 8, 100, 256)
             for m, st, bk in ((8, False, 128), (4, True, 128),
                               (8, False, 256))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES,
                         ids=["-".join(map(str, c)) for c in GPU_CASES])
def test_kernel_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    op, route, M, m, st, bk = case
    dev = torch.device("cuda")
    K = N = 512
    x, w = _operands(M, K, N, 7 + M + m)
    qw = route == "int8_wgmma"
    if not qw:
        # narrowed on the contraction block's tile: exact K-block sums
        w = bfp.quantize_weight(w, HBFPConfig(mantissa_bits=8, tile=bk))
    w = w.to(F32 if route == "cuda_core" else BF16).to(dev)
    tiles = dict(bk=bk, bn=128) if op == "fwd" else dict(bk=128, bn=bk)
    kw = dict(mantissa_bits=m, stochastic=st, quantize_w=qw, bm=128,
              **tiles)
    assert hm.gemm_route(op, mantissa_bits=m, quantize_w=qw, block=0, N=N,
                         w_dtype=w.dtype, **tiles) == route
    hm.reset_counts()
    if op == "fwd":
        a = x.to(BF16).to(dev)
        got = hm.hbfp_matmul_fwd(a, w, 0x5EED, **kw)
        want = hm.hbfp_matmul_plain(a, w, 0x5EED, **kw)
        counts = hm.hbfp_matmul_fwd.launches_by_route
    else:
        g = (x * 1e-3).to(dev)
        got = hm.hbfp_dgrad(g, w, 0x5EED, **kw)
        want = hm.hbfp_dgrad_plain(g, w, 0x5EED, **kw)
        counts = hm.hbfp_dgrad.launches_by_route
    torch.cuda.synchronize()
    assert counts[route] == 1
    assert torch.equal(got, want)
