"""Routes of the port's B4 (the HBFP flash-attention forward) and the
arithmetic that keeps its int8 tensor-core route bit for bit equal to the
plain version.

On the card a B4 call takes one of two routes (`hbfp_flash_attn.
flash_route`, mirrored by `flash_tc_route` in
`csrc/hbfp_flash_fwd_sm90.cuh`): int8 wgmma, with a pre-pass that writes
int8 q·α, k and vᵀ and their steps, or the CUDA-core kernel. Here, on the
CPU:

- the route table: yi-9b's training attention at "8; backend=pallas" and
  the adaptive "4; wgrad+4" path take int8 wgmma; m_qk or m_pv above 8,
  head dims that are not multiples of 32, blocks below 64 and S not a
  multiple of 128 stay on the CUDA cores;
- the int32 dataflow: the pre-pass's int8 operands (hd padded to 128 with
  zeros, vᵀ per k-block, p padded to 128 columns at bk 64) contracted
  exactly and rounded once equal the plain version's float64 products;
- the row sum of p in the wgmma fragment's order (per-thread sums over
  j, the off-8 step in the thread, shuffles with lane ^ 2 and lane ^ 1,
  then e = 0 + e = 1) equals `_row_sum` bit for bit;
- a whole-forward emulation in the kernel's order (128-row CTAs of two
  64-row warpgroups, each with its q-block's causal skip) equals
  `hbfp_flash_attn_plain` bit for bit, o and lse, and the JAX oracle
  within the port's stated forward tolerance.

The `gpu`-marked cases hold each route to its plain version on the card,
bit for bit; they skip where there is no CUDA device:
    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_flash_tc.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HBFPConfig
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import quantize_block
from repro_torch.models.attention import _flash_block
from repro_torch.precision import parse_policy
from repro_torch.precision.policy import role_width_for

F32 = torch.float32
HP = fa.HP
NEG_INF = tref.NEG_INF

# (name, policy, base, S, hd, expected route)
MAIN_PATH = [
    ("yi9b_train", "8; backend=pallas", None, 4096, 128, "int8_wgmma"),
    ("adaptive_yi9b", "4; wgrad+4; backend=pallas", HBFPConfig(4, 16,
                                                                tile=24),
     4096, 128, "int8_wgmma"),
    ("phi3_hd96", "8; backend=pallas", None, 4096, 96, "int8_wgmma"),
    ("qk_plus_4", "8; attn_qk+4; backend=pallas", None, 4096, 128,
     "cuda_core"),
    ("pv_minus_2", "8; attn_pv-2; backend=pallas", None, 4096, 128,
     "int8_wgmma"),
    ("m12", "12; backend=pallas", None, 4096, 128, "cuda_core"),
]


def _widths(policy, base):
    """(m, m_qk, m_pv) as `flash_mha` resolves them from the policy."""
    pol = parse_policy(policy, base=base) if base else parse_policy(policy)
    seg = pol.resolve_segment(0)
    cfg = seg.global_cfg
    out = []
    for role in ("attn_qk", "attn_pv"):
        rw = role_width_for(seg.role_widths, role)
        out.append(rw.apply(cfg).mantissa_bits if rw is not None
                   else cfg.mantissa_bits)
    return cfg.mantissa_bits, *out


@pytest.mark.parametrize("case", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
def test_route_table_main_path(case):
    _, policy, base, S, hd, want = case
    _, m_qk, m_pv = _widths(policy, base)
    blk = _flash_block(S)
    assert blk == 128
    assert fa.flash_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=blk,
                          bk=blk) == want


@pytest.mark.parametrize("S,hd,bq,bk,want", [
    (4096, 64, 64, 64, "int8_wgmma"),
    (4096, 128, 64, 128, "int8_wgmma"),
    (4096, 128, 128, 64, "int8_wgmma"),
    (4096, 80, 128, 128, "cuda_core"),     # hd not a multiple of 32
    (4096, 128, 32, 128, "cuda_core"),     # a block below one warpgroup
    (192, 128, 64, 64, "cuda_core"),       # S not whole 128-row CTAs
    (96, 64, 32, 32, "cuda_core"),
])
def test_route_table_shapes(S, hd, bq, bk, want):
    assert fa.flash_route(m_qk=8, m_pv=8, S=S, hd=hd, bq=bq, bk=bk) == want


def test_scratch_per_route():
    s = fa.flash_scratch("int8_wgmma", 32, 4096, 128)
    assert list(s) == ["q8", "k8", "vt8", "qsc", "ksc", "vsc"]
    assert s["q8"] == ((32 * 4096, HP), torch.int8) == s["k8"]
    assert s["vt8"] == ((32 * HP, 4096), torch.int8)
    assert s["qsc"] == ((32 * 4096,), F32) == s["ksc"]
    assert s["vsc"] == ((32, 4096 // 128, HP), F32)
    assert set(fa.flash_scratch("cuda_core", 32, 4096, 128).values()) == {
        None}


def test_launches_by_route_counts_only_card_launches():
    fa.reset_counts()
    q = torch.randn(1, 128, 64)
    fa.hbfp_flash_fwd(q, q, q)
    assert fa.hbfp_flash_fwd.plain_calls == 1
    assert fa.hbfp_flash_fwd.launches_by_route == dict.fromkeys(fa.ROUTES,
                                                                0)
    fa.reset_counts()


def _draw(seed, BH, S, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(
        np.float32)) for _ in range(3)]


def _prepass(q, k, v, m_qk, m_pv, bk):
    """The pre-pass's outputs, as integers: q·α and k per row over hd
    (padded to HP with zero mantissas), vᵀ per column over each k-block
    [BH, HP, S], and their steps."""
    BH, S, hd = q.shape
    scale = tref._flash_scale(hd, "cpu")
    pad = lambda t: torch.nn.functional.pad(t, (0, HP - hd))
    q8, qs = tref._rows(q.float() * scale, m_qk)
    k8, ks = tref._rows(k.float(), m_qk)
    vt8 = torch.zeros((BH, HP, S))
    vs = torch.zeros((BH, S // bk, HP))
    for j in range(S // bk):
        blk = v[:, j * bk:(j + 1) * bk].float()
        vq, dv = quantize_block(blk, m_pv, blk.abs().amax(dim=1,
                                                          keepdim=True),
                                stochastic=False)
        vt8[:, :hd, j * bk:(j + 1) * bk] = vq.transpose(1, 2)
        vs[:, j, :hd] = dv[:, 0]
    return (pad(q8).long(), qs[..., 0], pad(k8).long(), ks[..., 0],
            vt8.long(), vs)


def _i32(a, b):
    """An exact integer product (int64 here, int32 in the kernel, where
    |sum| < 2^22) rounded once to f32."""
    out = torch.bmm(a, b)
    assert int(out.abs().max()) < 2 ** 22
    return out.float()


@pytest.mark.parametrize("m_qk,m_pv", [(8, 8), (4, 4), (6, 8)])
@pytest.mark.parametrize("hd", [64, 128])
def test_int32_products_equal_plain_float64(m_qk, m_pv, hd):
    BH, S, bk = 2, 256, 128
    q, k, v = _draw(m_qk + hd, BH, S, hd)
    q8, qs, k8, ks, vt8, vs = _prepass(q, k, v, m_qk, m_pv, bk)
    # QKᵀ over the padded head dim
    s_i = _i32(q8, k8.transpose(1, 2))
    qq, _ = tref._rows(q.float() * tref._flash_scale(hd, "cpu"), m_qk)
    kq, _ = tref._rows(k.float(), m_qk)
    assert torch.equal(s_i, tref._idot(qq, kq.transpose(1, 2)))
    # PV of one k-block, p from the scores' softmax
    p = torch.softmax(s_i[:, :, :bk] * 1e-3, dim=-1)
    pq, _ = tref._rows(p, m_pv)
    vq = vt8[:, :, :bk].transpose(1, 2)                  # [BH, bk, HP]
    got = _i32(pq.long(), vq)[..., :hd]
    vblk = v[:, :bk].float()
    vq_ref, _ = quantize_block(vblk, m_pv, vblk.abs().amax(dim=1,
                                                           keepdim=True),
                               stochastic=False)
    assert torch.equal(got, tref._idot(pq, vq_ref))


def _fragment_row_sum(p):
    """Row sums of p [..., bk] in the wgmma fragment's order. Column
    c = 16 j + 8 h + 2 q + e: thread q (lane % 4) holds (h, e) for every
    j and sums each over j ascending; the off-8 step adds h = 0 and h = 1
    in the thread, off-4 and off-2 add the partner lane ^ 2 and lane ^ 1,
    off-1 adds e = 0 and e = 1. Returns [..., 4]: one sum per thread."""
    nj = p.shape[-1] // 16
    t = p.reshape(*p.shape[:-1], nj, 2, 4, 2)
    acc = t[..., 0, :, :, :]
    for j in range(1, nj):
        acc = acc + t[..., j, :, :, :]
    u = acc[..., 0, :, :] + acc[..., 1, :, :]              # [..., 4, 2]
    u = u + u[..., [2, 3, 0, 1], :]
    u = u + u[..., [1, 0, 3, 2], :]
    return u[..., 0] + u[..., 1]


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("kind", ["uniform", "exp", "wide"])
def test_fragment_row_sum_equals_row_sum(bk, kind):
    rng = np.random.default_rng(bk + len(kind))
    shape = (4, 64, bk)
    if kind == "uniform":
        p = rng.random(shape)
    elif kind == "exp":
        p = np.exp(-np.abs(rng.standard_normal(shape)) * 8)
    else:
        p = rng.random(shape) * np.exp2(rng.integers(-60, 1, shape))
    p = torch.from_numpy(p.astype(np.float32))
    got = _fragment_row_sum(p)
    want = tref._row_sum(p)
    # every thread of a quad holds the same bits, and they are _row_sum's
    assert torch.equal(got, want.expand_as(got))


def _tc_forward(q, k, v, *, m_qk, m_pv, bq, bk, causal):
    """B4's int8 route emulated in the kernel's order: the pre-pass, then
    per 128-row CTA two 64-row warpgroups, each visiting its q-block's
    k-blocks (the CTA's loop runs the larger count), exact integer
    products, f32 scores and online softmax, the fragment-order row sum,
    p quantized per row and PV over p padded to HP columns."""
    BH, S, hd = q.shape
    q8, qs, k8, ks, vt8, vs = _prepass(q, k, v, m_qk, m_pv, bk)
    o = torch.empty((BH, S, hd), dtype=F32)
    lse = torch.empty((BH, S), dtype=F32)
    nkb = S // bk
    for r0 in range(0, S, 128):
        for w in range(2):
            rows = slice(r0 + 64 * w, r0 + 64 * w + 64)
            qb = (r0 + 64 * w) // bq
            nk = min(nkb, (qb * bq + bq - 1) // bk + 1) if causal else nkb
            m = torch.full((BH, 64, 1), NEG_INF)
            l = torch.zeros((BH, 64, 1))
            acc = torch.zeros((BH, 64, HP))
            for kb in range(nk):
                cols = slice(kb * bk, (kb + 1) * bk)
                s = _i32(q8[:, rows], k8[:, cols].transpose(1, 2)) * (
                    qs[:, rows, None] * ks[:, None, cols])
                if causal:
                    qpos = torch.arange(r0 + 64 * w, r0 + 64 * w + 64)[:, None]
                    kpos = torch.arange(kb * bk, (kb + 1) * bk)[None, :]
                    s = torch.where(kpos <= qpos, s, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + _fragment_row_sum(p)[..., :1]
                pq, dp = tref._rows(p, m_pv)
                p_pad = torch.zeros((BH, 64, HP), dtype=torch.long)
                p_pad[..., :bk] = pq.long()
                v_tile = torch.zeros((BH, HP, HP), dtype=torch.long)
                width = min(HP, S - kb * bk)
                v_tile[..., :width] = vt8[..., kb * bk:kb * bk + width]
                pv = _i32(p_pad, v_tile.transpose(1, 2)) * (
                    dp * vs[:, kb][:, None, :])
                acc = acc * alpha + pv
                m = m_new
            lc = torch.clamp(l, min=1e-30)
            o[:, rows] = (acc / lc)[..., :hd]
            lse[:, rows] = (m + torch.log(lc))[..., 0]
    return o.to(q.dtype), lse


TC_CASES = [  # (S, hd, bq, bk, m_qk, m_pv, causal, dtype)
    (256, 128, 128, 128, 8, 8, True, "float32"),
    (256, 64, 64, 64, 8, 8, True, "float32"),
    (256, 128, 128, 64, 4, 4, True, "float32"),
    (256, 96, 64, 128, 8, 6, True, "float32"),
    (256, 128, 128, 128, 8, 8, False, "float32"),
    (256, 64, 128, 128, 8, 8, True, "bfloat16"),
]


@pytest.mark.parametrize("case", TC_CASES,
                         ids=["-".join(map(str, c)) for c in TC_CASES])
def test_kernel_order_forward_equals_plain_and_oracle(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    S, hd, bq, bk, m_qk, m_pv, causal, dtype = case
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt) for t in _draw(S + hd + bq + bk, 2, S, hd))
    kw = dict(m_bits=8, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk, causal=causal)
    assert fa.flash_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq,
                          bk=bk) == "int8_wgmma"
    o, lse = _tc_forward(q, k, v, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk,
                         causal=causal)
    o_p, lse_p = fa.hbfp_flash_fwd_plain(q, k, v, with_lse=True, **kw)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    jo, jl = jref.hbfp_flash_attn_ref(
        *(jnp.asarray(t.float().numpy(), getattr(jnp, dtype))
          for t in (q, k, v)), with_lse=True, **kw)
    # the port's forward tolerance against the oracle (test_torch_flash_
    # attn.py): 2e-6, plus one bf16 rounding of each side for bf16 o
    jo = torch.from_numpy(np.array(jo, np.float32))
    tol = 2e-6 + (2.0 ** -8 / (1 - 2.0 ** -8) * (jo.abs() + o.float().abs())
                  if dtype == "bfloat16" else 0.0)
    assert bool(((o.float() - jo).abs() <= tol).all())
    jl = torch.from_numpy(np.array(jl, np.float32))
    assert bool(((lse - jl).abs() <= 2e-6).all())


# (route, S, hd, bq, bk, m_qk, m_pv, causal, dtype, with_lse)
GPU_CASES = [
    ("int8_wgmma", 512, 128, 128, 128, 8, 8, True, "bfloat16", True),
    ("int8_wgmma", 512, 128, 128, 128, 8, 8, False, "float32", True),
    ("int8_wgmma", 512, 64, 64, 64, 8, 8, True, "bfloat16", False),
    ("int8_wgmma", 512, 96, 64, 128, 4, 4, True, "float32", True),
    ("int8_wgmma", 384, 128, 128, 64, 8, 6, True, "bfloat16", True),
    ("cuda_core", 512, 128, 128, 128, 10, 8, True, "bfloat16", True),
    ("cuda_core", 96, 64, 32, 32, 8, 8, True, "float32", True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES,
                         ids=["-".join(map(str, c)) for c in GPU_CASES])
def test_kernel_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    route, S, hd, bq, bk, m_qk, m_pv, causal, dtype, with_lse = case
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt).cuda() for t in _draw(S + hd, 4, S, hd))
    kw = dict(m_bits=8, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk, causal=causal,
              with_lse=with_lse)
    assert fa.flash_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq,
                          bk=bk) == route
    fa.reset_counts()
    got = fa.hbfp_flash_fwd(q, k, v, **kw)
    want = fa.hbfp_flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.hbfp_flash_fwd.launches_by_route[route] == 1
    got, want = (got, want) if with_lse else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
