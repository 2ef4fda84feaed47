"""Routes of the port's B5 (dq) and B6 (dk, dv), the HBFP flash-attention
backward, and the arithmetic of their int8/bf16 tensor-core routes.

On the card a B5 or B6 call takes one of two routes (`hbfp_flash_attn.
flash_bwd_route`, mirrored by `flash_bwd_tc_route` in
`csrc/hbfp_flash_bwd_sm90.cuh`): "int8_wgmma", where a pre-pass writes
int8 q·α, k, do, v with their steps (and bf16 k̂, or q̂ and dô), s and dp
run as int8 wgmma and dq, dk, dv as bf16 wgmma over dequantized operands;
or the CUDA-core kernels. Here, on the CPU:

- the route table: yi-9b's training attention ("8; backend=pallas") and
  the adaptive "4; wgrad+4" path take int8 wgmma; m_qk or m_pv of 9-12,
  head dims that are not multiples of 32, blocks below 64 and S not a
  multiple of 128 stay on the CUDA cores; the scratch per route; only
  card launches are counted by route;
- the integer dataflow: s = Q(q·α)·Q(k)ᵀ and dp = Q(do)·Q(v)ᵀ from the
  pre-pass's int8 rows (hd padded to 128 with zeros), exact in int32 and
  rounded once, equal the plain version's `_idot`;
- bf16 exactness: every operand of the bf16 products (k̂, q̂, dô, p̂, dŝ) is
  an integer of at most 7 bits times a power of two >= 2^-106, so a bf16
  round trip returns it unchanged at m 4 and 8, rows of extreme amplitude
  and f32 subnormals included; the products of the smoke draws' operands
  stay in f32's normal range, and on the card (a `gpu` case) the tensor
  cores keep products below it as subnormals rather than flushing them;
- the register-A fragment B5 packs from its ds accumulator is the layout
  wgmma's m64k16 A fragment takes;
- emulations of each kernel's order (B5: 64-row warpgroups, one f32
  partial per k-block summed in k16 steps and promoted as dq + part·α in
  ascending order; B6: 128-row k tiles, 64-row q chunks from the CTA's
  first visible q-block, p and ds quantized per q row over the k-block
  across both 64-column halves, dk and dv accumulated over the whole
  contraction in k16 steps) within chip_smoke.py's `_flash_grad_ok` bound
  2·S·2^-24·Σ|a||b| (+ one bf16 rounding of each side for bf16) of the
  plain version, with bit-equal quantized operands, and of the reference's
  `hbfp_flash_attention_bwd` in interpret mode given the same o and lse.

The `gpu`-marked cases hold each route to the plain version on the card at
chip_smoke.py's FLASH_SMALL shapes; they skip where there is no CUDA
device:
    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_flash_bwd_tc.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HBFPConfig
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import _flash_block
from repro_torch.precision import parse_policy
from repro_torch.precision.policy import role_width_for

F32 = torch.float32
HP = fa.HP
NEG_INF = tref.NEG_INF
F32_UNIT = 2.0 ** -24
BF16_ROUND = 2.0 ** -8 / (1 - 2.0 ** -8)
ENTRIES = ("hbfp_flash_dq", "hbfp_flash_dkv")

# (name, policy, base, S, hd, expected route)
MAIN_PATH = [
    ("yi9b_train", "8; backend=pallas", None, 4096, 128, "int8_wgmma"),
    ("adaptive_yi9b", "4; wgrad+4; backend=pallas", HBFPConfig(4, 16,
                                                                tile=24),
     4096, 128, "int8_wgmma"),
    ("phi3_hd96", "8; backend=pallas", None, 4096, 96, "int8_wgmma"),
    ("qk_plus_4", "8; attn_qk+4; backend=pallas", None, 4096, 128,
     "cuda_core"),
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
    assert fa.flash_bwd_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=blk,
                              bk=blk) == want


@pytest.mark.parametrize("S,hd,bq,bk,m_qk,m_pv,want", [
    (4096, 64, 64, 64, 8, 8, "int8_wgmma"),
    (4096, 96, 128, 128, 8, 8, "int8_wgmma"),
    (4096, 128, 64, 128, 8, 6, "int8_wgmma"),
    (4096, 128, 128, 64, 4, 4, "int8_wgmma"),
    (4096, 80, 128, 128, 8, 8, "cuda_core"),     # hd not a multiple of 32
    (4096, 128, 32, 128, 8, 8, "cuda_core"),     # a block below 64 rows
    (4096, 128, 128, 32, 8, 8, "cuda_core"),
    (192, 128, 64, 64, 8, 8, "cuda_core"),       # S not whole 128-row CTAs
    (4096, 128, 128, 128, 9, 8, "cuda_core"),    # integral sums past int8
    (4096, 128, 128, 128, 8, 10, "cuda_core"),
    (4096, 128, 128, 128, 12, 12, "cuda_core"),
])
def test_route_table_shapes(S, hd, bq, bk, m_qk, m_pv, want):
    got = fa.flash_bwd_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq, bk=bk)
    assert got == want
    # the backward takes the forward's tiles
    assert got == fa.flash_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq,
                                 bk=bk)


def test_scratch_per_route():
    BH, S = 32, 4096
    rows = BH * S
    common = ["q8", "k8", "do8", "v8", "qsc", "ksc", "dosc", "vsc"]
    dq = fa.flash_bwd_scratch("int8_wgmma", "hbfp_flash_dq", BH, S)
    dkv = fa.flash_bwd_scratch("int8_wgmma", "hbfp_flash_dkv", BH, S)
    assert list(dq) == common + ["kh"]
    assert list(dkv) == common + ["qh", "doh"]
    for s in (dq, dkv):
        for n in ("q8", "k8", "do8", "v8"):
            assert s[n] == ((rows, HP), torch.int8)
        for n in ("qsc", "ksc", "dosc", "vsc"):
            assert s[n] == ((rows,), F32)
    assert dq["kh"] == dkv["qh"] == dkv["doh"] == ((rows, HP),
                                                   torch.bfloat16)
    for e in ENTRIES:
        assert set(fa.flash_bwd_scratch("cuda_core", e, BH,
                                        S).values()) == {None}


def test_launches_by_route_counts_only_card_launches():
    fa.reset_counts()
    q = torch.randn(1, 128, 64)
    lse = torch.zeros(1, 128)
    fa.hbfp_flash_dq(q, q, q, q, lse, lse)
    fa.hbfp_flash_dkv(q, q, q, q, lse, lse)
    for e in ENTRIES:
        fn = getattr(fa, e)
        assert fn.plain_calls == 1 and fn.launches == 0
        assert fn.launches_by_route == dict.fromkeys(fa.ROUTES, 0)
    fa.reset_counts()


def _draw(seed, BH, S, hd, n=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(
        np.float32)) for _ in range(n)]


def _prepass(q, k, v, do, m_qk, m_pv):
    """The pre-pass's int8 rows as integers ([BH, S, HP], zero past hd)
    and their steps [BH, S, 1]: q·α and k at m_qk, do and v at m_pv."""
    hd = q.shape[-1]
    scale = tref._flash_scale(hd, "cpu")
    pad = lambda t: torch.nn.functional.pad(t, (0, HP - hd))
    out = []
    for x, m in ((q.float() * scale, m_qk), (k.float(), m_qk),
                 (do.float(), m_pv), (v.float(), m_pv)):
        xq, xs = tref._rows(x, m)
        out += [pad(xq).long(), xs]
    return out


def _i32(a, b):
    """An exact integer product (int64 here, int32 in the kernel, where
    |sum| < 2^22) rounded once to f32."""
    out = torch.bmm(a, b)
    assert int(out.abs().max()) < 2 ** 22
    return out.float()


def _exact_bf16(t):
    """t unchanged by a bf16 round trip (asserted), as the bf16 operand
    the kernel feeds to wgmma."""
    assert torch.equal(t.to(torch.bfloat16).float(), t)
    return t


@pytest.mark.parametrize("m_qk,m_pv", [(8, 8), (4, 4), (8, 6)])
@pytest.mark.parametrize("hd", [64, 128])
def test_int32_products_equal_idot(m_qk, m_pv, hd):
    BH, S = 2, 256
    q, k, v, do = _draw(m_qk + m_pv + hd, BH, S, hd)
    q8, _, k8, _, do8, _, v8, _ = _prepass(q, k, v, do, m_qk, m_pv)
    scale = tref._flash_scale(hd, "cpu")
    qq, _ = tref._rows(q * scale, m_qk)
    kq, _ = tref._rows(k, m_qk)
    doq, _ = tref._rows(do, m_pv)
    vq, _ = tref._rows(v, m_pv)
    assert int(q8.abs().max()) <= 2 ** (m_qk - 1) - 1
    assert torch.equal(_i32(q8, k8.transpose(1, 2)),
                       tref._idot(qq, kq.transpose(1, 2)))
    assert torch.equal(_i32(do8, v8.transpose(1, 2)),
                       tref._idot(doq, vq.transpose(1, 2)))


def _extreme_rows(seed, kind):
    """[64, 128] rows of one kind, each row at its own amplitude 2^e over
    f32's range: exponents from -149 (subnormal) to 120, zero rows,
    and for p, probabilities in [0, 1] down to 2^-140."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 128))
    e = np.linspace(-149, 120, 64).round()
    if kind == "p":
        x = np.abs(x) / np.abs(x).max() * np.exp2(np.minimum(e, 0) * 140
                                                   / 149)[:, None]
    else:
        x = x * np.exp2(e)[:, None]
    x[5] = 0.0
    x[6, ::3] = 1e-42                    # f32 subnormals beside zeros
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("kind", ["k_hat", "q_hat", "do_hat", "p", "ds"])
def test_bf16_operands_exact(m, kind):
    """Dequantized per-row operands are exact, normal bf16 values: an
    integer |q| <= 2^(m-1) - 1 times a step >= 2^(EXP_FLOOR - m + 2)."""
    x = _extreme_rows(m + len(kind), kind)
    if kind == "q_hat":
        x = x * tref._flash_scale(128, "cpu")
    xq, xs = tref._rows(x, m)
    xh = xq * xs
    _exact_bf16(xh)
    nz = xh[xh != 0].abs()
    assert float(nz.min()) >= 2.0 ** -106
    assert float(xs.min()) >= 2.0 ** (-100 - m + 2)


def test_register_a_fragment_is_the_accumulator_layout():
    """B5 packs ds^ for k16 slice t into register r as accumulator
    elements (8t + 2r, 8t + 2r + 1). In the m64nNk16 accumulator, element
    i of lane l in warp w sits at row 16w + l/4 + 8·((i>>1)&1), column
    8·(i>>2) + 2·(l%4) + (i&1); wgmma's register A fragment puts register
    r's element e at row 16w + l/4 + 8·(r&1), column 16t + 8·(r>>1) +
    2·(l%4) + e. The two coincide for every slice."""
    for w in range(4):
        for lane in range(32):
            for t in range(8):
                for r in range(4):
                    for e in range(2):
                        i = 8 * t + 2 * r + e
                        acc = (16 * w + lane // 4 + 8 * ((i >> 1) & 1),
                               8 * (i >> 2) + 2 * (lane % 4) + (i & 1))
                        afrag = (16 * w + lane // 4 + 8 * (r & 1),
                                 16 * t + 8 * (r >> 1) + 2 * (lane % 4) + e)
                        assert acc == afrag


def _k16(a, b, acc=None):
    """a [.., M, K] · b [.., K, N] in f32, summed in K-slices of 16 added
    to the accumulator in order (a wgmma k16 step each)."""
    out = acc if acc is not None else torch.zeros(
        (*a.shape[:-1], b.shape[-1]), dtype=F32)
    for t in range(0, a.shape[-1], 16):
        out = out + torch.bmm(a[..., t:t + 16], b[..., t:t + 16, :])
    return out


def _scores(qq, qs, kq, ks, rows, cols, causal, lse):
    """p = exp(s - lse) over q rows × k cols, the mask the reference's."""
    s = _i32(qq[:, rows], kq[:, cols].transpose(1, 2)) * (
        qs[:, rows] * ks[:, cols].transpose(1, 2))
    if causal:
        qpos = torch.arange(rows.start, rows.stop)[:, None]
        kpos = torch.arange(cols.start, cols.stop)[None, :]
        s = torch.where(kpos <= qpos, s, torch.tensor(NEG_INF))
    return torch.exp(s - lse[:, rows, None])


def _tc_dq(q, k, v, do, lse, delta, *, m_qk, m_pv, bq, bk, causal, ops):
    """B5's int8 route in the kernel's order: 128-row CTAs of two 64-row
    warpgroups, each over its q-block's visible k-blocks ascending; per
    k-block s and dp exact, ds quantized per row over bk, the partial
    ds^·k^ summed in k16 steps in its own f32 fragment and promoted as
    dq + part·α. `ops` collects the bf16 operands (checked exact)."""
    BH, S, hd = q.shape
    scale = tref._flash_scale(hd, "cpu")
    qq, qs = tref._rows(q.float() * scale, m_qk)
    kq, ks = tref._rows(k.float(), m_qk)
    doq, dos = tref._rows(do.float(), m_pv)
    vq, vs = tref._rows(v.float(), m_pv)
    kh = _exact_bf16(kq * ks)
    ops.append(kh)
    dq = torch.empty((BH, S, hd), dtype=F32)
    nkb = S // bk
    for r0 in range(0, S, 128):
        for w in range(2):
            rows = slice(r0 + 64 * w, r0 + 64 * w + 64)
            qb = rows.start // bq
            nk = min(nkb, (qb * bq + bq - 1) // bk + 1) if causal else nkb
            acc = torch.zeros((BH, 64, hd), dtype=F32)
            for kb in range(nk):
                cols = slice(kb * bk, (kb + 1) * bk)
                p = _scores(qq.long(), qs, kq.long(), ks, rows, cols,
                            causal, lse)
                dp = _i32(doq[:, rows].long(),
                          vq[:, cols].long().transpose(1, 2)) * (
                    dos[:, rows] * vs[:, cols].transpose(1, 2))
                ds = p * (dp - delta[:, rows, None])
                dsq, dsd = tref._rows(ds, m_qk)
                dsh = _exact_bf16(dsq * dsd)
                ops.append(dsh)
                acc = acc + _k16(dsh, kh[:, cols]) * scale
            dq[:, rows] = acc
    return dq.to(q.dtype)


def _tc_dkv(q, k, v, do, lse, delta, *, m_qk, m_pv, bq, bk, causal, ops):
    """B6's int8 route in the kernel's order: 128-row k CTAs, each walking
    64-row q chunks from the first q-block its first k-block visits (q rows
    before a k row add exact zeros); p and ds quantized per q row over each
    k-block (both 64-column halves at bk 128, each half at bk 64); dv +=
    p^ᵀ·do^ and dk += ds^ᵀ·q^ accumulated over every chunk in k16 steps."""
    BH, S, hd = q.shape
    scale = tref._flash_scale(hd, "cpu")
    qq, qs = tref._rows(q.float() * scale, m_qk)
    kq, ks = tref._rows(k.float(), m_qk)
    doq, dos = tref._rows(do.float(), m_pv)
    vq, vs = tref._rows(v.float(), m_pv)
    qh, doh = _exact_bf16(qq * qs), _exact_bf16(doq * dos)
    ops += [qh, doh]
    dk = torch.empty((BH, S, hd), dtype=F32)
    dv = torch.empty((BH, S, hd), dtype=F32)
    for k0 in range(0, S, 128):
        cols = slice(k0, k0 + 128)
        c0 = (k0 // bq) * bq if causal else 0
        dk_acc = torch.zeros((BH, 128, hd), dtype=F32)
        dv_acc = torch.zeros((BH, 128, hd), dtype=F32)
        for r0 in range(c0, S, 64):
            rows = slice(r0, r0 + 64)
            p = _scores(qq.long(), qs, kq.long(), ks, rows, cols, causal,
                        lse)
            dp = _i32(doq[:, rows].long(),
                      vq[:, cols].long().transpose(1, 2)) * (
                dos[:, rows] * vs[:, cols].transpose(1, 2))
            ds = p * (dp - delta[:, rows, None])
            ph, dsh = torch.empty_like(p), torch.empty_like(ds)
            for g in range(0, 128, bk):
                pq, pd = tref._rows(p[..., g:g + bk], m_pv)
                dq_, dd = tref._rows(ds[..., g:g + bk], m_qk)
                ph[..., g:g + bk] = pq * pd
                dsh[..., g:g + bk] = dq_ * dd
            ops += [_exact_bf16(ph), _exact_bf16(dsh)]
            dv_acc = _k16(ph.transpose(1, 2), doh[:, rows], dv_acc)
            dk_acc = _k16(dsh.transpose(1, 2), qh[:, rows], dk_acc)
        dk[:, cols], dv[:, cols] = dk_acc, dv_acc
    return dk.to(q.dtype), dv.to(q.dtype)


def _grad_ok(got, want, bound, S, bf16):
    """chip_smoke.py's `_flash_grad_ok`: |Δ| <= 2·S·u·Σ|a||b| (+ one bf16
    rounding of each side for bf16 outputs)."""
    g, w = got.float(), want.float()
    tol = 2 * S * F32_UNIT * bound
    if bf16:
        tol = tol + BF16_ROUND * (g.abs() + w.abs())
    return bool(((g - w).abs() <= tol).all())


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
def test_kernel_order_backward_within_bound(case):
    """Both emulations against the plain version (same inputs, lse and D:
    the quantized operands equal, dq, dk, dv within the bound) and against
    the reference's Pallas backward in interpret mode from the same o and
    lse (within the bound)."""
    import jax.numpy as jnp
    from repro.kernels.hbfp_flash_attn import \
        hbfp_flash_attention_bwd as jflash_bwd
    S, hd, bq, bk, m_qk, m_pv, causal, dtype = case
    assert fa.flash_bwd_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=bq,
                              bk=bk) == "int8_wgmma"
    dt = getattr(torch, dtype)
    q, k, v, do = _draw(S + hd + bq + bk + m_pv, 2, S, hd)
    q, k, v, do = q.to(dt), k.to(dt), v.to(dt), (do * 1e-2).to(dt)
    kw = dict(m_bits=8, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk, causal=causal)
    o, lse = fa.hbfp_flash_fwd_plain(q, k, v, with_lse=True, **kw)
    delta = tref.flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    ops = []
    dq = _tc_dq(*args, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk, causal=causal,
                ops=ops)
    dk, dv = _tc_dkv(*args, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk,
                     causal=causal, ops=ops)
    assert ops
    bf16 = dtype == "bfloat16"
    dq_p, b_dq = fa.hbfp_flash_dq_plain(*args, with_bound=True, **kw)
    dk_p, dv_p, b_dk, b_dv = fa.hbfp_flash_dkv_plain(*args, with_bound=True,
                                                     **kw)
    for got, want, b in ((dq, dq_p, b_dq), (dk, dk_p, b_dk),
                         (dv, dv_p, b_dv)):
        assert got.dtype == q.dtype
        assert _grad_ok(got, want, b, S, bf16)
    jargs = [jnp.asarray(t.float().numpy(), getattr(jnp, dtype))
             for t in (q, k, v, o)]
    jref = jflash_bwd(*jargs, jnp.asarray(lse.numpy()),
                      jnp.asarray(do.float().numpy(), getattr(jnp, dtype)),
                      interpret=True, **kw)
    for got, want, b in zip((dq, dk, dv), jref, (b_dq, b_dk, b_dv)):
        want = torch.from_numpy(np.array(want, np.float32))
        assert _grad_ok(got, want, b, S, bf16)


def test_smoke_draw_products_stay_normal():
    """The tensor cores' handling of a product below f32's normal range
    (2^-126) never arises on draws like chip_smoke.py's (q, k, v standard
    normal, do at 1e-2): every nonzero bf16 operand pair's product is far
    above it, so the bound covers those runs whatever the hardware does
    with such products."""
    BH, S, hd = 2, 256, 128
    q, k, v, do = _draw(17, BH, S, hd)
    do = do * 1e-2
    kw = dict(m_bits=8, bq=128, bk=128, causal=True)
    o, lse = fa.hbfp_flash_fwd_plain(q, k, v, with_lse=True, **kw)
    args = (q, k, v, do, lse, tref.flash_delta(o, do))
    ops_dq, ops_dkv = [], []
    _tc_dq(*args, m_qk=8, m_pv=8, bq=128, bk=128, causal=True, ops=ops_dq)
    _tc_dkv(*args, m_qk=8, m_pv=8, bq=128, bk=128, causal=True,
            ops=ops_dkv)
    least = lambda ts: min(float(t[t != 0].abs().min()) for t in ts)
    kh, dsh = ops_dq[0], ops_dq[1:]
    qh, doh, rest = ops_dkv[0], ops_dkv[1], ops_dkv[2:]
    ph, dsh2 = rest[0::2], rest[1::2]
    assert least([kh]) * least(dsh) > 2.0 ** -126
    assert least(ph) * least([doh]) > 2.0 ** -126
    assert least(dsh2) * least([qh]) > 2.0 ** -126


# (route, S, hd, blk or None (largest power of two <= 128 dividing S),
#  m_qk, m_pv, causal, dtype): chip_smoke.py's FLASH_SMALL shapes
GPU_CASES = [
    ("cuda_core", 512, 128, None, 12, 12, True, "bfloat16"),
    ("cuda_core", 512, 128, None, 10, 8, True, "bfloat16"),
    ("int8_wgmma", 512, 128, None, 8, 6, True, "bfloat16"),
    ("cuda_core", 512, 128, None, 12, 6, True, "bfloat16"),
    ("int8_wgmma", 512, 128, None, 8, 8, False, "bfloat16"),
    ("cuda_core", 96, 64, None, 8, 8, True, "float32"),
    ("int8_wgmma", 512, 128, None, 8, 8, False, "float32"),
    ("int8_wgmma", 512, 64, 64, 8, 8, True, "bfloat16"),
    ("int8_wgmma", 384, 96, None, 4, 4, True, "float32"),
    ("cuda_core", 256, 64, 32, 8, 8, True, "float32"),
    ("int8_wgmma", 512, 128, None, 8, 8, True, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", GPU_CASES,
                         ids=["-".join(map(str, c)) for c in GPU_CASES])
def test_kernel_within_bound_of_plain_on_card(case, entry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    route, S, hd, blk, m_qk, m_pv, causal, dtype = case
    blk = blk or min(128, S & -S)
    dt = getattr(torch, dtype)
    q, k, v, do = (t.cuda() for t in _draw(S + hd + m_qk, 4, S, hd))
    q, k, v, do = q.to(dt), k.to(dt), v.to(dt), (do * 1e-2).to(dt)
    kw = dict(m_bits=8, m_qk=m_qk, m_pv=m_pv, bq=blk, bk=blk, causal=causal)
    assert fa.flash_bwd_route(m_qk=m_qk, m_pv=m_pv, S=S, hd=hd, bq=blk,
                              bk=blk) == route
    o, lse = fa.hbfp_flash_fwd_plain(q, k, v, with_lse=True, **kw)
    args = (q, k, v, do, lse, tref.flash_delta(o, do))
    fa.reset_counts()
    got = getattr(fa, entry)(*args, **kw)
    want = getattr(fa, entry + "_plain")(*args, with_bound=True, **kw)
    torch.cuda.synchronize()
    assert getattr(fa, entry).launches_by_route[route] == 1
    got = got if isinstance(got, tuple) else (got,)
    n = len(got)
    for g, w, b in zip(got, want[:n], want[n:]):
        assert _grad_ok(g, w, b, S, dt == torch.bfloat16)


@pytest.mark.gpu
def test_subnormal_products_kept_on_card():
    """k scaled to the quantizer's step floor (k^ = small integers times
    2^-106) drives ds^·k^ products and dq below f32's normal range: the
    tensor cores keep them as subnormals (no flush to zero), so dq stays
    within the bound of the plain version and nonzero wherever the plain
    version's is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    BH, S, hd = 4, 512, 128
    q, k, v, do = (t.cuda() for t in _draw(105, BH, S, hd))
    k, do = k * 2.0 ** -105, do * 2.0 ** -14
    kw = dict(m_bits=8, bq=128, bk=128, causal=True)
    o, lse = fa.hbfp_flash_fwd_plain(q, k, v, with_lse=True, **kw)
    args = (q, k, v, do, lse, tref.flash_delta(o, do))
    got = fa.hbfp_flash_dq(*args, **kw)
    want, bound = fa.hbfp_flash_dq_plain(*args, with_bound=True, **kw)
    torch.cuda.synchronize()
    assert _grad_ok(got, want, bound, S, False)
    sub = (want != 0) & (want.abs() < 2.0 ** -126)
    assert int(sub.sum()) > 0
    assert bool((got[want != 0] != 0).all())
