"""Routes of the port's FP→BFP conversion (B7) and the banded dataflow that
keeps its main route bit for bit equal to the plain version.

On the card a launch takes one of two routes
(`bfp_quantize.bfp_quantize_route`, which with `band_plan` and
`split_ctas` plans the launch that `csrc/bfp_quantize.cu` runs):
"banded" (16-byte vectors, many tiles per CTA, x read once) or "split"
(the rest: tiles larger than a CTA, e.g. one exponent per matrix, and
rows or tiles that are not whole 16-byte vectors). Here, on the CPU:

- the route table: every B7 operand of the adaptive path and of a packed
  save at yi-9b's full width (the seven projections and the head at tile
  24 and 128, m 4/8/16, the activation rows) takes "banded", whole-matrix
  tiles and rows or tiles that are not whole 16-byte vectors (or an x
  that is not 16-byte aligned) "split";
- the banded plans of those operands within the kernel's sizes (the
  checks the C side makes before it launches);
- a CPU emulation of the banded dataflow, driven by the same `band_plan`:
  each CTA's threads gather their vectors, per-vector maxima fold into the
  thread's and then, as bit patterns, into the tile's; the conversion
  multiplies by the exact reciprocal of the step. It covers every element
  once, keeps each thread in one tile, and equals `bfp_quantize_ref` and
  the reference's Pallas kernel in interpret mode bit for bit in all five
  outputs, at the exponent clamp, with subnormal inputs and quotients,
  all-zero and padded edge tiles, m 2 and m 16 and stochastic rounding.

JAX is imported inside the one test that runs the reference, so the card
cases run where JAX is not installed. The `gpu`-marked cases hold the
kernel to its plain version per route at the same edge shapes and skip
where there is no CUDA device. Run them on the card:
    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_b7_routes.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import bfp
from repro_torch.kernels import bfp_quantize as bq
from repro_torch.kernels.common import max_exponent, pow2, uniform_from_index
from repro_torch.kernels.ref import _wrap_i32, bfp_quantize_ref, bfp_tiles
from repro_torch.models.transformer import _layer_shapes

F32, BF16 = torch.float32, torch.bfloat16


def _yi_b7_operands():
    """(name, R, C, tile_r, tile_c) of every B7 launch of a telemetry step
    and a packed save of yi-9b at full width, at tile 24 and 128, as
    `bfp.b7_slices` cuts them, and the two activation row views."""
    arch = get_arch("yi-9b")
    out = []
    for tile in (24, 128):
        for name, (K, N), _ in _layer_shapes(arch):
            lead, R, C, tr, tc, _ = bfp.b7_layout(
                (arch.n_layers, K, N), bfp.weight_tile_shape(3, tile))
            out.append((f"{name}_t{tile}", R, C, tr, tc))
        _, R, C, tr, tc, _ = bfp.b7_layout(
            (arch.d_model, arch.vocab_size), bfp.weight_tile_shape(2, tile))
        out.append((f"head_t{tile}", R, C, tr, tc))
    _, R, C, tr, tc, merged = bfp.b7_layout(
        (1, 4096, arch.d_model), bfp.act_tile_shape(3, None))
    assert merged
    out.append(("act_rows", R, C, tr, tc))
    return out


MAIN_PATH = _yi_b7_operands()


@pytest.mark.parametrize("case", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_route_table_main_path(case, m, dtype):
    _, R, C, tr, tc = case
    assert bq.bfp_quantize_route(R, C, tr, tc, dtype, m) == "banded"
    assert bq.bfp_quantize_scratch("banded", R, C, tr, tc, dtype,
                                   True) == 0


# (name, R, C, tile_r, tile_c, dtype, aligned, route)
OFF_PATH = [
    ("whole_ffn_wg", 4096, 11008, None, None, F32, True, "split"),
    ("whole_bf16", 4096, 11008, None, None, BF16, True, "split"),
    ("column_strips", 4096, 512, None, 128, F32, True, "split"),
    ("whole_misaligned_c", 300, 130, None, None, F32, True, "split"),
    ("row_64000_bf16", 8, 64000, 1, None, BF16, True, "split"),
    ("c130_t32", 100, 130, 32, 32, F32, True, "split"),
    ("c130_bf16", 100, 130, 32, 32, BF16, True, "split"),
    ("tc6_f32", 128, 256, 6, 6, F32, True, "split"),
    ("tc4_bf16", 128, 256, 4, 4, BF16, True, "split"),
    ("unaligned_x", 128, 256, 32, 32, F32, False, "split"),
    ("small_t32", 128, 256, 32, 32, F32, True, "banded"),
    ("tile_1x4", 64, 64, 1, 4, F32, True, "banded"),
]


@pytest.mark.parametrize("case", OFF_PATH, ids=[c[0] for c in OFF_PATH])
def test_route_table_off_path(case):
    _, R, C, tr, tc, dtype, aligned, want = case
    assert bq.bfp_quantize_route(R, C, tr, tc, dtype, 8, aligned) == want
    words = bq.bfp_quantize_scratch(want, R, C, tr or R, tc or C, dtype,
                                    True, aligned)
    assert (words > 0) == (want == "split")


def test_route_rejects_what_b7_cannot_do():
    with pytest.raises(ValueError, match="2 <= m <= 16"):
        bq.bfp_quantize_route(64, 64, 8, 8, F32, 17)
    with pytest.raises(TypeError):
        bq.bfp_quantize_route(64, 64, 8, 8, torch.float64, 8)


@pytest.mark.parametrize("case", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_band_plan_within_kernel_sizes(case, dtype):
    """Every banded plan of the main path passes the C side's checks: each
    vector of a tile taken by one thread, each thread within one tile and
    its kBandItems registers, the CTA within its launch bound."""
    _, R, C, tr, tc = case
    vec = bq._vec(C, tc, dtype, True)
    p = bq.band_plan(-(-R // tr), -(-C // tc), tr, tc, vec)
    assert p["vt"] * vec == tc
    if p["T"] == 1:
        assert p["Wt"] * p["P"] >= p["vt"]
    else:
        assert p["P"] == 1 and p["Wt"] == p["T"] * p["vt"]
    assert p["Hs"] * p["Q"] >= tr and p["P"] * p["Q"] <= bq.BAND_ITEMS
    assert p["threads"] % 32 == 0
    assert p["Wt"] * p["Hs"] * p["RB"] <= p["threads"] <= bq.BAND_THREADS
    assert p["RB"] * p["T"] <= bq.BAND_THREADS


# ---------------------------------------------------------------------------
# CPU emulation of the banded kernel

def _emulate_banded(x, seed, *, mantissa_bits, tile_r, tile_c, stochastic,
                    block_r=256, block_c=512):
    """B7's five outputs computed the banded kernel's way: per CTA of
    `band_plan`, each thread's vectors, per-vector then per-thread maxima,
    a fold of the bit patterns per tile, x times the reciprocal of the
    step, clip counts per thread then per tile. Also checks that every
    element is covered once and every thread stays in one tile."""
    R, C = x.shape
    tr, tc, Rp, Cp, br, bc = bfp_tiles(R, C, tile_r, tile_c, block_r,
                                       block_c)
    vec = bq._vec(C, tc, x.dtype, True)
    assert vec
    n_tr, n_tc = Rp // tr, Cp // tc
    p = bq.band_plan(n_tr, n_tc, tr, tc, vec)
    vt, T, RB, Wt, P, Hs, Q, NT = (p[k] for k in (
        "vt", "T", "RB", "Wt", "P", "Hs", "Q", "threads"))
    gx, gy = -(-n_tc // T), -(-n_tr // RB)
    cta = torch.arange(gx * gy)
    by, bx = (cta // gx)[:, None, None], (cta % gx)[:, None, None]
    t = torch.arange(NT)[None, :, None]
    active = t < Wt * Hs * RB
    c, h = t % Wt, t // Wt
    tcol = torch.zeros_like(c) if T == 1 else c // vt
    key = torch.where(active, (h // Hs) * T + tcol, 0)
    i = torch.arange(bq.BAND_ITEMS)[None, None, :]
    vi = c - tcol * vt + (i // Q) * Wt           # vector column in the tile
    ri = h % Hs + (i % Q) * Hs                   # row in the tile
    row = (by * RB + h // Hs) * tr + ri
    col = ((bx * T + tcol) * vt + vi) * vec
    valid = active & (i < P * Q) & (vi < vt) & (ri < tr) & (row < R) \
        & (col < C)
    rows = row[..., None].expand(*valid.shape, vec)
    cols = col[..., None] + torch.arange(vec)
    m4 = valid[..., None].expand_as(cols)
    flat = (rows * C + cols)[m4]
    hits = torch.zeros(R * C, dtype=torch.int64)
    hits.index_add_(0, flat, torch.ones_like(flat))
    assert bool((hits == 1).all()), "an element is missed or taken twice"
    ti = (by * RB + h // Hs).expand_as(row)
    tj = (bx * T + tcol).expand_as(row)
    assert bool(((row // tr == ti) & (col // tc == tj))[valid].all()), \
        "a thread's vectors span two tiles"
    vals = torch.zeros(cols.shape, dtype=torch.float32)
    vals[m4] = x.to(torch.float32).reshape(-1)[flat]

    tmax = vals.abs().amax(-1).amax(-1)          # vector, then thread
    bits = torch.zeros((gx * gy, RB * T), dtype=torch.int32)
    bits.scatter_reduce_(1, key[..., 0].expand(gx * gy, NT),
                         tmax.view(torch.int32) * active[..., 0],
                         "amax", include_self=True)
    amax = bits.view(torch.float32)
    e_tile = max_exponent(amax)
    inv = pow2(mantissa_bits - 2 - e_tile)       # the step's reciprocal
    v = vals * inv.gather(1, key[..., 0].expand(gx * gy, NT))[..., None,
                                                                None]
    if stochastic:
        idx = _wrap_i32(rows.to(torch.int64) * Cp + cols)
        v = torch.floor(v + uniform_from_index(int(seed), idx))
    else:
        v = torch.round(v)
    lim = float(2 ** (mantissa_bits - 1) - 1)
    clipped = (v.abs() > lim) & m4
    mdt = torch.int8 if mantissa_bits <= 8 else torch.int16
    mant = torch.zeros(R * C, dtype=mdt)
    mant[flat] = v.clamp(-lim, lim)[m4].to(mdt)
    nclip = torch.zeros((gx * gy, RB * T), dtype=torch.int32)
    nclip.scatter_add_(1, key[..., 0].expand(gx * gy, NT),
                       (clipped.sum((2, 3)) * active[..., 0]).to(torch.int32))

    li = torch.arange(RB * T)
    ei = (cta[:, None] // gx) * RB + li // T
    ej = (cta[:, None] % gx) * T + li % T
    own = (ei < n_tr) & (ej < n_tc)
    expo = torch.full((n_tr, n_tc), 127, dtype=torch.int32)
    clip = torch.full((n_tr, n_tc), -1, dtype=torch.int32)
    expo[ei[own], ej[own]] = e_tile[own]
    clip[ei[own], ej[own]] = nclip[own]
    assert int(own.sum()) == n_tr * n_tc, "a tile has no owner"
    eb = expo.reshape(Rp // br, br // tr, Cp // bc, bc // tc)
    return (mant.reshape(R, C), expo.to(torch.int8), clip,
            eb.amin(dim=(1, 3)), eb.amax(dim=(1, 3)))


def _edge_x(R, C, tr, tc, dtype, seed):
    """x with, tile by tile in turn: normal values, an all-zero tile,
    amax below 2^-100 (exponent clamped at -100), amax near 2^127
    (clamped at 126), only subnormal inputs, and one near-2^127 element
    over unit values (subnormal quotients at m 2); padded edges where the
    tiles do not divide R and C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, C)).astype(np.float32) * 2.5
    n_tc = -(-C // tc)
    for ti in range(-(-R // tr)):
        for tj in range(n_tc):
            s = np.s_[ti * tr:(ti + 1) * tr, tj * tc:(tj + 1) * tc]
            kind = (ti * n_tc + tj) % 7
            u = rng.uniform(-1.0, 1.0, x[s].shape).astype(np.float32)
            if kind == 1:
                x[s] = 0.0
            elif kind == 2:
                x[s] = u * np.float32(2.0 ** -103)
            elif kind == 3:
                x[s] = u * np.float32(1.7e38)
            elif kind == 4:
                x[s] = u * np.float32(1e-39)
            elif kind == 5:
                x[s] = u
                x[s][0, 0] = np.float32(1.5 * 2.0 ** 127)
    t = torch.from_numpy(x)
    return t.to(dtype) if dtype != F32 else t


# (name, R, C, dtype, m, tile_r, tile_c, stochastic, seed, block_r,
# block_c); 4096 = 170·24 + 16 and 50 = 2·24 + 2 pad the last tiles
EMU_CASES = [
    ("t24_m4", 50, 4096, F32, 4, 24, 24, False, 0, 256, 512),
    ("t24_m2", 50, 4096, F32, 2, 24, 24, False, 0, 256, 512),
    ("t24_m16", 50, 4096, F32, 16, 24, 24, False, 0, 256, 512),
    ("t24_stoch_s7", 50, 4096, F32, 8, 24, 24, True, 7, 256, 512),
    ("t24_stoch_sneg", 50, 4096, F32, 4, 24, 24, True, -123457, 256, 512),
    ("t24_bf16_m4", 50, 4096, BF16, 4, 24, 24, False, 0, 256, 512),
    ("t128_m8", 200, 392, F32, 8, 128, 128, False, 0, 256, 512),
    ("t128_m16_stoch", 200, 392, F32, 16, 128, 128, True, 99, 256, 512),
    ("t64_m8", 200, 136, F32, 8, 64, 64, False, 0, 256, 512),
    ("rows_bf16_m4", 10, 4096, BF16, 4, 1, None, False, 0, 256, 512),
    ("rows_f32_stoch", 10, 4096, F32, 8, 1, None, True, 5, 256, 512),
    ("t32x64_blocks", 128, 256, F32, 4, 32, 64, False, 0, 32, 128),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_banded_emulation_equals_plain(case):
    _, R, C, dtype, m, tr, tc, st, seed, br, bc = case
    x = _edge_x(R, C, tr or R, tc or C, dtype, R * 1000 + C + m)
    kw = dict(mantissa_bits=m, tile_r=tr, tile_c=tc, stochastic=st,
              block_r=br, block_c=bc)
    assert bq.bfp_quantize_route(R, C, tr, tc, dtype, m) == "banded"
    got = _emulate_banded(x, seed, **kw)
    want = bfp_quantize_ref(x, seed, with_stats=True, **kw)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", [c for c in EMU_CASES
                                  if c[0] in ("t24_m2", "t24_stoch_sneg",
                                              "t24_bf16_m4", "t128_m16_stoch",
                                              "rows_bf16_m4")],
                         ids=lambda c: c[0])
def test_banded_emulation_equals_pallas(case):
    """The same emulation against the reference's Pallas kernel in
    interpret mode on the same values."""
    import jax.numpy as jnp
    from repro.kernels.bfp_quantize import bfp_quantize_pallas
    _, R, C, dtype, m, tr, tc, st, seed, br, bc = case
    x = _edge_x(R, C, tr or R, tc or C, dtype, R * 1000 + C + m)
    kw = dict(mantissa_bits=m, tile_r=tr or R, tile_c=tc or C,
              stochastic=st, block_r=br, block_c=bc)
    xj = jnp.asarray(x.float().numpy())
    if dtype == BF16:
        xj = xj.astype(jnp.bfloat16)
    want = bfp_quantize_pallas(xj, jnp.full((1, 1), seed, jnp.int32),
                               interpret=True, with_stats=True, **kw)
    got = _emulate_banded(x, seed, **kw)
    for a, b in zip(got, want):
        b = np.array(b)
        assert a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_reciprocal_is_exact_over_the_exponent_range():
    """2^(m-2-e) is a normal f32 for every clamped e and 2 <= m <= 16, and
    x times it equals x divided by the step for normal, subnormal and
    extreme x (the quotient rounds once either way)."""
    e = torch.arange(-100, 127, dtype=torch.int32)
    xs = torch.tensor([1.0, -0.75, 3.0e38, 1.2e-38, 1e-41, 1.4e-45,
                       -2.5e-39, 7.0, 1.5 * 2.0 ** 127], dtype=F32)
    for m in range(2, 17):
        inv = pow2(m - 2 - e)
        step = pow2(e - m + 2)
        assert bool((inv >= torch.finfo(F32).tiny).all())
        assert torch.equal(inv * step, torch.ones_like(inv))
        assert torch.equal(xs[:, None] * inv[None, :],
                           xs[:, None] / step[None, :])


# ---------------------------------------------------------------------------
# on the card

# the emulated cases on the banded route; whole-matrix and over-large row
# tiles on split (vector and scalar), and misaligned rows, odd tiles and
# an unaligned x on split's scalar passes
GPU_CASES = (
    [(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9], c[10],
      "banded", 0) for c in EMU_CASES]
    + [("whole_f32_m16", 300, 2048, F32, 16, None, None, False, 0, 256, 512,
        "split", 0),
       ("whole_bf16_stoch", 300, 2048, BF16, 8, None, None, True, 3, 256,
        512, "split", 0),
       ("strips_f32_m4", 1000, 520, F32, 4, None, 128, False, 0, 256, 512,
        "split", 0),
       ("whole_c130_scalar", 300, 130, F32, 8, None, None, False, 0, 256,
        512, "split", 0),
       ("c130_t32_m4", 100, 130, F32, 4, 32, 32, False, 0, 256, 512,
        "split", 0),
       ("tc6_stoch", 100, 96, F32, 8, 6, 6, True, 11, 256, 512, "split",
        0),
       ("unaligned_t24", 50, 4096, F32, 4, 24, 24, False, 0, 256, 512,
        "split", 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_kernel_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    name, R, C, dtype, m, tr, tc, st, seed, br, bc, route, shift = case
    x = _edge_x(R, C, tr or R, tc or C, dtype, R * 1000 + C + m)
    if shift:   # x one element past a 16-byte boundary
        buf = torch.zeros(R * C + shift, dtype=dtype, device="cuda")
        buf[shift:] = x.reshape(-1).cuda()
        x = buf[shift:].view(R, C)
    else:
        x = x.cuda()
    kw = dict(mantissa_bits=m, tile_r=tr, tile_c=tc, stochastic=st,
              block_r=br, block_c=bc, with_stats=True)
    assert bq.bfp_quantize_route(R, C, tr, tc, dtype, m,
                                 x.data_ptr() % 16 == 0) == route
    bq.reset_counts()
    got = bq.bfp_quantize(x, seed, **kw)
    torch.cuda.synchronize()
    assert bq.bfp_quantize.launches_by_route[route] == 1
    want = bq.bfp_quantize_plain(x, seed, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
