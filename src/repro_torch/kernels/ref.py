"""Plain PyTorch versions of the HBFP kernels (port of
`repro.kernels.ref`): the FP→BFP conversion `bfp_quantize_ref` (B7), the
GEMMs `hbfp_matmul_ref`, `hbfp_dgrad_ref`,
`hbfp_wgrad_ref`, and flash attention `hbfp_flash_attn_ref` (B4),
`hbfp_flash_dq_ref` (B5), `hbfp_flash_dkv_ref` (B6) with their
compositions `hbfp_flash_attn_bwd_ref` and `hbfp_flash_attn_vjp_ref`.

They are the oracles the CUDA kernels are held to, and what the kernel
wrappers compute for tensors that lie on the CPU. The reference loops over
(contraction block, output block) tiles; the GEMM versions loop over the
contraction blocks in ascending order and handle all output blocks of one
contraction block at once, which computes every output element with the
same dot product; the flash versions are batched over B·H and loop over
q- and k-blocks. Integral-mantissa dot products run in float64: with at
most 2^(2m-2) per product and the few hundred products of a block the
float64 sum is exact, and its single rounding to f32 is what the kernels'
exact accumulation gives too (at m > 8 the reference's f32 dot rounds
partial sums past 2^24 instead, ROADMAP C4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (STREAM_G, STREAM_W, STREAM_X,
                                        quantize_block, row_group_amax)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 with the same low 32 bits (int32 wraparound)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _slab_group_amax(ws: torch.Tensor, rb: int, cb: int) -> torch.Tensor:
    """|w| max over (rb, cb) groups of a 2-D slab of w, broadcast back to
    the slab."""
    r, c = ws.shape
    g = ws.abs().reshape(r // rb, rb, c // cb, cb).amax(dim=(1, 3),
                                                       keepdim=True)
    return g.expand(r // rb, rb, c // cb, cb).reshape(r, c)


def _seed_value(seed) -> int:
    return 0 if seed is None else int(torch.as_tensor(seed).reshape(-1)[0])


def _index(r0: int, nr: int, c0: int, nc: int, C: int, stream: int,
           device, base=None) -> torch.Tensor:
    """int32 global element indices r * C + c + stream of a slab of a
    [R, C] operand; with `base` (a 2-D `IndexBase` on the padded
    one-process operand, `kernels.common.flat_base`) the operand is a part
    of that one and r, c, C are its row, column and row length."""
    r = torch.arange(r0, r0 + nr, dtype=torch.int64, device=device)
    c = torch.arange(c0, c0 + nc, dtype=torch.int64, device=device)
    if base is not None:
        r, c, C = r + base.offset[0], c + base.offset[1], base.shape[1]
    return _wrap_i32(r[:, None] * C + c[None, :] + stream)


def _given_amax(amax: torch.Tensor, R: int, c0: int, width: int,
                block: int) -> torch.Tensor:
    """The slab [c0, c0 + width)'s part of a given row amax ([R] or
    [R, C/group], one value per row group), broadcast to its columns."""
    gx = block if block and block < width else width
    a = amax.to(torch.float32).reshape(R, -1)[:, c0 // gx:(c0 + width) // gx]
    return a if gx == width else a.repeat_interleave(gx, dim=1)


def _quantize_rows(a: torch.Tensor, c0: int, width: int, C: int,
                   mantissa_bits: int, block: int, stochastic: bool,
                   seed: int, stream: int, amax=None, base=None):
    """Columns [c0, c0 + width) of the f32 [R, C] operand `a`, quantized
    per (row, block group): (q, delta) on the operand's stochastic
    stream (at `base`, see `_index`), each group on its own amax or,
    given `amax`, on that one."""
    s = a[:, c0:c0 + width]
    idx = _index(0, a.shape[0], c0, width, C, stream, a.device, base) \
        if stochastic else None
    g = row_group_amax(s, block) if amax is None else \
        _given_amax(amax, a.shape[0], c0, width, block)
    return quantize_block(s, mantissa_bits, g, stochastic=stochastic,
                          seed=seed, idx=idx)


def _quantize_w(ws: torch.Tensor, r0: int, c0: int, N: int, rb: int,
                cb: int, mantissa_bits: int, stochastic: bool, seed: int,
                base=None):
    """A slab of w [K, N] starting at (r0, c0), quantized per (rb, cb)
    group on STREAM_W with w's own element indices (so the forward and
    dgrad draw the same numbers), at `base` (see `_index`): (q, delta)."""
    idx = _index(r0, ws.shape[0], c0, ws.shape[1], N, STREAM_W, ws.device,
                 base) if stochastic else None
    return quantize_block(ws, mantissa_bits, _slab_group_amax(ws, rb, cb),
                          stochastic=stochastic, seed=seed, idx=idx)


def fit_block(n_tiles: int, want_tiles: int) -> int:
    """Largest tile count <= want_tiles that divides n_tiles (>= 1): the
    reference's `_fit_block`, which sets B7's grid of per-block stats."""
    k = max(1, min(want_tiles, n_tiles))
    while n_tiles % k:
        k -= 1
    return k


def bfp_tiles(R: int, C: int, tile_r, tile_c, block_r: int, block_c: int):
    """B7's geometry for x [R, C]: the clipped tile (tr, tc; None is the
    whole dim), the padded shape (Rp, Cp) and the fitted stats block
    (block_r, block_c) in elements."""
    tr = R if tile_r is None else min(tile_r, R)
    tc = C if tile_c is None else min(tile_c, C)
    Rp, Cp = -(-R // tr) * tr, -(-C // tc) * tc
    br = tr * fit_block(Rp // tr, max(min(block_r, Rp) // tr, 1))
    bc = tc * fit_block(Cp // tc, max(min(block_c, Cp) // tc, 1))
    return tr, tc, Rp, Cp, br, bc


def bfp_quantize_ref(x, seed=0, *, mantissa_bits=8, tile_r=128, tile_c=128,
                     stochastic=False, block_r=256, block_c=512,
                     with_stats=False, base=None):
    """B7's plain version: x [R, C] zero-padded to whole (tile_r, tile_c)
    tiles, one exponent per tile, mantissas sliced back to [R, C] (int8
    for m <= 8, else int16). Returns (mantissa, exponent int8) or, with
    stats, also (clip count per tile, exponent min and max per fitted
    block), all int32. `base` (a 2-D `IndexBase` on the padded
    one-process operand) draws x as that part of it."""
    R, C = x.shape
    tr, tc, Rp, Cp, br, bc = bfp_tiles(R, C, tile_r, tile_c, block_r,
                                       block_c)
    xf = x.to(torch.float32)
    if (Rp, Cp) != (R, C):
        xf = torch.nn.functional.pad(xf, (0, Cp - C, 0, Rp - R))
    g = xf.reshape(Rp // tr, tr, Cp // tc, tc)
    amax = g.abs().amax(dim=(1, 3), keepdim=True)
    idx = _index(0, Rp, 0, Cp, Cp, 0, x.device, base).reshape(g.shape) \
        if stochastic else None
    q, delta, clipped = quantize_block(
        g, mantissa_bits, amax, stochastic=stochastic,
        seed=_seed_value(seed), idx=idx, with_clip=True)
    mdt = torch.int8 if mantissa_bits <= 8 else torch.int16
    dbits = delta.contiguous().view(torch.int32)
    et = (((dbits >> 23) & 0xFF) - 127 + (mantissa_bits - 2))[:, 0, :, 0]
    mant = q.reshape(Rp, Cp).to(mdt)[:R, :C].contiguous()
    if not with_stats:
        return mant, et.to(torch.int8)
    eb = et.reshape(Rp // br, br // tr, Cp // bc, bc // tc)
    return (mant, et.to(torch.int8),
            clipped.sum(dim=(1, 3)).to(torch.int32),
            eb.amin(dim=(1, 3)).to(torch.int32),
            eb.amax(dim=(1, 3)).to(torch.int32))


def hbfp_matmul_ref(x, w, seed=None, *, mantissa_bits=8, stochastic=False,
                    quantize_w=True, block=0, bm=128, bk=128, bn=128,
                    out_dtype=torch.float32, x_amax=None, x_base=None,
                    w_base=None):
    """y = Σ_k Q_row(x)·Q_tile(w)·δx·δw with per-(row, K-block) activation
    exponents and per-(bk, bn) weight-tile exponents, f32 accumulation in
    ascending K-block order. quantize_w=False contracts the given
    (pre-narrowed) w in f32; block>0 refines x to per-(row, block) and w to
    (block, block) groups and dequantizes before an f32 dot (DESIGN.md
    §13). `x_amax` ([M] or [M, K/group]) replaces x's group amaxes;
    `x_base`, `w_base` (2-D `IndexBase`s, `_index`) draw each operand as
    that part of the one-process operand. Shapes must be divisible by the
    clipped tiles."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} x {tuple(w.shape)}")
    bm_, bk_, bn_ = min(bm, M), min(bk, K), min(bn, N)
    if M % bm_ or K % bk_ or N % bn_:
        raise ValueError(f"({M},{K})x({K},{N}) not divisible by "
                         f"({bm_},{bk_},{bn_})")
    x_sub = bool(block) and block < bk_
    w_sub = bool(block) and (block < bk_ or block < bn_)
    seed_v = _seed_value(seed)
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    rb, cb = (min(block, bk_), min(block, bn_)) if w_sub else (bk_, bn_)
    for k0 in range(0, K, bk_):
        qx, dx = _quantize_rows(xf, k0, bk_, K, mantissa_bits, block,
                                stochastic, seed_v, STREAM_X, x_amax, x_base)
        ws = wf[k0:k0 + bk_]                                   # [bk, N]
        if not quantize_w:
            if x_sub:
                acc = acc + (qx * dx) @ ws
            else:
                acc = acc + (qx @ ws) * dx
            continue
        qw, dw = _quantize_w(ws, k0, 0, N, rb, cb, mantissa_bits, stochastic,
                             seed_v, w_base)
        if x_sub or w_sub:
            acc = acc + (qx * dx) @ (qw * dw)
            continue
        part = (qx.to(torch.float64) @ qw.to(torch.float64)).to(torch.float32)
        acc = acc + part * (dx * dw[:1])       # δw is constant down a column
    return acc.to(out_dtype)


def hbfp_dgrad_ref(g, w, seed=None, *, mantissa_bits=8, stochastic=False,
                   quantize_w=True, block=0, bm=128, bk=128, bn=128,
                   out_dtype=torch.float32, g_amax=None, g_base=None,
                   w_base=None):
    """dx[M,K] = Q(g)·Q(w)ᵀ: gradient rows quantized per (row, N-block)
    on STREAM_G, weight tiles per (bk, bn) block of w on STREAM_W (the
    forward's element index), f32 accumulation over N-blocks in ascending
    order. quantize_w=False contracts the given (pre-narrowed) w; block>0
    refines the exponent groups like hbfp_matmul_ref; `g_amax` replaces
    g's group amaxes; `g_base`, `w_base` as hbfp_matmul_ref's."""
    M, N = g.shape
    K, N2 = w.shape
    if N != N2:
        raise ValueError(f"dgrad: {tuple(g.shape)} vs {tuple(w.shape)}")
    bm_, bk_, bn_ = min(bm, M), min(bk, K), min(bn, N)
    if M % bm_ or K % bk_ or N % bn_:
        raise ValueError(f"dgrad ({M},{N})x({K},{N}) not divisible by "
                         f"({bm_},{bk_},{bn_})")
    g_sub = bool(block) and block < bn_
    w_sub = bool(block) and (block < bk_ or block < bn_)
    seed_v = _seed_value(seed)
    gf = g.to(torch.float32)
    wf = w.to(torch.float32)
    acc = torch.zeros((M, K), dtype=torch.float32, device=g.device)
    rb, cb = (min(block, bk_), min(block, bn_)) if w_sub else (bk_, bn_)
    for n0 in range(0, N, bn_):
        qg, dg = _quantize_rows(gf, n0, bn_, N, mantissa_bits, block,
                                stochastic, seed_v, STREAM_G, g_amax, g_base)
        ws = wf[:, n0:n0 + bn_]                                 # [K, bn]
        if not quantize_w:
            if g_sub:
                acc = acc + (qg * dg) @ ws.T
            else:
                acc = acc + (qg @ ws.T) * dg
            continue
        qw, dw = _quantize_w(ws, 0, n0, N, rb, cb, mantissa_bits, stochastic,
                             seed_v, w_base)
        if g_sub or w_sub:
            acc = acc + (qg * dg) @ (qw * dw).T
            continue
        part = (qg.to(torch.float64) @ qw.to(torch.float64).T).to(torch.float32)
        acc = acc + part * (dg * dw[:, 0][None, :])  # δw constant along a row
    return acc.to(out_dtype)


def hbfp_wgrad_ref(x, g, seed=None, *, mantissa_bits=8, stochastic=False,
                   block=0, bm=128, bk=128, bn=128, out_dtype=torch.float32,
                   operands=False, x_amax=None, g_amax=None, x_base=None,
                   g_base=None):
    """dw[K,N] = (Q(x)·δx)ᵀ·(Q(g)·δg): x rows per (row, K-block) on the
    forward's STREAM_X, g rows per (row, N-block) on STREAM_G, dequantized
    f32 products accumulated over M-blocks in ascending order, as the
    reference does. `operands` also returns the dequantized x̂ [M,K] and
    ĝ [M,N] (what the kernel's scratch holds); `x_amax`, `g_amax` replace
    the operands' group amaxes; `x_base`, `g_base` as hbfp_matmul_ref's."""
    M, K = x.shape
    M2, N = g.shape
    if M != M2:
        raise ValueError(f"wgrad: {tuple(x.shape)} vs {tuple(g.shape)}")
    bm_, bk_, bn_ = min(bm, M), min(bk, K), min(bn, N)
    if M % bm_ or K % bk_ or N % bn_:
        raise ValueError(f"wgrad ({M},{K})x({M},{N}) not divisible by "
                         f"({bm_},{bk_},{bn_})")
    seed_v = _seed_value(seed)

    def dequant(a, C, width, stream, amax, base):
        out = torch.empty_like(a)
        for c0 in range(0, C, width):
            q, d = _quantize_rows(a, c0, width, C, mantissa_bits, block,
                                  stochastic, seed_v, stream, amax, base)
            out[:, c0:c0 + width] = q * d
        return out

    xh = dequant(x.to(torch.float32), K, bk_, STREAM_X, x_amax, x_base)
    gh = dequant(g.to(torch.float32), N, bn_, STREAM_G, g_amax, g_base)
    acc = torch.zeros((K, N), dtype=torch.float32, device=x.device)
    for m0 in range(0, M, bm_):
        acc = acc + xh[m0:m0 + bm_].T @ gh[m0:m0 + bm_]
    acc = acc.to(out_dtype)
    return (acc, xh, gh) if operands else acc


# ----------------------------------------------------------------------------
# Flash attention (port of `repro.kernels.ref.hbfp_flash_attn_ref` and
# `hbfp_flash_attn_vjp_ref`), batched over BH, looping over q- and k-blocks.
# ----------------------------------------------------------------------------

NEG_INF = -1e30


def _flash_blocks(S: int, bq: int, bk: int):
    bq_, bk_ = min(bq, S), min(bk, S)
    if S % bq_ or S % bk_:
        raise ValueError(f"flash: S={S} not divisible by blocks ({bq_},{bk_})")
    return bq_, bk_


def _flash_scale(hd: int, device) -> torch.Tensor:
    """1/√hd as an f32 tensor: q·α is taken in f32 after the cast, never
    with a scale rounded to q's dtype."""
    return torch.tensor(1.0 / (hd ** 0.5), dtype=torch.float32, device=device)


def _rows(x: torch.Tensor, m_bits: int):
    """Nearest BFP quantization with one exponent per row of the last axis:
    (integral mantissas, step [..., 1])."""
    return quantize_block(x, m_bits, x.abs().amax(dim=-1, keepdim=True),
                          stochastic=False)


def _idot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of integral mantissas, summed exactly (float64) and
    rounded once to f32, as the kernels' exact partial sums are."""
    return torch.bmm(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def _row_sum(p: torch.Tensor) -> torch.Tensor:
    """Row sum over the last axis in the flash kernel's order: each of 16
    lanes adds its columns c = lane + 16 j in ascending j, then the lanes
    are summed by a halving tree (8, 4, 2, 1). Returns [..., 1]."""
    n = p.shape[-1]
    nj = -(-n // 16)
    if nj * 16 != n:
        p = torch.nn.functional.pad(p, (0, nj * 16 - n))
    t = p.reshape(*p.shape[:-1], nj, 16)
    s = t[..., 0, :]
    for j in range(1, nj):
        s = s + t[..., j, :]
    for off in (8, 4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    return s


def _causal_mask(s: torch.Tensor, i: int, j: int, bq: int, bk: int):
    qpos = i * bq + torch.arange(bq, device=s.device)[:, None]
    kpos = j * bk + torch.arange(bk, device=s.device)[None, :]
    return torch.where(kpos <= qpos, s,
                       torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))


def _n_kblocks(i: int, bq: int, bk: int, nk: int, causal: bool) -> int:
    """k-blocks a q-block visits: all, or those that `kb*bk <= i*bq + bq-1`
    leaves unmasked (the reference skips the others)."""
    return min(nk, (i * bq + bq - 1) // bk + 1) if causal else nk


def hbfp_flash_attn_ref(q, k, v, *, m_bits=8, m_qk=0, m_pv=0, bq=128,
                        bk=128, causal=True, with_lse=False):
    """B4's plain version. q, k, v: [BH, S, hd]. Per (q-block, k-block):
    q·α and k per row over hd at m_qk, s = Q(q)·Q(k)ᵀ·δqδk, the f32 online
    softmax, p per row over bk and v per column over bk at m_pv,
    acc = acc·α + Q(p)·Q(v)·δpδv. Returns o in q's dtype, and lse [BH, S]
    f32 when with_lse. m_qk/m_pv 0 mean m_bits."""
    BH, S, hd = q.shape
    m_qk, m_pv = m_qk or m_bits, m_pv or m_bits
    bq_, bk_ = _flash_blocks(S, bq, bk)
    dev = q.device
    scale = _flash_scale(hd, dev)
    out = torch.empty((BH, S, hd), dtype=q.dtype, device=dev)
    lse_out = torch.empty((BH, S), dtype=torch.float32, device=dev)
    for i in range(S // bq_):
        rows = slice(i * bq_, (i + 1) * bq_)
        qq, dq = _rows(q[:, rows].to(torch.float32) * scale, m_qk)
        m = torch.full((BH, bq_, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((BH, bq_, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, bq_, hd), dtype=torch.float32, device=dev)
        for j in range(_n_kblocks(i, bq_, bk_, S // bk_, causal)):
            cols = slice(j * bk_, (j + 1) * bk_)
            kq, dk = _rows(k[:, cols].to(torch.float32), m_qk)
            s = _idot(qq, kq.transpose(1, 2)) * (dq * dk.transpose(1, 2))
            if causal:
                s = _causal_mask(s, i, j, bq_, bk_)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + _row_sum(p)
            pq, dp = _rows(p, m_pv)
            vs = v[:, cols].to(torch.float32)
            vq, dv = quantize_block(vs, m_pv,
                                    vs.abs().amax(dim=1, keepdim=True),
                                    stochastic=False)
            acc = acc * alpha + _idot(pq, vq) * (dp * dv)
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        out[:, rows] = (acc / lc).to(q.dtype)
        lse_out[:, rows] = (m + torch.log(lc))[..., 0]
    return (out, lse_out) if with_lse else out


def _flash_bwd_blocks(q, k, v, do, lse, delta, *, m_qk, m_pv, bq, bk,
                      causal, want_dq, want_dkv, with_bound):
    """The two-pass flash backward's arithmetic over every (q-block,
    k-block) pair the causal mask leaves, q-blocks outer: dq accumulates
    over k-blocks and dk/dv over q-blocks, each in ascending order, as
    both reference kernels do. With `with_bound` each f32 contraction also
    sums |a|·|b| of its products (same shapes as dq, dk, dv)."""
    BH, S, hd = q.shape
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale = _flash_scale(hd, dev)
    dq = torch.zeros((BH, S, hd), **f32) if want_dq else None
    dk = torch.zeros((BH, S, hd), **f32) if want_dkv else None
    dv = torch.zeros((BH, S, hd), **f32) if want_dkv else None
    bounds = {n: torch.zeros((BH, S, hd), **f32) for n, w in
              (("dq", want_dq), ("dk", want_dkv), ("dv", want_dkv))
              if w and with_bound}
    for i in range(S // bq):
        rows = slice(i * bq, (i + 1) * bq)
        qq, dqs = _rows(q[:, rows].to(torch.float32) * scale, m_qk)
        do_q, do_d = _rows(do[:, rows].to(torch.float32), m_pv)
        lse_i = lse[:, rows, None]
        delta_i = delta[:, rows, None]
        for j in range(_n_kblocks(i, bq, bk, S // bk, causal)):
            cols = slice(j * bk, (j + 1) * bk)
            kq, dks = _rows(k[:, cols].to(torch.float32), m_qk)
            s = _idot(qq, kq.transpose(1, 2)) * (dqs * dks.transpose(1, 2))
            if causal:
                s = _causal_mask(s, i, j, bq, bk)
            p = torch.exp(s - lse_i)
            vq, dvs = _rows(v[:, cols].to(torch.float32), m_pv)
            dp = _idot(do_q, vq.transpose(1, 2)) * (do_d * dvs.transpose(1, 2))
            ds = p * (dp - delta_i)
            ds_q, ds_d = _rows(ds, m_qk)
            dsh = ds_q * ds_d
            if want_dq:
                kh = kq * dks
                dq[:, rows] = dq[:, rows] + torch.bmm(dsh, kh) * scale
                if with_bound:
                    bounds["dq"][:, rows] += torch.bmm(dsh.abs(),
                                                       kh.abs()) * scale
            if want_dkv:
                p_q, p_d = _rows(p, m_pv)
                ph, doh, qh = p_q * p_d, do_q * do_d, qq * dqs
                dv[:, cols] = dv[:, cols] + torch.bmm(ph.transpose(1, 2), doh)
                dk[:, cols] = dk[:, cols] + torch.bmm(dsh.transpose(1, 2), qh)
                if with_bound:
                    bounds["dv"][:, cols] += torch.bmm(
                        ph.abs().transpose(1, 2), doh.abs())
                    bounds["dk"][:, cols] += torch.bmm(
                        dsh.abs().transpose(1, 2), qh.abs())
    return dq, dk, dv, bounds


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(do ∘ o) in f32 [BH, S], from the saved o (the FP side,
    outside the kernels as in the reference)."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(-1)


def hbfp_flash_dq_ref(q, k, v, do, lse, delta, *, m_bits=8, m_qk=0, m_pv=0,
                      bq=128, bk=128, causal=True, with_bound=False):
    """B5's plain version: dq [BH, S, hd] in q's dtype (with_bound: also
    the f32 Σ|a||b| of its contraction)."""
    S = q.shape[1]
    bq_, bk_ = _flash_blocks(S, bq, bk)
    dq, _, _, b = _flash_bwd_blocks(
        q, k, v, do, lse, delta, m_qk=m_qk or m_bits, m_pv=m_pv or m_bits,
        bq=bq_, bk=bk_, causal=causal, want_dq=True, want_dkv=False,
        with_bound=with_bound)
    dq = dq.to(q.dtype)
    return (dq, b["dq"]) if with_bound else dq


def hbfp_flash_dkv_ref(q, k, v, do, lse, delta, *, m_bits=8, m_qk=0,
                       m_pv=0, bq=128, bk=128, causal=True,
                       with_bound=False):
    """B6's plain version: (dk, dv) in q's dtype (with_bound: also their
    f32 Σ|a||b| bounds)."""
    S = q.shape[1]
    bq_, bk_ = _flash_blocks(S, bq, bk)
    _, dk, dv, b = _flash_bwd_blocks(
        q, k, v, do, lse, delta, m_qk=m_qk or m_bits, m_pv=m_pv or m_bits,
        bq=bq_, bk=bk_, causal=causal, want_dq=False, want_dkv=True,
        with_bound=with_bound)
    dk, dv = dk.to(q.dtype), dv.to(q.dtype)
    return (dk, dv, b["dk"], b["dv"]) if with_bound else (dk, dv)


def hbfp_flash_attn_bwd_ref(q, k, v, o, lse, do, *, m_bits=8, m_qk=0,
                            m_pv=0, bq=128, bk=128, causal=True):
    """(dq, dk, dv) from the forward's saved o and lse, as the kernel entry
    takes them: D from o, then B5's and B6's arithmetic."""
    S = q.shape[1]
    bq_, bk_ = _flash_blocks(S, bq, bk)
    dq, dk, dv, _ = _flash_bwd_blocks(
        q, k, v, do, lse, flash_delta(o, do), m_qk=m_qk or m_bits,
        m_pv=m_pv or m_bits, bq=bq_, bk=bk_, causal=causal, want_dq=True,
        want_dkv=True, with_bound=False)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def hbfp_flash_attn_vjp_ref(q, k, v, do, *, m_bits=8, m_qk=0, m_pv=0,
                            bq=128, bk=128, causal=True):
    """The reference's oracle composition: the forward with lse, then the
    backward from its o and lse. Returns (dq, dk, dv)."""
    kw = dict(m_bits=m_bits, m_qk=m_qk, m_pv=m_pv, bq=bq, bk=bk,
              causal=causal)
    o, lse = hbfp_flash_attn_ref(q, k, v, with_lse=True, **kw)
    return hbfp_flash_attn_bwd_ref(q, k, v, o, lse, do, **kw)
