"""GQA attention with RoPE, KV caches (slab and paged) and the 8-bit BFP
KV cache (port of the serving path of `repro.models.attention`).

QK^T and PV are activation x activation products and run on the sim path
(`core/hbfp_ops.py`) in BFP when cfg.quantize_attention, forward and
backward (`mha`). The cache-less path keeps the reference's static flash
gate: with a full-causal pattern without softcap, standard positions,
backend "pallas", nearest rounding and a flash block dividing S, attention
runs on the fused flash kernels instead (`flash_mha`: B4 forward, B5/B6
backward, `kernels/hbfp_flash_attn.py`). The serving stages pass
`flash_ok=False`, as the reference's jitted stages see traced positions.

Unlike the reference's functional caches, cache appends here write into
the cache tensors in place (the stacked [L, ...] tensors, through per-layer
views): a decode tick then moves only the new tokens instead of copying
the whole cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.common import max_exponent, pow2
from repro_torch.kernels.hbfp_flash_attn import FlashAttention, FlashSpec
from repro_torch.models.layers import (apply_mrope, apply_rope, ctx_matmul,
                                       softcap)
from repro_torch.precision import role_width_for

NEG_INF = -1e30

_FLASH_BLOCKS = (128, 64, 32, 16, 8)


def _flash_block(S: int):
    """Largest flash block dividing S (None: no flash path)."""
    for b in _FLASH_BLOCKS:
        if S % b == 0:
            return min(b, S)
    return None


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, Hkv, C, hd] (fp, or int8 BFP mantissas)
    v: torch.Tensor          # [B, Hkv, C, hd]
    slot_pos: torch.Tensor   # [B, C] absolute position per slot (-1 empty)
    k_exp: Optional[torch.Tensor] = None   # int8 [B, Hkv, C] (BFP mode)
    v_exp: Optional[torch.Tensor] = None


class PagedKVCache(NamedTuple):
    """Page-pooled KV cache (DESIGN.md §14): a shared pool of fixed-size
    token pages plus a per-lane page table. Lane slot s lives in pool page
    page_table[b, s // ps] at offset s % ps; -1 entries are unallocated
    (reads see empty slots, writes are dropped onto the spare page P-1,
    which the page pool never hands out). Shapes are per layer; the
    stacked cache carries a leading L on every field."""
    k: torch.Tensor           # [P, Hkv, ps, hd], P = pool pages + 1
    v: torch.Tensor
    slot_pos: torch.Tensor    # [P, ps]
    page_table: torch.Tensor  # [B, NP] int32
    k_exp: Optional[torch.Tensor] = None   # int8 [P, Hkv, ps]
    v_exp: Optional[torch.Tensor] = None


def _acfg(ctx):
    cfg = ctx.cfg
    return cfg if (cfg is not None and cfg.quantize_attention) else None


_KV_M = 8  # BFP KV-cache mantissa bits


def quantize_kv_vec(x: torch.Tensor):
    """x: [..., hd] -> (int8 mantissas [..., hd], int8 exponent [...]), one
    exponent per vector."""
    xf = x.to(torch.float32)
    e = max_exponent(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.round(xf / pow2(e - _KV_M + 2)).clamp(-127, 127)
    return q.to(torch.int8), e.squeeze(-1).to(torch.int8)


def dequantize_kv(q: torch.Tensor, e: torch.Tensor, dtype):
    scale = pow2(e.to(torch.int32) - _KV_M + 2)
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _attend_block(qb, k, v, qpos, kpos, ctx, cap, window, heads=None,
                  seq=None, fold=False):
    """One query block against all kv. qb: [B,Hkv,G,C,hd]; k, v:
    [B,Hkv,S,hd]; qpos: [C] or [B,C]; kpos: [B,S]. `heads` (offset,
    global count) places the kv heads in one process's under tensor
    parallelism, for the products' index bases. `seq` (offset, global
    count): k and v are this rank's run of the cache's slots, the rest on
    the other model ranks (`ctx.tp`); the attention is then row-parallel
    (`_seq_softmax`, the PV's f32 partials summed over the ranks and cast
    once). `fold` (a decode over a cache): a kv head's G query heads go
    in as the rows of one product ([B,Hkv,1,G·C,hd]: the same rows in the
    same order, so the same exponent groups and stochastic indices), so
    k and v are not copied G times to match them."""
    acfg = _acfg(ctx)
    hp = () if heads is None else ((1, *heads),)
    sp = lambda d: () if seq is None else ((d, *seq),)
    Bq, Hk, G, C = qb.shape[:4]
    rows = (lambda t: t.reshape(Bq, Hk, 1, G * C, t.shape[-1])) if fold \
        else (lambda t: t)
    qf = rows(qb)
    kt = k.transpose(-1, -2)[:, :, None]               # [B,Hkv,1,hd,S]
    scores = ctx_matmul(qf, kt, ctx, "qk", cfg=acfg, w_kind="act",
                        x_base=ctx.batch_base(qf.shape, hp),
                        w_base=ctx.batch_base(kt.shape, hp + sp(-1)))
    scores = scores.reshape(Bq, Hk, G, C, -1)
    scores = softcap(scores.to(torch.float32), cap)
    if qpos.ndim == 1:
        qp = qpos[None, :, None]
    else:
        qp = qpos[:, :, None]
    kp = kpos[:, None, :]
    mask = (kp <= qp) & (kp >= 0)
    if window is not None:
        mask &= kp > qp - window
    scores = torch.where(mask[:, None, None], scores,
                         scores.new_full((), NEG_INF))
    vb = v[:, :, None]
    out = lambda t: t.reshape(Bq, Hk, G, C, t.shape[-1])
    if seq is None:
        probs = rows(torch.softmax(scores, dim=-1).to(qb.dtype))
        return out(ctx_matmul(probs, vb, ctx, "pv", cfg=acfg, w_kind="act",
                              x_base=ctx.batch_base(probs.shape, hp),
                              w_base=ctx.batch_base(vb.shape, hp)))
    tp = ctx.tp
    probs = rows(_seq_softmax(scores, tp).to(qb.dtype))
    # the probabilities' rows and v's columns are exponent groups along the
    # contraction, which the run cuts: the row call takes their global
    # amax (a group the run leaves whole needs none; one it cuts that is
    # not a whole row or column is refused)
    part = ctx_matmul(probs, vb, ctx, "pv", cfg=acfg, w_kind="act",
                      x_base=ctx.batch_base(probs.shape, hp + sp(-1)),
                      w_base=ctx.batch_base(vb.shape, hp + sp(-2)),
                      call=tp.call("row"))
    return out(tp.sum_(part.to(torch.float32)).to(qb.dtype))


def _seq_softmax(scores, tp):
    """The softmax of score rows whose columns lie on the model ranks:
    the global row max (all-reduce MAX) and the global sum of
    exponentials (all-reduce SUM), in f32; one process's softmax up to
    the order of that sum."""
    mx = tp.max_(scores.amax(dim=-1, keepdim=True))
    e = torch.exp(scores - mx)
    return e / tp.sum_(e.sum(dim=-1, keepdim=True))


def mha(q, k, v, qpos, kpos, ctx, *, cap=None, window=None,
        q_chunk: Optional[int] = None, heads=None, seq=None, fold=False):
    """q: [B,H,Sq,hd]; k, v: [B,Hkv,Skv,hd]. Causal + optional window.
    With q_chunk (dividing Sq) the query blocks run one after another,
    bounding the score tensor to one chunk. `heads`, `seq`, `fold`: see
    `_attend_block`."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    # the scale is rounded to q's dtype first, as jax does with a Python
    # scalar: in bf16 this changes every score by up to 2^-9 relative.
    # Filled on the device: a host scalar's copy would break graph capture
    scale = q.new_full((), 1.0 / (hd ** 0.5))
    qs = (q * scale).reshape(B, Hkv, G, Sq, hd)
    if q_chunk is None or Sq <= q_chunk or Sq % q_chunk != 0:
        out = _attend_block(qs, k, v, qpos, kpos, ctx, cap, window, heads,
                            seq, fold)
        return out.reshape(B, H, Sq, hd)
    outs = []
    for s0 in range(0, Sq, q_chunk):
        qp = qpos[s0:s0 + q_chunk] if qpos.ndim == 1 \
            else qpos[:, s0:s0 + q_chunk]
        outs.append(_attend_block(qs[:, :, :, s0:s0 + q_chunk], k, v, qp,
                                  kpos, ctx, cap, window, heads, seq,
                                  fold))
    return torch.cat(outs, dim=3).reshape(B, H, Sq, hd)


def flash_mha(q, k, v, ctx):
    """Full-causal training attention on the flash kernels (forward B4,
    backward B5/B6 through `FlashAttention`). q: [B,H,S,hd]; k, v:
    [B,Hkv,S,hd]. GQA repeats each kv head for its G query heads
    (`repeat_interleave`, as `jnp.repeat(axis=1)`; autograd sums the group
    gradients). Masks by position index, so it needs the standard layout,
    which attention_layer's gate checks. The attn_qk/attn_pv role widths
    become FlashSpec.m_qk/m_pv (0 when equal to the base width)."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    blk = _flash_block(S)
    m = ctx.cfg.mantissa_bits
    widths = {}
    for role in ("attn_qk", "attn_pv"):
        rw = role_width_for(ctx.roles, role)
        w = rw.apply(ctx.cfg).mantissa_bits if rw is not None else m
        widths[role] = 0 if w == m else w
    spec = FlashSpec(m_bits=m, bq=blk, bk=blk, causal=True,
                     m_qk=widths["attn_qk"], m_pv=widths["attn_pv"])
    flat = lambda t: t.reshape(B * H, S, hd).contiguous()
    out = FlashAttention.apply(spec, flat(q), flat(k), flat(v))
    return out.reshape(B, H, S, hd)


def _slab_append(cache: KVCache, k, v, tok_pos, bfp_cache: bool, dtype):
    """Write S tokens into their ring slots pos % C of the [B,Hkv,C,hd]
    slab (in place) and return (cache, k_dense, v_dense, kpos)."""
    B = k.shape[0]
    C = cache.k.shape[2]
    slot = tok_pos % C                                   # [B, S]
    bidx = torch.arange(B, device=k.device)[:, None]
    kt = k.transpose(1, 2)                               # [B, S, Hkv, hd]
    vt = v.transpose(1, 2)
    cache.slot_pos[bidx, slot] = tok_pos.to(cache.slot_pos.dtype)
    if bfp_cache:
        kq, ke = quantize_kv_vec(kt)
        vq, ve = quantize_kv_vec(vt)
        cache.k[bidx, :, slot] = kq
        cache.v[bidx, :, slot] = vq
        cache.k_exp[bidx, :, slot] = ke
        cache.v_exp[bidx, :, slot] = ve
        kd = dequantize_kv(cache.k, cache.k_exp, dtype)
        vd = dequantize_kv(cache.v, cache.v_exp, dtype)
    else:
        cache.k[bidx, :, slot] = kt.to(cache.k.dtype)
        cache.v[bidx, :, slot] = vt.to(cache.v.dtype)
        kd, vd = cache.k, cache.v
    return cache, kd, vd, cache.slot_pos


def _slab_append_run(cache: KVCache, k, v, tok_pos, bfp_cache: bool, dtype,
                     rank: int, size: int):
    """The sequence-sharded slab: this rank holds the ring slots [rank·c,
    (rank+1)·c) of the C = size·c slots of k and v ([B,Hkv,c,hd], and the
    8-bit cache's exponents [B,Hkv,c]) and the whole [B,C] slot_pos,
    which every rank writes alike. Of the S incoming tokens each rank
    writes into k and v only those whose slot pos % C falls in its run,
    one token index at a time (a row's tokens take distinct slots, and a
    token outside the run writes its clamped slot's own value back: no
    data-dependent shape, no host sync). Returns (cache, k_run, v_run,
    the run's slot positions)."""
    B, S = tok_pos.shape
    c = cache.k.shape[2]
    C = c * size
    slot = tok_pos % C                                   # [B, S]
    bidx = torch.arange(B, device=k.device)
    cache.slot_pos[bidx[:, None], slot] = tok_pos.to(cache.slot_pos.dtype)
    local = slot - rank * c
    own = (local >= 0) & (local < c)
    local = local.clamp(0, c - 1)
    kt = k.transpose(1, 2)                               # [B, S, Hkv, hd]
    vt = v.transpose(1, 2)
    if bfp_cache:
        kt, ke = quantize_kv_vec(kt)
        vt, ve = quantize_kv_vec(vt)
        parts = ((cache.k, kt), (cache.v, vt), (cache.k_exp, ke),
                 (cache.v_exp, ve))
    else:
        parts = ((cache.k, kt), (cache.v, vt))
    for s in range(S):
        at, mine = local[:, s], own[:, s]
        for dst, src in parts:
            keep = mine.reshape(B, *([1] * (src.ndim - 2)))
            dst[bidx, :, at] = torch.where(keep, src[:, s].to(dst.dtype),
                                           dst[bidx, :, at])
    if bfp_cache:
        kd = dequantize_kv(cache.k, cache.k_exp, dtype)
        vd = dequantize_kv(cache.v, cache.v_exp, dtype)
    else:
        kd, vd = cache.k, cache.v
    return cache, kd, vd, cache.slot_pos[:, rank * c:(rank + 1) * c]


def _paged_append(cache: PagedKVCache, k, v, tok_pos, bfp_cache: bool,
                  dtype):
    """Paged write (in place) + gather (DESIGN.md §14): writes route
    through the page table, and a write to an unallocated entry lands on
    the pool's spare last page, which no page table names and no gather
    reads (the reference's `mode="drop"`, with shapes fixed so a CUDA
    graph can capture it). The read gathers this lane's pages into the
    dense [B,Hkv,C,hd] view, with unallocated pages reading as zeros and
    slot_pos -1, like untouched slab slots."""
    B = k.shape[0]
    P, Hkv, ps, hd = cache.k.shape
    NP = cache.page_table.shape[1]
    C = NP * ps
    slot = tok_pos % C
    pid = torch.gather(cache.page_table.long(), 1, slot // ps)  # [B, S]
    pid = torch.where(pid < 0, P - 1, pid)               # the spare page
    off = slot % ps
    kt = k.transpose(1, 2)                               # [B, S, Hkv, hd]
    vt = v.transpose(1, 2)
    if bfp_cache:
        kt, ke = quantize_kv_vec(kt)
        vt, ve = quantize_kv_vec(vt)
        cache.k_exp[pid, :, off] = ke
        cache.v_exp[pid, :, off] = ve
    cache.k[pid, :, off] = kt.to(cache.k.dtype)
    cache.v[pid, :, off] = vt.to(cache.v.dtype)
    cache.slot_pos[pid, off] = tok_pos.to(cache.slot_pos.dtype)

    pt = cache.page_table.long()
    have = pt >= 0                                       # [B, NP]
    safe = pt.clamp(min=0)

    def gather(pool, fill):
        g = pool[safe]                                   # [B, NP, ...]
        m = have.reshape(B, NP, *([1] * (g.ndim - 2)))
        return torch.where(m, g, torch.full((), fill, dtype=g.dtype,
                                            device=g.device))

    to_dense = lambda g: g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, C, hd)
    npos = gather(cache.slot_pos, -1).reshape(B, C)
    if bfp_cache:
        keg = gather(cache.k_exp, 0).permute(0, 2, 1, 3).reshape(B, Hkv, C)
        veg = gather(cache.v_exp, 0).permute(0, 2, 1, 3).reshape(B, Hkv, C)
        kd = dequantize_kv(to_dense(gather(cache.k, 0)), keg, dtype)
        vd = dequantize_kv(to_dense(gather(cache.v, 0)), veg, dtype)
    else:
        kd = to_dense(gather(cache.k, 0))
        vd = to_dense(gather(cache.v, 0))
    return cache, kd, vd, npos


def attention_layer(x, p, ctx, *, n_heads, n_kv_heads, head_dim,
                    positions, rope_theta=10000.0, mrope: bool = False,
                    window=None, attn_cap=None, q_chunk=512, cache=None,
                    return_cache: bool = False, bfp_cache: bool = False,
                    flash_ok: bool = False):
    """x: [B,S,D]; positions: [B,S], or [3,B,S] under M-RoPE, whose
    temporal component is the token's position for the mask and the
    cache. Without a cache (training, prefill) the block attends causally
    within x; with one (decode, chunked prefill) the S incoming tokens
    are appended to their ring slots first and the block attends over the
    cache. flash_ok: the arch's pattern is full-causal without softcap
    and the positions are standard, so the reference would take its flash
    kernel here. Under tensor parallelism with the attention projections
    sharded (`ctx.tp`, `tp_dim` -1 on wq) the rank works on its H/m query
    and Hkv/m kv heads, each query head's kv head on the same rank, and
    wo is row-parallel.

    A decode cache split over "model" where the attention is replicated
    (`ctx.kv`, `sharding.partitioning.cache_layout`): with "heads" the
    rank writes and attends its kv heads (and their query heads) and the
    ranks' outputs are gathered by head; with "seq" the slab holds the
    rank's run of the ring's slots and the attention over it is
    row-parallel (`_attend_block`). The paged cache is not split."""
    B, S, D = x.shape
    heads = None
    tp = ctx.tp
    if tp is not None and getattr(p["attn_wq"], "tp_dim", None) == -1:
        heads = (tp.rank * (n_kv_heads // tp.size), n_kv_heads)
        n_heads //= tp.size
        n_kv_heads //= tp.size
    kv = None if cache is None or tp is None else ctx.kv
    if kv is not None and (heads is not None or isinstance(
            cache, PagedKVCache)):
        if kv == "seq" or isinstance(cache, PagedKVCache):
            raise ValueError(f"a {kv}-split cache needs a replicated "
                             f"attention and a slab cache")
        kv = None          # the attention's own heads are the cache's
    q = ctx_matmul(x, p["attn_wq"], ctx, "wq", out="shard")
    k = ctx_matmul(x, p["attn_wk"], ctx, "wk", out="shard")
    v = ctx_matmul(x, p["attn_wv"], ctx, "wv", out="shard")
    q = q.reshape(B, S, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    rot = apply_mrope if mrope else apply_rope
    q = rot(q, positions, rope_theta)
    k = rot(k, positions, rope_theta)
    tok_pos = positions[0] if mrope else positions

    if cache is None:
        # the reference's static flash gate (repro/models/attention.py)
        use_flash = (flash_ok and ctx.backend == "pallas"
                     and ctx.cfg is not None and ctx.cfg.quantize_attention
                     and ctx.cfg.rounding == "nearest"
                     and _flash_block(S) is not None)
        if use_flash:
            out = flash_mha(q, k, v, ctx)
        else:
            out = mha(q, k, v, tok_pos, tok_pos, ctx, cap=attn_cap,
                      window=window, q_chunk=q_chunk, heads=heads)
        new_cache = None
        if return_cache:
            if bfp_cache:
                kq, ke = quantize_kv_vec(k)
                vq, ve = quantize_kv_vec(v)
                new_cache = KVCache(kq, vq, tok_pos, ke, ve)
            else:
                new_cache = KVCache(k=k, v=v, slot_pos=tok_pos)
    elif kv == "seq":
        new_cache, kd, vd, npos = _slab_append_run(
            cache, k, v, tok_pos, bfp_cache, x.dtype, tp.rank, tp.size)
        c = kd.shape[2]
        out = mha(q, kd, vd, tok_pos, npos, ctx, cap=attn_cap, window=window,
                  q_chunk=None, seq=(tp.rank * c, c * tp.size), fold=True)
    else:
        if kv == "heads":
            # this rank's kv heads and their query heads, gathered after
            hk = n_kv_heads // tp.size
            hq = n_heads // tp.size
            heads = (tp.rank * hk, n_kv_heads)
            q = q[:, tp.rank * hq:(tp.rank + 1) * hq]
            k = k[:, tp.rank * hk:(tp.rank + 1) * hk]
            v = v[:, tp.rank * hk:(tp.rank + 1) * hk]
        if isinstance(cache, PagedKVCache):
            new_cache, kd, vd, npos = _paged_append(cache, k, v, tok_pos,
                                                    bfp_cache, x.dtype)
        else:
            new_cache, kd, vd, npos = _slab_append(cache, k, v, tok_pos,
                                                   bfp_cache, x.dtype)
        out = mha(q, kd, vd, tok_pos, npos, ctx, cap=attn_cap, window=window,
                  q_chunk=None, heads=heads, fold=True)
        if kv == "heads":
            out = tp.gather(out, 1)

    out = out.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    out = ctx_matmul(out, p["attn_wo"], ctx, "wo")
    return out, new_cache
