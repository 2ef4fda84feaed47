"""GQA attention with RoPE, KV caches (slab and paged) and the 8-bit BFP
KV cache (port of the serving path of `repro.models.attention`).

QK^T and PV are activation x activation products and run on the sim path
(`core/hbfp_ops.py`) in BFP when cfg.quantize_attention. The prefill path
without a cache always takes `mha`, as the reference's jitted serving
stages do; the flash gate comes with ROADMAP B4.

Unlike the reference's functional caches, cache appends here write into
the cache tensors in place (the stacked [L, ...] tensors, through per-layer
views): a decode tick then moves only the new tokens instead of copying
the whole cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.common import max_exponent, pow2
from repro_torch.models.layers import apply_rope, ctx_matmul, softcap

NEG_INF = -1e30


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
    (reads see empty slots, writes are dropped). Shapes are per layer; the
    stacked cache carries a leading L on every field."""
    k: torch.Tensor           # [P, Hkv, ps, hd]
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


def _attend_block(qb, k, v, qpos, kpos, ctx, cap, window):
    """One query block against all kv. qb: [B,Hkv,G,C,hd]; k, v:
    [B,Hkv,S,hd]; qpos: [C] or [B,C]; kpos: [B,S]."""
    acfg = _acfg(ctx)
    kt = k.transpose(-1, -2)[:, :, None]               # [B,Hkv,1,hd,S]
    scores = ctx_matmul(qb, kt, ctx, "qk", cfg=acfg, w_kind="act")
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
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(qb.dtype)
    return ctx_matmul(probs, v[:, :, None], ctx, "pv", cfg=acfg,
                      w_kind="act")


def mha(q, k, v, qpos, kpos, ctx, *, cap=None, window=None,
        q_chunk: Optional[int] = None):
    """q: [B,H,Sq,hd]; k, v: [B,Hkv,Skv,hd]. Causal + optional window.
    With q_chunk (dividing Sq) the query blocks run one after another,
    bounding the score tensor to one chunk."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    # the scale is rounded to q's dtype first, as jax does with a Python
    # scalar: in bf16 this changes every score by up to 2^-9 relative
    scale = torch.tensor(1.0 / (hd ** 0.5), dtype=q.dtype, device=q.device)
    qs = (q * scale).reshape(B, Hkv, G, Sq, hd)
    if q_chunk is None or Sq <= q_chunk or Sq % q_chunk != 0:
        out = _attend_block(qs, k, v, qpos, kpos, ctx, cap, window)
        return out.reshape(B, H, Sq, hd)
    outs = []
    for s0 in range(0, Sq, q_chunk):
        qp = qpos[s0:s0 + q_chunk] if qpos.ndim == 1 \
            else qpos[:, s0:s0 + q_chunk]
        outs.append(_attend_block(qs[:, :, :, s0:s0 + q_chunk], k, v, qp,
                                  kpos, ctx, cap, window))
    return torch.cat(outs, dim=3).reshape(B, H, Sq, hd)


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


def _paged_append(cache: PagedKVCache, k, v, tok_pos, bfp_cache: bool,
                  dtype):
    """Paged write (in place) + gather (DESIGN.md §14): writes route
    through the page table and drop on unallocated entries; the read
    gathers this lane's pages into the dense [B,Hkv,C,hd] view, with
    unallocated pages reading as zeros and slot_pos -1, like untouched slab
    slots."""
    B = k.shape[0]
    P, Hkv, ps, hd = cache.k.shape
    NP = cache.page_table.shape[1]
    C = NP * ps
    slot = tok_pos % C
    pid = torch.gather(cache.page_table.long(), 1, slot // ps)  # [B, S]
    off = slot % ps
    ok = pid >= 0
    pid_v, off_v = pid[ok], off[ok]
    kt = k.transpose(1, 2)[ok]                           # [n, Hkv, hd]
    vt = v.transpose(1, 2)[ok]
    if bfp_cache:
        kt, ke = quantize_kv_vec(kt)
        vt, ve = quantize_kv_vec(vt)
        cache.k_exp[pid_v, :, off_v] = ke
        cache.v_exp[pid_v, :, off_v] = ve
    cache.k[pid_v, :, off_v] = kt.to(cache.k.dtype)
    cache.v[pid_v, :, off_v] = vt.to(cache.v.dtype)
    cache.slot_pos[pid_v, off_v] = tok_pos[ok].to(cache.slot_pos.dtype)

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
                    positions, rope_theta=10000.0, window=None,
                    attn_cap=None, q_chunk=512, cache=None,
                    return_cache: bool = False, bfp_cache: bool = False):
    """x: [B,S,D]; positions: [B,S]. Without a cache (prefill) the block
    attends causally within x; with one (decode, chunked prefill) the S
    incoming tokens are appended to their ring slots first and the block
    attends over the cache."""
    B, S, D = x.shape
    q = ctx_matmul(x, p["attn_wq"], ctx, "wq")
    k = ctx_matmul(x, p["attn_wk"], ctx, "wk")
    v = ctx_matmul(x, p["attn_wv"], ctx, "wv")
    q = q.reshape(B, S, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    tok_pos = positions

    if cache is None:
        out = mha(q, k, v, tok_pos, tok_pos, ctx, cap=attn_cap,
                  window=window, q_chunk=q_chunk)
        new_cache = None
        if return_cache:
            if bfp_cache:
                kq, ke = quantize_kv_vec(k)
                vq, ve = quantize_kv_vec(v)
                new_cache = KVCache(kq, vq, tok_pos, ke, ve)
            else:
                new_cache = KVCache(k=k, v=v, slot_pos=tok_pos)
    else:
        if isinstance(cache, PagedKVCache):
            new_cache, kd, vd, npos = _paged_append(cache, k, v, tok_pos,
                                                    bfp_cache, x.dtype)
        else:
            new_cache, kd, vd, npos = _slab_append(cache, k, v, tok_pos,
                                                   bfp_cache, x.dtype)
        out = mha(q, kd, vd, tok_pos, npos, ctx, cap=attn_cap, window=window,
                  q_chunk=None)

    out = out.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    out = ctx_matmul(out, p["attn_wo"], ctx, "wo")
    return out, new_cache
