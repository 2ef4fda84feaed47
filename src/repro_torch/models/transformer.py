"""Dense transformer stack for serving (port of the dense path of
`repro.models.transformer`).

Entry points:
  init_params(seed, arch, device=None)             -> params dict
  from_jax_params(tree_of_numpy, device, dtype)    -> params dict
  prefill(params, batch, arch, ctx)                -> (logits_last, cache)
  decode_step(params, batch, cache, arch, ctx)     -> (logits, cache)

Parameters keep the reference's nested-dict layout: a "layers" dict of
tensors stacked on a leading L axis, "embed_table", "head_w" and
"final_norm_scale", so parameter names are byte-identical. The layer scan
is a Python loop over layers. Caches are stacked per-layer NamedTuples
(leading L) that decode updates in place. MoE, SSM and xLSTM layers come
with ROADMAP A12.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import check_on, dtype_of, resolve_device
from repro_torch.models.attention import (KVCache, PagedKVCache,
                                          attention_layer)
from repro_torch.models.layers import (Ctx, ctx_matmul, gelu_ffn, rms_norm,
                                       softcap, swiglu_ffn)

BIG_WINDOW = 1 << 30


def _require_dense(arch: ArchConfig) -> None:
    if arch.xlstm or arch.ssm or arch.n_experts or arch.mrope \
            or arch.input_kind != "tokens" or arch.n_codebooks > 1:
        raise NotImplementedError(
            f"{arch.name}: only the dense token-input family is ported; "
            f"the others come with ROADMAP A12")


def _layer_shapes(arch: ArchConfig):
    """(name, per-layer shape, init scale) of every dense layer weight, in
    the reference's order."""
    D, F, H, Hkv, hd = (arch.d_model, arch.d_ff, arch.n_heads,
                        arch.n_kv_heads, arch.hd)
    return (("attn_wq", (D, H * hd), D ** -0.5),
            ("attn_wk", (D, Hkv * hd), D ** -0.5),
            ("attn_wv", (D, Hkv * hd), D ** -0.5),
            ("attn_wo", (H * hd, D), (H * hd) ** -0.5),
            ("ffn_wg", (D, F), D ** -0.5),
            ("ffn_wi", (D, F), D ** -0.5),
            ("ffn_wo", (F, D), F ** -0.5))


def init_params(seed: int, arch: ArchConfig, device=None):
    """Random weights with the reference's shapes and scales, drawn from a
    seeded torch.Generator on `device` (the CUDA device by default). The
    draws differ from the reference's jax ones; tests that compare the two
    packages load the reference's weights with `from_jax_params`."""
    _require_dense(arch)
    dev = resolve_device(device)
    dtype = dtype_of(arch.dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, D, V = arch.n_layers, arch.d_model, arch.vocab_size

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    ones = 0.0 if arch.zero_centered_norm else 1.0
    layers: Dict[str, Any] = {
        "ln1_norm_scale": torch.full((L, D), ones, device=dev),
        "ln2_norm_scale": torch.full((L, D), ones, device=dev),
    }
    if arch.post_norms:
        layers["post1_norm_scale"] = torch.full((L, D), ones, device=dev)
        layers["post2_norm_scale"] = torch.full((L, D), ones, device=dev)
    for name, shape, scale in _layer_shapes(arch):
        t = torch.empty((L, *shape), dtype=dtype, device=dev)
        for i in range(L):
            t[i] = normal(shape, scale)
        layers[name] = t
    return {"layers": layers,
            "final_norm_scale": torch.full((D,), ones, device=dev),
            "embed_table": normal((V, D), 0.02),
            "head_w": normal((D, V), D ** -0.5)}


def _np_to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":       # ml_dtypes arrays from jax
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_params(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Map the reference's `init_params` tree, handed over as numpy arrays,
    onto the port's params dict with identical names. `dtype` casts the
    floating weights (ndim >= 2); None keeps every array's dtype."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = _np_to_torch(np.asarray(x))
        if dtype is not None and t.is_floating_point() and t.ndim >= 2:
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def _layer_windows(arch: ArchConfig, n_layers: int):
    """Per-layer attention window; BIG_WINDOW = full causal."""
    if arch.attn_pattern == "local_global":
        return [arch.window if i % 2 == 0 else BIG_WINDOW
                for i in range(n_layers)]
    if arch.attn_pattern == "sliding":
        return [arch.window] * n_layers
    return [BIG_WINDOW] * n_layers


def _attn_ffn_block(x, lp, ctx, arch: ArchConfig, positions, window,
                    cache, want_cache: bool):
    """Pre-norm block (gemma2-style post-norms when set). Returns
    (x, new_cache)."""
    h = rms_norm(x, lp["ln1_norm_scale"], arch.norm_eps,
                 arch.zero_centered_norm)
    a, new_kv = attention_layer(
        h, lp, ctx, n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads,
        head_dim=arch.hd, positions=positions, rope_theta=arch.rope_theta,
        window=window, attn_cap=arch.attn_softcap, q_chunk=arch.q_chunk,
        cache=None if cache is None else cache["kv"],
        return_cache=want_cache, bfp_cache=arch.bfp_kv_cache)
    new_cache = {"kv": new_kv} if (want_cache or cache is not None) else None
    if arch.post_norms:
        a = rms_norm(a, lp["post1_norm_scale"], arch.norm_eps,
                     arch.zero_centered_norm)
    x = x + arch.residual_scale * a
    h = rms_norm(x, lp["ln2_norm_scale"], arch.norm_eps,
                 arch.zero_centered_norm)
    f = gelu_ffn(h, lp, ctx) if arch.ffn_act == "geglu" \
        else swiglu_ffn(h, lp, ctx)
    if arch.post_norms:
        f = rms_norm(f, lp["post2_norm_scale"], arch.norm_eps,
                     arch.zero_centered_norm)
    return x + arch.residual_scale * f, new_cache


def _embed_in(params, batch, arch: ArchConfig, device):
    tok = torch.as_tensor(batch["tokens"], device=device).long()
    x = params["embed_table"][tok] * arch.emb_scale
    B, S = x.shape[:2]
    if "positions" in batch:
        positions = torch.as_tensor(batch["positions"], device=device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device)[None].expand(B, S)
    return x, positions.to(torch.int32)


def _layer_cache(cache, i: int):
    kv = cache["kv"]
    return {"kv": type(kv)(*(None if t is None else t[i] for t in kv))}


def _run_stack(params, x, positions, arch: ArchConfig, ctx,
               cache=None, want_cache: bool = False):
    """The layer loop. Decode updates `cache` in place and returns it; a
    prefill with want_cache stacks the per-layer prompt caches."""
    L = arch.n_layers
    windows = _layer_windows(arch, L)
    layers = params["layers"]
    built = []
    for i in range(L):
        lp = {k: v[i] for k, v in layers.items()}
        x, nc = _attn_ffn_block(x, lp, ctx, arch, positions, windows[i],
                                None if cache is None
                                else _layer_cache(cache, i), want_cache)
        if cache is None and want_cache:
            built.append(nc["kv"])
    if cache is not None:
        return x, cache
    if not want_cache:
        return x, None
    kv = type(built[0])(*(None if built[0][j] is None
                          else torch.stack([c[j] for c in built])
                          for j in range(len(built[0]))))
    return x, {"kv": kv}


def _head_logits(params, x, arch: ArchConfig, ctx):
    """LM head on [..., D] hidden states -> f32 logits [..., V]."""
    hcfg = ctx.cfg if (ctx.cfg and ctx.cfg.quantize_lm_head) else None
    logits = ctx_matmul(x, params["head_w"], ctx, "head", cfg=hcfg)
    logits = logits / arch.logit_divisor
    return softcap(logits.to(torch.float32), arch.final_softcap)


def _logits(params, x, arch: ArchConfig, ctx):
    x = rms_norm(x, params["final_norm_scale"], arch.norm_eps,
                 arch.zero_centered_norm)
    return _head_logits(params, x, arch, ctx)


def _entry_device(params, ctx, device):
    dev = resolve_device(device if device is not None else ctx.device)
    check_on(params["head_w"], dev, "params")
    return dev


def prefill(params, batch, arch: ArchConfig, ctx: Ctx, device=None):
    """Forward over the prompt; returns (last-token logits [B,1,V], cache).
    Runs on `device`, else ctx.device, else the CUDA device."""
    _require_dense(arch)
    dev = _entry_device(params, ctx, device)
    x, positions = _embed_in(params, batch, arch, dev)
    x, cache = _run_stack(params, x, positions, arch, ctx, want_cache=True)
    return _logits(params, x[:, -1:], arch, ctx), cache


def decode_step(params, batch, cache, arch: ArchConfig, ctx: Ctx,
                device=None):
    """One multi-token step over the cache (updated in place). batch:
    tokens [B,S] + positions [B,S]."""
    _require_dense(arch)
    dev = _entry_device(params, ctx, device)
    x, positions = _embed_in(params, batch, arch, dev)
    x, cache = _run_stack(params, x, positions, arch, ctx, cache=cache)
    return _logits(params, x, arch, ctx), cache


def lane_capacity(arch: ArchConfig, ctx_len: int) -> int:
    """Per-lane KV slot count: sliding-window archs ring over
    min(window, ctx_len); everything else keeps ctx_len."""
    if arch.attn_pattern == "sliding" and arch.window is not None:
        return min(arch.window, ctx_len)
    return ctx_len


def make_cache(params, arch: ArchConfig, batch_size: int, ctx_len: int):
    """An empty stacked slab cache on the params' device."""
    _require_dense(arch)
    dev = params["head_w"].device
    L, B, C = arch.n_layers, batch_size, lane_capacity(arch, ctx_len)
    shape = (L, B, arch.n_kv_heads, C, arch.hd)
    pos = torch.full((L, B, C), -1, dtype=torch.int32, device=dev)
    if arch.bfp_kv_cache:
        i8 = dict(dtype=torch.int8, device=dev)
        kv = KVCache(torch.zeros(shape, **i8), torch.zeros(shape, **i8), pos,
                     torch.zeros(shape[:-1], **i8),
                     torch.zeros(shape[:-1], **i8))
    else:
        dt = dict(dtype=dtype_of(arch.dtype), device=dev)
        kv = KVCache(torch.zeros(shape, **dt), torch.zeros(shape, **dt), pos)
    return {"kv": kv}


def make_paged_cache(params, arch: ArchConfig, batch_size: int,
                     ctx_len: int, n_pages: int, page_size: int):
    """An empty page-pooled cache (DESIGN.md §14): one [L,P,Hkv,ps,hd] pool
    and a [L,B,NP] page table of -1."""
    _require_dense(arch)
    C = lane_capacity(arch, ctx_len)
    if C % page_size:
        raise ValueError(f"page_size {page_size} must divide the lane "
                         f"capacity {C}")
    dev = params["head_w"].device
    L, P, ps = arch.n_layers, n_pages, page_size
    shape = (L, P, arch.n_kv_heads, ps, arch.hd)
    pt = torch.full((L, batch_size, C // ps), -1, dtype=torch.int32,
                    device=dev)
    pos = torch.full((L, P, ps), -1, dtype=torch.int32, device=dev)
    if arch.bfp_kv_cache:
        i8 = dict(dtype=torch.int8, device=dev)
        kv = PagedKVCache(torch.zeros(shape, **i8), torch.zeros(shape, **i8),
                          pos, pt, torch.zeros(shape[:-1], **i8),
                          torch.zeros(shape[:-1], **i8))
    else:
        dt = dict(dtype=dtype_of(arch.dtype), device=dev)
        kv = PagedKVCache(torch.zeros(shape, **dt), torch.zeros(shape, **dt),
                          pos, pt)
    return {"kv": kv}
