"""Transformer-family stack (port of `repro.models.transformer`): the
dense family, hymba's hybrid layers (attention and a mamba branch in
parallel, `models/ssm.py`), xLSTM stacks (`models/xlstm.py`), the MoE
family (`models/moe.py`: llama4-scout's shared expert, arctic's dense
residual), qwen2-vl (M-RoPE, embeddings input) and musicgen (embeddings
input, one head per codebook).

Entry points:
  init_params(seed, arch, device=None)             -> params dict
  from_jax_params(tree_of_numpy, device, dtype)    -> params dict
  forward(params, batch, arch, ctx)                -> (logits, aux)
  loss_fn(params, batch, arch, ctx)                -> (loss, metrics)
  prefill(params, batch, arch, ctx)                -> (logits_last, cache)
  decode_step(params, batch, cache, arch, ctx)     -> (logits, cache)

`batch` keys: "tokens" [B,S] (or [B,S,K] codebook tokens, whose
embeddings are summed) or "embeds" [B,S,D] for an arch with
input_kind "embeddings"; "positions" [B,S], or [3,B,S] under M-RoPE
(synthesized as arange when absent); "labels" [B,S], or [B,S,K] with K
codebooks.

Parameters keep the reference's nested-dict layout: a "layers" dict of
tensors stacked on a leading L axis, "embed_table" (token input only),
"head_w" ([D,V], or [K,D,V] with K codebooks) and "final_norm_scale",
so parameter names are byte-identical. "layers" may
also be a list of per-layer dicts (the train step's narrow copy, so each
layer's weights are autograd leaves of their own). The layer scan is a
Python loop over layers; with `arch.remat` each layer, and each chunk of
the chunked cross-entropy, is recomputed in the backward
(`torch.utils.checkpoint`), as the reference's `jax.checkpoint`s do.
Caches are dicts of stacked per-layer entries (leading L): "kv" a
`KVCache` or `PagedKVCache`, and the recurrent states as tuples of
tensors, "ssm" (h,) for hymba, "mlstm" (C, n, m) and "slstm" (h, c, n, m)
for xLSTM. Decode and the chunked prefill write every entry in place, so
the tensors keep their addresses (a captured CUDA graph replays them).
An xLSTM layer runs only its active branch (the reference runs both and
selects one: the same output); the other branch's parameters are unused
and the train step gives them zero gradients. A MoE layer's aux
load-balance loss is carried out of the layer (out of its checkpoint
too) and summed over the layers.

Kernel launches of one training step under "…; backend=pallas" with
remat, C cross-entropy chunks and K heads (K = 1 but for musicgen's
codebooks; each head is its own [D,V] product), P projections a layer
summed over the layers (7 dense, 9 hybrid, 4 mLSTM and 2 sLSTM; 7 MoE:
four attention and the three of the shared expert or dense residual, as
the expert GEMMs' weights are 3-D and take the sim path): B1 2·(P + K·C)
(forward and recompute), or 2P + K when the tokens fit one chunk (the
head is then not recomputed); B2 and B3 P + K·C each; where attention
takes flash (yi-9b, llama4-scout, arctic, qwen2-vl with text positions,
musicgen), B4 2L (its Function's forward runs again in each layer's
recompute), B5 and B6 L.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bfp import act_tile_shape
from repro_torch.device import check_on, dtype_of, resolve_device
from repro_torch.kernels.common import IndexBase
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (KVCache, PagedKVCache,
                                          attention_layer)
from repro_torch.models.layers import (Ctx, ctx_matmul, gelu_ffn, rms_norm,
                                       softcap, swiglu_ffn)
from repro_torch.numerics.stats import tensor_stats

BIG_WINDOW = 1 << 30
# the recurrent-state entries of a cache (tuples of stacked tensors)
STATE_KEYS = ("ssm", "mlstm", "slstm")


def _layer_leaves(arch: ArchConfig):
    """(name, per-layer shape, init) of every layer parameter, in the
    reference's order (`_init_layer`): a float init draws a normal at
    that scale in the arch dtype, ("f32", scale) one in f32 (the MoE
    router); the string inits are the reference's f32 constants
    ("norm": ones, or zeros for zero-centered norms)."""
    D, F, H, Hkv, hd = (arch.d_model, arch.d_ff, arch.n_heads,
                        arch.n_kv_heads, arch.hd)
    if arch.xlstm:
        return xlstm_mod.xlstm_shapes(D, H)
    out = [("ln1_norm_scale", (D,), "norm"), ("ln2_norm_scale", (D,), "norm")]
    if arch.post_norms:
        out += [("post1_norm_scale", (D,), "norm"),
                ("post2_norm_scale", (D,), "norm")]
    out += [("attn_wq", (D, H * hd), D ** -0.5),
            ("attn_wk", (D, Hkv * hd), D ** -0.5),
            ("attn_wv", (D, Hkv * hd), D ** -0.5),
            ("attn_wo", (H * hd, D), (H * hd) ** -0.5)]
    if arch.ssm:
        out += [("ssm_branch_norm_scale", (D,), "ones"),
                ("attn_branch_norm_scale", (D,), "ones")]
        out += list(ssm_mod.ssm_shapes(D, arch.d_inner, H, arch.ssm_state))
    if arch.n_experts:
        out += list(moe_mod.moe_shapes(
            D, F, arch.n_experts, dense_residual=arch.moe_dense_residual,
            dense_ff=F, shared_expert=arch.shared_expert))
    else:
        out += [("ffn_wg", (D, F), D ** -0.5), ("ffn_wi", (D, F), D ** -0.5),
                ("ffn_wo", (F, D), F ** -0.5)]
    return tuple(out)


def _layer_shapes(arch: ArchConfig):
    """(name, per-layer shape, init scale) of every projection matrix of a
    layer that the kernels see (the 2-D weights drawn from a normal in the
    arch dtype), in the reference's order: not the MoE experts (3-D, the
    sim path) nor the f32 router (FP by name)."""
    return tuple(r for r in _layer_leaves(arch)
                 if isinstance(r[2], float) and len(r[1]) == 2)


def _constant(init: str, shape, arch: ArchConfig, dev) -> torch.Tensor:
    """A per-layer f32 constant of the reference's init."""
    if init == "norm":
        return torch.full(shape, 0.0 if arch.zero_centered_norm else 1.0,
                          device=dev)
    if init == "ones":
        return torch.ones(shape, device=dev)
    if init == "zeros":
        return torch.zeros(shape, device=dev)
    if init == "a_log":
        return ssm_mod.ssm_a_log(shape[0], device=dev)
    if init == "gates_bias":
        return xlstm_mod.mlstm_gates_bias(shape[0] // 2, device=dev)
    raise ValueError(f"unknown init {init!r}")


def init_params(seed: int, arch: ArchConfig, device=None):
    """Random weights with the reference's shapes, scales and dtypes
    (projections in the arch dtype; norm scales, SSM constants, gate
    biases and the MoE router in f32), drawn from a seeded
    torch.Generator on `device` (the CUDA device by default): no
    "embed_table" for embeddings input, a [K, D, V] "head_w" with K
    codebooks. The draws
    differ from the reference's jax ones; tests that compare the two
    packages load the reference's weights with `from_jax_params`. On the
    "meta" device the tree has the shapes and dtypes and no values (what
    `sharding.partitioning` and the data-parallel layout read)."""
    dev = resolve_device(device)
    dtype = dtype_of(arch.dtype)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(int(seed))
    L, D, V = arch.n_layers, arch.d_model, arch.vocab_size

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    layers: Dict[str, Any] = {}
    for name, shape, init in _layer_leaves(arch):
        if isinstance(init, str):
            layers[name] = _constant(init, shape, arch, dev)[None].repeat(
                L, *([1] * len(shape)))
            continue
        dt, scale = (torch.float32, init[1]) if isinstance(init, tuple) \
            else (dtype, init)
        t = torch.empty((L, *shape), dtype=dt, device=dev)
        for i in range(L if gen is not None else 0):
            t[i] = normal(shape, scale, dt)
        layers[name] = t
    params = {"layers": layers,
              "final_norm_scale": _constant("norm", (D,), arch, dev)}
    if arch.input_kind == "tokens":
        params["embed_table"] = normal((V, D), 0.02)
    K = arch.n_codebooks
    params["head_w"] = normal((K, D, V) if K > 1 else (D, V), D ** -0.5)
    return params


def _np_to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":       # ml_dtypes arrays from jax
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_params(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Map the reference's `init_params` tree, handed over as numpy arrays,
    onto the port's params dict with identical names. With `dtype=None`
    every leaf keeps the reference's dtype. `dtype` casts every floating
    leaf with ndim >= 2, and that takes in the stacked per-layer f32
    vectors too: [L, D] norm scales, hymba's [L, H] `ssm_a_log`,
    `ssm_dt_bias` and `ssm_d`, xLSTM's [L, 2H] `mlstm_gates_bias`. To
    keep those f32, load the reference's init at the arch's own dtype
    with `dtype=None`."""
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
                    cache, want_cache: bool, std_pos: bool = False):
    """Pre-norm block (gemma2-style post-norms when set; hymba's mamba
    branch in parallel with attention when arch.ssm; the MoE FFN when
    arch.n_experts). Returns (x, new_cache, aux): the cache's "kv", and
    "ssm" for hymba; aux the MoE load-balance loss, None without
    experts. Under sequence parallelism (`ctx.tp.sp`) x holds the local
    tokens: the norms run on them, each mixer on the gathered sequence
    (`seq_in`), its output back on the local tokens (`seq_out`)."""
    tp = ctx.tp
    s_local = x.shape[1]
    seq_in = (lambda t: t) if tp is None else tp.seq_in
    seq_out = (lambda t: t) if tp is None else \
        (lambda t: tp.seq_out(t, s_local))
    h = seq_in(rms_norm(x, lp["ln1_norm_scale"], arch.norm_eps,
                        arch.zero_centered_norm))
    a, new_kv = attention_layer(
        h, lp, ctx, n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads,
        head_dim=arch.hd, positions=positions, rope_theta=arch.rope_theta,
        mrope=arch.mrope, window=window, attn_cap=arch.attn_softcap,
        q_chunk=arch.q_chunk,
        cache=None if cache is None else cache["kv"],
        return_cache=want_cache, bfp_cache=arch.bfp_kv_cache,
        # flash masks by block index, so it also needs the standard
        # positions (std_pos)
        flash_ok=(arch.attn_pattern == "global"
                  and arch.attn_softcap is None and std_pos))
    a = seq_out(a)
    new_cache = {"kv": new_kv} if (want_cache or cache is not None) else None
    if arch.ssm:
        s, new_ssm = ssm_mod.ssm_branch(
            h, lp, ctx, n_heads=arch.n_heads, d_state=arch.ssm_state,
            chunk=arch.ssm_chunk,
            state=None if cache is None else cache["ssm"])
        s = seq_out(s)
        # hymba: the mean of the per-branch normalized outputs
        a = 0.5 * (rms_norm(a, lp["attn_branch_norm_scale"], arch.norm_eps)
                   + rms_norm(s, lp["ssm_branch_norm_scale"], arch.norm_eps))
        if new_cache is not None:
            new_cache["ssm"] = new_ssm
    if arch.post_norms:
        a = rms_norm(a, lp["post1_norm_scale"], arch.norm_eps,
                     arch.zero_centered_norm)
    x = _residual(x, a, arch)
    h = seq_in(rms_norm(x, lp["ln2_norm_scale"], arch.norm_eps,
                        arch.zero_centered_norm))
    aux = None
    if arch.n_experts:
        f, aux = moe_mod.moe_ffn(
            h, lp, ctx, n_experts=arch.n_experts, top_k=arch.top_k,
            capacity_factor=arch.capacity_factor, n_groups=arch.moe_groups,
            dense_residual=arch.moe_dense_residual,
            shared_expert=arch.shared_expert)
    elif arch.ffn_act == "geglu":
        f = gelu_ffn(h, lp, ctx)
    else:
        f = swiglu_ffn(h, lp, ctx)
    f = seq_out(f)
    if arch.post_norms:
        f = rms_norm(f, lp["post2_norm_scale"], arch.norm_eps,
                     arch.zero_centered_norm)
    return _residual(x, f, arch), new_cache, aux


def _is_slstm(arch: ArchConfig, layer: int) -> bool:
    """Every slstm_every-th layer of an xLSTM stack is sLSTM."""
    return bool(arch.xlstm and arch.slstm_every
                and layer % arch.slstm_every == arch.slstm_every - 1)


def _xlstm_block(x, lp, ctx, arch: ArchConfig, is_slstm: bool, cache,
                 want_cache: bool):
    """xLSTM layer: the active branch only (the reference evaluates both
    and selects one with `jnp.where`: the same output). The inactive
    branch's state passes through unchanged, zeros when there was none.
    Returns (x, new_cache). Under sequence parallelism the block runs on
    the gathered sequence and keeps its local tokens."""
    own, other = ("slstm", "mlstm") if is_slstm else ("mlstm", "slstm")
    st = None if cache is None else cache[own]
    tp, s_local = ctx.tp, x.shape[1]
    if tp is not None:
        x = tp.seq_in(x)
    if is_slstm:
        y, new = xlstm_mod.slstm_block(x, lp, ctx, n_heads=arch.n_heads,
                                       state=st)
    else:
        y, new = xlstm_mod.mlstm_block(x, lp, ctx, n_heads=arch.n_heads,
                                       chunk=arch.ssm_chunk, state=st)
    if tp is not None:
        y = tp.seq_out(y, s_local)
    if not (want_cache or cache is not None):
        return y, None
    if cache is not None:
        keep = cache[other]
    elif is_slstm:
        keep = xlstm_mod.mlstm_state_init(x.shape[0], arch.n_heads,
                                          arch.d_model, device=x.device)
    else:
        keep = xlstm_mod.slstm_state_init(x.shape[0], arch.d_model,
                                          device=x.device)
    return y, {own: new, other: keep}


def _block(x, lp, ctx, arch: ArchConfig, layer: int, positions, window,
           cache, want_cache: bool, std_pos: bool):
    """One layer: (x, new_cache, aux), aux None but for a MoE layer."""
    if arch.xlstm:
        return (*_xlstm_block(x, lp, ctx, arch, _is_slstm(arch, layer),
                              cache, want_cache), None)
    return _attn_ffn_block(x, lp, ctx, arch, positions, window, cache,
                           want_cache, std_pos)


def _residual(x, branch, arch: ArchConfig):
    """x + residual_scale·branch, the scale rounded to the branch's dtype
    first as jax rounds a Python scalar (ROADMAP C2, C14: minicpm's
    1.4/√40 is not a bf16 number); a scale of 1 adds the branch as it is.
    Filled on the device: a host scalar's copy would break graph capture."""
    if arch.residual_scale == 1.0:
        return x + branch
    return x + branch.new_full((), arch.residual_scale) * branch


def _lookup(table, tok, tp):
    """The embedding rows of `tok`; from a vocab-sharded table (`tp_dim`
    -2) each rank looks up the rows it holds, zeros elsewhere, and the
    ranks add them (one nonzero term an element: exact). Under sequence
    parallelism the result holds the local tokens: the sum
    reduce-scattered, or a replicated table's rows sliced (its gradient
    whole on every rank)."""
    if tp is None:
        return table[tok]
    if getattr(table, "tp_dim", None) == -2:
        v = table.shape[0]
        local = tok - tp.rank * v
        have = (local >= 0) & (local < v)
        x = table[local.clamp(0, v - 1)] * have[..., None].to(table.dtype)
        return tp.reduce_scatter(x, 1) if tp.sp else tp.reduce(x)
    x = table[tok]
    return tp.split(x, 1) if tp.sp else x


def _embed_in(params, batch, arch: ArchConfig, device, tp=None):
    """(x [B,S,D], positions): the stub frontend's embeddings cast to the
    arch dtype, or the token embeddings (codebook tokens [B,S,K] summed
    over K), times emb_scale. Absent positions are the arange, broadcast
    to [3,B,S] under M-RoPE. No host sync: a graphed decode tick runs
    this. Under tensor parallelism (`tp`, a TPGroup) the lookup is
    vocab-parallel (`_lookup`); under sequence parallelism x holds the
    local tokens [B, S/m, D] and the positions stay whole."""
    if arch.input_kind == "embeddings":
        x = torch.as_tensor(batch["embeds"], device=device).to(
            dtype_of(arch.dtype))
        B, S = x.shape[:2]
        if tp is not None and tp.sp:
            x = tp.split(x, 1)
    else:
        tok = torch.as_tensor(batch["tokens"], device=device).long()
        B, S = tok.shape[:2]
        x = _lookup(params["embed_table"], tok, tp)
        if arch.n_codebooks > 1 and tok.ndim == 3:
            x = x.sum(dim=2)
    x = x * arch.emb_scale
    if "positions" in batch:
        positions = torch.as_tensor(batch["positions"], device=device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device)[None].expand(B, S)
        if arch.mrope:
            positions = positions[None].expand(3, B, S)
    return x, positions.to(torch.int32)


def _like(c, items):
    """`items` in the container type of cache entry c: the KV NamedTuple,
    or a state tuple."""
    items = list(items)
    return type(c)(*items) if hasattr(c, "_fields") else tuple(items)


def _layer_cache(cache, i: int):
    """Layer i's views of a stacked cache: the KV NamedTuple's fields and
    each recurrent state's tensors, sliced on the leading L axis."""
    return {k: _like(c, (None if t is None else t[i] for t in c))
            for k, c in cache.items()}


def _write_state(dst, src) -> None:
    """Copy a layer's new recurrent states into the cache's own tensors,
    so the stacked state keeps its address (graph replay)."""
    for k in STATE_KEYS:
        if k in dst:
            for d, s in zip(dst[k], src[k]):
                if d is not s:
                    d.copy_(s)


def _stack_caches(built):
    """Stack the per-layer prompt caches of a prefill on a leading L."""
    out = {}
    for k, c in built[0].items():
        out[k] = _like(c, (None if c[j] is None
                           else torch.stack([b[k][j] for b in built])
                           for j in range(len(c))))
    return out


def _std_positions(batch) -> bool:
    """True when attention may mask by block index (the reference's flash
    gate): positions are absent from the batch, or a [B, S] (or [3, B, S])
    array equal to the standard contiguous arange. The port's serving
    stages, which stand in for the reference's jitted ones, pass
    std_pos=False explicitly; fake positions (the dry run's, which carry
    no values) are the reference's traced ones: False."""
    if "positions" not in batch:
        return True
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(batch["positions"]):
        return False
    p = torch.as_tensor(batch["positions"])
    if p.ndim not in (2, 3):
        return False
    want = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
    return bool((p == want).all())


def _remat_block(x, lp, ctx, arch, layer, positions, window, std_pos):
    """A checkpointed layer's (x, aux): the aux of a MoE layer leaves the
    checkpoint beside x."""
    x, _, aux = _block(x, lp, ctx, arch, layer, positions, window, None,
                       False, std_pos)
    return x, aux


def _run_stack(params, x, positions, arch: ArchConfig, ctx,
               cache=None, want_cache: bool = False,
               std_pos: bool = False):
    """The layer loop: (x, cache, aux). Decode and the chunked prefill
    update `cache` in place and return it; a prefill with want_cache
    stacks the per-layer prompt caches. Under autograd with arch.remat
    each layer is recomputed in the backward (hymba's chunk scan, xLSTM's
    scans and the MoE routing included). aux is the MoE layers' aux
    losses summed over the layers, an f32 zero without experts."""
    L = arch.n_layers
    windows = _layer_windows(arch, L)
    layers = params["layers"]
    remat = (arch.remat and cache is None and not want_cache
             and torch.is_grad_enabled())
    built = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(L):
        lp = layers[i] if isinstance(layers, (list, tuple)) \
            else {k: v[i] for k, v in layers.items()}
        # the layer's key is a host int, so the recompute of a checkpointed
        # layer folds the same key and draws the same noise
        lctx = ctx.fold(i)
        if remat:
            x, la = checkpoint(_remat_block, x, lp, lctx, arch, i,
                               positions, windows[i], std_pos,
                               use_reentrant=False)
        else:
            lc = None if cache is None else _layer_cache(cache, i)
            x, nc, la = _block(x, lp, lctx, arch, i, positions, windows[i],
                               lc, want_cache, std_pos)
            if lc is not None:
                _write_state(lc, nc)
            elif want_cache:
                built.append(nc)
        if la is not None:
            aux = aux + la
    if cache is not None:
        return x, cache, aux
    if not want_cache:
        return x, None, aux
    return x, _stack_caches(built), aux


_BATCH_ROWS = object()


def _head_logits(params, x, arch: ArchConfig, ctx, x_base=_BATCH_ROWS):
    """LM head on [..., D] hidden states -> f32 logits [..., V], or
    [..., K, V] with K codebooks: one [D,V] product a head, at sites
    "head0".."head{K-1}" (which fold the reference's key: its first four
    bytes, "head", the same for every head). A vocab-sharded head (under
    tensor parallelism) gives this rank's columns of the logits. `x_base`:
    x's part of the one-process operand (default: its batch rows)."""
    hcfg = ctx.cfg if (ctx.cfg and ctx.cfg.quantize_lm_head) else None
    head = params["head_w"]
    kw = {} if x_base is _BATCH_ROWS else {"x_base": x_base}
    if arch.n_codebooks > 1:
        d = getattr(head, "tp_dim", None)
        logits = torch.stack(
            [ctx_matmul(x, head[k], ctx, f"head{k}", cfg=hcfg, out="shard",
                        tp_dim=d, **kw)
             for k in range(arch.n_codebooks)], dim=-2)
    else:
        logits = ctx_matmul(x, head, ctx, "head", cfg=hcfg, out="shard",
                            **kw)
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


def forward(params, batch, arch: ArchConfig, ctx: Ctx, device=None):
    """Logits [B,S,V] ([B,S,K,V] with K codebooks) over the batch of
    tokens or embeds, and the aux loss (the MoE layers' load-balance
    losses summed; zero without experts). Runs on `device`, else
    ctx.device, else the CUDA device. Under tensor parallelism the logits
    are gathered whole."""
    dev = _entry_device(params, ctx, device)
    tp = ctx.tp
    x, positions = _embed_in(params, batch, arch, dev, tp)
    x, _, aux = _run_stack(params, x, positions, arch, ctx,
                           std_pos=_std_positions(batch))
    x = rms_norm(x, params["final_norm_scale"], arch.norm_eps,
                 arch.zero_centered_norm)
    if tp is None:
        return _head_logits(params, x, arch, ctx), aux
    if tp.sp:
        x = tp.gather(x, 1)
    logits = _head_logits(params, x, arch, ctx)
    sharded = getattr(params["head_w"], "tp_dim", None) == -1
    return (tp.gather(logits, -1) if sharded else logits), aux


def _ce(params, xc, lc, arch: ArchConfig, ctx, x_base=None):
    """Summed next-token CE of one token chunk: head, softcap, logsumexp.
    lc: [t], or [t, K] with K codebooks. A vocab-sharded head takes the
    vocab-parallel CE (`TPGroup.vocab_ce`). `x_base`: the chunk's part of
    the one-process chunk (`_ce_pieces`)."""
    logits = _head_logits(params, xc, arch, ctx, x_base)  # [t, (K,) V] f32
    if ctx.tp is not None and getattr(params["head_w"], "tp_dim",
                                      None) == -1:
        return ctx.tp.vocab_ce(logits, lc).sum()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None]).squeeze(-1)
    return (lse - ll).sum()


def _ce_pieces(B: int, S: int, D: int, lc: int, dp):
    """(start, length, x_base) of the CE's head products over the B·S
    local tokens (width D). One process takes `loss_chunk` chunks of its
    tokens when they are more than one whole number of them (each chunk
    its own operand, every chunk drawing from the same key), else all at
    once. A data-parallel rank (`dp`) cuts its tokens at one process's
    chunk bounds and draws each piece at its rows of its chunk."""
    T = B * S
    if dp is None:
        if lc and T > lc and T % lc == 0:
            return [(c0, lc, None) for c0 in range(0, T, lc)]
        return [(0, T, None)]
    Tg, t0 = dp.size * S, dp.offset * S
    n = lc if lc and Tg > lc and Tg % lc == 0 else Tg
    out, t = [], t0
    while t < t0 + T:
        c = t // n * n
        end = min(c + n, t0 + T)
        out.append((t - t0, end - t, IndexBase((n, D), (t - c, 0))))
        t = end
    return out


def loss_fn(params, batch, arch: ArchConfig, ctx: Ctx,
            aux_weight: float = 0.01, device=None):
    """Next-token CE, the LM head and softmax-CE computed in `loss_chunk`
    token chunks (each recomputed in the backward under arch.remat), so
    the f32 [tokens, vocab] logits exist one chunk at a time; with K
    codebooks the labels are [B,S,K] and the CE is the mean over the
    T·K of them. Returns
    (loss, {"nll", "aux", "loss"}), loss = nll + aux_weight·aux (aux the
    MoE layers' summed load-balance loss, zero without experts); with
    `ctx.act_tap` the metrics gain
    "act_stats", the `TensorStats` of quantizing the residual stream at
    the stack's entry ("embed_out") and exit ("final_hidden") at the
    activation format, each one B7 launch (a callable `ctx.act_tap`
    reduces each tap's raw sums over the ranks first). Under tensor
    parallelism (`ctx.tp`) the embedding and the head are vocab-parallel;
    under sequence parallelism the final norm runs on the local tokens,
    which are gathered for the head."""
    dev = _entry_device(params, ctx, device)
    tp = ctx.tp
    x, positions = _embed_in(params, batch, arch, dev, tp)
    act_stats = None
    if ctx.act_tap and ctx.cfg is not None:
        reduce = ctx.act_tap if callable(ctx.act_tap) else None

        def tap(t):
            return tensor_stats(t.detach(), ctx.cfg.mantissa_bits,
                                act_tile_shape(t.ndim, ctx.cfg.act_block),
                                reduce=reduce)

        act_stats = {"embed_out": tap(x)}
    x, _, aux = _run_stack(params, x, positions, arch, ctx,
                           std_pos=_std_positions(batch))
    if act_stats is not None:
        act_stats["final_hidden"] = tap(x)
    x = rms_norm(x, params["final_norm_scale"], arch.norm_eps,
                 arch.zero_centered_norm)
    if tp is not None and tp.sp:
        x = tp.gather(x, 1)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    lt = labels.reshape(T, *labels.shape[2:])
    pieces = _ce_pieces(B, S, D, arch.loss_chunk, ctx.dp)
    if len(pieces) > 1:
        remat = arch.remat and torch.is_grad_enabled()
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        for c0, n, xb in pieces:
            args = (params, xt[c0:c0 + n], lt[c0:c0 + n], arch, ctx, xb)
            tot = tot + (checkpoint(_ce, *args, use_reentrant=False)
                         if remat else _ce(*args))
    else:
        tot = _ce(params, xt, lt, arch, ctx, pieces[0][2])
    nll = tot / labels.numel()
    loss = nll + aux_weight * aux
    metrics = {"nll": nll, "aux": aux, "loss": loss}
    if act_stats is not None:
        metrics["act_stats"] = act_stats
    return loss, metrics


def _served_logits(params, x, arch: ArchConfig, ctx):
    """The final norm and head of served hidden states; a vocab-sharded
    head's columns gathered whole, as `forward` gathers them."""
    logits = _logits(params, x, arch, ctx)
    if ctx.tp is not None and getattr(params["head_w"], "tp_dim",
                                      None) == -1:
        return ctx.tp.gather(logits, -1)
    return logits


def prefill(params, batch, arch: ArchConfig, ctx: Ctx, device=None,
            std_pos: Optional[bool] = None):
    """Forward over the prompt (tokens or embeds, positions [B,S] or
    [3,B,S]); returns (last-token logits [B,1,V], [B,1,K,V] with K
    codebooks, cache). Runs on `device`, else ctx.device, else the CUDA device. std_pos None
    reads the batch's positions as the reference's un-jitted prefill
    does; the serving stages pass False, as the reference's jitted ones
    see traced positions. Under tensor parallelism (`ctx.tp`, the
    parameters a rank's shards) the embedding is vocab-parallel and the
    logits are gathered whole; under sequence parallelism (the
    reference's `seq_parallel` prefill option, `ctx.tp.sp`) the residual
    stream holds the local tokens, gathered before the last token's
    head."""
    dev = _entry_device(params, ctx, device)
    tp = ctx.tp
    x, positions = _embed_in(params, batch, arch, dev, tp)
    if std_pos is None:
        std_pos = _std_positions(batch)
    x, cache, _ = _run_stack(params, x, positions, arch, ctx,
                             want_cache=True, std_pos=std_pos)
    if tp is not None and tp.sp:
        x = tp.gather(x, 1)
    return _served_logits(params, x[:, -1:], arch, ctx), cache


def decode_step(params, batch, cache, arch: ArchConfig, ctx: Ctx,
                device=None):
    """One multi-token step over the cache (updated in place). batch:
    tokens [B,S] or embeds [B,S,D], and positions [B,S] ([3,B,S] under
    M-RoPE). Under tensor parallelism as `prefill`, the cache a rank's
    part (`ctx.kv`); sequence parallelism is a prefill option only."""
    dev = _entry_device(params, ctx, device)
    if ctx.tp is not None and ctx.tp.sp:
        raise ValueError("sequence parallelism is a prefill option: decode "
                         "with a model group whose sp is off")
    x, positions = _embed_in(params, batch, arch, dev, ctx.tp)
    x, cache, _ = _run_stack(params, x, positions, arch, ctx, cache=cache)
    return _served_logits(params, x, arch, ctx), cache


def lane_capacity(arch: ArchConfig, ctx_len: int) -> int:
    """Per-lane KV slot count: sliding-window archs ring over
    min(window, ctx_len); everything else keeps ctx_len."""
    if arch.attn_pattern == "sliding" and arch.window is not None:
        return min(arch.window, ctx_len)
    return ctx_len


def _state_cache(arch: ArchConfig, batch_size: int, dev):
    """The recurrent-state entries of an empty cache, each tensor stacked
    [L, B, ...] in f32: hymba's "ssm", xLSTM's "mlstm" and "slstm"."""
    L, B = arch.n_layers, batch_size
    stack = lambda st: tuple(t[None].repeat(L, *([1] * t.ndim)) for t in st)
    if arch.xlstm:
        return {"mlstm": stack(xlstm_mod.mlstm_state_init(
                    B, arch.n_heads, arch.d_model, device=dev)),
                "slstm": stack(xlstm_mod.slstm_state_init(
                    B, arch.d_model, device=dev))}
    if arch.ssm:
        return {"ssm": stack(ssm_mod.ssm_state_init(
            B, arch.n_heads, arch.d_inner, arch.ssm_state, device=dev))}
    return {}


def make_cache(params, arch: ArchConfig, batch_size: int, ctx_len: int,
               kv_split=None):
    """An empty stacked slab cache on the params' device: "kv" (none for
    xLSTM) and the recurrent states. `kv_split` (mode, m) makes a model
    rank's part of k and v (and the 8-bit cache's exponents): "heads" its
    Hkv/m kv heads, "seq" its C/m ring slots (slot_pos stays whole; see
    `sharding.partitioning.cache_layout`)."""
    dev = params["head_w"].device
    if arch.xlstm:
        return _state_cache(arch, batch_size, dev)
    L, B, C = arch.n_layers, batch_size, lane_capacity(arch, ctx_len)
    Hkv, Ck = arch.n_kv_heads, C
    if kv_split is not None:
        mode, m = kv_split
        Hkv, Ck = (Hkv // m, C) if mode == "heads" else (Hkv, C // m)
    shape = (L, B, Hkv, Ck, arch.hd)
    pos = torch.full((L, B, C), -1, dtype=torch.int32, device=dev)
    if arch.bfp_kv_cache:
        i8 = dict(dtype=torch.int8, device=dev)
        kv = KVCache(torch.zeros(shape, **i8), torch.zeros(shape, **i8), pos,
                     torch.zeros(shape[:-1], **i8),
                     torch.zeros(shape[:-1], **i8))
    else:
        dt = dict(dtype=dtype_of(arch.dtype), device=dev)
        kv = KVCache(torch.zeros(shape, **dt), torch.zeros(shape, **dt), pos)
    return {"kv": kv, **_state_cache(arch, B, dev)}


def make_paged_cache(params, arch: ArchConfig, batch_size: int,
                     ctx_len: int, n_pages: int, page_size: int):
    """An empty page-pooled cache (DESIGN.md §14): one [L,P+1,Hkv,ps,hd]
    pool, of which the last page is the spare that takes the dropped
    writes of unallocated slots, and a [L,B,NP] page table of -1. SSM
    states stay dense per lane (O(1) in sequence length: nothing to
    page); xLSTM archs have no KV cache to page."""
    if arch.xlstm:
        raise ValueError("xlstm archs have no KV cache to page")
    C = lane_capacity(arch, ctx_len)
    if C % page_size:
        raise ValueError(f"page_size {page_size} must divide the lane "
                         f"capacity {C}")
    dev = params["head_w"].device
    L, P, ps = arch.n_layers, n_pages + 1, page_size
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
    return {"kv": kv, **_state_cache(arch, batch_size, dev)}
