"""Mixture-of-Experts with grouped capacity dispatch (GShard/Switch style),
port of `repro.models.moe`.

Expert FFN matmuls run in HBFP (they are the dominant dot products of MoE
archs); the router — a tiny matmul feeding a range-sensitive softmax/top-k —
stays FP32 (excluded by name "router"). Dispatch and combine are one-hot
permutations, not value dot products, and stay FP: each output element
has at most top_k nonzero terms.

Supports top-k routing with normalized gates, a capacity factor, the aux
load-balance loss, a parallel dense-FFN residual (snowflake-arctic) and a
shared expert (llama4-scout).

The expert weights are 3-D ([E, D, F], [E, F, D]), so `ctx_matmul` sends
the expert SwiGLU to the sim path (`core/hbfp_ops.py`, a batched matmul
over weights quantized per call), as the reference sends them past its
Pallas kernels; the shared expert and the dense residual are 2-D and take
the kernels. Every shape is fixed by the token count: no host sync, no
data-dependent indexing, so the layer is captured in the graphed
generate tick as it is. Capacity makes a token's output depend on the
other tokens of its group (the lanes of a decode tick, the tokens of a
prefill chunk), as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import part_base
from repro_torch.models.layers import ctx_matmul, swiglu_ffn


def moe_shapes(d_model: int, d_ff: int, n_experts: int,
               dense_residual: bool = False, dense_ff: Optional[int] = None,
               shared_expert: bool = False):
    """(name, per-layer shape, init) of a MoE layer's parameters in the
    reference's order (`init_moe`): a float scale draws a normal at that
    scale in the arch dtype; ("f32", scale) draws it in f32 (the router)."""
    D, F_, E = d_model, d_ff, n_experts
    out = [("router_w", (D, E), ("f32", D ** -0.5)),
           ("moe_wg", (E, D, F_), D ** -0.5),
           ("moe_wi", (E, D, F_), D ** -0.5),
           ("moe_wo", (E, F_, D), F_ ** -0.5)]
    prefix = "ffn_" if dense_residual else \
        "shared_" if shared_expert else None
    if prefix:
        dff = dense_ff or F_
        out += [(f"{prefix}wg", (D, dff), D ** -0.5),
                (f"{prefix}wi", (D, dff), D ** -0.5),
                (f"{prefix}wo", (dff, D), dff ** -0.5)]
    return tuple(out)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot by comparison: an index outside [0, n) is an all-zero row,
    as `jax.nn.one_hot` gives it (torch's one_hot raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index first
    (`jax.lax.top_k`'s rule; torch.topk promises no order on ties)."""
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def route(x, router_w, n_experts: int, top_k: int, mean=None):
    """x: [G, T, D] grouped tokens -> (gates [G,T,k], idx [G,T,k], aux).
    `mean` (a data-parallel rank's groups: `DataPart.mean`) turns the
    local means of the load-balance loss into the global ones."""
    logits = torch.einsum("gtd,de->gte", x.to(torch.float32),
                          router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss over the first choice: E · Σ_e f_e · p_e
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = _one_hot(idx[..., 0], n_experts, torch.float32).mean(dim=(0, 1))
    if mean is not None:
        me, ce = mean(me), mean(ce)
    aux = n_experts * torch.sum(me * ce)
    return gates, idx, aux


def make_dispatch(gates, idx, n_experts: int, capacity: int, dtype):
    """GShard dispatch/combine tensors, both [G, T, E, Cap]. Slots go
    token-major (token t's k choices before token t+1's); a choice whose
    slot is past the capacity is dropped (an all-zero row)."""
    G, T, k = idx.shape
    onehot = _one_hot(idx, n_experts, torch.int32)               # [G,T,k,E]
    flat = onehot.reshape(G, T * k, n_experts)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, T, k, n_experts)
    slot = (pos * onehot).sum(-1)                                # [G,T,k]
    slot_oh = _one_hot(torch.where(slot < capacity, slot, capacity),
                       capacity, torch.float32)                  # [G,T,k,Cap]
    oh = onehot.to(torch.float32)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh, slot_oh).to(dtype)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", oh, slot_oh,
                           gates.to(torch.float32)).to(dtype)
    return dispatch, combine


def n_groups_for(T_all: int, n_groups: Optional[int],
                 group_tokens: int = 2048) -> int:
    """The group count: the reference's search up for a divisor of T_all,
    with the clamp to T_all put before the search (ROADMAP C16: the
    reference clamps after it, and its search never ends when n_groups >
    T_all). Equal to the reference's wherever that one ends."""
    G = min(n_groups or max(1, T_all // group_tokens), T_all)
    while T_all % G:
        G += 1          # search up: smaller groups, never bigger
    return G


def capacity_for(T: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Slots per expert and group; >= top_k, so a one-token group never
    drops a choice."""
    return max(top_k, int(T * top_k * capacity_factor / n_experts))


def moe_ffn(x, p, ctx, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, n_groups: Optional[int] = None,
            dense_residual: bool = False, shared_expert: bool = False,
            group_tokens: int = 2048):
    """x: [B, S, D] -> ([B, S, D], aux_loss).

    Tokens are routed within groups of ~group_tokens (GShard): the dispatch
    tensor is [G, T, E, Cap] with Cap ∝ T/E. The dispatch and combine
    einsums are exact (one nonzero term per output of the dispatch, at
    most top_k of the combine).

    Expert parallelism (`ctx.tp` with the experts sharded on E, `tp_dim`
    -3): the router, dispatch and combine run on every rank; each rank
    slices its experts' rows of the dispatched tokens and of the combine
    tensor, runs its experts and takes its experts' part of the combine
    in f32, which the ranks add (at most top_k nonzero terms an output,
    the sum one process's f32 accumulation gives) before one cast. Under
    sequence parallelism x is the gathered sequence, and each part of the
    output comes back on the local tokens.

    Under data parallelism (`ctx.dp`) the groups are the global batch's,
    on the data axis as the reference's `shard_fn` puts them: a rank
    routes its whole groups alone (so its capacity is one process's), the
    load-balance loss takes the global means, and the experts' operands
    are their one-process part along the groups (the index bases of the
    stochastic draws, with the experts' block under expert parallelism).
    A rank whose tokens do not fall on whole groups is refused, unless
    its data part asks to gather them (`DataPart.gather_groups`, the
    serving layout's): then every data rank routes the global groups on
    the gathered batch, as one process does, and keeps its rows."""
    B, S, D = x.shape
    T_all = B * S
    dp = ctx.dp
    if dp is None:
        G = n_groups_for(T_all, n_groups, group_tokens)
        g0, G_all = 0, G
    else:
        G_all = n_groups_for(dp.size * S, n_groups, group_tokens)
        per = dp.size * S // G_all
        if T_all % per or (dp.offset * S) % per:
            if not dp.gather_groups:
                raise ValueError(
                    f"a data shard of {T_all} tokens at token "
                    f"{dp.offset * S} cuts the {G_all} MoE groups of {per} "
                    f"tokens")
            whole = dp.transport.all_gather_dim(x.contiguous(), 0)
            out, aux = moe_ffn(
                whole, p, ctx.without_dp(), n_experts=n_experts,
                top_k=top_k, capacity_factor=capacity_factor,
                n_groups=n_groups, dense_residual=dense_residual,
                shared_expert=shared_expert, group_tokens=group_tokens)
            return out[dp.offset:dp.offset + B], aux
        G, g0 = T_all // per, dp.offset * S // per
    T = T_all // G
    xg = x.reshape(G, T, D)

    gates, idx, aux = route(xg, p["router_w"], n_experts, top_k,
                            None if dp is None else dp.mean)
    capacity = capacity_for(T, top_k, capacity_factor, n_experts)
    dispatch, combine = make_dispatch(gates, idx, n_experts, capacity,
                                      x.dtype)
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xg)     # [E,G,Cap,D]
    tp = ctx.tp
    ep = tp is not None and getattr(p["moe_wg"], "tp_dim", None) == -3
    E = n_experts
    if ep:
        E = n_experts // tp.size
        expert_in = tp.split(expert_in, 0)
        combine = tp.split(combine, 2)
    expert_in = expert_in.reshape(E, G * capacity, D)

    # the operands' parts of one process's: the rank's experts, its groups
    ex = (0, tp.rank * E, n_experts) if ep else None
    rows = None if dp is None else (1, g0 * capacity, G_all * capacity)
    xb = lambda t: part_base(t.shape, (ex, rows))
    wb = lambda w: part_base(w.shape, (ex,))
    # per-expert SwiGLU in HBFP: [E, G·Cap, D] @ [E, D, F] (the sim path)
    g = ctx_matmul(expert_in, p["moe_wg"], ctx, "moe_g",
                   x_base=xb(expert_in), w_base=wb(p["moe_wg"]))
    u = ctx_matmul(expert_in, p["moe_wi"], ctx, "moe_i",
                   x_base=xb(expert_in), w_base=wb(p["moe_wi"]))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    eo = ctx_matmul(h, p["moe_wo"], ctx, "moe_o", x_base=xb(h),
                    w_base=wb(p["moe_wo"]))
    eo = eo.reshape(E, G, capacity, D)

    if ep:
        part = torch.einsum("gtec,egcd->gtd", combine.to(torch.float32),
                            eo.to(torch.float32)).reshape(B, S, D)
        out = (tp.reduce_scatter(part, 1) if tp.sp
               else tp.reduce(part)).to(x.dtype)
    else:
        out = torch.einsum("gtec,egcd->gtd", combine, eo).reshape(B, S, D)
    local = (lambda t: t) if tp is None else \
        (lambda t: tp.seq_out(t, S // tp.size if tp.sp else S))
    out = local(out)
    if shared_expert:
        shared = {k_.replace("shared_", "ffn_"): v for k_, v in p.items()
                  if k_.startswith("shared_")}
        out = out + local(swiglu_ffn(x, shared, ctx))
    if dense_residual:
        out = out + local(swiglu_ffn(x, p, ctx))
    return out, aux
