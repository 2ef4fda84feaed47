"""Tensor, sequence and expert parallelism over the "model" axis, with
HBFP's exponent groups kept whole (no counterpart in the reference: there
XLA's GSPMD partitions the jitted step under `fwd_param_specs` and the
`act_constraint` / `shard_fn` hooks, `repro/launch/dryrun.py:138-189`,
and keeps the one-device semantics; here the port earns them by hand).

The layout (`tp_layout`) starts from `fwd_param_specs` and replicates
every leaf whose "model" shard would cut a square weight tile (shard size
% tile != 0), and every member of a group that must shard together when
one member cannot (`GROUPS`: attention's four projections, which also
need the query and kv heads to divide; each FFN's three; the experts'
three) or whose in-projection is a concatenation that a shard would cut
mid-part (the Mamba-2 branch's `ssm_in_w` [D, 2·di + 2N + H], the
mLSTM's `mlstm_up_w` and `mlstm_qkv_w`, the sLSTM's four gates). A
mixer is then either wholly sharded or wholly replicated.

`TPGroup` (the `Ctx.tp` slot) runs a product on its weight's layout
(`matmul`; the weight's `tp_dim` attribute, set by `train.zero`'s narrow
copy, is -1 for a column shard, -2 for a row shard, -3 for an expert
shard):

  * column-parallel, y[:, part] = x · w[:, part]: x whole; the output
    stays sharded where its consumer is head-local or elementwise (q, k,
    v by head, the gated FFN's gate and up), else it is gathered. The
    backward sums the ranks' partial input gradients (f32, cast once),
    and quantizes g on its global row amax when its exponent group spans
    the ranks;
  * row-parallel, y = Σ_ranks x[:, part] · w[part, :]: x the local part
    (a whole x is split), quantized on the global row amax when its
    group spans the ranks; the f32 partial products are summed over the
    ranks and cast once, the one rounding of one process (at twice the
    bytes of a reduce in the model's bf16).

Where the heads do not divide (or a group cannot shard whole) the layout
keeps the mixer replicated rather than gathering sharded outputs: a
gathered attention output would meet wo's shard whole, the same work as
the replicated mixer and more traffic.

Row amax: an activation's exponent group runs along its whole feature
row on the sim path (`act_block=None`) and along a K-block of the
kernels' tiles on the kernel path. Where a shard cuts the group, one
all-reduce (MAX) of the [M] f32 row amax gives every rank the
one-process exponent, and the quantized operand is bit-equal to one
process's (B1–B3 take it as `x_amax` / `g_amax`). A group that the shard
leaves whole needs nothing; one that a shard cuts but that is not the
whole row is refused (the layout keeps such a leaf replicated).

Sequence parallelism (`sp`): the residual stream is sharded over the
sequence and the norms on it run on the local tokens; a block gathers
the sequence before its mixer (`seq_in`) and reduce-scatters after its
row-parallel products (backward all-gather); a replicated mixer's output
is cut back to the local tokens (`seq_out`, backward all-gather). Inside
the gathered region every gradient is whole, as without `sp`: a
gradient is quantized (BFP rounding is not additive) only where it is
the sum over the ranks, never a partial one. So only the residual
stream's norm scales (`SP_PARTIAL`) take partial gradients, over their
local tokens, and `train.zero` sums them over "model". Every replicated
computation carries whole, identical gradients.

Stochastic rounding: each product's operands are parts of the ones a
single process multiplies, and `matmul` adds this rank's column block of
w (and of g) or row block of x and w to the operands' index bases, so
every draw is one process's (`kernels.common.IndexBase`). `DataPart` is
a rank's rows of the data-parallel batch, the `Ctx.dp` slot.

Every collective is one of `launch.transport.Transport`'s, recorded. No
collective runs inside a captured CUDA graph (training never captures
one around a layer; the sLSTM's graphed loops hold none).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.common import IndexBase, index_base
from repro_torch.sharding.partitioning import fwd_param_specs, mesh_axes

# products that shard together, by layer-leaf name
GROUPS = (("attn_wq", "attn_wk", "attn_wv", "attn_wo"),
          ("ffn_wg", "ffn_wi", "ffn_wo"),
          ("shared_wg", "shared_wi", "shared_wo"),
          ("moe_wg", "moe_wi", "moe_wo"))
# norm scales applied to the sequence-sharded residual stream: partial
# gradients under sequence parallelism
SP_PARTIAL = ("ln1_norm_scale", "ln2_norm_scale", "post1_norm_scale",
              "post2_norm_scale", "attn_branch_norm_scale",
              "ssm_branch_norm_scale", "final_norm_scale")
# mixers whose in-projection concatenates several parts: kept replicated
CONCATENATED = (("ssm_in_w", "ssm_out_w"),
                ("mlstm_up_w", "mlstm_qkv_w", "mlstm_down_w"),
                ("slstm_in_w", "slstm_out_w"))


class TPLayout(NamedTuple):
    """dims: {leaf name: the dim it shards over "model", counted from the
    end (-1 column, -2 row, -3 experts), or None}; replicated: {leaf name:
    why a leaf the reference's rules shard stays whole}."""
    dims: dict
    replicated: dict


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def tp_layout(params, mesh, tile: Optional[int], n_heads: int = 0,
              n_kv_heads: int = 0, ep_only: bool = False) -> TPLayout:
    """The tile-aligned "model" layout of a params tree (shapes only: a
    "meta" tree will do) on `mesh` (anything `mesh_axes` reads), for
    square weight tiles of edge `tile` (None: one tile spans its dim, so
    no matrix dim shards; the caller folds the kernels' tiles and the
    activation block into it). `ep_only` is the reference's MoE serving
    layout (`fwd_param_specs(ep_only=True)`): only the experts shard, and
    every dense and attention leaf that the full rules shard is listed
    replicated with that reason."""
    m = mesh_axes(mesh)["model"]
    specs = dict(_flat(fwd_param_specs(params, mesh)))
    if ep_only:
        ep = dict(_flat(fwd_param_specs(params, mesh, ep_only=True)))
    leaves = dict(_flat(params))
    dims, why = {}, {}
    for name, t in leaves.items():
        spec = specs[name]
        d = next((i for i, s in enumerate(spec) if s == "model"), None)
        if d is None or m == 1:
            dims[name] = None
            continue
        if ep_only and "model" not in ep[name]:
            dims[name] = None
            why[name] = "ep_only: only the experts shard"
            continue
        if d >= t.ndim - 2:              # a weight-matrix dim, not experts
            part = t.shape[d] // m
            if tile is None or part % tile:
                dims[name] = None
                why[name] = (f"{t.shape[d]} / {m} = {part} cuts a "
                             f"{tile}-tile")
                continue
        dims[name] = d - t.ndim
    base = lambda n: n.rsplit("/", 1)[-1]
    by_base = {}
    for name in leaves:
        by_base.setdefault(base(name), []).append(name)

    def replicate(names, reason):
        for n in names:
            for full in by_base.get(n, ()):
                if dims.get(full) is not None:
                    dims[full] = None
                    why[full] = reason

    heads_ok = n_heads % m == 0 and n_kv_heads % m == 0
    for group in GROUPS:
        present = [f for n in group for f in by_base.get(n, ())]
        if not present:
            continue
        cut = [f for f in present if dims[f] is None]
        if cut:
            replicate(group, f"its group shards together and "
                             f"{base(cut[0])} stays whole")
        elif group[0] == "attn_wq" and not heads_ok:
            replicate(group, f"{n_heads} query / {n_kv_heads} kv heads do "
                             f"not divide over {m} ranks")
    for group in CONCATENATED:
        replicate(group, f"{group[0]} concatenates several projections")
    return TPLayout(dims=dims, replicated=why)


# -- collectives as autograd Functions -----------------------------------------

def _chunk(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k)


class _Reduce(torch.autograd.Function):
    """from-model: all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.transport.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the ranks, this rank's chunk along `dim` forward; the
    all-gather along `dim` backward."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.transport.reduce_scatter(x.contiguous().clone(), dim,
                                           kind="reduce_scatter")

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.transport.all_gather_dim(g.contiguous(), ctx.dim), \
            None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` forward; backward the rank's slice of the
    whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.transport.all_gather_dim(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _chunk(g, ctx.dim, tp.size, tp.rank).contiguous(), None, None


class _Split(torch.autograd.Function):
    """The rank's slice along `dim` forward; backward the all-gather of the
    slices' gradients (a whole gradient on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _chunk(x, dim, tp.size, tp.rank).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.transport.all_gather_dim(g.contiguous(), ctx.dim), \
            None, None


class _VocabCE(torch.autograd.Function):
    """Per-token CE of vocab-sharded logits [..., V/m] (f32): the global
    max and sum of exponentials over the ranks, the label's logit from the
    rank that holds it. Backward: softmax − one-hot on the local columns."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        v = logits.shape[-1]
        v0 = tp.rank * v
        mx = tp.max_(logits.detach().amax(dim=-1))
        e = torch.exp(logits - mx[..., None])
        s = tp.sum_(e.sum(dim=-1))
        local = labels - v0
        have = (local >= 0) & (local < v)
        pick = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])
        ll = tp.sum_(torch.where(have, pick.squeeze(-1),
                                 torch.zeros((), device=logits.device)))
        ctx.save_for_backward(e, s, local, have)
        ctx.v = v
        return mx + torch.log(s) - ll

    @staticmethod
    def backward(ctx, g):
        e, s, local, have = ctx.saved_tensors
        d = e / s[..., None]
        hot = torch.zeros_like(d).scatter_(
            -1, local.clamp(0, ctx.v - 1)[..., None],
            have[..., None].to(d.dtype))
        return (d - hot) * g[..., None], None, None


class TPCall(NamedTuple):
    """What one product's Function needs of the model group: its kind
    ("col": the output columns sharded; "row": the contraction), the group
    size, the MAX reduce of a row amax and, for a column product, the f32
    sum that completes its input gradient."""
    kind: str
    size: int
    reduce_max: Callable
    reduce_dx: Optional[Callable] = None


def row_amax_needed(group: Optional[int], local: int, full: int) -> bool:
    """Whether a row whose `full` features are split into parts of `local`
    needs the global row amax to keep an exponent group of `group`
    features (None: the whole row) whole: False where every group lies in
    one part, True where the group is the whole row; a cut group that is
    not the whole row is refused."""
    g = full if group is None else min(group, full)
    if local % g == 0:
        return False
    if g == full:
        return True
    raise ValueError(f"a shard of {local} of {full} features cuts "
                     f"{g}-feature exponent groups that are not whole rows")


def local_row_amax(a: torch.Tensor) -> torch.Tensor:
    """|a|'s max along the last axis, f32, keepdim."""
    return a.detach().abs().amax(dim=-1, keepdim=True).to(torch.float32)


class _DPMean(torch.autograd.Function):
    """The mean over the data ranks forward; the identity backward (each
    rank's gradient of the global mean is then averaged over the ranks
    with every other gradient, which completes the 1/n)."""

    @staticmethod
    def forward(ctx, x, transport):
        t = transport.all_reduce_(x.detach().contiguous().clone())
        return t / transport.size

    @staticmethod
    def backward(ctx, g):
        return g, None


class DataPart(NamedTuple):
    """A rank's rows of the data-parallel batch (the `Ctx.dp` slot): the
    first row `offset` and the global batch `size` along dim 0 of the
    activations, and the data axis's transport. `gather_groups` (the
    serving layout's choice, `train.serve_step.ServeLayout`): where the
    rank's rows cut the MoE groups, the MoE layer gathers the batch and
    routes the global groups (no gradient); otherwise it refuses them."""
    offset: int
    size: int
    transport: object
    gather_groups: bool = False

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of `t` over the data ranks (differentiable: see
        `_DPMean`)."""
        return _DPMean.apply(t, self.transport)


class TPGroup:
    """The model group of one rank (the `Ctx.tp` slot): its transport,
    size and rank, and the sequence-parallel flag."""

    def __init__(self, transport, sp: bool = False):
        self.transport = transport
        self.size = transport.size
        self.rank = transport.rank
        self.sp = bool(sp)

    # -- plain collectives (no gradient) ----------------------------------

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        return self.transport.all_reduce_(t.contiguous().clone(),
                                          op=dist.ReduceOp.MAX)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        return self.transport.all_reduce_(t.contiguous().clone())

    def row_amax(self, a: torch.Tensor) -> torch.Tensor:
        """The global row amax of a row-split operand (MAX over ranks)."""
        return self.max_(local_row_amax(a))

    # -- differentiable -----------------------------------------------------

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def reduce_scatter(self, x, dim: int):
        return _ReduceScatter.apply(x, dim, self)

    def gather(self, x, dim: int):
        """All-gather along `dim` (backward: the local slice)."""
        return _Gather.apply(x, dim % x.ndim, self)

    def split(self, x, dim: int):
        """The local slice along `dim` (backward: the all-gather)."""
        return _Split.apply(x, dim % x.ndim, self)

    def vocab_ce(self, logits, labels):
        return _VocabCE.apply(logits, labels, self)

    # -- sequence parallelism -----------------------------------------------

    def seq_in(self, h):
        """A block's input [B, S_local, D] as the whole sequence (SP), or
        h as it is."""
        return self.gather(h, 1) if self.sp else h

    def seq_out(self, y, s_local: int):
        """A mixer's output back on the local tokens under SP: already
        there when a row-parallel product reduce-scattered it, else (a
        replicated mixer, computed alike on every rank) its local
        slice."""
        if not self.sp or y.shape[1] == s_local:
            return y
        return self.split(y, 1)

    # -- products -----------------------------------------------------------

    def call(self, kind: str) -> TPCall:
        return TPCall(kind, self.size, self.row_amax,
                      self.sum_ if kind == "col" else None)

    def matmul(self, x, w, tp_dim: int, run, out: str = "gather",
               x_base: Optional[IndexBase] = None):
        """The product of x and the sharded weight w through `run(x, w,
        call, x_base, w_base)` (the ctx's backend with a `TPCall` and the
        operands' index bases: `x_base`, over x as given, with this
        rank's block added). tp_dim -1 is column-parallel (out "shard"
        keeps the output sharded, "gather" all-gathers it), -2
        row-parallel (the output summed over the ranks, or
        reduce-scattered over the sequence under SP)."""
        if x_base is None:
            x_base = index_base(x.shape)
        if tp_dim == -1:
            n = w.shape[-1]
            wb = IndexBase((w.shape[0], n * self.size), (0, self.rank * n))
            y = run(x, w, self.call("col"), x_base, wb)
            return y if out == "shard" else self.gather(y, -1)
        if tp_dim != -2:
            raise ValueError(f"a 2-D product takes tp_dim -1 or -2, got "
                             f"{tp_dim}")
        k = w.shape[-2]
        if x.shape[-1] == k * self.size:
            x = self.split(x, -1)
        elif x_base.shape[-1] != k or x_base.offset[-1]:
            raise ValueError(f"a row-parallel part of {k} features takes "
                             f"x whole or its own part, got base {x_base}")
        # x's part: this rank's block of the one-process contraction
        xb = IndexBase(x_base.shape[:-1] + (k * self.size,),
                       x_base.offset[:-1] + (self.rank * k,))
        wb = IndexBase((k * self.size, w.shape[1]), (self.rank * k, 0))
        y = run(x, w, self.call("row"), xb, wb)    # f32 partial sums
        y = self.reduce_scatter(y, 1) if self.sp else self.reduce(y)
        return y.to(x.dtype)


def shard_params(params, dims: dict, rank: int, size: int):
    """A model rank's part of whole (narrow) parameters, for serving (the
    counterpart of `train.zero`'s narrow copy): each leaf that `dims`
    (`TPLayout.dims`) shards, this rank's block along its dim, copied;
    the rest as it is. "layers" becomes a list of per-layer dicts, each
    sharded tensor tagged with its `tp_dim` (counted from the end, as the
    narrow copy's), which `ctx_matmul` and the model read."""
    def part(t, d):
        if d is None:
            return t
        k = t.shape[d] // size
        out = t.narrow(d, rank * k, k).clone(
            memory_format=torch.contiguous_format)
        out.tp_dim = d
        return out

    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    out = {k: part(v, dims.get(k)) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [{k: part(v[i], dims.get(f"layers/{k}"))
                      for k, v in layers.items()} for i in range(L)]
    return out
