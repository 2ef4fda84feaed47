"""Shared model layers (port of `repro.models.layers`). Non-dot-product
ops (norms, rotary, softcap, gating) run in FP per the HBFP rule; dot
products route through `ctx_matmul` (DESIGN.md §10, §11)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.hbfp_ops import hbfp_matmul
from repro_torch.kernels.common import fold_in, part_base, seed_from_key
from repro_torch.precision.policy import as_segment, role_width_for


def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = False):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = (1.0 + scale) if zero_centered else scale
    return (y * s).to(x.dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    if x.dtype != torch.float32:
        return cap * torch.tanh(x.to(torch.float32) / cap).to(x.dtype)
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None):
    t = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (t / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [B, H, S, hd]; positions: [B, S] int."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[:, None, :, None].to(torch.float32) * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float = 1e6,
                sections=(0.25, 0.375, 0.375)):
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191 §2.1): the frequency
    axis splits into temporal, height and width sections, each rotated by
    its own position component. x: [B, H, S, hd]; positions3: [3, B, S]
    int (t = h = w for text, which reduces to `apply_rope`)."""
    hd = x.shape[-1]
    half = hd // 2
    s0 = int(half * sections[0])
    s1 = int(half * sections[1])
    sizes = (s0, s1, half - s0 - s1)
    inv = rope_freqs(hd, theta, device=x.device)
    parts, start = [], 0
    for comp, sz in enumerate(sizes):
        pos = positions3[comp][:, None, :, None].to(torch.float32)
        parts.append(pos * inv[start:start + sz])
        start += sz
    ang = torch.cat(parts, dim=-1)                    # [B, 1, S, half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_UNSET = object()

# ctx_matmul sites that are one of the named attention roles
_ATTN_ROLE = {"qk": "attn_qk", "pv": "attn_pv"}


def ctx_matmul(x, w, ctx, site: str, cfg=_UNSET, w_kind: str = "weight",
               out: str = "gather", tp_dim=_UNSET, x_base=_UNSET,
               w_base=None, call=None):
    """Route one model dot product through the Ctx's resolved policy, with
    the reference's dispatch: attention roles take their role width on the
    sim path; backend "pallas" sends 2-D weight-kind products to the
    kernels (`kernels/linear.py`: forward, dgrad and wgrad); everything
    else is the sim path (`core/hbfp_ops.py`). dgrad/wgrad role widths
    reach the backward of both. The site's stochastic key is a host int:
    the kernels take its seed with no device round trip.

    Under tensor parallelism (`ctx.tp`) a 2-D weight sharded over "model"
    (its `tp_dim` attribute, or `tp_dim` given for a slice of a sharded
    leaf) runs as its rank's part (`TPGroup.matmul`): a column-parallel
    output stays sharded with out="shard", else it is gathered.

    Under a mesh each operand is a part of the one a single process
    multiplies here (its stochastic draws follow that one's element
    indices): `x_base` defaults to x's rows of the data-parallel batch
    (`ctx.dp`, dim 0) and `w_base` to a whole weight (an activation-kind
    w: its batch rows); a site whose operands are parts along other dims
    (attention's local heads, the experts, a CE chunk) passes its
    `kernels.common.IndexBase`s, and `TPGroup.matmul` adds the model
    axis's column or row block.

    `call` (a `sharding.tensor_parallel.TPCall` of kind "row") runs an
    attention product whose contraction this rank holds a part of (the
    sequence-sharded cache's PV): the f32 partial product, which the
    caller sums over the ranks."""
    cfg = ctx.cfg if cfg is _UNSET else cfg
    key = ctx.key_for(site)
    if x_base is _UNSET:
        x_base = ctx.batch_base(x.shape)
        if w_kind != "weight" and w_base is None:
            w_base = ctx.batch_base(w.shape)
    role = _ATTN_ROLE.get(site)
    if role is not None:
        rw = role_width_for(ctx.roles, role)
        if rw is not None:
            cfg = rw.apply(cfg)
        return hbfp_matmul(x, w, cfg, key, w_kind=w_kind, x_base=x_base,
                           w_base=w_base, tp=call)
    dgrad_cfg = wgrad_cfg = None
    if cfg is not None and ctx.roles:
        dg = role_width_for(ctx.roles, "dgrad")
        wg = role_width_for(ctx.roles, "wgrad")
        dgrad_cfg = dg.apply(cfg) if dg is not None else None
        wgrad_cfg = wg.apply(cfg) if wg is not None else None
        dgrad_cfg = None if dgrad_cfg is cfg else dgrad_cfg
        wgrad_cfg = None if wgrad_cfg is cfg else wgrad_cfg
    kernel = (ctx.backend == "pallas" and cfg is not None and w.ndim == 2
              and w_kind == "weight")

    def run(x, w, tp=None, x_base=None, w_base=None):
        if kernel:
            from repro_torch.kernels.linear import hbfp_matmul_kernel
            seed = None if key is None else seed_from_key(key)
            return hbfp_matmul_kernel(x, w, cfg, seed, dgrad_cfg=dgrad_cfg,
                                      wgrad_cfg=wgrad_cfg, tp=tp,
                                      x_base=x_base, w_base=w_base)
        return hbfp_matmul(x, w, cfg, key, w_kind=w_kind,
                           dgrad_cfg=dgrad_cfg, wgrad_cfg=wgrad_cfg, tp=tp,
                           x_base=x_base, w_base=w_base)

    d = None
    if ctx.tp is not None and w.ndim == 2 and w_kind == "weight":
        d = getattr(w, "tp_dim", None) if tp_dim is _UNSET else tp_dim
    if d is None:
        return run(x, w, None, x_base, w_base)
    return ctx.tp.matmul(x, w, d, run, out=out, x_base=x_base)


def swiglu_ffn(x, p, ctx):
    """SwiGLU: (silu(x@wg) * (x@wi)) @ wo — three HBFP matmuls (under
    tensor parallelism the gate and up products stay sharded on d_ff:
    the gating is elementwise)."""
    g = ctx_matmul(x, p["ffn_wg"], ctx, "ffn_g", out="shard")
    u = ctx_matmul(x, p["ffn_wi"], ctx, "ffn_i", out="shard")
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return ctx_matmul(h, p["ffn_wo"], ctx, "ffn_o")


def gelu_ffn(x, p, ctx):
    """GeGLU variant (tanh-approximated gelu gating)."""
    g = ctx_matmul(x, p["ffn_wg"], ctx, "ffn_g", out="shard")
    u = ctx_matmul(x, p["ffn_wi"], ctx, "ffn_i", out="shard")
    h = F.gelu(g.to(torch.float32), approximate="tanh").to(x.dtype) * u
    return ctx_matmul(h, p["ffn_wo"], ctx, "ffn_o")


class Ctx:
    """Quantization context (DESIGN.md §11): one `ResolvedPolicy` segment
    (global format, per-role widths, backend) plus the stochastic-rounding
    key and the device the model runs on.

    cfg      — the segment's global activation format (None: FP);
    backend  — "sim" or "pallas" (the kernel backend);
    roles    — the per-GEMM-role width table;
    key      — an int (`kernels.common.fold_in`) or None; as the
               reference's PRNG key it is folded per layer (`fold`) and
               per site (`key_for`), so a recomputed layer, or a resumed
               step with the same key, draws the same noise;
    act_tap  — `loss_fn` measures the residual stream at the stack's entry
               and exit (numerics observatory, DESIGN.md §9; measurement
               only, the values are untouched);
    tp       — None, or this rank's model group
               (`sharding.tensor_parallel.TPGroup`: its transport, size,
               rank and the sequence-parallel flag), the port's
               counterpart of the reference's `act_constraint` and
               `shard_fn` slots: products on sharded weights run as this
               rank's part (`ctx_matmul`);
    dp       — None, or this rank's rows of the data-parallel batch
               (`sharding.tensor_parallel.DataPart`: the first row and
               the global batch, dim 0 of the activations): each
               operand's stochastic draws are one process's at its rows,
               and the MoE groups lie on the data shards;
    kv       — how a decode cache splits over "model" where the attention
               does not shard it by its own heads
               (`sharding.partitioning.CacheLayout.kv`): None (whole, or
               on the attention's local heads), "heads" (this rank's kv
               heads of a replicated attention) or "seq" (this rank's run
               of the ring's slots).
    """

    __slots__ = ("policy", "cfg", "key", "backend", "roles", "device",
                 "act_tap", "tp", "dp", "kv")

    def __init__(self, cfg=None, key: Optional[int] = None, backend=None,
                 policy=None, device=None, act_tap: bool = False,
                 tp=None, dp=None, kv=None):
        if policy is None:
            policy = as_segment(cfg, backend=backend or "sim")
        self.policy = policy
        self.cfg = policy.global_cfg
        self.backend = backend or policy.backend
        self.roles = policy.role_widths
        self.key = key
        self.device = device
        self.act_tap = act_tap
        self.tp = tp
        self.dp = dp
        self.kv = kv

    def batch_base(self, shape, parts=()):
        """The index base of an activation of local `shape` whose dim 0
        is the batch: its data-parallel rows and the further
        (dim, offset, global size) `parts`; None for a whole operand."""
        rows = None if self.dp is None else (0, self.dp.offset,
                                             self.dp.size)
        return part_base(shape, (rows, *parts))

    def key_for(self, site: str) -> Optional[int]:
        """The stochastic-rounding key of `site` (None unless the format
        rounds stochastically): the key folded with the site name's first
        four bytes, as the reference."""
        if self.key is None or self.cfg is None \
                or self.cfg.rounding != "stochastic":
            return None
        return fold_in(self.key, int.from_bytes(site.encode()[:4], "little"))

    def without_dp(self) -> "Ctx":
        """This context for a whole (gathered) batch: no data part."""
        return Ctx(key=self.key, backend=self.backend, policy=self.policy,
                   device=self.device, act_tap=self.act_tap, tp=self.tp,
                   kv=self.kv)

    def fold(self, i: int) -> "Ctx":
        """The context of layer i: the key folded with i."""
        return Ctx(key=None if self.key is None else fold_in(self.key, i),
                   backend=self.backend, policy=self.policy,
                   device=self.device, act_tap=self.act_tap, tp=self.tp,
                   dp=self.dp, kv=self.kv)
