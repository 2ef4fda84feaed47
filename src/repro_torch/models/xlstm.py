"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM
(arXiv:2405.04517; port of `repro.models.xlstm`).

mLSTM: a matrix memory C in R^{dv×dk} with an exponential input gate and
a sigmoid forget gate, in the chunkwise-parallel form (a decay-masked
product within a chunk, a loop over chunks carrying the state and the
max-stabilizer m): O(S·Q) compute, O(1) decode state.

sLSTM: a scalar memory with block-diagonal recurrent weights, a true
h_{t-1} recurrence, run as a Python loop over time (the reference's
`lax.scan`) under an autograd Function with its backward through time
written out.

HBFP: the projections (up, qkv, gates, down, sLSTM in and out) go through
`ctx_matmul`, so B1-B3 on the kernel backend; the gating recurrences are
exponential-range state arithmetic and stay FP.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ctx_matmul, rms_norm

LOG_EPS = -30.0


def _logsigmoid(x):
    return -F.softplus(-x)


# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------

def mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk: int):
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; log_i, log_f: [B, S, H];
    state: (C [B, H, dv, dk], n [B, H, dk], m [B, H]). Returns (h, state)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # padding: i-gate -> 0 (LOG_EPS), f-gate -> 1 (0) keeps the state
        zpad = lambda t, val=0.0: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad],
                                        value=val)
        q, k, v = zpad(q), zpad(k), zpad(v)
        log_i = zpad(log_i, LOG_EPS)
        log_f = zpad(log_f, 0.0)
    nc = (S + pad) // Q
    causal = torch.ones(Q, Q, dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]
    eps = q.new_full((), LOG_EPS)
    C0, n0, m0 = state
    hs = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        qc, kc, vc, li, lf = (t[:, sl] for t in (q, k, v, log_i, log_f))
        F_ = torch.cumsum(lf, dim=1)                               # [B,Q,H]
        # intra: w[t,s] = F_t - F_s + log i_s (s <= t); inter: F_t + m0
        w = F_[:, :, None] - F_[:, None] + li[:, None]             # [B,t,s,H]
        b = F_ + m0[:, None]                                       # [B,Q,H]
        w = torch.where(causal, w, eps)
        m_t = torch.maximum(w.amax(dim=2), b)                      # [B,Q,H]
        wn = torch.exp(w - m_t[:, :, None])                        # [B,t,s,H]
        bn = torch.exp(b - m_t)                                    # [B,Q,H]
        qk = torch.einsum("bthk,bshk->btsh", qc, kc)               # [B,t,s,H]
        num = torch.einsum("btsh,bshv->bthv", qk * wn, vc)
        num = num + bn[..., None] * torch.einsum("bthk,bhvk->bthv", qc, C0)
        nq = (qk * wn).sum(dim=2) \
            + bn * torch.einsum("bthk,bhk->bth", qc, n0)
        den = torch.maximum(nq.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])                            # [B,Q,H,dv]
        # chunk-final state
        Ftot = F_[:, -1]                                           # [B,H]
        m_end = torch.maximum(Ftot + m0,
                              (Ftot[:, None] - F_ + li).amax(dim=1))
        sw = torch.exp(Ftot[:, None] - F_ + li - m_end[:, None])  # [B,Q,H]
        decay = torch.exp(Ftot + m0 - m_end)                       # [B,H]
        C0 = decay[:, :, None, None] * C0 \
            + torch.einsum("bsh,bshv,bshk->bhvk", sw, vc, kc)
        n0 = decay[:, :, None] * n0 + torch.einsum("bsh,bshk->bhk", sw, kc)
        m0 = m_end
    h = torch.cat(hs, dim=1)[:, :S]
    return h, (C0, n0, m0)


def mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step. q, k: [B, 1, H, dk]; v: [B, 1, H, dv]."""
    C0, n0, m0 = state
    li, lf = log_i[:, 0], log_f[:, 0]                              # [B,H]
    m1 = torch.maximum(lf + m0, li)
    fp = torch.exp(lf + m0 - m1)
    ip = torch.exp(li - m1)
    C1 = fp[:, :, None, None] * C0 + ip[:, :, None, None] * \
        torch.einsum("bhv,bhk->bhvk", v[:, 0], k[:, 0])
    n1 = fp[:, :, None] * n0 + ip[:, :, None] * k[:, 0]
    nq = torch.einsum("bhk,bhk->bh", n1, q[:, 0])
    den = torch.maximum(nq.abs(), torch.exp(-m1))
    h = torch.einsum("bhvk,bhk->bhv", C1, q[:, 0]) / den[..., None]
    return h[:, None], (C1, n1, m1)


def mlstm_block(x, p, ctx, *, n_heads: int, chunk: int = 128, state=None):
    """Pre-norm mLSTM block with a 2x up-projection and a gated output.
    `state` None runs the chunkwise form from zeros; a state runs one
    decode step (S == 1), as the reference does."""
    B, S, D = x.shape
    xn = rms_norm(x, p["norm_scale"])
    up = ctx_matmul(xn, p["mlstm_up_w"], ctx, "up")
    inner, gate = torch.chunk(up, 2, dim=-1)                       # [B,S,D]
    dk = D // n_heads
    proj = ctx_matmul(inner, p["mlstm_qkv_w"], ctx, "qkv")
    q, k, v = torch.chunk(proj, 3, dim=-1)
    gpre = ctx_matmul(inner, p["mlstm_gates_w"], ctx, "gates") \
        + p["mlstm_gates_bias"]
    shp = (B, S, n_heads, dk)
    q = q.reshape(shp).to(torch.float32)
    # the scale rounds to k's dtype first, as jax rounds a Python scalar
    k = (k.reshape(shp) * k.new_full((), dk ** -0.5)).to(torch.float32)
    v = v.reshape(shp).to(torch.float32)
    li = gpre[..., :n_heads].to(torch.float32)                     # exp gate
    lf = _logsigmoid(gpre[..., n_heads:].to(torch.float32))
    if state is None:
        st = mlstm_state_init(B, n_heads, D, device=x.device)
        h, st = mlstm_chunkwise(q, k, v, li, lf, st, chunk)
    else:
        h, st = mlstm_step(q, k, v, li, lf, state)
    h = h.reshape(B, S, D).to(x.dtype)
    h = h * F.silu(gate.to(torch.float32)).to(x.dtype)
    out = ctx_matmul(h, p["mlstm_down_w"], ctx, "down")
    return x + out, st


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------

def _slstm_gates(g_t, h, m, r_w, n_heads: int):
    """One step's gate values from the input preactivations g_t [B, 4·D]
    and the previous h and m: (zi, zf, zz, zo, a = log f + m, m1, ip, fp,
    tanh(zz), sigmoid(zo)), each [B, D]."""
    B, D = h.shape
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, n_heads, D // n_heads),
                       r_w).reshape(B, 4 * D)
    z = g_t + rec
    zi, zf, zz, zo = torch.chunk(z, 4, dim=-1)
    lf = _logsigmoid(zf)
    a = lf + m
    m1 = torch.maximum(a, zi)
    return (zi, zf, zz, zo, a, m1, torch.exp(zi - m1), torch.exp(a - m1),
            torch.tanh(zz), torch.sigmoid(zo))


def _slstm_forward(gx, r_w, h0, c0, n0, m0, n_heads: int):
    """The sLSTM recurrence over gx's S tokens: every state (h, c, n, m)
    stacked [B, S + 1, D], the initial one first."""
    h, c, n, m = h0, c0, n0, m0
    hs, cs, ns, ms = [h0], [c0], [n0], [m0]
    for t in range(gx.shape[1]):
        _, _, _, _, _, m, ip, fp, tz, so = _slstm_gates(gx[:, t], h, m, r_w,
                                                        n_heads)
        c = fp * c + ip * tz
        n = fp * n + ip
        h = so * c / torch.clamp(n, min=1e-6)
        hs.append(h)
        cs.append(c)
        ns.append(n)
        ms.append(m)
    return tuple(torch.stack(t, dim=1) for t in (hs, cs, ns, ms))


def _slstm_backward(gx, r_w, hs, cs, ns, ms, d_hs, dh, dc, dn, dm,
                    n_heads: int):
    """Backward through time of `_slstm_forward`: from the grads of the
    outputs h_1..h_S (d_hs) and of the final state, the grads of gx, r_w
    and the initial state. Each step's gates are recomputed from the
    stored state."""
    B, S, D4 = gx.shape
    D, H = D4 // 4, n_heads
    dz = torch.empty_like(gx)
    for t in range(S - 1, -1, -1):
        dh = dh + d_hs[:, t]
        h, c, n, m = hs[:, t], cs[:, t], ns[:, t], ms[:, t]
        zi, zf, zz, zo, a, m1, ip, fp, tz, so = _slstm_gates(
            gx[:, t], h, m, r_w, H)
        c1, n1 = cs[:, t + 1], ns[:, t + 1]
        nc = torch.clamp(n1, min=1e-6)
        # h1 = so · c1 / max(n1, 1e-6)
        dso = dh * c1 / nc
        dc1 = dc + dh * so / nc
        dn1 = dn - (dh * so * c1 / (nc * nc)) * (n1 >= 1e-6)
        # c1 = fp·c + ip·tz ; n1 = fp·n + ip
        dfp = dc1 * c + dn1 * n
        dip = dc1 * tz + dn1
        dc, dn = dc1 * fp, dn1 * fp
        # ip = exp(zi - m1) ; fp = exp(a - m1)
        gi, gf = dip * ip, dfp * fp
        dm1 = dm - gi - gf
        # m1 = max(a, zi), the gradient split at ties as jax does
        wa = (a > zi).to(a.dtype) + 0.5 * (a == zi).to(a.dtype)
        da = gf + dm1 * wa
        dzi = gi + dm1 * (1 - wa)
        # a = lf + m, lf = logsigmoid(zf)
        dm = da
        dz[:, t] = torch.cat([dzi, da * torch.sigmoid(-zf),
                              dc1 * ip * (1 - tz * tz),
                              dso * so * (1 - so)], dim=-1)
        drec = dz[:, t].reshape(B, H, 4 * D // H)
        dh = torch.einsum("bhe,hde->bhd", drec, r_w).reshape(B, D)
    # the recurrent weight's grad: one contraction over every step
    dr_w = torch.einsum("bshd,bshe->hde",
                        hs[:, :-1].reshape(B, S, H, D // H),
                        dz.reshape(B, S, H, 4 * D // H))
    return dz, dr_w, dh, dc, dn, dm


class _LoopGraph:
    """One loop of the sLSTM (forward or backward) captured as a CUDA
    graph on static copies of its inputs; a call copies the inputs in,
    replays the graph and returns copies of its outputs."""

    def __init__(self, fn, args):
        self.static = [a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.static)

    def __call__(self, args):
        for d, s in zip(self.static, args):
            d.copy_(s)
        self.graph.replay()
        return tuple(o.clone() for o in self.out)


# the training loops' graphs by (loop, heads, argument shapes), a few
_LOOP_GRAPHS: dict = {}
_LOOP_GRAPHS_MAX = 4


def _run_loop(fn, args, n_heads: int, graphed: bool):
    """fn(*args, n_heads) eagerly; with `graphed` on the CUDA device
    (outside another capture) the second call of a shape captures it as a
    CUDA graph and every later call replays it. The loops are thousands
    of tiny eager ops a call, so a replay takes their device time in
    place of their launch time; the graph runs the same kernels."""
    if not (graphed and args[0].is_cuda) \
            or torch.cuda.is_current_stream_capturing():
        return fn(*args, n_heads)
    key = (fn.__name__, n_heads) + tuple(
        (tuple(a.shape), a.dtype, a.device) for a in args)
    g = _LOOP_GRAPHS.get(key)
    if g is None:
        # the first call runs eagerly: it warms the allocator and the
        # library handles the capture must not create
        while len(_LOOP_GRAPHS) >= _LOOP_GRAPHS_MAX:
            _LOOP_GRAPHS.pop(next(iter(_LOOP_GRAPHS)))
        _LOOP_GRAPHS[key] = "seen"
        return fn(*args, n_heads)
    if g == "seen":
        g = _LOOP_GRAPHS[key] = _LoopGraph(
            lambda *a: fn(*a, n_heads), args)
    return g(args)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over S tokens with a hand-written backward
    through time: the forward keeps each step's state (h, c, n, m) and the
    backward recomputes one step's gates from it. The reference
    differentiates its `lax.scan`; autograd over the Python loop would
    record ~25 ops a token, and a remat recompute twice, so the port
    writes the same derivatives once. In training (`graphed`) both loops
    replay CUDA graphs on the card."""

    @staticmethod
    def forward(ctx, gx, r_w, h0, c0, n0, m0, n_heads, graphed):
        states = _run_loop(_slstm_forward, (gx, r_w, h0, c0, n0, m0),
                           n_heads, graphed)
        ctx.save_for_backward(gx, r_w, *states)
        ctx.n_heads, ctx.graphed = n_heads, graphed
        hs, cs, ns, ms = states
        return hs[:, 1:], hs[:, -1], cs[:, -1], ns[:, -1], ms[:, -1]

    @staticmethod
    def backward(ctx, d_hs, dh, dc, dn, dm):
        gx, r_w, hs, cs, ns, ms = ctx.saved_tensors
        B, S, D4 = gx.shape
        zero = lambda shape: gx.new_zeros(shape)
        grads = [g if g is not None else zero(shape) for g, shape in (
            (d_hs, (B, S, D4 // 4)), (dh, (B, D4 // 4)), (dc, (B, D4 // 4)),
            (dn, (B, D4 // 4)), (dm, (B, D4 // 4)))]
        out = _run_loop(_slstm_backward, (gx, r_w, hs, cs, ns, ms, *grads),
                        ctx.n_heads, ctx.graphed)
        return (*out, None, None)


def slstm_seq(gx, r_w, h0, c0, n0, m0, n_heads: int):
    """gx: [B, S, 4·D] input-gate preactivations; r_w [H, dh, 4·dh]
    block-diagonal recurrent weights. Returns (h [B, S, D], (h, c, n, m))."""
    graphed = torch.is_grad_enabled() and (gx.requires_grad
                                           or r_w.requires_grad)
    hs, h, c, n, m = _SLSTMScan.apply(gx, r_w, h0, c0, n0, m0, n_heads,
                                      graphed)
    return hs, (h, c, n, m)


def slstm_block(x, p, ctx, *, n_heads: int, state=None):
    B, S, D = x.shape
    xn = rms_norm(x, p["norm_scale"])
    gx = ctx_matmul(xn, p["slstm_in_w"], ctx, "sin").to(torch.float32)
    if state is None:
        state = slstm_state_init(B, D, device=x.device)
    h, state = slstm_seq(gx, p["slstm_r_w"].to(torch.float32), *state,
                         n_heads=n_heads)
    out = ctx_matmul(h.to(x.dtype), p["slstm_out_w"], ctx, "sout")
    return x + out, state


def xlstm_shapes(d_model: int, n_heads: int):
    """(name, per-layer shape, init) of an xLSTM layer's parameters in the
    reference's order (`init_mlstm` then `init_slstm`, whose second
    `norm_scale` write wins: both are ones): a float scale draws a normal
    at that scale in the arch dtype; "ones" and "gates_bias" are f32."""
    D, H = d_model, n_heads
    s, dh = D ** -0.5, D // H
    return (("norm_scale", (D,), "ones"),
            ("mlstm_up_w", (D, 2 * D), s),
            ("mlstm_qkv_w", (D, 3 * D), s),
            ("mlstm_gates_w", (D, 2 * H), s),
            ("mlstm_gates_bias", (2 * H,), "gates_bias"),
            ("mlstm_down_w", (D, D), s),
            ("slstm_in_w", (D, 4 * D), s),
            ("slstm_r_w", (H, dh, 4 * dh), dh ** -0.5),
            ("slstm_out_w", (D, D), s))


def mlstm_gates_bias(n_heads: int, device=None) -> torch.Tensor:
    """The reference's gate bias: zeros for the input gate, 3..6 for the
    forget gate, f32."""
    return torch.cat([torch.zeros(n_heads, device=device),
                      torch.linspace(3.0, 6.0, n_heads, dtype=torch.float32,
                                     device=device)])


def mlstm_state_init(batch: int, n_heads: int, d_model: int, device=None):
    dk = d_model // n_heads
    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, n_heads, dk, dk), **z),
            torch.zeros((batch, n_heads, dk), **z),
            torch.zeros((batch, n_heads), **z))


def slstm_state_init(batch: int, d_model: int, device=None):
    z = dict(dtype=torch.float32, device=device)
    return tuple(torch.zeros((batch, d_model), **z) for _ in range(4))
