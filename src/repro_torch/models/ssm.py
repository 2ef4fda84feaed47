"""Selective SSM in the Mamba-2/SSD chunked form: the mamba branch of
hymba (port of `repro.models.ssm`).

Within a chunk the recurrence is a decay-masked attention-like product,
batched over the chunks; across chunks a Python loop (the reference's
`lax.scan`) carries the [B, H, P, N] state.

HBFP: the in and out projections are ordinary dot products and go
through `ctx_matmul` (B1-B3 on the kernel backend). The recurrence (decay
products, the small C·h contractions) is gating and state arithmetic with
a wide dynamic range and stays FP, per the paper's hybrid rule.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ctx_matmul


def _chunk_scan(xh, logdecay, Bm, Cm, h0, chunk: int):
    """SSD chunked scan.

    xh:  [B, S, H, P]   dt-scaled inputs
    logdecay: [B, S, H] log a_t (a_t = exp(dt·A) in (0, 1))
    Bm, Cm:   [B, S, N] shared across heads (mamba-2, one group)
    h0:  [B, H, P, N]   initial state
    Returns (y [B, S, H, P], h_end [B, H, P, N]).

    The reference's `lax.scan` step computes each chunk's terms in turn;
    here every chunk's intra-chunk product, decay weights and state
    increment come out of one batched op each, and only the state
    passing (h_c = exp(L_c,end)·h_{c-1} + dh_c, two ops a chunk) loops.
    The sums are the same, in another association.
    """
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # dt = 0 padding: decay 1 and zero input, so the state passes
        # through unchanged
        zpad = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        xh, logdecay, Bm, Cm = map(zpad, (xh, logdecay, Bm, Cm))
    nc = (S + pad) // Q
    x = xh.reshape(B, nc, Q, H, P)
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    # cumulative log decay within each chunk: L[b, c, t, h]
    L = torch.cumsum(logdecay.reshape(B, nc, Q, H), dim=2)
    # intra-chunk: M[t, s, h] = exp(L_t - L_s) · (C_t·B_s), s <= t
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)                 # [B,c,Q,Q]
    dl = L[:, :, :, None, :] - L[:, :, None, :, :]                # [B,c,t,s,H]
    causal = torch.ones(Q, Q, dtype=torch.bool,
                        device=xh.device).tril()[:, :, None]
    # mask BEFORE exp: dl > 0 above the diagonal would overflow and
    # poison the gradients through the masked branch (inf·0)
    dl = torch.where(causal, dl, xh.new_full((), float("-inf")))
    M = torch.exp(dl) * cb[..., None]
    y = torch.einsum("bctsh,bcshp->bcthp", M, x)
    # each chunk's state increment and decay
    Ltot = L[:, :, -1]                                            # [B,c,H]
    w = torch.exp(Ltot[:, :, None] - L)                           # [B,c,Q,H]
    dh = torch.einsum("bcth,bcthp,bctn->bchpn", w, x, Bc)
    decay = torch.exp(Ltot)[..., None, None]                      # [B,c,H,1,1]
    h, h_in = h0, []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c] * h + dh[:, c]
    # inter-chunk: y += exp(L_t)·C_t·h (the state entering the chunk)
    y = y + torch.einsum("bctn,bchpn,bcth->bcthp", Cc,
                         torch.stack(h_in, dim=1), torch.exp(L))
    return y.reshape(B, nc * Q, H, P)[:, :S], h


def ssm_branch(u, p, ctx, *, n_heads: int, d_state: int, chunk: int = 128,
               state=None):
    """Mamba-2 style branch. u: [B, S, D].

    Params: ssm_in_w [D, 2·di + 2·N + H] (z, x, B, C, dt), ssm_out_w
    [di, D], ssm_a_log [H], ssm_dt_bias [H], ssm_d [H], ssm_norm_scale
    [di]. `state`: None (a fresh scan from zeros), or (h [B, H, P, N],):
    with S > 1 the chunked scan seeded with it (chunked prefill), with
    S == 1 one recurrence step (decode).
    Returns (y [B, S, D], (h_end,)).
    """
    B, S, D = u.shape
    di = p["ssm_out_w"].shape[0]
    P = di // n_heads
    N = d_state
    zxbcdt = ctx_matmul(u, p["ssm_in_w"], ctx, "ssm_in")
    z, xr, Bm, Cm, dt_raw = torch.split(zxbcdt, [di, di, N, N, n_heads],
                                        dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["ssm_dt_bias"])  # [B,S,H]
    A = -torch.exp(p["ssm_a_log"].to(torch.float32))              # [H]
    logdecay = dt * A                                             # [B,S,H]
    xh = xr.to(torch.float32).reshape(B, S, n_heads, P)
    xh_dt = xh * dt[..., None]
    Bmf = Bm.to(torch.float32)
    Cmf = Cm.to(torch.float32)

    if state is None or S > 1:
        # training and one-shot prefill start from zeros; a chunked
        # prefill (DESIGN.md §14) runs the same scan seeded with the
        # lane's running state
        h0 = torch.zeros((B, n_heads, P, N), dtype=torch.float32,
                         device=u.device) if state is None else state[0]
        y, h_end = _chunk_scan(xh_dt, logdecay, Bmf, Cmf, h0, chunk)
    else:
        (h0,) = state
        # one step: h = a·h + dt·x⊗B ; y = C·h
        a = torch.exp(logdecay[:, 0])                             # [B,H]
        h_end = a[:, :, None, None] * h0 + \
            torch.einsum("bhp,bn->bhpn", xh_dt[:, 0], Bmf[:, 0])
        y = torch.einsum("bn,bhpn->bhp", Cmf[:, 0], h_end)[:, None]

    y = y + xh * p["ssm_d"][None, None, :, None]                  # skip
    y = y.reshape(B, S, di)
    # gated RMS-norm output (mamba-2): norm(y) · silu(z)
    yf = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    yf = yf * p["ssm_norm_scale"] * F.silu(z.to(torch.float32))
    out = ctx_matmul(yf.to(u.dtype), p["ssm_out_w"], ctx, "ssm_out")
    return out, (h_end,)


def ssm_shapes(d_model: int, d_inner: int, n_heads: int, d_state: int):
    """(name, per-layer shape, init) of the branch's parameters in the
    reference's order: a float scale draws a normal at that scale in the
    arch dtype; "a_log", "zeros" and "ones" are the reference's f32
    constants."""
    d_in_proj = 2 * d_inner + 2 * d_state + n_heads
    return (("ssm_in_w", (d_model, d_in_proj), d_model ** -0.5),
            ("ssm_out_w", (d_inner, d_model), d_inner ** -0.5),
            ("ssm_a_log", (n_heads,), "a_log"),
            ("ssm_dt_bias", (n_heads,), "zeros"),
            ("ssm_d", (n_heads,), "ones"),
            ("ssm_norm_scale", (d_inner,), "ones"))


def ssm_a_log(n_heads: int, device=None) -> torch.Tensor:
    """The reference's A init: log of n_heads points evenly from 1 to 16,
    in f32."""
    return torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                    device=device))


def ssm_state_init(batch: int, n_heads: int, d_inner: int, d_state: int,
                   device=None):
    P = d_inner // n_heads
    return (torch.zeros((batch, n_heads, P, d_state), dtype=torch.float32,
                        device=device),)
