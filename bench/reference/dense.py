"""The dense decoder (`family` "dense") in plain float32 PyTorch.

A layer (pre-norm, residual):

    h = rms(x) · ln1
    x = x + W_o attention(h)               GQA, RoPE, causal (or a window)
    x = x + W_o (silu(W_g · rms(x) · ln2) ⊙ W_i · rms(x) · ln2)

then the final norm and the head; the loss is the mean next-token
cross-entropy. RoPE rotates the two halves of each head; query head h
reads kv head h // (H / Hkv); scores are scaled by 1/√hd; a window w
keeps the keys q − w < k ≤ q. Attention runs in query blocks and each
layer and loss chunk is recomputed in the backward
(torch.utils.checkpoint), so a cell's sizes fit the card.

`layer_specs` is the layer's weight layout, which the benchmark's
weights (`harness.weights`) and work counts (`harness.yardstick`) follow.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512        # queries per attention block
CE_CHUNK = 2048      # tokens per cross-entropy chunk


@contextlib.contextmanager
def exact_fp32():
    """Float32 products in float32 while the `with` lasts: no TF32 on the
    card. The flags are put back after, so the program never runs under
    the reference's settings."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def to_f32(tree: Dict) -> Dict:
    """The weights in float32, each leaf converted and its original
    freed."""
    for k in list(tree):
        v = tree[k]
        tree[k] = to_f32(v) if isinstance(v, dict) else v.float()
    return tree


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def layer_specs(model: dict) -> List[Tuple[str, tuple, object]]:
    """(name, per-layer shape, init) of one layer's leaves, in the port's
    parameter layout: a float init is the scale of a normal draw, a
    string a constant ("ones")."""
    D, Dff = model["d_model"], model["d_ff"]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = _hd(model)
    return [("ln1_norm_scale", (D,), "ones"),
            ("ln2_norm_scale", (D,), "ones"),
            ("attn_wq", (D, H * hd), D ** -0.5),
            ("attn_wk", (D, Hkv * hd), D ** -0.5),
            ("attn_wv", (D, Hkv * hd), D ** -0.5),
            ("attn_wo", (H * hd, D), (H * hd) ** -0.5),
            ("ffn_wg", (D, Dff), D ** -0.5),
            ("ffn_wi", (D, Dff), D ** -0.5),
            ("ffn_wo", (Dff, D), Dff ** -0.5)]


def rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x [B, H, S, hd], pos [S]."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, q0, k0, window):
    """One query block [q0, q0 + Sq) against keys [k0, k0 + Sk)."""
    s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5)
    qp = torch.arange(q0, q0 + q.shape[2], device=q.device)[:, None]
    kp = torch.arange(k0, k0 + k.shape[2], device=q.device)[None]
    keep = kp <= qp
    if window is not None:
        keep = keep & (kp > qp - window)
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def attention(q, k, v, window, grad: bool):
    """q [B, H, S, hd], k and v [B, Hkv, S, hd] -> [B, H, S, hd]."""
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    S = q.shape[2]
    outs = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        args = (q[:, :, q0:q1], k[:, :, k0:q1], v[:, :, k0:q1], q0, k0,
                window)
        outs.append(checkpoint(_attend, *args, use_reentrant=False)
                    if grad else _attend(*args))
    return torch.cat(outs, dim=2)


def layer(x, lp: Dict, m: dict, pos, grad: bool):
    B, S, D = x.shape
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    eps = m.get("norm_eps", 1e-6)
    theta = m.get("rope_theta", 10000.0)
    w = m.get("window") if m.get("attn_pattern") == "sliding" else None
    h = rms(x, lp["ln1_norm_scale"], eps)
    q = (h @ lp["attn_wq"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (h @ lp["attn_wk"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = (h @ lp["attn_wv"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    o = attention(rope(q, pos, theta), rope(k, pos, theta), v, w, grad)
    a = o.transpose(1, 2).reshape(B, S, H * hd) @ lp["attn_wo"]
    x = x + m.get("residual_scale", 1.0) * a
    h = rms(x, lp["ln2_norm_scale"], eps)
    f = (F.silu(h @ lp["ffn_wg"]) * (h @ lp["ffn_wi"])) @ lp["ffn_wo"]
    return x + m.get("residual_scale", 1.0) * f


def hidden(params: Dict, tokens, m: dict, grad: bool = False):
    """The final-normed hidden states [B, S, D] of tokens [B, S]."""
    x = params["embed_table"][tokens] * m.get("emb_scale", 1.0)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(m["n_layers"]):
        lp = {k: v[i] for k, v in params["layers"].items()}
        x = checkpoint(layer, x, lp, m, pos, grad, use_reentrant=False) \
            if grad else layer(x, lp, m, pos, grad)
    return rms(x, params["final_norm_scale"], m.get("norm_eps", 1e-6))


def head(params: Dict, x, m: dict):
    return (x @ params["head_w"]) / m.get("logit_divisor", 1.0)


def _ce(params, x, labels, m):
    logits = head(params, x, m)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(params: Dict, tokens, labels, m: dict):
    """The mean next-token cross-entropy of a batch, with its graph."""
    x = hidden(params, tokens, m, grad=True)
    x = x.reshape(-1, x.shape[-1])
    lab = labels.reshape(-1)
    tot = 0.0
    for c0 in range(0, x.shape[0], CE_CHUNK):
        tot = tot + checkpoint(_ce, params, x[c0:c0 + CE_CHUNK],
                               lab[c0:c0 + CE_CHUNK], m, use_reentrant=False)
    return tot / lab.numel()


@torch.no_grad()
def logits_at(params: Dict, tokens, rows, m: dict):
    """Logits [len(rows), V] at positions `rows` of one sequence tokens
    [S], in float32 with TF32 off."""
    with exact_fp32():
        x = hidden(params, tokens[None], m)[0]
        return head(params, x[rows], m)
