"""Shared kernel helpers (port of `repro.kernels.common`): exponent
extraction, exact powers of two, the paper's xorshift32 stream and the
group-amax / quantize-block helpers.

The plain versions of the kernels use these, and the CUDA sources under
`csrc/` compute the same integer and float operations, so nearest and
stochastic results agree bit for bit. Integer hashing runs on int32
tensors, whose multiply and shift-left wrap like the reference's int32.
"""
from __future__ import annotations

import torch

EXP_FLOOR = -100
EXP_CEIL = 126

# Stochastic-rounding stream offsets: each operand draws from a disjoint
# region of the counter-based stream keyed by its global element index.
STREAM_X = 0x00000000
STREAM_G = 0x20000000
STREAM_W = 0x40000000

# Per-GEMM-role seed salts (DESIGN.md §11).
ROLE_STREAM_SALT = {
    "fwd": 0x00000000,
    "dgrad": 0x1B873593,
    "wgrad": 0x6A09E667,
    "attn_qk": 0x3C6EF372,
    "attn_pv": 0x510E527F,
}


def role_stream_salt(role: str, m_bits: int, base_bits: int,
                     block: int = 0, base_block: int = 0) -> int:
    """Seed salt for one operand in GEMM role `role` at width `m_bits` and
    block size `block`: 0 at the base (fwd) format, else a disjoint
    (role, width, block) stream (DESIGN.md §11, §13)."""
    if m_bits == base_bits and int(block) == int(base_block):
        return 0
    salt = ROLE_STREAM_SALT[role] ^ (m_bits * 0x9E3779B9)
    if int(block) != int(base_block):
        salt ^= (int(block) + 1) * 0x85EBCA6B
    return salt & 0x7FFFFFFF


def max_exponent(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2 amax) by f32 bit-field extraction (int32)."""
    bits = amax.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return e.clamp(EXP_FLOOR, EXP_CEIL)


def xorshift32(x: torch.Tensor) -> torch.Tensor:
    """One round of Marsaglia xorshift32 on int32 (the right shift is made
    logical by the mask)."""
    x = x ^ (x << 13)
    x = x ^ ((x >> 17) & 0x7FFF)
    x = x ^ (x << 5)
    return x


def _as_i32(v: int) -> int:
    """A Python int reduced to the int32 with the same low 32 bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def uniform_from_index(seed, idx: torch.Tensor) -> torch.Tensor:
    """Counter-based U[0,1): hash (seed, int32 element index) through two
    xorshift rounds and keep 24 bits."""
    if isinstance(seed, int):
        seed = _as_i32(seed)
    seed = torch.as_tensor(seed, dtype=torch.int32, device=idx.device)
    s = (idx.to(torch.int32) * _as_i32(0x9E3779B9)) ^ seed
    s = xorshift32(xorshift32(s | 1))
    return ((s >> 7) & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e via IEEE-754 bit construction."""
    bits = (e.to(torch.int32) + 127) << 23
    return bits.contiguous().view(torch.float32)


def row_group_amax(x: torch.Tensor, block: int) -> torch.Tensor:
    """Per-row |x| max over `block`-sized groups of the last axis of a 2-D
    tile; block=0 (or >= the row) gives one amax per row (DESIGN.md §13).
    Broadcastable against x."""
    a = x.abs()
    r, c = x.shape
    if not block or block >= c:
        return a.amax(dim=1, keepdim=True)
    if c % block:
        raise ValueError(f"block {block} must divide the tile K edge {c}")
    g = a.reshape(r, c // block, block).amax(dim=2, keepdim=True)
    return g.expand(r, c // block, block).reshape(r, c)


def tile_group_amax(w: torch.Tensor, block: int) -> torch.Tensor:
    """|w| max over (block, block) sub-tiles of a 2-D tile, clamped per
    dim to the tile edges; block=0 gives one amax for the whole tile."""
    a = w.abs()
    if not block:
        return a.amax()
    r, c = w.shape
    rb, cb = min(block, r), min(block, c)
    if r % rb or c % cb:
        raise ValueError(f"block {block} must divide tile edges {(r, c)}")
    g = a.reshape(r // rb, rb, c // cb, cb).amax(dim=(1, 3), keepdim=True)
    return g.expand(r // rb, rb, c // cb, cb).reshape(r, c)


def quantize_block(x: torch.Tensor, mantissa_bits: int, amax, *,
                   stochastic: bool, seed=None, idx=None,
                   with_clip: bool = False):
    """Quantize x against broadcastable amax: (q, delta) with q integral
    f32; with_clip adds the saturation mask."""
    delta = pow2(max_exponent(amax) - mantissa_bits + 2)
    v = x.to(torch.float32) / delta
    if stochastic:
        v = torch.floor(v + uniform_from_index(seed, idx))
    else:
        v = torch.round(v)
    lim = float(2 ** (mantissa_bits - 1) - 1)
    q = v.clamp(-lim, lim)
    if with_clip:
        return q, delta, v.abs() > lim
    return q, delta
