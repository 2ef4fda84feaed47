"""Shared kernel helpers (port of `repro.kernels.common`): exponent
extraction, exact powers of two, the paper's xorshift32 stream and the
group-amax / quantize-block helpers.

The plain versions of the kernels use these, and the CUDA sources under
`csrc/` compute the same integer and float operations, so nearest and
stochastic results agree bit for bit. Integer hashing runs on int32
tensors, whose multiply and shift-left wrap like the reference's int32.

Stochastic rounding is keyed by host integers: `fold_in` derives a key
from a key and a datum (the counterpart of `jax.random.fold_in`) and
`seed_from_key` gives the kernels' int32 seed. No tensor, generator or
device touches a key, so deriving one never waits for the card, and a
recomputed forward or a resumed run derives the same keys. The draws are
the xorshift stream below, equal on the CPU and the card; they are not
the reference's threefry draws, so parity with it is statistical.

Under a mesh a rank quantizes a part of the operand one process would
quantize: `IndexBase` says which, and every quantizer (`core.bfp`, the
kernels' plain versions and the CUDA passes) draws at the element's
index in the one-process operand, so the draws do not depend on the
mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

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


_M32 = 0xFFFFFFFF


def _mix32(h: int) -> int:
    """murmur3's 32-bit finalizer, a bijection of 32-bit integers."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def fold_in(key: int, data: int) -> int:
    """A new 32-bit key from `key` and the low 32 bits of `data`: a
    bijection in each argument while the other is held."""
    return _mix32((key & _M32) ^ _mix32((data & _M32) ^ 0x9E3779B9))


def seed_from_key(key: int) -> int:
    """The kernels' int32 seed of a key (the reference's
    `kernels.linear.seed_from_key`)."""
    return _as_i32(key)


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
        seed = _as_i32(seed)        # a Python scalar: no host-to-device copy
    else:
        seed = torch.as_tensor(seed, dtype=torch.int32, device=idx.device)
    s = (idx.to(torch.int32) * _as_i32(0x9E3779B9)) ^ seed
    s = xorshift32(xorshift32(s | 1))
    return ((s >> 7) & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)


class IndexBase(NamedTuple):
    """Where one process's part of an operand lies in the operand that a
    single process quantizes at the same call with the same key: that
    operand's `shape` and the part's `offset` in each dim. A stochastic
    draw is keyed by the element's row-major index in the one-process
    operand padded as its quantizer pads it,

        i = Σ_d (local_d + offset_d) · stride_d   (wrapped to int32),

    so every part of a mesh draws what one process draws there. `shape`
    is unpadded for `core.bfp.quantize` (it pads it as it pads the part);
    the GEMM and conversion kernels take operands their caller padded,
    and with them the 2-D base of `flat_base` on the padded shape. A base
    with the part's own shape and no offset is the whole operand: its own
    row-major stream, bit for bit."""
    shape: Tuple[int, ...]
    offset: Tuple[int, ...]


def index_base(shape: Sequence[int],
               offset: Optional[Sequence[int]] = None) -> IndexBase:
    """The base of a part at `offset` (None: the origin) of the
    one-process operand `shape`."""
    shape = tuple(int(d) for d in shape)
    offset = (0,) * len(shape) if offset is None else \
        tuple(int(o) for o in offset)
    if len(offset) != len(shape):
        raise ValueError(f"offset {offset} does not match shape {shape}")
    return IndexBase(shape, offset)


def part_base(shape: Sequence[int], parts=()) -> Optional[IndexBase]:
    """The base of a tensor of local `shape` that is a part of the
    one-process operand along each (dim, offset, global size) of `parts`
    (whole along every other dim); None when `parts` is empty."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    g, o = list(shape), [0] * len(shape)
    for d, off, size in parts:
        d %= len(shape)
        o[d] += int(off)
        g[d] = int(size)
    return IndexBase(tuple(int(v) for v in g), tuple(o))


def shift_base(base: IndexBase, dim: int, start: int,
               size: Optional[int] = None) -> IndexBase:
    """`base` with its part moved `start` along `dim` of a one-process
    operand `size` long there (None: the shape as it is): the base of a
    slice of a part, or of a part split over more ranks."""
    dim %= len(base.shape)
    shape = list(base.shape)
    if size is not None:
        shape[dim] = int(size)
    off = list(base.offset)
    off[dim] += int(start)
    return IndexBase(tuple(shape), tuple(off))


def is_whole(base: Optional[IndexBase], shape: Sequence[int]) -> bool:
    """True when `base` names no part of a larger operand for a tensor of
    `shape` (None, or the whole operand: no offset and the same shape):
    the tensor draws its own row-major stream."""
    return base is None or (not any(base.offset)
                            and tuple(base.shape) == tuple(shape))


def base_rows(base: IndexBase, local_shape: Sequence[int],
              padded: Sequence[int], device) -> torch.Tensor:
    """int64 [rows]: the one-process index of each local row's first
    element, Σ_{d<last} (i_d + offset_d)·stride_d + offset_last, with the
    strides of the padded one-process shape `padded` (a row runs along
    the last dim). The plain arithmetic every plain version uses."""
    local_shape = tuple(local_shape)
    if len(local_shape) != len(base.shape) or len(padded) != len(base.shape):
        raise ValueError(f"a base of rank {len(base.shape)} for a part of "
                         f"shape {local_shape}")
    for d, (l, o, p) in enumerate(zip(local_shape, base.offset, padded)):
        if o < 0 or o + l > p:
            raise ValueError(f"part {local_shape} at {base.offset} leaves "
                             f"the padded operand {tuple(padded)} on dim {d}")
    r = torch.zeros((), dtype=torch.int64, device=device)
    for l, o, p in zip(local_shape[:-1], base.offset[:-1], padded[:-1]):
        r = r[..., None] * p + (torch.arange(l, device=device) + o)
    return r.reshape(-1) * padded[-1] + base.offset[-1]


def flat_base(base: Optional[IndexBase], local_shape: Sequence[int],
              ld: int) -> IndexBase:
    """The 2-D base (rows, ld) at (row offset, column offset) of a part
    flattened to [rows, C] (every dim but the last into rows), as the
    GEMM and conversion kernels take it: the one-process operand
    flattened alike and padded to the row length `ld`. The part's rows
    must be one contiguous run of the one-process rows; a part that is
    not (a slice of an inner dim of several outer rows) is refused, never
    given another stream."""
    local_shape = tuple(int(d) for d in local_shape)
    rows = math.prod(local_shape[:-1])
    if base is None:
        return IndexBase((rows, int(ld)), (0, 0))
    G, o, l = base.shape, base.offset, local_shape
    if len(G) != len(l):
        raise ValueError(f"a base of rank {len(G)} for a part of shape {l}")
    lead = len(l) - 1
    k = next((d for d in range(lead) if l[d] > 1), lead)
    for d in range(k + 1, lead):
        if l[d] != G[d] or o[d]:
            raise ValueError(
                f"part {l} at {o} of {G}: its rows are not one contiguous "
                f"run of the one-process rows (dim {d})")
    if o[-1] + l[-1] > ld:
        raise ValueError(f"part {l} at {o}: its columns pass the row "
                         f"length {ld}")
    row = 0
    for d in range(lead):
        row = row * G[d] + o[d]
    return IndexBase((math.prod(G[:-1]), int(ld)), (row, o[-1]))


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
