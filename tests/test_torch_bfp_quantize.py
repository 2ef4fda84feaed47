"""The port's FP→BFP conversion (B7) against the JAX package on the CPU.

`bfp_quantize_plain` (what B7's wrapper computes for CPU tensors) and the
port's `kernels.ops.bfp_quantize` are held to the reference's Pallas
kernel in interpret mode and to its oracle `bfp_quantize_ref`, bit for bit
in all five outputs (mantissas, exponents, clip counts, exponent min and
max), for nearest and stochastic rounding; `core.bfp.pack` / `unpack`
are held to the reference's for 2-D and stacked leaves. Inputs are made
with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfp as jbfp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bfp_quantize import bfp_quantize_pallas
from repro_torch.core import bfp
from repro_torch.kernels import bfp_quantize as bq
from repro_torch.kernels import ops

SHAPES = [(128, 256), (130, 72)]
TILES = [(32, 32), (64, 128)]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _x(shape, seed, scale=3.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.array(b)
        assert a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("m", [4, 8, 12])
def test_plain_matches_pallas_and_oracle(shape, tile, m):
    x = _x(shape, hash((shape, tile, m)) % 2 ** 31)
    kw = dict(mantissa_bits=m, tile_r=tile[0], tile_c=tile[1],
              with_stats=True)
    got = bq.bfp_quantize(torch.from_numpy(x), 0, **kw)
    _assert_outputs_equal(got, jref.bfp_quantize_ref(jnp.asarray(x), 0,
                                                     **kw))
    _assert_outputs_equal(got, bfp_quantize_pallas(
        jnp.asarray(x), jnp.zeros((1, 1), jnp.int32), interpret=True, **kw))


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("shape,tile,seed", [
    ((128, 128), 64, 99), ((100, 130), 32, 7), ((100, 130), 32, -123457)])
def test_stochastic_stream_matches(m, shape, tile, seed):
    """The xorshift stream indexes row · Cp + col with Cp the padded
    width, hashed in int32 with wrap-around, as the reference does."""
    x = _x(shape, seed & 0xFFFF, 0.7)
    kw = dict(mantissa_bits=m, tile_r=tile, tile_c=tile, stochastic=True,
              with_stats=True)
    got = bq.bfp_quantize(torch.from_numpy(x), seed, **kw)
    _assert_outputs_equal(got, jref.bfp_quantize_ref(jnp.asarray(x), seed,
                                                     **kw))
    _assert_outputs_equal(got, bfp_quantize_pallas(
        jnp.asarray(x), jnp.full((1, 1), seed, jnp.int32), interpret=True,
        **kw))


def test_whole_dim_tile_bf16_input_and_blocks():
    """tile None shares one exponent along the whole dim (the reference's
    tile (R, C)); bf16 input is read as f32; non-default stats blocks
    follow the reference's `_fit_block` grid."""
    x = _x((100, 130), 3)
    got = bq.bfp_quantize(torch.from_numpy(x), 0, mantissa_bits=8,
                          tile_r=None, tile_c=None, with_stats=True)
    _assert_outputs_equal(got, jref.bfp_quantize_ref(
        jnp.asarray(x), 0, mantissa_bits=8, tile_r=100, tile_c=130,
        with_stats=True))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    kw = dict(mantissa_bits=4, tile_r=1, tile_c=64, with_stats=True)
    _assert_outputs_equal(bq.bfp_quantize(xb, 0, **kw),
                          jref.bfp_quantize_ref(xj, 0, **kw))
    for br, bc in ((64, 96), (32, 128), (1000, 7)):
        kw = dict(mantissa_bits=8, tile_r=32, tile_c=32, block_r=br,
                  block_c=bc, with_stats=True)
        _assert_outputs_equal(
            bq.bfp_quantize(torch.from_numpy(x), 0, **kw),
            bfp_quantize_pallas(jnp.asarray(x), jnp.zeros((1, 1), jnp.int32),
                                interpret=True, **kw))


@pytest.mark.parametrize("shape", [(128, 256), (100, 130)])
def test_ops_wrapper_and_stats_dict(shape):
    x = _x(shape, shape[1])
    mk, ek = ops.bfp_quantize(torch.from_numpy(x), mantissa_bits=4, tile=64)
    mr, er = jops.bfp_quantize(jnp.asarray(x), mantissa_bits=4, tile=64)
    _assert_outputs_equal((mk, ek), (mr, er))
    m2, e2, st = ops.bfp_quantize(torch.from_numpy(x), mantissa_bits=4,
                                  tile=64, with_stats=True)
    _, _, jst = jops.bfp_quantize(jnp.asarray(x), mantissa_bits=4, tile=64,
                                  with_stats=True)
    assert torch.equal(m2, mk) and torch.equal(e2, ek)
    assert set(st) == set(jst)
    for k in st:
        assert float(st[k]) == float(jst[k]), k


def test_wrapper_counts_and_raises():
    x = torch.from_numpy(_x((64, 64), 1))
    bq.reset_counts()
    bq.bfp_quantize(x, 0, mantissa_bits=8)
    assert (bq.bfp_quantize.plain_calls, bq.bfp_quantize.launches) == (1, 0)
    for m in (1, 17):
        with pytest.raises(ValueError, match="2 <= m <= 16"):
            bq.bfp_quantize(x, 0, mantissa_bits=m)
    with pytest.raises(ValueError, match="2-D"):
        bq.bfp_quantize(x[None], 0)
    with pytest.raises(TypeError):
        bq.bfp_quantize(x.double(), 0)
    # a tensor off the CPU never takes the plain version
    with pytest.raises(ValueError, match="device"):
        bq.bfp_quantize(torch.empty((8, 8), device="meta"), 0)
    assert bq.bfp_quantize.plain_calls == 1


@pytest.mark.parametrize("shape", [(100, 130), (3, 100, 130), (2, 48, 72),
                                   (130,)])
@pytest.mark.parametrize("tile", [24, 128, None])
def test_pack_unpack_match_reference(shape, tile):
    """`pack` (B7 per 2-D slice, or once on a [L·K, N] view when the tile
    divides K) gives the reference's padded mantissas, exponent grid and
    dtype, and `unpack` its values."""
    x = _x(shape, len(shape) * 1000 + (tile or 0))
    m = 16 if tile == 24 else 8
    ts = jbfp.weight_tile_shape(len(shape), tile)
    bq.reset_counts()
    p = bfp.pack(torch.from_numpy(x), m, ts)
    jp = jbfp.pack(jnp.asarray(x), m, ts)
    _assert_outputs_equal((p.mantissa, p.exponent),
                          (jp.mantissa, jp.exponent))
    assert (p.mantissa_bits, p.tile_shape, p.shape) == \
        (jp.mantissa_bits, jp.tile_shape, jp.shape)
    assert p.nbytes == jp.nbytes
    np.testing.assert_array_equal(bfp.unpack(p).numpy(),
                                  np.asarray(jbfp.unpack(jp)))
    lead, R, C, tr, tc, merged = bfp.b7_layout(shape, ts)
    slices = 1 if merged else int(np.prod(lead))
    assert bq.bfp_quantize.plain_calls == slices
    # packing a wide-BFP tensor at its own format is lossless
    wide = bfp.quantize(torch.from_numpy(x), m, ts)
    assert torch.equal(bfp.unpack(bfp.pack(wide, m, ts)), wide)


def test_pack_rejects_what_b7_cannot_do():
    """Stochastic packing runs B7 at the key's seed and packs the
    mantissas of `quantize(..., "stochastic", key)`, also for a batch of
    slices whose tiles do not divide the rows (padded to whole tile rows
    for one B7 stream); it needs a key. B7 tiles the trailing dims only."""
    for shape, ts in (((4, 8, 8), (1, 8, 8)), ((3, 20, 30), (1, 8, 8))):
        x = torch.from_numpy(_x(shape, 3))
        bq.reset_counts()
        p = bfp.pack(x, 8, ts, rounding="stochastic", key=12345)
        assert bq.bfp_quantize.plain_calls == 1
        assert torch.equal(bfp.unpack(p), bfp.quantize(x, 8, ts,
                                                       "stochastic", 12345))
        assert not torch.equal(bfp.unpack(p), bfp.quantize(x, 8, ts))
    with pytest.raises(ValueError, match="key"):
        bfp.pack(x, 8, (1, 8, 8), rounding="stochastic")
    x = torch.from_numpy(_x((4, 8, 8), 2))
    with pytest.raises(ValueError, match="trailing"):
        bfp.pack(x, 8, (2, 8, 8))
