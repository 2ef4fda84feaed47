"""The port's formats, BFP quantizer and kernel helpers against the JAX
package: bit-exact (np.array_equal) at nearest rounding, including
pad-and-slice tile shapes, and on the xorshift stream's int32
wraparound; the sim path's stochastic rounding is held statistically,
since torch cannot replay jax's threefry draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfp as jbfp
from repro.core import formats as jfmt
from repro.kernels import common as jcommon
from repro_torch.core import bfp as tbfp
from repro_torch.core import formats as tfmt
from repro_torch.kernels import common as tcommon


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.asarray(a)


@pytest.mark.parametrize("kw", [{}, {"mantissa_bits": 12},
                                {"tile": 24, "act_block": 16},
                                {"tile": None, "rounding": "stochastic"}])
def test_hbfp_config_matches_reference(kw):
    a, b = jfmt.HBFPConfig(**kw), tfmt.HBFPConfig(**kw)
    assert dataclass_dict(a) == dataclass_dict(b)
    assert a.name == b.name and a.block_size == b.block_size
    assert dataclass_dict(a.with_block(32)) == dataclass_dict(b.with_block(32))
    assert dataclass_dict(a.with_block(None)) == \
        dataclass_dict(b.with_block(None))
    assert tfmt.HBFP8_16.name == jfmt.HBFP8_16.name
    assert tfmt.HBFP12_16.name == jfmt.HBFP12_16.name


def dataclass_dict(c):
    import dataclasses
    return dataclasses.asdict(c)


def test_exponent_and_pow2_bit_exact():
    rng = np.random.default_rng(0)
    amax = np.abs(np.concatenate([
        rng.standard_normal(1000) * 10.0 ** rng.integers(-40, 38, 1000),
        [0.0, 1e-45, 1.0, 2.0, 3.4e38]])).astype(np.float32)
    e_ref = _j(jbfp._max_exponent(jnp.asarray(amax)))
    assert np.array_equal(tbfp._max_exponent(_t(amax)).numpy(), e_ref)
    assert np.array_equal(tcommon.max_exponent(_t(amax)).numpy(),
                          _j(jcommon.max_exponent(jnp.asarray(amax))))
    e = np.arange(-110, 127, dtype=np.int32)
    assert np.array_equal(tbfp.pow2(_t(e)).numpy(), _j(jbfp.pow2(jnp.asarray(e))))
    assert np.array_equal(tcommon.pow2(_t(e)).numpy(),
                          _j(jcommon.pow2(jnp.asarray(e))))


@pytest.mark.parametrize("shape,tile", [
    ((16, 128), (1, None)), ((7, 50), (1, 16)), ((33, 70), (24, 24)),
    ((3, 130, 260), (1, 128, 128)), ((5, 9), (None, 4)), ((300,), (128,))])
@pytest.mark.parametrize("m", [4, 8, 12])
def test_quantize_nearest_bit_exact(shape, tile, m):
    rng = np.random.default_rng(m * 100 + len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.flat[::7] *= 1e-3                     # spread the exponents
    ref = _j(jbfp.quantize(jnp.asarray(x), m, tile))
    got = tbfp.quantize(_t(x), m, tile).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(tbfp.tile_scales(_t(x), m, tile).numpy(),
                          _j(jbfp.tile_scales(jnp.asarray(x), m, tile)))


@pytest.mark.parametrize("cfg", [tfmt.HBFP8_16, tfmt.HBFP12_16,
                                 tfmt.HBFP8_16.with_block(16)])
def test_act_and_weight_quantizers_bit_exact(cfg):
    jcfg = jfmt.HBFPConfig(**dataclass_dict(cfg))
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 40)).astype(np.float32)
    w = rng.standard_normal((2, 150, 70)).astype(np.float32)
    assert tbfp.act_tile_shape(3, cfg.act_block) == \
        jbfp.act_tile_shape(3, jcfg.act_block)
    assert tbfp.weight_tile_shape(3, cfg.tile) == \
        jbfp.weight_tile_shape(3, jcfg.tile)
    assert np.array_equal(tbfp.quantize_act(_t(a), cfg).numpy(),
                          _j(jbfp.quantize_act(jnp.asarray(a), jcfg)))
    for wide in (False, True):
        assert np.array_equal(
            tbfp.quantize_weight(_t(w), cfg, wide=wide).numpy(),
            _j(jbfp.quantize_weight(jnp.asarray(w), jcfg, wide=wide)))


def test_quantize_bf16_bit_exact():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9, 200)).astype(np.float32)
    ref = jbfp.quantize(jnp.asarray(x, jnp.bfloat16), 8, (128, 128))
    got = tbfp.quantize(_t(x).to(torch.bfloat16), 8, (128, 128))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))


def test_xorshift_and_uniform_bit_exact_on_wraparound():
    """Indices near and past int32 overflow, negative seeds: the int32
    multiply and shifts wrap identically in both packages."""
    idx = np.concatenate([
        np.arange(0, 4096), np.arange(2 ** 31 - 2048, 2 ** 31 - 1),
        np.arange(-2 ** 31, -2 ** 31 + 2048),
        np.random.default_rng(0).integers(-2 ** 31, 2 ** 31 - 1, 4096),
    ]).astype(np.int32)
    assert np.array_equal(tcommon.xorshift32(_t(idx)).numpy(),
                          _j(jcommon.xorshift32(jnp.asarray(idx))))
    for seed in (0, 12345, -7, 2 ** 31 - 1):
        ref = _j(jcommon.uniform_from_index(jnp.int32(seed),
                                            jnp.asarray(idx)))
        got = tcommon.uniform_from_index(seed, _t(idx)).numpy()
        assert np.array_equal(got, ref), seed
        assert got.min() >= 0.0 and got.max() < 1.0


def test_role_stream_salt_matches():
    for role in ("fwd", "dgrad", "wgrad", "attn_qk", "attn_pv"):
        for m, base, b, bb in ((8, 8, 0, 0), (10, 8, 0, 0), (8, 8, 16, 0),
                               (12, 8, 32, 64)):
            assert tcommon.role_stream_salt(role, m, base, b, bb) == \
                jcommon.role_stream_salt(role, m, base, b, bb)


@pytest.mark.parametrize("block", [0, 16, 64, 256])
def test_group_amax_bit_exact(block):
    rng = np.random.default_rng(block)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    assert np.array_equal(
        tcommon.row_group_amax(_t(x), block).numpy(),
        np.broadcast_to(_j(jcommon.row_group_amax(jnp.asarray(x), block)),
                        tcommon.row_group_amax(_t(x), block).shape))
    w = rng.standard_normal((64, 32)).astype(np.float32)
    got = tcommon.tile_group_amax(_t(w), block).numpy()
    ref = _j(jcommon.tile_group_amax(jnp.asarray(w), block))
    assert np.array_equal(np.broadcast_to(got, np.broadcast_shapes(
        got.shape, ref.shape)), np.broadcast_to(ref, np.broadcast_shapes(
            got.shape, ref.shape)))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("m", [4, 8, 12])
def test_quantize_block_bit_exact(stochastic, m):
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((16, 48)) * 5).astype(np.float32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    idx = (np.arange(16 * 48, dtype=np.int32).reshape(16, 48) * 977
           + jcommon.STREAM_W).astype(np.int32)
    q_ref, d_ref, c_ref = jcommon.quantize_block(
        jnp.asarray(x), m, jnp.asarray(amax), stochastic=stochastic,
        seed=jnp.int32(99), idx=jnp.asarray(idx), with_clip=True)
    q, d, c = tcommon.quantize_block(_t(x), m, _t(amax),
                                     stochastic=stochastic, seed=99,
                                     idx=_t(idx), with_clip=True)
    assert np.array_equal(q.numpy(), _j(q_ref))
    assert np.array_equal(d.numpy(), _j(d_ref))
    assert np.array_equal(c.numpy(), _j(c_ref))


def test_stochastic_rounding_unbiased():
    """Mirrors tests/test_bfp.py::test_stochastic_rounding_unbiased with a
    torch.Generator in place of the jax key."""
    x = torch.full((200_000,), 0.37)
    g = torch.Generator().manual_seed(1)
    q = tbfp.quantize(x, 4, (None,), "stochastic", g)
    assert abs(float(q.mean()) - 0.37) < 2e-3
    ref = jbfp.quantize(jnp.full((200_000,), 0.37), 4, (None,),
                        "stochastic", jax.random.key(1))
    # both land on the same two grid points, with the same mean
    assert set(np.unique(q.numpy())) == set(np.unique(np.asarray(ref)))
    with pytest.raises(ValueError):
        tbfp.quantize(torch.ones(4, 4), 8, (1, None), "stochastic", None)


def test_quantize_idempotent_and_identity_at_m24():
    x = torch.randn(32, 300, generator=torch.Generator().manual_seed(0))
    q = tbfp.quantize(x, 8, (128, 128))
    assert torch.equal(tbfp.quantize(q, 8, (128, 128)), q)
    assert torch.equal(tbfp.quantize(x, 24, (1, None)), x)
