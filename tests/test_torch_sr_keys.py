"""Stochastic rounding's keys and streams in the port (ROADMAP A5).

Keys are host ints: `kernels.common.fold_in` (the counterpart of
`jax.random.fold_in`) derives them and `seed_from_key` gives the kernels'
int32 seed. `opt_shell.param_fold` folds the reference's data word, the
crc32 of the parameter name. `bfp.quantize(..., "stochastic", key)` draws
B7's stream (row-major over the padded 2-D operand, stream 0) at
`seed_from_key(key)`, so it equals B7's plain version bit for bit. The
operand and role folds of the sim path and the role salts of the kernel
path keep each GEMM role at its own width off another role's draws, as
the reference's `tests/test_precision_policy.py` checks them.

Run on the CPU:
    PYTHONPATH=src python -m pytest tests/test_torch_sr_keys.py
"""
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import opt_shell as jshell
from repro.models import init_params as jinit_params
from repro_torch.configs import get_arch
from repro_torch.core import bfp, opt_shell
from repro_torch.core.formats import HBFPConfig
from repro_torch.core.hbfp_ops import hbfp_matmul
from repro_torch.kernels import linear
from repro_torch.kernels.common import (fold_in, role_stream_salt,
                                        seed_from_key)
from repro_torch.kernels.ref import bfp_quantize_ref
from repro_torch.models import init_params
from repro_torch.optim.adamw import named_leaves


def test_fold_in_is_deterministic_and_spreads():
    keys = [0, 1, 2, 0x5EED, 0xFFFFFFFF] + list(range(100, 195))
    data = list(range(100))
    out = {(k, d): fold_in(k, d) for k in keys for d in data}
    assert len(out) == 10_000
    assert len(set(out.values())) == len(out)          # no collision
    assert all(0 <= v < 2 ** 32 for v in out.values())
    assert all(fold_in(k, d) == v for (k, d), v in out.items())
    # data past 32 bits and negative keys reduce to their low 32 bits
    assert fold_in(-1, 7) == fold_in(0xFFFFFFFF, 7)
    assert fold_in(3, 2 ** 32 + 5) == fold_in(3, 5)
    s = seed_from_key(0xFFFFFFFF)
    assert s == -1 and -2 ** 31 <= seed_from_key(fold_in(9, 9)) < 2 ** 31


@pytest.mark.parametrize("name", ["gemma2-2b", "yi-9b"])
def test_param_fold_data_word_matches_reference(name, monkeypatch):
    """Every parameter name of the smoke model: the port folds the word
    the reference folds, crc32(name) & 0x7FFFFFFF."""
    arch = get_arch(name).smoke()
    names = [n for n, _ in named_leaves(init_params(0, arch,
                                                    device="cpu"))]
    jparams = jinit_params(jax.random.key(0), jget_arch(name).smoke())
    jnames = [jshell.param_path_name(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert sorted(names) == sorted(jnames)

    seen = []
    real = jax.random.fold_in
    monkeypatch.setattr(jax.random, "fold_in",
                        lambda k, d: seen.append(int(d)) or real(k, d))
    tseen = []
    treal = opt_shell.fold_in
    monkeypatch.setattr(opt_shell, "fold_in",
                        lambda k, d: tseen.append(d) or treal(k, d))
    for n in names:
        jshell.param_fold(jax.random.key(1), n)
        k = opt_shell.param_fold(1, n)
        assert k == treal(1, zlib.crc32(n.encode()) & 0x7FFFFFFF)
    assert seen == tseen == [zlib.crc32(n.encode()) & 0x7FFFFFFF
                             for n in names]


def _b7_dequant(x2, m, tr, tc, seed):
    """B7's plain version at `seed`, dequantized: mantissa · 2^(e-m+2)."""
    mant, expo = bfp_quantize_ref(x2, seed, mantissa_bits=m, tile_r=tr,
                                  tile_c=tc, stochastic=True)
    R, C = x2.shape
    delta = bfp.pow2(expo.to(torch.int32) - m + 2)
    delta = delta.repeat_interleave(tr, 0).repeat_interleave(tc, 1)[:R, :C]
    return mant.to(torch.float32) * delta


@pytest.mark.parametrize("shape,tile,m", [
    ((100, 130), (32, 32), 4), ((128, 256), (24, 24), 8),
    ((64, 300), (1, None), 8), ((64, 256), (1, 32), 4),
    ((4, 48, 72), (1, 24, 24), 8), ((2, 9, 40), (1, 1, 16), 4),
    ((1000,), (None,), 4)])
def test_quantize_equals_b7_plain_stream(shape, tile, m):
    rng = np.random.default_rng(len(shape) * 100 + m)
    x = torch.from_numpy((rng.standard_normal(shape) * 2.5)
                         .astype(np.float32))
    for key in (0, 12345, fold_in(7, 0x5EED)):
        got = bfp.quantize(x, m, tile, "stochastic", key)
        lead, R, C, tr, tc, merged = bfp.b7_layout(shape, tile)
        assert merged
        want = _b7_dequant(x.reshape(-1, C), m, tr, tc, seed_from_key(key))
        assert torch.equal(got, want.reshape(shape))
        assert not torch.equal(got, bfp.quantize(x, m, tile))
    with pytest.raises(ValueError, match="key"):
        bfp.quantize(x, m, tile, "stochastic")


@pytest.mark.parametrize("value", [0.37, -1.7, 5e-3])
def test_stochastic_rounding_unbiased(value):
    """As tests/test_bfp.py::test_stochastic_rounding_unbiased, over
    several keys and values: the mean of 200,000 stochastic roundings of
    one value is within 4 standard errors of it."""
    x = torch.full((200_000,), value)
    for key in (1, 2, fold_in(3, 4)):
        q = bfp.quantize(x, 4, (None,), "stochastic", key).double()
        lo, hi = float(q.min()), float(q.max())
        p = (value - lo) / (hi - lo)
        se = (hi - lo) * np.sqrt(p * (1 - p) / x.numel())
        assert len(torch.unique(q)) == 2
        assert abs(float(q.mean()) - value) < 4 * se


def test_per_role_stochastic_streams_are_separated_sim():
    """As the reference's test of that name: at the base width the wgrad
    quantization of x replays the forward's draws bit for bit; at a
    diverged width it draws from its own salted stream."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    w0 = torch.from_numpy((rng.standard_normal((32, 8)) * 0.1)
                          .astype(np.float32))
    g = torch.ones(16, 8)
    sr = HBFPConfig(4, 16, tile=24, rounding="stochastic")

    def dw_at(cfg, wgrad_cfg=None, key=9):
        w = w0.clone().requires_grad_()
        (hbfp_matmul(x, w, cfg, key, wgrad_cfg=wgrad_cfg) * g).sum() \
            .backward()
        return w.grad

    assert torch.equal(dw_at(sr), dw_at(sr, wgrad_cfg=sr))
    assert not torch.equal(dw_at(sr), dw_at(sr, key=10))
    sr8 = sr.with_(mantissa_bits=8)
    assert not torch.equal(dw_at(sr, wgrad_cfg=sr8), dw_at(sr8))


def test_per_role_stochastic_streams_are_separated_pallas():
    """As the reference's test of that name: the backward kernels get an
    xor-salted seed exactly when their role width diverges; through the
    kernels' plain versions, an explicit wgrad at the base width equals
    the uniform path and a diverged one draws apart."""
    seed = 12345
    assert linear._role_seed(seed, "wgrad", 8, 8) == seed
    s1 = linear._role_seed(seed, "wgrad", 8, 4)
    s2 = linear._role_seed(seed, "dgrad", 8, 4)
    assert s1 != seed and s2 != seed and s1 != s2
    assert s1 == seed ^ role_stream_salt("wgrad", 8, 4)

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    w0 = torch.from_numpy((rng.standard_normal((64, 32)) * 0.1)
                          .astype(np.float32))
    sr = HBFPConfig(4, 16, tile=24, rounding="stochastic")

    def grads_at(cfg, wgrad_cfg=None):
        xx, w = x.clone().requires_grad_(), w0.clone().requires_grad_()
        linear.hbfp_matmul_kernel(xx, w, cfg, seed,
                                  wgrad_cfg=wgrad_cfg).sum().backward()
        return xx.grad, w.grad

    dx, dw = grads_at(sr)
    dx_e, dw_e = grads_at(sr, wgrad_cfg=sr)
    assert torch.equal(dx, dx_e) and torch.equal(dw, dw_e)
    sr8 = sr.with_(mantissa_bits=8)
    assert not torch.equal(grads_at(sr, wgrad_cfg=sr8)[1], grads_at(sr8)[1])


@pytest.mark.parametrize("tile", [24, 128])
def test_narrow_with_stats_equals_narrow_per_slice(tile):
    """The shell's streams: a stacked leaf's slice i draws from
    fold_in(param_fold(key, name), i), whether narrowed whole, slice by
    slice, or through B7 with its stats; the wide update of slice i
    alone rounds as the whole leaf's widening does."""
    from repro_torch.numerics import narrow_params_with_stats
    arch = get_arch("gemma2-2b").smoke()
    params = init_params(0, arch, device="cpu")
    params = {k: ({n: t.float() for n, t in v.items()} if k == "layers"
                  else v.float()) for k, v in params.items()}
    cfg = HBFPConfig(4, 16, tile=tile, rounding="stochastic")
    key = fold_in(0, 99)
    narrow = opt_shell.narrow_params(params, cfg, key)
    with_stats, stats = narrow_params_with_stats(params, cfg, key)
    assert _leaves_equal(narrow, with_stats)
    assert set(stats) == {n for n, t in named_leaves(params)
                          if opt_shell.is_hbfp_weight(n, t)}
    name, leaf = "layers/ffn_wi", params["layers"]["ffn_wi"]
    for i in range(leaf.shape[0]):
        k = opt_shell.param_key(key, name, cfg, i)
        assert k == fold_in(opt_shell.param_fold(key, name), i)
        assert torch.equal(narrow["layers"]["ffn_wi"][i],
                           bfp.quantize_weight(leaf[i], cfg, k))
    wide = opt_shell.widen_params(params, cfg, key)
    upd = torch.zeros_like(leaf[1])
    one = leaf.clone()
    opt_shell.apply_update_(name, one, 1, upd, cfg, key)
    assert torch.equal(one[1], wide["layers"]["ffn_wi"][1])
    assert not torch.equal(wide["layers"]["ffn_wi"],
                           opt_shell.widen_params(params, cfg, key + 1)
                           ["layers"]["ffn_wi"])


def _leaves_equal(a, b) -> bool:
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_no_a5_refusal_remains_in_the_port():
    import pathlib
    import repro_torch
    root = pathlib.Path(repro_torch.__file__).parent
    hits = [str(p) for p in root.rglob("*.py")
            if "ROADMAP A5" in p.read_text()]
    assert hits == []
