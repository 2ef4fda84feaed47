"""The port's public GEMM wrappers (`repro_torch.kernels.ops`:
`hbfp_matmul`, `hbfp_dgrad`, `hbfp_wgrad`) against the reference's
(`repro.kernels.ops`, Pallas in interpret mode) at shapes that pad every
dim, with default (table-resolved) and explicit tiles, block 16 and
stochastic rounding from one seed. On the CPU the wrappers run B1-B3's
plain versions. B1 and B2 are held bit for bit at block 0 (integral
mantissas give exact block sums) and within 1e-6 of the output's largest
magnitude at block 16 (dequantized f32 dots summed in another order),
the tolerances of tests/test_torch_hbfp_matmul.py and
tests/test_torch_hbfp_grads.py; B3 sums tokens with varying scales in f32
in another order and is held within 1e-6 of its largest magnitude, as the
autograd test there holds dw.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import autotune
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.kernels import ops as tops

SEED = 7
# (name, keyword arguments): tiles resolved from the (empty) table,
# explicit tiles that pad K and N, block 16 inside explicit tiles, and
# stochastic rounding on the resolved tiles
CONFIGS = (("default", {}),
           ("explicit", dict(bm=64, bk=64, bn=32)),
           ("block16", dict(block=16, bm=64, bk=64, bn=32)),
           ("stochastic", dict(stochastic=True)))


def _check(got, want, block, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if block == 0 and not rel:
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _seed(kw):
    return SEED if kw.get("stochastic") else None


@pytest.mark.parametrize("name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_matmul_matches_reference(name, kw):
    """[2, 3, 50, 96] @ [96, 72]: leading dims flattened into M = 300,
    padded to the tiles (128 rows by default) and sliced back."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 50, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 72)) * 0.1).astype(np.float32)
    want = jops.hbfp_matmul(jnp.asarray(x), jnp.asarray(w), _seed(kw), **kw)
    hm.reset_counts()
    got = tops.hbfp_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           _seed(kw), **kw)
    assert hm.hbfp_matmul_fwd.plain_calls == 1
    _check(got.numpy(), want, kw.get("block", 0))


@pytest.mark.parametrize("name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_dgrad_and_wgrad_match_reference(name, kw):
    """[100, 200] @ [200, 72]: dgrad dx = Q(g)·Q(w)ᵀ and wgrad
    dw = Q(x)ᵀ·Q(g) with M, K and N all padded."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((100, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 72)) * 0.1).astype(np.float32)
    g = rng.standard_normal((100, 72)).astype(np.float32)
    jd = jops.hbfp_dgrad(jnp.asarray(g), jnp.asarray(w), _seed(kw), **kw)
    jw = jops.hbfp_wgrad(jnp.asarray(x), jnp.asarray(g), _seed(kw), **kw)
    td = tops.hbfp_dgrad(torch.from_numpy(g), torch.from_numpy(w),
                         _seed(kw), **kw)
    tw = tops.hbfp_wgrad(torch.from_numpy(x), torch.from_numpy(g),
                         _seed(kw), **kw)
    _check(td.numpy(), jd, kw.get("block", 0))
    _check(tw.numpy(), jw, kw.get("block", 0), rel=True)


def test_explicit_tiles_are_clipped_and_none_resolves_from_table(
        tmp_path, monkeypatch):
    """Explicit tiles larger than the problem clip to it (one tile); a
    None tile takes the table's entry for the logical shape, the others
    stay as given."""
    monkeypatch.setenv(autotune.TABLE_ENV, str(tmp_path / "t.json"))
    autotune.invalidate_cache()
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((100, 200)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((200, 72)) * 0.1)
                         .astype(np.float32))
    whole = hm.hbfp_matmul_plain(x, w, bm=100, bk=200, bn=72)
    assert torch.equal(tops.hbfp_matmul(x, w, bm=512, bk=512, bn=512),
                       whole)
    t = autotune.TuningTable.load()
    t.put(autotune.cache_key("matmul_fwd", 100, 200, 72, "float32", 8),
          (32, 64, 32))
    t.save()
    autotune.invalidate_cache()
    tuned = tops.hbfp_matmul(x, w)
    assert torch.equal(tuned, tops.hbfp_matmul(x, w, bm=32, bk=64, bn=32))
    assert not torch.equal(tuned, whole)
    # bk pinned at 200, bm and bn from the table
    assert torch.equal(tops.hbfp_matmul(x, w, bk=200),
                       tops.hbfp_matmul(x, w, bm=32, bk=200, bn=32))
    autotune.invalidate_cache()
