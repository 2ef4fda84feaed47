"""The port's BFP-compressed gradient reduction
(`repro_torch.core.grad_compress`) against the reference's
(`repro.core.grad_compress`).

  * `compress` / `decompress` bit-equal to the reference's at m 8 and 12,
    for 1-, 2- and 3-D leaves, a row length that is no multiple of the
    512-element tile among them (the port packs through B7's plain
    version on the CPU);
  * error feedback: residual + decompress(packed) == g exactly, and the
    residual equals the reference's bit for bit;
  * `compressed_psum_tree` over 2 and 4 gloo CPU ranks (one process
    each, started once for the module) against the reference's under
    `shard_map` on 2 and 4 forced host devices, in a subprocess as
    `tests/test_sharding.py` runs it, from the same inputs and nonzero
    residuals. Tolerance: bit-equal at N = 2 (both sum the two ranks'
    dequantized payloads once); at N = 4 XLA's reduction order over the
    stacked ranks may differ from the port's rank order, so within
    N·2⁻²⁴ of the summed magnitudes. The new residuals are bit-equal at
    every N (each is local to its rank).

The ranks are `python tests/torch_dist_worker.py compress RANK N PORT
DIR`.
"""
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grad_compress as jgc
from repro_torch.core import grad_compress as tgc
from torch_dist_worker import MBITS, SHAPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
RANKS = (2, 4)


def _leaf(rng, shape):
    """Normals with the scale spread over rows, so tiles take many
    exponents (and some tiny ones flush)."""
    x = rng.standard_normal(shape).astype(np.float32)
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    scale = 10.0 ** rng.uniform(-6, 3, size=(rows, 1)).astype(np.float32)
    return (x.reshape(rows, -1) * scale).reshape(shape)


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    out = {}
    for k, s in SHAPES.items():
        out["g:" + k] = np.stack([_leaf(rng, s) for _ in range(n)])
        out["r:" + k] = np.stack([_leaf(rng, s) * 1e-3 for _ in range(n)])
    return out


@pytest.mark.parametrize("m", [8, 12])
@pytest.mark.parametrize("name", list(SHAPES))
def test_compress_matches_reference(name, m):
    x = _leaf(np.random.default_rng(7), SHAPES[name])
    jp = jgc.compress(jnp.asarray(x), m)
    tp = tgc.compress(torch.from_numpy(x), m)
    assert tp.tile_shape == tuple(jp.tile_shape)
    assert tp.shape == tuple(jp.shape)
    assert np.array_equal(tp.mantissa.numpy(), np.asarray(jp.mantissa))
    assert tp.mantissa.dtype == (torch.int8 if m <= 8 else torch.int16)
    assert np.array_equal(tp.exponent.numpy(), np.asarray(jp.exponent))
    got = tgc.decompress(tp).numpy()
    assert np.array_equal(got, np.asarray(jgc.decompress(jp)))
    assert np.abs(got - x).max() <= np.abs(x).max() * 2.0 ** (2 - m)


@pytest.mark.parametrize("name", list(SHAPES))
def test_error_feedback_is_exact(name):
    g = _leaf(np.random.default_rng(8), SHAPES[name])
    tg = torch.from_numpy(g)
    p = tgc.compress(tg, MBITS)
    resid = tg - tgc.decompress(p)
    assert torch.equal(tgc.decompress(p) + resid, tg)
    jp = jgc.compress(jnp.asarray(g), MBITS)
    jres = jnp.asarray(g) - jgc.decompress(jp)
    assert np.array_equal(resid.numpy(), np.asarray(jres))


_REFERENCE = """
import sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.grad_compress import compressed_psum_tree
d = dict(np.load(sys.argv[1]))
n = int(sys.argv[2])
mesh = jax.make_mesh((n,), ('data',))
if hasattr(jax, 'shard_map'):
    smap = partial(jax.shard_map, check_vma=False)
else:
    from jax.experimental.shard_map import shard_map
    smap = partial(shard_map, check_rep=False)
names = sorted(k[2:] for k in d if k.startswith('g:'))
g = {k: jnp.asarray(d['g:' + k]) for k in names}
r = {k: jnp.asarray(d['r:' + k]) for k in names}
@partial(smap, mesh=mesh, in_specs=(P('data'), P('data')),
         out_specs=(P('data'), P('data')))
def red(gs, rs):
    gs = jax.tree.map(lambda x: x[0], gs)
    rs = jax.tree.map(lambda x: x[0], rs)
    out, res = compressed_psum_tree(gs, 'data', mantissa_bits=%d,
                                    residual=rs)
    return (jax.tree.map(lambda x: x[None], out),
            jax.tree.map(lambda x: x[None], res))
out, res = jax.jit(red)(g, r)
np.savez(sys.argv[3], **{'o:' + k: np.asarray(out[k]) for k in names},
         **{'res:' + k: np.asarray(res[k]) for k in names})
print('OK')
""" % MBITS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' reduces at every N, started together: the
    reference's subprocess and the port's N gloo ranks."""
    d = tmp_path_factory.mktemp("grad_compress")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = []
    for n in RANKS:
        inp = d / f"in{n}.npz"
        np.savez(inp, **_inputs(n))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(inp), str(n),
             str(d / f"ref{n}.npz")], cwd=ROOT,
            env={**env, "XLA_FLAGS":
                 f"--xla_force_host_platform_device_count={n}"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        port = _free_port()
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, "compress", str(r), str(n),
                 str(port), str(d)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    return d


@pytest.mark.parametrize("n", RANKS)
def test_compressed_psum_matches_reference(runs, n):
    inp = dict(np.load(runs / f"in{n}.npz"))
    ref = dict(np.load(runs / f"ref{n}.npz"))
    for r in range(n):
        got = dict(np.load(runs / f"port{n}_{r}.npz"))
        for k in SHAPES:
            want = ref["o:" + k][r]
            if n == 2:
                assert np.array_equal(got["o:" + k], want), k
            else:
                mags = sum(np.abs(tgc.decompress(tgc.compress(
                    torch.from_numpy(inp["g:" + k][q] + inp["r:" + k][q]),
                    MBITS)).numpy()) for q in range(n))
                assert np.all(np.abs(got["o:" + k] - want)
                              <= n * 2.0 ** -24 * mags), k
            assert np.array_equal(got["res:" + k], ref["res:" + k][r]), k
            # within the compression's error of the plain mean
            mean = inp["g:" + k].mean(axis=0)
            rel = np.abs(got["o:" + k] - mean).max() / np.abs(mean).max()
            assert rel < 0.02, (k, rel)


@pytest.mark.parametrize("n", RANKS)
def test_wire_bytes_are_int8(runs, n):
    """The port's collectives: two all-gathers a leaf (int8 mantissas,
    int8 exponents), each of the padded leaf's bytes and one byte per
    512-element tile."""
    got = dict(np.load(runs / f"port{n}_0.npz"))
    kinds, nbytes = got["kinds"], got["bytes"]
    assert set(kinds.tolist()) == {"all_gather"}
    want = 0
    for s in SHAPES.values():
        padded = int(np.prod(s[:-1])) * -(-s[-1] // 512) * 512
        want += padded + padded // 512
    assert int(nbytes.sum()) == want
