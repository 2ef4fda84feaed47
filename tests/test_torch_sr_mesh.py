"""Stochastic rounding under a mesh: every rank draws the xorshift stream
at one process's element indices (`kernels.common.IndexBase`), on the
sim path (`core.bfp.quantize`), in B1-B3's and B7's plain versions, and
through `make_step(..., mesh=)` on gloo CPU ranks, the "pod" axis
included.

The index base alone (no ranks):

  * for random shapes, tiles, paddings and offsets (a head-dim offset
    and a part past 2^31 included), `bfp.quantize` of a part with its
    base is the whole operand's quantization, sliced, bit for bit, and
    the same part drawn at its own indices (no base) is not;
  * B1, B2, B3 and B7's plain versions on a data shard's rows and a
    column- or row-parallel block equal the whole operand's, sliced, bit
    for bit (B3's dequantized operands; its dw sums over the rows);
  * the same parts against the JAX package: the reference's oracles and
    Pallas kernels (interpret mode) on the whole operand, sliced;
  * `opt_shell._quantize_matrix` rounds a large matrix in blocks of tile
    rows under stochastic rounding too, bit-equal to the whole matrix.

The mesh runs: gemma2 smoke in f32 (B 4 × S 32, the CE in chunks of 64
tokens, so a {data 2} rank takes one chunk and a {pod 2, data 2} rank
half of one) under "8~stochastic" on the sim path (32-tiles) and the
kernel path's plain versions (64-tiles), 3 steps on the Trainer's keys,
on {data 2}, {data 1, model 2} (SP off and on) and {pod 2, data 2,
model 1}, and one step of llama4-scout smoke on {data 2} (its MoE groups
on the data axis) and {model 2} (its experts sharded on E), each held to
one process on the full batch:

  * step 1's narrow copy is one process's part bit for bit, and differs
    when each shard is drawn as a whole leaf;
  * every operand a product quantizes in step 1 (recorded by
    `torch_dist_worker.OperandRecorder`) whose raw part equals one
    process's (up to the DP size's power of two: a rank's loss is the
    mean of its tokens) quantizes to one process's part bit for bit;
    that is every operand but the gradients of the vocab-parallel CE,
    which it computes in its own order;
  * 3 steps within `tests/test_torch_dp_train.py`'s f32 bounds (losses
    1e-5 relative, master 1e-5 and moments 1e-4 relative Frobenius);
    with grad_accum 2 on {data 2}; the Trainer on the pod mesh preempted
    at step 3 and resumed from its step-2 checkpoint bit for bit, the
    checkpoint loading in one process and in `repro.checkpoint`.

The ranks are `python tests/torch_dist_worker.py sr RANK N PORT DIR
MESH`, one mesh at a time. Summed case time under `-n 6 --dist loadfile`
beside the tier-1 run's other files: see CHANGES.md (the one-process
fixture pinned to one intra-op thread).
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.kernels.bfp_quantize import bfp_quantize_pallas
from repro.kernels.hbfp_matmul import (hbfp_dgrad_pallas,
                                       hbfp_matmul_pallas,
                                       hbfp_wgrad_pallas)
from repro.models import init_params as jinit_params
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import load_checkpoint
from repro_torch.core import HBFPConfig, bfp, opt_shell
from repro_torch.kernels import ref
from repro_torch.kernels.common import (IndexBase, flat_base, index_base,
                                        seed_from_key, uniform_from_index)
from repro_torch.train import init_train_state
from torch_dist_worker import (SR_CHUNK, SR_MESHES, STEPS, accum_batch,
                               arch_batch, batch, np_tree, sr_arch,
                               sr_policy, sr_run)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
# losses: `tests/test_torch_dp_train.py`'s f32 bound, and on the model
# axis's kernel path `tests/test_torch_tp_train.py`'s HBFP one (its
# row-parallel K-block partials add in another order); updates p3 - p0
# and moments: the HBFP bounds of both files (the f32 sum order of the
# FP leaves' gradients moves the clip factor's last ulp, and Adam's
# moments of the small norm scales carry it: 4.35e-5 relative in
# ln1_norm_scale on the sim path, where nearest rounding moved 6.4e-8)
TOL = dict(loss=1e-5, loss_tp_kernel=2e-3, updates=0.25, moments=0.1)
RUNS = {"d2": ("sim", "kernel"), "m2": ("sim", "sim_sp", "kernel"),
        "p2d2": ("sim", "kernel")}
CASES = [(m, r) for m, runs in RUNS.items() for r in runs]
CHUNKS = 4 * 32 // SR_CHUNK            # the CE's chunks of the global batch


# -- the index base alone --------------------------------------------------------

def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(
        rng.integers(-6, 6, shape[:-1] + (1,)))
    return torch.from_numpy((x * scale).astype(np.float32))


# (shape, tile_shape, part as (offset, size) per dim)
PARTS = (
    ((4, 6, 40), (1, 1, 8), ((2, 2), (0, 6), (0, 40))),          # DP rows
    ((4, 6, 40), (1, 1, None), ((0, 4), (0, 6), (16, 24))),      # row-parallel
    ((3, 4, 2, 5, 32), (1, 1, 1, 1, None),
     ((1, 2), (2, 2), (0, 2), (0, 5), (0, 32))),                 # heads
    ((50, 72), (24, 24), ((24, 24), (24, 48))),                  # weight tiles
    ((50, 70), (24, 24), ((0, 48), (48, 22))),                   # padded tile
    ((2, 48, 30), (1, 16, 16), ((1, 1), (16, 32), (0, 30))),     # experts
    ((8, 100), (1, 32), ((5, 3), (32, 64))),                     # act block
    ((6, 10, 12), (1, 1, None), ((2, 4), (3, 7), (0, 12))))      # inner dim


@pytest.mark.parametrize("i", range(len(PARTS)))
def test_quantize_part_equals_whole(i):
    shape, tile, part = PARTS[i]
    x = _x(shape, 40 + i)
    key = 0x1234567 + i
    whole = bfp.quantize(x, 4, tile, "stochastic", key)
    sl = tuple(slice(o, o + n) for o, n in part)
    # a row split over ranks takes its one exponent on the global row amax
    amax = x.abs().amax(-1, keepdim=True)[sl[:-1]] \
        if tile[-1] is None and part[-1][1] < shape[-1] else None
    got = bfp.quantize(x[sl], 4, tile, "stochastic", key, amax,
                       base=index_base(shape, [o for o, _ in part]))
    assert torch.equal(got, whole[sl])
    assert not torch.equal(bfp.quantize(x[sl], 4, tile, "stochastic", key,
                                        amax), whole[sl])


def test_quantize_part_wraps_int32():
    """A part of a one-process operand of 2^34 elements: its draws are the
    xorshift stream at the int32-wrapped global indices."""
    G = (1 << 17, 1 << 17)
    off = (70000, 256)
    x = _x((6, 64), 9)
    key = 4242
    got = bfp.quantize(x, 6, (1, None), "stochastic", key,
                       base=index_base(G, off))
    r = torch.arange(6, dtype=torch.int64)[:, None] + off[0]
    c = torch.arange(64, dtype=torch.int64)[None, :] + off[1]
    idx = ref._wrap_i32(r * G[1] + c)
    assert int((r * G[1] + c).max()) > 1 << 32
    delta = bfp.tile_scales(x, 6, (1, None))
    u = uniform_from_index(seed_from_key(key), idx)
    want = (torch.floor(x / delta + u).clamp(-31, 31) * delta)
    assert torch.equal(got, want)


KW = dict(mantissa_bits=6, stochastic=True, bm=16, bk=32, bn=32)
M, K, N = 64, 96, 128
# (rows, K block, N block) of each part: a data shard, a column and a
# row block, and a row block of a data shard
GEMM_PARTS = (((16, 48), (0, 96), (0, 128)), ((0, 64), (0, 96), (64, 64)),
              ((0, 64), (32, 64), (0, 128)), ((32, 32), (64, 32), (0, 128)))


def _gemm_operands(seed):
    return (_x((M, K), seed), _x((K, N), seed + 1, 0.1),
            _x((M, N), seed + 2, 0.01))


def _parts(p):
    (r0, nr), (k0, nk), (n0, nn) = p
    return (slice(r0, r0 + nr), slice(k0, k0 + nk), slice(n0, n0 + nn),
            r0, k0, n0)


@pytest.mark.parametrize("op", ["fwd", "dgrad", "wgrad", "b7"])
@pytest.mark.parametrize("p", range(len(GEMM_PARTS)))
def test_kernel_plain_part_equals_whole(op, p):
    """Each part with its 2-D base against the whole operand, sliced;
    with no base the part draws its own stream and differs."""
    x, w, g = _gemm_operands(60 + p)
    rs, ks, ns, r0, k0, n0 = _parts(GEMM_PARTS[p])
    xb = IndexBase((M, K), (r0, k0))
    wb = IndexBase((K, N), (k0, n0))
    gb = IndexBase((M, N), (r0, n0))
    xp, wp, gp = (x[rs, ks].contiguous(), w[ks, ns].contiguous(),
                  g[rs, ns].contiguous())
    if op == "fwd":
        # a K block contributes partial sums: compare Q(x)·Q(w) blocks
        whole = ref.hbfp_matmul_ref(x[rs], w[:, ns].contiguous(), 5, **KW,
                                    x_base=IndexBase((M, K), (r0, 0)),
                                    w_base=IndexBase((K, N), (0, n0)))
        want = ref.hbfp_matmul_ref(x, w, 5, **KW)[rs, ns]
        assert torch.equal(whole, want)
        got = ref.hbfp_matmul_ref(xp, wp, 5, **KW, x_base=xb, w_base=wb)
        blocks = [ref.hbfp_matmul_ref(
            x[rs, kb:kb + 32].contiguous(), w[kb:kb + 32, ns].contiguous(),
            5, **KW, x_base=IndexBase((M, K), (r0, kb)),
            w_base=IndexBase((K, N), (kb, n0)))
            for kb in range(k0, k0 + xp.shape[1], 32)]
        assert torch.equal(got, sum(blocks[1:], blocks[0]))
        own = ref.hbfp_matmul_ref(xp, wp, 5, **KW)
    elif op == "dgrad":
        got = ref.hbfp_dgrad_ref(g[rs].contiguous(), w[ks].contiguous(), 9,
                                 **KW, g_base=IndexBase((M, N), (r0, 0)),
                                 w_base=IndexBase((K, N), (k0, 0)))
        assert torch.equal(got, ref.hbfp_dgrad_ref(g, w, 9, **KW)[rs, ks])
        own = ref.hbfp_dgrad_ref(g[rs].contiguous(), w[ks].contiguous(), 9,
                                 **KW)
    elif op == "wgrad":
        _, xh, gh = ref.hbfp_wgrad_ref(x, g, 11, operands=True, **KW)
        _, pxh, pgh = ref.hbfp_wgrad_ref(xp, gp, 11, operands=True, **KW,
                                         x_base=xb, g_base=gb)
        assert torch.equal(pxh, xh[rs, ks]) and torch.equal(pgh, gh[rs, ns])
        _, oxh, ogh = ref.hbfp_wgrad_ref(xp, gp, 11, operands=True, **KW)
        got = torch.cat([pxh.flatten(), pgh.flatten()])
        own = torch.cat([oxh.flatten(), ogh.flatten()])
    else:
        kw = dict(mantissa_bits=5, tile_r=16, tile_c=32, stochastic=True,
                  with_stats=True)
        whole = ref.bfp_quantize_ref(x, 3, **kw)
        got = ref.bfp_quantize_ref(xp, 3, **kw, base=xb)
        assert torch.equal(got[0], whole[0][rs, ks])
        assert torch.equal(got[1], whole[1][r0 // 16:(r0 + xp.shape[0]) // 16,
                                            k0 // 32:(k0 + xp.shape[1]) // 32])
        got, own = got[0], ref.bfp_quantize_ref(xp, 3, **kw)[0]
    # the control, where the op's operands are a part and not the whole
    whole_op = {"fwd": r0 == 0 and rs.stop == M and ns.start == 0,
                "dgrad": r0 == 0 and rs.stop == M and k0 == 0
                and ks.stop == K, "wgrad": tuple(xp.shape) == (M, K)
                and tuple(gp.shape) == (M, N), "b7": tuple(xp.shape) == (M, K)}
    if not whole_op[op]:
        assert not torch.equal(got, own)


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("op", ["fwd", "dgrad", "wgrad", "b7"])
def test_parts_match_jax_reference(op):
    """The port's plain version on a shard with its base against the JAX
    package on the whole operand, sliced: the oracle and the Pallas
    kernel in interpret mode for B1, B2 and B7; for B3 its dequantized
    operands against the reference's quantizer, and dw within the f32
    bound of `tests/test_torch_hbfp_grads.py` (its M-block sums run in
    another order)."""
    x, w, g = _gemm_operands(90)
    seed = np.array([[0x2468ACE]], np.int32)
    tkw = dict(mantissa_bits=6, stochastic=True, bm=16, bk=32, bn=32)
    r0, k0, n0 = 16, 32, 64
    rs, ks, ns = slice(r0, r0 + 32), slice(k0, k0 + 64), slice(n0, n0 + 64)
    if op == "fwd":
        want = [np.asarray(jref.hbfp_matmul_ref(_j(x), _j(w), seed, **tkw)),
                np.asarray(hbfp_matmul_pallas(_j(x), _j(w), seed,
                                              interpret=True, **tkw))]
        got = ref.hbfp_matmul_ref(x[rs].contiguous(), w[:, ns].contiguous(),
                                  torch.from_numpy(seed), **tkw,
                                  x_base=IndexBase((M, K), (r0, 0)),
                                  w_base=IndexBase((K, N), (0, n0)))
        sl = (rs, ns)
        own = ref.hbfp_matmul_ref(x[rs].contiguous(), w[:, ns].contiguous(),
                                  torch.from_numpy(seed), **tkw)
    elif op == "dgrad":
        want = [np.asarray(jref.hbfp_dgrad_ref(_j(g), _j(w), seed, **tkw)),
                np.asarray(hbfp_dgrad_pallas(_j(g), _j(w), seed,
                                             interpret=True, **tkw))]
        got = ref.hbfp_dgrad_ref(g[rs].contiguous(), w[ks].contiguous(),
                                 torch.from_numpy(seed), **tkw,
                                 g_base=IndexBase((M, N), (r0, 0)),
                                 w_base=IndexBase((K, N), (k0, 0)))
        sl = (rs, ks)
        own = ref.hbfp_dgrad_ref(g[rs].contiguous(), w[ks].contiguous(),
                                 torch.from_numpy(seed), **tkw)
    elif op == "wgrad":
        dw, xh, gh = ref.hbfp_wgrad_ref(
            x[:, ks].contiguous(), g[:, ns].contiguous(),
            torch.from_numpy(seed), operands=True, **tkw,
            x_base=IndexBase((M, K), (0, k0)),
            g_base=IndexBase((M, N), (0, n0)))
        for a, q, stream, s in ((x, xh, jref.STREAM_X, ks),
                                (g, gh, jref.STREAM_G, ns)):
            C = a.shape[1]
            r = jax.lax.broadcasted_iota(jnp.int32, (M, 32), 0)
            c = jax.lax.broadcasted_iota(jnp.int32, (M, 32), 1)
            parts = []
            for c0 in range(0, C, 32):
                blk = _j(a[:, c0:c0 + 32].contiguous())
                qq, d = jref.quantize_block(
                    blk, 6, jref.row_group_amax(blk, 0), stochastic=True,
                    seed=jnp.int32(seed[0, 0]),
                    idx=r * C + (c0 + c) + jnp.int32(stream))
                parts.append(np.asarray(qq * d))
            assert np.array_equal(q.numpy(), np.concatenate(parts, 1)[:, s])
        want = np.asarray(jref.hbfp_wgrad_ref(_j(x), _j(g), seed, **tkw))
        pal = np.asarray(hbfp_wgrad_pallas(_j(x), _j(g), seed,
                                           interpret=True, **tkw))
        bound = 2 * M * 2.0 ** -24 * (np.abs(xh.numpy()).T
                                      @ np.abs(gh.numpy()))
        for other in (want, pal):
            assert np.all(np.abs(dw.numpy() - other[ks, ns]) <= bound)
        own = ref.hbfp_wgrad_ref(x[:, ks].contiguous(), g[:, ns].contiguous(),
                                 torch.from_numpy(seed), operands=True,
                                 **tkw)[1]
        assert not torch.equal(own, xh)
        return
    else:
        kw = dict(mantissa_bits=5, tile_r=16, tile_c=32, stochastic=True,
                  with_stats=False)
        want = [np.asarray(jref.bfp_quantize_ref(_j(x), int(seed[0, 0]),
                                                 **kw)[0]),
                np.asarray(bfp_quantize_pallas(_j(x), jnp.asarray(seed),
                                               interpret=True, **kw)[0])]
        got = ref.bfp_quantize_ref(x[rs, ks].contiguous(), int(seed[0, 0]),
                                   **kw, base=IndexBase((M, K), (r0, k0)))[0]
        sl = (rs, ks)
        own = ref.bfp_quantize_ref(x[rs, ks].contiguous(), int(seed[0, 0]),
                                   **kw)[0]
    for w_ in want:
        assert np.array_equal(got.numpy(), w_[sl])
    assert not torch.equal(got, own)


@pytest.mark.parametrize("rows,tile", [(1000, 128), (640, 24)])
def test_matrix_blocks_stochastic_equal_whole(rows, tile, monkeypatch):
    """`_quantize_matrix` rounds a large matrix in blocks of tile rows
    under stochastic rounding too (each block at its rows' index in the
    whole): bit-equal to the whole matrix, also as a shard with a base."""
    w = _x((rows, 300), rows, 0.05)
    c = HBFPConfig(8, 16, tile=tile, rounding="stochastic")
    monkeypatch.setattr(opt_shell, "_ROW_BLOCK_ELEMS", 300 * 3 * tile)
    for wide in (False, True):
        got = opt_shell.quantize_leaf(w, c, wide, 77)
        assert torch.equal(got, bfp.quantize_weight(w, c, 77, wide=wide))
        big = index_base((rows * 2, 300), (rows, 0))
        assert torch.equal(opt_shell.quantize_leaf(w, c, wide, 77, big),
                           bfp.quantize_weight(w, c, 77, wide=wide,
                                               base=big))


def test_flat_base_refuses_a_scattered_part():
    """A part whose rows are not one contiguous run of the one-process
    rows (a slice of an inner dim of several outer rows) is refused,
    never given another stream."""
    b = index_base((4, 6, 8), (0, 2, 0))
    with pytest.raises(ValueError, match="contiguous"):
        flat_base(b, (2, 2, 8), 8)
    assert flat_base(index_base((4, 6, 8), (2, 0, 0)), (2, 6, 8), 8) \
        == IndexBase((24, 8), (12, 0))
    assert flat_base(index_base((4, 6, 8), (3, 2, 0)), (1, 2, 8), 8) \
        == IndexBase((24, 8), (20, 0))


# -- the mesh runs -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results by mesh name: [rank 0's, ...]."""
    d = tmp_path_factory.mktemp("sr_mesh")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + 300
    res = {"dir": d}
    for name, pod, data, model in SR_MESHES:
        n, port = pod * data * model, _free_port()
        procs = [subprocess.Popen(
            [sys.executable, WORKER, "sr", str(r), str(n), str(port),
             str(d), name], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=max(1.0, deadline
                                              - time.monotonic()))
                    for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-4000:]
        res[name] = []
        for r in range(n):
            with open(d / f"sr_{name}_{r}.pkl", "rb") as f:
                res[name].append(pickle.load(f))
    return res


def _single(a, pol, steps, data, record=False, **kw):
    losses, st, _, rec = sr_run(a, pol, steps, data, record=record, **kw)
    return dict(losses=losses, params=np_tree(st.params),
                mu=np_tree(st.opt.mu), nu=np_tree(st.opt.nu),
                records=None if rec is None else rec.records)


@pytest.fixture(scope="module")
def single():
    """One process on the full batch, on one intra-op thread (as
    `tests/test_torch_tp_train.py`'s fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = sr_arch()
        la = sr_arch("llama4-scout-17b-a16e")
        return dict(
            init=np_tree(init_train_state(0, a, device="cpu").params),
            init_llama4=np_tree(init_train_state(0, la,
                                                 device="cpu").params),
            sim=_single(a, sr_policy(), STEPS, batch, record=True),
            kernel=_single(a, sr_policy("pallas"), STEPS, batch,
                           record=True),
            accum=_single(a, sr_policy(), 1, accum_batch, grad_accum=2),
            llama4=_single(la, sr_policy(), 1, lambda i: arch_batch(la, i)))
    finally:
        torch.set_num_threads(n)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, init, loss_tol=TOL["loss"]):
    assert np.allclose(got["losses"], want["losses"], rtol=loss_tol,
                       atol=0), (got["losses"], want["losses"])
    worst = {}
    for what, tol in (("params", TOL["updates"]), ("mu", TOL["moments"]),
                      ("nu", TOL["moments"])):
        assert set(got[what]) == set(want[what])
        for n, a in got[what].items():
            b = want[what][n]
            rel = _rel(a - init[n], b - init[n]) if what == "params" \
                else _rel(a, b)
            assert rel <= tol, (what, n, rel)
            worst[what] = max(worst.get(what, 0.0), rel)
    print(f"worst relative: {worst}")


def _match(mine, whole):
    """(matched, mismatched, unmatched) records of a rank against one
    process's: a record matches one of one process's with its key whose
    raw operand, sliced at the part's offset, equals the rank's up to a
    power of two (the rank's loss is the mean over its own tokens); it
    is mismatched when its quantized part then differs from the slice of
    one process's."""
    by = defaultdict(list)
    for key, raw, out, _ in whole:
        by[key].append((raw, out))
    counts = [0, 0, 0]
    for key, raw, out, base in mine:
        off = (0,) * raw.ndim if base is None else base[1]
        sl = tuple(slice(o, o + d) for o, d in zip(off, raw.shape))
        hit = None
        for wr, wo in by[key]:
            if wr.ndim != raw.ndim or any(s.stop > d for s, d in
                                          zip(sl, wr.shape)):
                continue
            f = next((f for f in (1.0, 2.0, 4.0)
                      if np.array_equal(wr[sl] * f, raw)), None)
            if f is not None:
                hit = wo[sl] * f
                break
        if hit is None:
            counts[2] += 1
        else:
            counts[0 if np.array_equal(hit, out) else 1] += 1
    return counts


@pytest.mark.parametrize("mesh,run", CASES, ids=[f"{m}-{r}" for m, r in CASES])
def test_step1_narrow_copy_and_operands_exact(runs, single, mesh, run):
    whole = single["kernel" if run == "kernel" else "sim"]["records"]
    head_grads = 0
    for r, res in enumerate(runs[mesh]):
        got = res["runs"][run]
        assert got["narrow"]["equal"], (mesh, run, r)
        # None: no shard keeps whole tiles at an offset (p2d2's kernel
        # path: D = 128 over four ranks cuts every 64-tile)
        assert got["narrow"]["differs_without_base"] in (
            True, None if r == 0 or (mesh, run) == ("p2d2", "kernel")
            else True), (mesh, run, r)
        matched, bad, unmatched = _match(got["records"], whole)
        assert bad == 0 and matched > 0, (mesh, run, r, matched, bad)
        if mesh == "m2":
            # the vocab-parallel CE's gradients, one a CE chunk: the
            # head's dgrad and wgrad g (kernel path), its g (sim path)
            head_grads = CHUNKS * (2 if run == "kernel" else 1)
        assert unmatched == head_grads, (mesh, run, r, unmatched)
        if r > 0 and run != "kernel":
            # the control: drawn at their own indices the parts differ
            assert not all(got["baseless_equal"]), (mesh, run, r)
    assert runs[mesh][0]["runs"][run]["n"] == (4 if mesh == "p2d2" else
                                               2 if mesh == "d2" else 1)


@pytest.mark.parametrize("mesh,run", CASES, ids=[f"{m}-{r}" for m, r in CASES])
def test_steps_match_one_process(runs, single, mesh, run):
    got = runs[mesh][0]["runs"][run]
    tol = TOL["loss_tp_kernel"] if (mesh, run) == ("m2", "kernel") \
        else TOL["loss"]
    _close(got, single["kernel" if run == "kernel" else "sim"],
           single["init"], tol)
    for res in runs[mesh][1:]:
        assert res["runs"][run]["losses"] == got["losses"]


def test_pod_axis_is_data_parallel(runs):
    """{pod 2, data 2}: the data axes flatten pod-major into one group of
    four, whose rank is the global rank."""
    for r, res in enumerate(runs["p2d2"]):
        got = res["runs"]["sim"]
        assert got["axis"] == ("pod", "data") and got["n"] == 4
        assert got["rank"] == r and got["rank_m"] == 0


def test_grad_accum_matches_one_process(runs, single):
    _close(runs["d2"][0]["accum"], single["accum"], single["init"])


@pytest.mark.parametrize("mesh", ["d2", "m2"])
def test_llama4_experts_match_one_process(runs, single, mesh):
    """llama4-scout smoke: on {data 2} each rank routes its own whole
    MoE groups (one of two), with the load-balance loss on the global
    means; on {model 2} the experts are sharded on E."""
    got = runs[mesh][0]["llama4"]
    _close(got, single["llama4"], single["init_llama4"])
    assert runs[mesh][1]["llama4"]["losses"] == got["losses"]


def test_pod_trainer_resume_and_cross_load(runs):
    """The Trainer on {pod 2, data 2} (seed `SR_SEED`) preempted at step 3
    and resumed from its step-2 checkpoint equals the uninterrupted run
    bit for bit on every rank; the checkpoint, written whole by rank 0,
    loads in one process and in the reference."""
    for res in runs["p2d2"]:
        assert res["preempted"] == "simulated preemption at step 3"
        assert res["resumed_from"] == 2 and res["resume_exact"]
    want = runs["p2d2"][0]["final"]
    ckpt = runs["p2d2"][0]["ckpt"]
    a = sr_arch()
    state, meta = load_checkpoint(ckpt, init_train_state(0, a,
                                                         device="cpu"))
    assert meta["step"] == 4
    for tree, key in ((state.params, "params"), (state.opt.mu, "mu"),
                      (state.opt.nu, "nu")):
        for n, v in np_tree(tree).items():
            assert np.array_equal(v, want[key][n]), (key, n)
    ja = dataclasses.replace(jget_arch("gemma2-2b").smoke(), dtype="float32")
    jstate = jinit_train_state(jax.random.key(0), ja, jinit_params)
    jrestored, _ = jload(ckpt, jstate)
    flat = jax.tree_util.tree_flatten_with_path(jrestored.params)[0]
    for p, v in flat:
        name = "/".join(str(k.key) for k in p)
        assert np.array_equal(np.asarray(v), want["params"][name]), name
    assert int(jrestored.step) == 4
