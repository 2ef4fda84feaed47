"""The tuning table of the port (`repro_torch.kernels.autotune`) against
the reference's (`repro.kernels.autotune`).

* Keys, clipping, block alignment and the candidate list equal the
  reference's at clipped and unclipped shapes, blocks 0/16/32 (the port
  drops the reference's TPU VMEM filter, which drops no menu triple).
* One table drives both packages: a table either package writes is read
  by the other, byte for byte the same JSON, and `lookup` gives equal
  tiles; a corrupt file counts as untuned in both.
* `autotune_op` on the CPU (menu (32, 64), n=1) records the winner, saves,
  invalidates the cache and emits "autotune/search" and "autotune/winner"
  with the reference's fields.
* One table, same numbers: a table with non-default tiles for one shape
  drives both packages' `resolve_spec` to equal specs and both
  `hbfp_matmul_kernel`s (the reference's Pallas kernels in interpret mode)
  to equal y and dx (bit for bit) and dw (within 1e-6 of its largest
  magnitude, the tolerance of tests/test_torch_hbfp_grads.py), with the
  table and without it.

Every test that touches the table sets REPRO_AUTOTUNE_TABLE itself.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jfmt
from repro.kernels import autotune as jat
from repro.kernels import linear as jlinear
from repro.obs import MemorySink as JMemorySink
from repro.obs import Recorder as JRecorder
from repro_torch.core import HBFPConfig
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import linear as tlinear
from repro_torch.kernels import ops as tops
from repro_torch.obs import MemorySink, Recorder

SHAPES = ((8, 4096, 4096), (64, 64, 64), (100, 200, 72), (4096, 2304, 2048),
          (1, 24, 300), (256, 32, 33))


@pytest.fixture
def table_env(tmp_path, monkeypatch):
    """Both packages' table at one temp path, caches dropped around the
    test."""
    path = str(tmp_path / "table.json")
    monkeypatch.setenv(tat.TABLE_ENV, path)
    tat.invalidate_cache()
    jat.invalidate_cache()
    yield path
    tat.invalidate_cache()
    jat.invalidate_cache()


def test_names_and_defaults_match_reference():
    assert tat.TABLE_ENV == jat.TABLE_ENV
    assert tat.TILE_MENU == jat.TILE_MENU
    assert tat.DEFAULT_TILES == jat.DEFAULT_TILES
    assert tat.DEFAULT_TABLE_PATH.endswith(
        os.path.join("results", "autotune_kernels_torch.json"))
    assert tat.DEFAULT_TABLE_PATH != jat.DEFAULT_TABLE_PATH


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_key_tiles_and_candidates_match_reference(shape):
    M, K, N = shape
    for op in ("matmul_fwd", "matmul_dgrad", "matmul_wgrad"):
        for dtype in ("float32", "bfloat16"):
            for m, block in ((8, 0), (4, 16), (12, 32)):
                assert tat.cache_key(op, M, K, N, dtype, m, block) == \
                    jat.cache_key(op, M, K, N, dtype, m, block)
    for tiles in ((128, 128, 128), (32, 256, 64), (4096, 1, 300)):
        assert tat.clip_tiles(tiles, M, K, N) == jat.clip_tiles(tiles, M, K,
                                                                N)
        for block in (0, 16, 32):
            t = tat.clip_tiles(tiles, M, K, N)
            assert tat.align_tiles(t, block) == jat.align_tiles(t, block)
    for menu in (tat.TILE_MENU, (32, 64)):
        assert tat.candidates(M, K, N, menu=menu) == \
            jat.candidates(M, K, N, menu=menu)


def test_dtype_name_is_the_reference_spelling():
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        assert tat.dtype_name(tdt) == str(jnp.zeros((), jdt).dtype)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_one_table_read_by_both_packages(table_env, writer):
    """Entries written by one package's TuningTable: the other reads the
    same tiles, lookup agrees in both (clipped), and both write the same
    bytes for the same entries."""
    entries = [(("matmul_fwd", 4096, 2304, 2048, "bfloat16", 8, 0),
                (64, 256, 128)),
               (("matmul_wgrad", 100, 200, 72, "float32", 4, 16),
                (256, 32, 32))]
    mod = jat if writer == "reference" else tat
    t = mod.TuningTable.load()
    for args, tiles in entries:
        t.put(mod.cache_key(*args), tiles, us=1.5, backend="x")
    t.save()
    with open(table_env, "rb") as f:
        written = f.read()
    for args, tiles in entries:
        op, M, K, N, dtype, m, block = args
        key = tat.cache_key(*args)
        assert tat.TuningTable.load().get(key) == tiles
        assert jat.TuningTable.load().get(key) == tiles
        kw = dict(dtype=dtype, mantissa_bits=m, block=block)
        assert tat.lookup(op, M, K, N, **kw) == \
            jat.lookup(op, M, K, N, **kw) == tat.clip_tiles(tiles, M, K, N)
        # another dtype or width is another cell
        assert tat.lookup(op, M, K, N, dtype="float16", mantissa_bits=m,
                          block=block) == tat.clip_tiles(tat.DEFAULT_TILES,
                                                         M, K, N)
    other = tat if writer == "reference" else jat
    t2 = other.TuningTable({k: dict(v) for k, v in
                            tat.TuningTable.load().entries.items()},
                           table_env)
    t2.save()
    with open(table_env, "rb") as f:
        assert f.read() == written


@pytest.mark.parametrize("content", [b"{not json", b'{"a": [1, 2', b""])
def test_corrupt_table_is_untuned(table_env, content):
    with open(table_env, "wb") as f:
        f.write(content)
    want = tat.clip_tiles(tat.DEFAULT_TILES, 100, 200, 72)
    assert tat.TuningTable.load().entries == {}
    assert tat.lookup("matmul_fwd", 100, 200, 72) == want
    assert jat.lookup("matmul_fwd", 100, 200, 72) == want


@pytest.mark.parametrize("content", [b"[1, 2, 3]", b"\xff\xfe"])
def test_non_object_table_and_entry_are_untuned(table_env, content):
    """A file that is not UTF-8 or not a {key: entry} object, or an entry
    without three tiles, counts as untuned (the port's load; the
    reference's raises on both files)."""
    with open(table_env, "wb") as f:
        f.write(content)
    assert tat.TuningTable.load().entries == {}
    assert tat.lookup("matmul_fwd", 64, 64, 64) == (64, 64, 64)
    key = tat.cache_key("matmul_fwd", 64, 64, 64, "float32", 8)
    t = tat.TuningTable({key: {"tiles": [32, 32]}, "x": 3})
    assert t.get(key) is None and t.get("x") is None


def test_table_is_loaded_once_per_path(table_env, tmp_path, monkeypatch):
    loads = []
    real = tat.TuningTable.load.__func__

    def counted(cls, path=None):
        loads.append(path)
        return real(cls, path)
    monkeypatch.setattr(tat.TuningTable, "load", classmethod(counted))
    for _ in range(5):
        tlinear.resolve_spec(HBFPConfig(8, 16), 64, 64, 64)
    assert loads == [table_env]
    other = str(tmp_path / "other.json")
    monkeypatch.setenv(tat.TABLE_ENV, other)
    tat.lookup("matmul_fwd", 64, 64, 64)
    tat.lookup("matmul_fwd", 64, 64, 64)
    assert loads == [table_env, other]


def test_autotune_op_events_and_report_match_reference(table_env):
    """Both packages' autotune_op on a trivial run_fn: the same report
    keys, the same event kinds and fields, the same table entry fields."""
    menu = (32, 64)
    jsink, tsink = JMemorySink(), MemorySink()
    _, jrep = jat.autotune_op(
        "matmul_fwd", lambda t: jnp.zeros(()), 64, 64, 64,
        table=jat.TuningTable(path=table_env + ".j"), menu=menu, n=1,
        save=False, recorder=JRecorder([jsink]))
    _, trep = tat.autotune_op(
        "matmul_fwd", lambda t: torch.zeros(()), 64, 64, 64,
        table=tat.TuningTable(path=table_env + ".t"), menu=menu, n=1,
        save=False, recorder=Recorder([tsink]))
    assert set(trep) == set(jrep)
    assert trep["n_candidates"] == jrep["n_candidates"] == 8
    assert trep["default_tiles"] == jrep["default_tiles"] == [64, 64, 64]
    assert trep["backend"] == "cpu"
    for kind in ("autotune/search", "autotune/winner"):
        (je,), (te,) = jsink.of_kind(kind), tsink.of_kind(kind)
        assert set(te.data) == set(je.data)
        if kind == "autotune/search":
            assert te.data == je.data


def test_autotune_op_on_cpu_records_saves_and_invalidates(table_env):
    """autotune_op over ops.hbfp_matmul on CPU tensors (the plain
    version): the winner lands in the saved table, the cache is dropped,
    and lookup and the ops wrapper then resolve the tuned tiles."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 64)) * 0.1)
                         .astype(np.float32))
    tat.lookup("matmul_fwd", 64, 64, 64)                 # cache the table
    sink = MemorySink()
    best, rep = tat.autotune_op(
        "matmul_fwd", lambda t: tops.hbfp_matmul(
            x, w, mantissa_bits=8, bm=t[0], bk=t[1], bn=t[2]),
        64, 64, 64, menu=(32, 64), n=1, recorder=Recorder([sink]))
    assert tuple(rep["tiles"]) == best and rep["speedup"] >= 1.0
    assert rep["backend"] == "cpu" and rep["n_candidates"] == 8
    assert tat._CACHED is None
    key = tat.cache_key("matmul_fwd", 64, 64, 64, "float32", 8)
    entry = tat.TuningTable.load(table_env).entries[key]
    assert entry["tiles"] == list(best)
    assert set(entry) == {"tiles", "us", "default_tiles", "default_us",
                          "speedup", "backend", "n_candidates"}
    assert tat.lookup("matmul_fwd", 64, 64, 64) == best
    assert torch.equal(tops.hbfp_matmul(x, w),
                       tops.hbfp_matmul(x, w, bm=best[0], bk=best[1],
                                        bn=best[2]))
    (win,) = sink.of_kind("autotune/winner")
    assert win.data["key"] == key and win.data["tiles"] == list(best)
    assert len(sink.of_kind("autotune/search")) == 1


# one shape, three non-default tilings (fwd, dgrad, wgrad); M = 150 pads
TUNED_SHAPE = (2, 75, 256, 192)
TUNED = {"matmul_fwd": (64, 64, 64), "matmul_dgrad": (32, 128, 64),
         "matmul_wgrad": (64, 128, 32)}


@pytest.mark.parametrize("tuned", [False, True], ids=["empty", "tuned"])
def test_one_table_same_numbers(table_env, tuned):
    B, S, K, N = TUNED_SHAPE
    M = B * S
    if tuned:
        t = tat.TuningTable.load()
        for op, tiles in TUNED.items():
            t.put(tat.cache_key(op, M, K, N, "float32", 8), tiles)
        t.save()
    tcfg, jcfg = HBFPConfig(8, 16), jfmt.HBFPConfig(8, 16)
    tspec = tlinear.resolve_spec(tcfg, M, K, N, dtype="float32")
    jspec = jlinear.resolve_spec(jcfg, M, K, N, dtype="float32")
    assert tuple(tspec) == tuple(jspec)
    want = TUNED if tuned else dict.fromkeys(TUNED, tat.DEFAULT_TILES)
    assert (tspec.fwd, tspec.dgrad, tspec.wgrad) == tuple(want.values())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((B, S, N)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jlinear.hbfp_matmul_kernel(a, b, jcfg),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = tlinear.hbfp_matmul_kernel(tx, tw, tcfg)
    ty.backward(torch.from_numpy(gy))
    assert np.array_equal(ty.detach().numpy(), np.asarray(y))
    assert np.array_equal(tx.grad.numpy(), np.asarray(jdx))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=1e-6 * float(np.abs(jdw).max()))
    if tuned:                                  # the table moved the numbers
        os.remove(table_env)
        tat.invalidate_cache()
        assert not torch.equal(tlinear.hbfp_matmul_kernel(
            torch.from_numpy(x), torch.from_numpy(w), tcfg), ty.detach())
