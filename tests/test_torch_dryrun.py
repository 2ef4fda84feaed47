"""The port's dry run (`repro_torch.launch.dryrun`) on PyTorch's fake
process group, against the reference's (`repro.launch.dryrun`) without
an XLA compile.

  * argument bytes, every cell: for all 10 archs × 4 shapes × the single
    and multi-pod production meshes, the per-device bytes of the port's
    cell arguments (built on fake tensors as rank 0 of the fake group)
    equal the reference's, computed from its specs over `jax.eval_shape`
    trees on a duck-typed mesh (`master_param_specs` and
    `opt_state_specs` for training, `fwd_param_specs` and `cache_specs(
    seq_shard=True)` for serving, `batch_specs` for the batch), plus, leaf
    by leaf, each leaf the port's layouts keep whole with its reason
    (`tp_layout`'s tile and head rules, `ep_only`, the replicated
    recurrent mixers' states). The reference's two int32 step counters
    and its PRNG key are host ints in the port and are not counted;
  * `applicable` and the skip reason equal the reference's;
  * whole cells on the fake group at the production mesh: yi-9b
    `train_4k` and llama4-scout `prefill_32k` with `ep_only` (the
    roofline track, at 1 and 2 layers here for time; their memory
    track at full depth takes 71 and 123 s on fake tensors here, and is
    left to the CLI's `--all` run), yi-9b `decode_32k` (the cache's ring
    sharded over "model") and xlstm-350m's on the multi-pod mesh (both
    tracks), a `long_500k` skip, each record with the reference's keys,
    rendered by `analysis.report.render_dryrun`;
  * `collective_bytes_from_records` on records equal to
    `tests/test_roofline.py::test_collective_parser`'s HLO lines gives
    that test's bytes;
  * the CLI writes `--out` and resumes from it.
"""
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import sharding as jsh
from repro.configs import arch_ids as jarch_ids
from repro.configs import get_arch as jget_arch
from repro.launch import dryrun as jdry
from repro.models import init_params as jinit_params
from repro.models import make_cache as jmake_cache
from repro.train import init_train_state as jinit_train_state
from repro_torch.analysis import report
from repro_torch.analysis.roofline import collective_bytes_from_records
from repro_torch.configs import get_arch
from repro_torch.core.formats import HBFP8_16
from repro_torch.launch import dryrun

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Duck-typed mesh: the reference's partitioning reads .shape and
    .axis_names."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jname(path) -> str:
    keys = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                keys.append(str(getattr(k, attr)))
                break
    return "/".join(keys)


def _leaf_bytes(tree, specs, mesh, extra=None, prefix=""):
    """Per-device bytes of a shape tree under its specs; `extra` {leaf
    name: reason}: leaves the port keeps whole over "model" (their
    "model" entry counts as replicated)."""
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sp = dict((_jname(p), s) for p, s in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0])
    total = 0
    for path, leaf in leaves:
        name = _jname(path)
        n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
        for axis in sp[name]:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is None or (a == "model" and extra and
                                 prefix + name in extra):
                    continue
                n //= mesh.shape[a]
        total += n
    return total


def _batch_bytes(arch, kind, batch, seq, mesh):
    """The reference's `_batch_struct` shapes, per device."""
    dt = jnp.dtype(arch.dtype)
    pos_len = 1 if kind == "decode" else seq
    shapes = {}
    if arch.input_kind == "embeddings":
        shapes["embeds"] = jax.ShapeDtypeStruct((batch, pos_len,
                                                 arch.d_model), dt)
    elif arch.n_codebooks > 1:
        shapes["tokens"] = jax.ShapeDtypeStruct(
            (batch, pos_len, arch.n_codebooks), jnp.int32)
    else:
        shapes["tokens"] = jax.ShapeDtypeStruct((batch, pos_len), jnp.int32)
    shapes["positions"] = jax.ShapeDtypeStruct(
        (3, batch, pos_len) if arch.mrope else (batch, pos_len), jnp.int32)
    if kind == "train":
        shapes["labels"] = jax.ShapeDtypeStruct(
            (batch, pos_len, arch.n_codebooks) if arch.n_codebooks > 1
            else (batch, pos_len), jnp.int32)
    return _leaf_bytes(shapes, jsh.batch_specs(shapes, mesh), mesh)


@functools.lru_cache(maxsize=None)
def _trees(name, what, *args):
    """The reference's shape trees of an arch, once a module: its params,
    its train state, or its decode cache of (batch, ctx)."""
    arch = jget_arch(name)
    if what == "params":
        return jax.eval_shape(lambda s: jinit_params(jax.random.key(s),
                                                     arch), 0)
    if what == "state":
        return jax.eval_shape(lambda s: jinit_train_state(
            jax.random.key(s), arch, jinit_params), 0)
    return jax.eval_shape(lambda s: jmake_cache(
        jinit_params(jax.random.key(s), arch), arch, *args), 0)


def _reference_bytes(name, shape, multi, replicated):
    """The reference's per-device argument bytes of a cell (its state or
    parameters, batch and cache), with the port's listed replications."""
    arch = jget_arch(name)
    mesh = FakeMesh(MESHES[multi])
    sh = jdry.SHAPES[shape]
    kind = sh["kind"]
    params = _trees(name, "params")
    if kind == "train":
        state = _trees(name, "state")
        pspecs = jsh.master_param_specs(state.params, mesh)
        rep = replicated["params"]
        n = _leaf_bytes(state.params, pspecs, mesh, rep)
        n += 2 * _leaf_bytes(state.opt.mu, pspecs, mesh, rep)
        return n + _batch_bytes(arch, kind, sh["batch"], sh["seq"], mesh)
    dt = jnp.dtype(arch.dtype)
    p = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
        l.shape, dt if l.ndim >= 2 else l.dtype), params)
    n = _leaf_bytes(p, jsh.fwd_param_specs(
        p, mesh, ep_only=kind == "prefill" and name.startswith("llama4")),
        mesh, replicated["params"])
    if kind == "prefill":
        return n + _batch_bytes(arch, kind, sh["batch"], sh["seq"], mesh)
    cache = _trees(name, "cache", sh["batch"], sh["ctx"])
    n += _leaf_bytes(cache, jsh.cache_specs(cache, mesh, seq_shard=True),
                     mesh, replicated["cache"])
    return n + _batch_bytes(arch, kind, sh["batch"], 1, mesh)


@pytest.fixture(scope="module")
def fake_world():
    """The fake process group, restarted per world size by the dry run;
    torn down after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cell(name, shape, multi):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = dryrun._mesh(multi)
    opts = {"ep_only": True} if shape == "prefill_32k" and \
        name.startswith("llama4") else None
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = dryrun.build_cell(get_arch(name), shape, mesh, HBFP8_16,
                                 opts, device="cpu")
        return dryrun.tree_bytes(cell.arguments), cell.replicated


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape", list(jdry.SHAPES))
def test_argument_bytes_match_reference(fake_world, shape, multi):
    for name in jarch_ids():
        got, replicated = _cell(name, shape, multi)
        replicated = {"params": replicated["params"],
                      "cache": replicated.get("cache", {})}
        want = _reference_bytes(name, shape, multi, replicated)
        assert got == want, (name, shape, multi, got, want)


@pytest.mark.parametrize("shape", list(jdry.SHAPES))
def test_applicable_matches_reference(shape):
    for name in jarch_ids():
        assert dryrun.applicable(get_arch(name), shape) == \
            jdry.applicable(jget_arch(name), shape)
    assert dryrun.FULL_ATTENTION_SKIP == jdry.FULL_ATTENTION_SKIP
    assert dryrun.SHAPES == jdry.SHAPES


KEYS = {"arch", "shape", "mesh", "hbfp", "status", "opts", "memory",
        "roofline_ssm_chunk", "roofline_raw", "roofline"}


@pytest.fixture(scope="module")
def cells(fake_world):
    out = {}
    for name, shape, multi, opts, tracks, layers in (
            ("yi-9b", "train_4k", False, None, ("roofline",), (1, 2)),
            ("llama4-scout-17b-a16e", "prefill_32k", False,
             {"ep_only": True}, ("roofline",), (1, 2)),
            ("yi-9b", "decode_32k", False, None, ("memory", "roofline"),
             (2, 4)),
            ("yi-9b", "long_500k", False, None, ("memory", "roofline"),
             (2, 4)),
            ("xlstm-350m", "decode_32k", True, None,
             ("memory", "roofline"), (2, 4))):
        out[name, shape, multi] = dryrun.run_cell(
            name, shape, multi, HBFP8_16, tracks, roofline_layers=layers,
            opts=opts, device="cpu")
    return out


def test_whole_cells(cells, tmp_path, capsys):
    train = cells["yi-9b", "train_4k", False]
    pre = cells["llama4-scout-17b-a16e", "prefill_32k", False]
    dec = cells["yi-9b", "decode_32k", False]
    multi = cells["xlstm-350m", "decode_32k", True]
    for rec in (train, pre):
        assert set(rec) == KEYS - {"memory"}, set(rec) ^ KEYS
    for rec in (dec, multi):
        assert set(rec) == KEYS | {"trace_s"}, set(rec) ^ KEYS
    for rec in (train, pre, dec, multi):
        assert rec["status"] == "ok"
        r = rec["roofline"]
        assert r["n_chips"] == (512 if rec is multi else 256)
        assert r["hlo_flops_per_device"] > 0
        assert r["hlo_bytes_per_device"] > 0
    # ZeRO-1's data-axis reduce and gather; the ep_only prefill's experts
    # combine over "model"
    assert train["roofline_raw"]["collective_detail"]["all-gather"] > 0
    assert pre["roofline_raw"]["collective_detail"]["all-reduce"] > 0
    for rec in (dec, multi):
        m = rec["memory"]
        assert min(m["argument_bytes"], m["output_bytes"],
                   m["temp_bytes"]) > 0
        assert m["per_device_total_gib"] == round(
            (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"])
            / 2**30, 3)
    # the decode cell's sequence-sharded attention reduces over "model"
    detail = dec["roofline_raw"]["collective_detail"]
    assert detail.get("all-reduce", 0) > 0
    skip = cells["yi-9b", "long_500k", False]
    assert skip == {"arch": "yi-9b", "shape": "long_500k", "mesh": "single",
                    "status": "skipped",
                    "reason": dryrun.FULL_ATTENTION_SKIP}
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps({f"{r['arch']}|{r['shape']}|{r['mesh']}": r
                                for r in cells.values()}))
    report.render_dryrun(str(path))
    out = capsys.readouterr().out
    assert "cells: 4 ok / 1 skipped / 0 error" in out
    for rec in (train, pre, dec, multi):
        assert f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |" in out
    assert out.count("| yi-9b | decode_32k | single |") == 2   # both tables


def test_collective_bytes_from_records():
    """tests/test_roofline.py::test_collective_parser's HLO lines as
    transport records: f32[16,1024] all-gather over 4 (a payload of
    4 × 1024 f32 a rank), bf16[8,256] all-reduce over 8, f32[4,128]
    reduce-scatter over 2 (issued as an all-reduce of the whole f32[8,128]
    in the port: counted at the all-reduce's multiplier)."""
    recs = [("all_gather", 4 * 1024 * 4, 4, 0.0),
            ("all_reduce", 8 * 256 * 2, 8, 0.0)]
    r = collective_bytes_from_records(recs)
    ag = 16 * 1024 * 4 * 1.0 * (3 / 4)
    ar = 8 * 256 * 2 * 2.0 * (7 / 8)
    assert np.isclose(r["by_kind"]["all-gather"], ag)
    assert np.isclose(r["by_kind"]["all-reduce"], ar)
    assert np.isclose(r["total_bytes"], ag + ar)
    assert r["op_counts"] == {"all-gather": 1, "all-reduce": 1}
    rs = collective_bytes_from_records([("reduce_scatter", 8 * 128 * 4, 2,
                                         0.0)])
    assert np.isclose(rs["by_kind"]["all-reduce"], 8 * 128 * 4 * 2.0 / 2)
    assert collective_bytes_from_records([])["total_bytes"] == 0


def test_cli_writes_and_resumes(fake_world, tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "yi-9b", "--shape", "long_500k", "--mesh", "both",
            "--device", "cpu", "--out", str(out)]
    dryrun.main(argv)
    got = json.loads(out.read_text())
    assert set(got) == {"yi-9b|long_500k|single", "yi-9b|long_500k|multi"}
    assert got["yi-9b|long_500k|single"]["reason"] == \
        jdry.FULL_ATTENTION_SKIP
    assert all(r["status"] == "skipped" for r in got.values())
    first = capsys.readouterr().out
    assert "done: 0 ok, 2 skipped, 0 errors" in first
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                 "--mesh", "single", "--tracks", "memory", "--device", "cpu",
                 "--out", str(out)])
    dryrun.main(argv)
    again = capsys.readouterr().out
    assert again.count("[cached]") == 2
    got = json.loads(out.read_text())
    assert got["xlstm-350m|decode_32k|single"]["status"] == "ok"
    assert "done: 1 ok, 2 skipped, 0 errors" in again
    report.render_dryrun(str(out))
    assert "| xlstm-350m | decode_32k | single |" in capsys.readouterr().out
