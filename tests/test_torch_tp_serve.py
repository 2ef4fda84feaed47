"""Sharded serving: prefill and decode on the reference's serving layouts
(`train.serve_step.ServeLayout`: the parameters on `tp_layout` (with
`ep_only` the experts alone), the batch over "data", the decode cache on
`sharding.partitioning.cache_layout`) on gloo CPU ranks, held against one
process of the port and against the reference's `prefill` and
`decode_step` (`repro.train.serve_step`'s stages over them, jitted) on
the reference's weights (`from_jax_params`).

Smoke archs in f32 under HBFP8 on the sim path with 32 × 32 weight tiles
(the layout then shards attention by heads where they divide), a prompt
of 4 × 8 tokens, the cache grown to a ring of 16 (hymba's below), then 4
decode ticks:

  * yi-9b on {data 1, model 2}: attention, FFN, embedding and head
    sharded, the cache on the local kv heads;
  * yi-9b on {data 1, model 4}: its 2 kv heads do not divide 4, so the
    attention is replicated and the ring's 16 slots are 4 a rank: the
    row-parallel attention over them (global max and sum of
    exponentials, PV's f32 partials summed), on the slab and the 8-bit
    cache; a ring of 8 (2 slots a rank) under 4-feature activation
    groups cuts the PV's groups other than whole: refused;
  * yi-9b on {data 2, model 2}: the batch rows over "data" too;
  * llama4-scout on {model 2} with `ep_only`: the experts sharded on E,
    everything else replicated, the cache on "heads" (the attention
    replicated, each rank attending its kv heads, gathered); and on
    {data 2, model 2} routing one MoE group over the global batch, which
    a data rank's tokens cut: the ranks gather the batch and route the
    global group (serving only);
  * hymba, a prompt of 24 tokens, longer than the smoke window of 16,
    grown to the ring of 32 one process holds: on {model 2} its 2 kv
    heads shard, and its sliding ring and its Mamba-2 state (replicated:
    the mixer's in-projection concatenates several parts) go through
    decode; on {model 4} the 2 kv heads do not divide 4, so the ring's
    slots split (8 a rank: the oldest prompt tokens on rank 0, the ticks
    on rank 3).

What each mesh holds:

  * bit for bit: the cache parts against one process's slices (every
    layer: a BFP operand absorbs the f32 order of the partial sums on
    these inputs); with the heads sharded, layer 0's q, k and v against
    one process's heads; with the sequence sharded, layer 0's scores of
    each tick against one process's columns of the rank's run;
  * yi-9b's prefill on {data 1, model 2} again with the reference's
    `seq_parallel` option (the residual stream's tokens split over
    "model");
  * the logits against one process within 1e-5 · max|one| (C18's f32
    order: a row-parallel product's partials, the attention's sum of
    exponentials) and against the reference within
    `tests/test_torch_serve.py`'s 2e-3 · max|ref| plus that term.

The ranks are `python tests/torch_dist_worker.py serve RANK N PORT DIR`:
one world of 2 and one of 4 ranks, started together, each taking its
meshes one at a time while the test process takes one process and the
reference.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.formats import HBFPConfig as JHBFPConfig
from repro.models import init_params as jinit_params
from repro.train import serve_step as jss
from repro_torch.models import from_jax_params
from repro_torch.train.serve_step import narrow_serving_params
from torch_dist_worker import (SERVE_B, SERVE_MESHES, SERVE_S, SERVE_TICKS,
                               SERVE_TILE, serve_arch, serve_cfg,
                               serve_dims, serve_inputs, serve_run)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
F32_TOL = 2e-3            # tests/test_torch_serve.py's f32 tolerance
ORDER_TOL = 1e-5          # C18: f32 partial sums in another order
MESHES = [m[0] for m in SERVE_MESHES]
ARCHS = sorted({m[1] for m in SERVE_MESHES})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's seeded f32 smoke weights of each arch, as numpy,
    written where the ranks read them."""
    d = tmp_path_factory.mktemp("tp_serve")
    out = {"dir": d}
    for name in ARCHS:
        ja = dataclasses.replace(jget_arch(name).smoke(), dtype="float32")
        tree = jax.tree.map(np.asarray, jinit_params(jax.random.key(0), ja))
        np.savez(d / f"w_{name}.npz", **_flat(tree))
        out[name] = tree
    return out


def _start_ranks(d):
    """Start one world of 2 and one of 4 ranks at once; each takes its
    meshes one after another. Returns the processes."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for n in sorted({m[2] * m[3] for m in SERVE_MESHES}):
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, WORKER, "serve", str(r), str(n), str(port),
             str(d)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
    return procs


def _collect(procs, d):
    """The ranks' results by mesh name: [rank 0's, ...]."""
    deadline = time.monotonic() + 300
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    res = {}
    for name, _, data, model, _ in SERVE_MESHES:
        res[name] = []
        for r in range(data * model):
            with open(d / f"serve_{name}_{r}.pkl", "rb") as f:
                res[name].append(pickle.load(f))
    return res


def _reference(tree, a, S, ctx_len):
    """The reference's prefill of an S-token prompt and SERVE_TICKS decode
    logits over a ring of `ctx_len` on its weights (its jitted serving
    stages over `prefill` / `decode_step`)."""
    ja = dataclasses.replace(jget_arch(a.name).smoke(), dtype="float32",
                             bfp_kv_cache=a.bfp_kv_cache,
                             moe_groups=a.moe_groups)
    cfg = JHBFPConfig(8, 16, tile=SERVE_TILE)
    params = jss.narrow_serving_params(tree, ja, cfg)
    toks, ticks = serve_inputs(a, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (SERVE_B, S)).copy()
    lg, cache = jax.jit(jss.make_prefill_fn(ja, cfg))(
        params, {"tokens": toks, "positions": pos})
    out = [np.asarray(lg, np.float32)]
    cache = jss.prefill_to_decode_cache(cache, ja, ctx_len)
    dec = jax.jit(jss.make_decode_fn(ja, cfg))
    for i in range(SERVE_TICKS):
        lg, cache = dec(params, {"tokens": ticks[i],
                                 "positions": jnp.full((SERVE_B, 1),
                                                       S + i,
                                                       jnp.int32)}, cache)
        out.append(np.asarray(lg, np.float32))
    return out


def _single(weights):
    """One process of the port and the reference, per (arch, 8-bit
    cache, MoE groups, prompt, ring); the reference's compiles run on
    three threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out, refs = {}, {}
    pool = ThreadPoolExecutor(3)
    for name, arch_name, *_ in SERVE_MESHES:
        for bfp_kv in ([False, True] if name == "y14" else [False]):
            a = serve_arch(arch_name, bfp_kv, name)
            dims = serve_dims(name)
            key = (arch_name, bfp_kv, a.moe_groups, *dims)
            if key in out:
                continue
            params = narrow_serving_params(
                from_jax_params(weights[arch_name], device="cpu"), a,
                serve_cfg())
            logits, cache, calls = serve_run(a, params, serve_cfg(),
                                             S=dims[0], ctx_len=dims[1])
            out[key] = dict(logits=logits, cache=cache, calls=calls)
            refs[key] = pool.submit(_reference, weights[arch_name], a, *dims)
    torch.set_num_threads(threads)
    for key, ref in refs.items():
        out[key]["ref"] = ref.result()
    pool.shutdown()
    return out


@pytest.fixture(scope="module")
def results(weights):
    """(the ranks' results by mesh, one process's by case): the ranks run
    while this process takes one process and the reference."""
    procs = _start_ranks(weights["dir"])
    try:
        one = _single(weights)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _collect(procs, weights["dir"]), one


@pytest.fixture(scope="module")
def runs(results):
    return results[0]


@pytest.fixture(scope="module")
def single(results):
    return results[1]


def _mesh(name):
    return next(m for m in SERVE_MESHES if m[0] == name)


def _rows(case, n_data):
    """This rank's batch rows of a one-process tensor (dim 0)."""
    k = SERVE_B // n_data
    return slice(case["rank"] * k, (case["rank"] + 1) * k)


def _cases(runs, single, name):
    _, arch_name, data, model, _ = _mesh(name)
    for res in runs[name]:
        for bfp_kv, case in res["cases"].items():
            a = serve_arch(arch_name, bfp_kv, name)
            yield res, case, single[(arch_name, bfp_kv, a.moe_groups,
                                     *serve_dims(name))], data, model


@pytest.mark.parametrize("name", MESHES)
def test_logits_match_one_process_and_reference(runs, single, name):
    for res, case, one, data, _ in _cases(runs, single, name):
        rows = _rows(case, data)
        assert len(case["logits"]) == 1 + SERVE_TICKS
        for got, want, ref in zip(case["logits"], one["logits"],
                                  one["ref"]):
            want, ref = want[rows], ref[rows]
            assert got.shape == want.shape == ref.shape
            assert np.isfinite(got).all()
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= ORDER_TOL * scale, name
            assert np.abs(got - ref).max() <= (F32_TOL + ORDER_TOL) \
                * np.abs(ref).max(), name


@pytest.mark.parametrize("name", MESHES)
def test_cache_parts_are_one_process_slices(runs, single, name):
    for res, case, one, data, model in _cases(runs, single, name):
        for leaf, got in case["cache"].items():
            whole = one["cache"][leaf]
            spec = case["cache_specs"][leaf]
            want = whole
            for d, s in enumerate(spec):
                if s is None:
                    continue
                r = case["rank_m"] if s == "model" else case["rank"]
                k = got.shape[d]
                want = np.take(want, range(r * k, (r + 1) * k), axis=d)
            assert got.shape == want.shape, (leaf, got.shape, want.shape)
            assert np.array_equal(got, want), (name, leaf)


def _layer0(calls, site):
    """Layer 0's products of `site` in each stage (prefill, then every
    tick): the first of each stage's calls (a prefill's first query
    chunk)."""
    out, first = [], False
    for c in calls:
        if c[0] == "stage":
            first = True
        elif c[0] == site and first:
            out.append(c)
            first = False
    assert len(out) == 1 + SERVE_TICKS
    return out


@pytest.mark.parametrize("name", MESHES)
def test_attention_operands_bit_equal(runs, single, name):
    """Heads sharded (by the attention or by the cache): layer 0's q (the
    QK product's x), k and v (its w, PV's w) are one process's heads, bit
    for bit; sequence sharded: layer 0's scores of each tick are one
    process's columns of the rank's run."""
    for res, case, one, data, model in _cases(runs, single, name):
        rows = _rows(case, data)
        qk, oqk = _layer0(case["calls"], "qk"), _layer0(one["calls"], "qk")
        pv, opv = _layer0(case["calls"], "pv"), _layer0(one["calls"], "pv")
        seq = case["kv"] == "seq"
        for t, ((_, x, w, y), (_, ox, ow, oy)) in enumerate(zip(qk, oqk)):
            ox, ow, oy = ox[rows], ow[rows], oy[rows]
            if seq:
                if t == 0:        # the prefill's attention is replicated
                    assert np.array_equal(y, oy)
                    continue
                c = y.shape[-1]
                r = case["rank_m"]
                assert np.array_equal(y, oy[..., r * c:(r + 1) * c]), t
                continue
            h = x.shape[1]
            r = case["rank_m"] if h < ox.shape[1] else 0
            cut = lambda a: a[:, r * h:(r + 1) * h]
            assert np.array_equal(x, cut(ox)), t
            assert np.array_equal(w, cut(ow)), t
        for t, ((_, _, w, _), (_, _, ow, _)) in enumerate(zip(pv, opv)):
            ow = ow[rows]
            if seq and t > 0:
                c = w.shape[-2]
                r = case["rank_m"]
                assert np.array_equal(w, ow[..., r * c:(r + 1) * c, :]), t
                continue
            h = w.shape[1]
            r = case["rank_m"] if h < ow.shape[1] else 0
            assert np.array_equal(w, ow[:, r * h:(r + 1) * h]), t


def test_layouts_and_the_refusal(runs):
    """What each mesh shards, and what it keeps whole with its reason."""
    y12, y14, y22 = runs["y12"][0], runs["y14"][0], runs["y22"][0]
    l12, h12 = runs["l12"][0], runs["h12"][0]
    for res in (y12, y22, h12):
        case = res["cases"][False]
        assert case["kv"] is None
        assert case["dims"]["layers/attn_wq"] == -1
        assert case["cache_specs"]["kv/k"][2] == "model"
    assert y22["cases"][False]["cache_specs"]["kv/k"][1] == "data"
    for bfp_kv in (False, True):
        case = y14["cases"][bfp_kv]
        assert case["kv"] == "seq"
        # the data axis of one rank "shards" the batch, as the reference's
        assert case["cache_specs"]["kv/k"] == (None, "data", None, "model",
                                               None)
        assert case["cache_specs"]["kv/slot_pos"] == (None, "data", None)
        assert "layers/attn_wq" in case["replicated"]
        kinds = {r[0] for r in case["records"]}
        assert {"all_reduce", "all_reduce_max"} <= kinds
    assert "cuts 4-feature exponent groups" in y14["refused"]
    ep = l12["cases"][False]
    assert ep["kv"] == "heads"
    assert ep["dims"]["layers/moe_wg"] == -3
    assert all(v == "ep_only: only the experts shard"
               for k, v in ep["replicated"].items() if "moe_w" not in k)
    assert ep["dims"]["head_w"] is None
    assert ep["dims"]["layers/shared_wg"] is None
    hy = h12["cases"][False]
    assert "mixer is replicated" in hy["cache_replicated"]["ssm/0"]
    assert hy["cache_specs"]["ssm/0"] == (None, "data", None, None, None)
    for res in runs["h14"]:
        case = res["cases"][False]
        assert case["kv"] == "seq"
        assert case["cache_specs"]["kv/k"][3] == "model"
        # the ring one process holds: every prompt token and tick kept
        S, ctx_len = serve_dims("h14")
        pos = case["cache"]["kv/slot_pos"]
        assert pos.shape[-1] == ctx_len
        assert (pos[..., :S + SERVE_TICKS] == np.arange(S + SERVE_TICKS)).all()
        assert case["cache"]["kv/k"].shape[3] == ctx_len // 4


def test_sequence_parallel_prefill(runs, single):
    """yi-9b on {data 1, model 2} with the reference's seq_parallel
    prefill: the last token's logits as without it, within C18's order
    term (the row-parallel sums reduce-scattered over the tokens), and
    layer 0's cache bit for bit (attention runs on the gathered
    sequence)."""
    one = single[("yi-9b", False, serve_arch("yi-9b").moe_groups,
                  *serve_dims())]
    for res in runs["y12"]:
        sp, case = res["sp"], res["cases"][False]
        assert {"reduce_scatter", "all_gather"} <= set(sp["kinds"])
        want = one["logits"][0]
        assert np.abs(sp["logits"] - want).max() <= \
            ORDER_TOL * np.abs(want).max()
        assert np.array_equal(sp["k"][0], case["cache"]["kv/k"][0][
            ..., :SERVE_S, :])


def test_moe_group_cut_gathers_only_where_the_layout_asks():
    """A data part that cuts the MoE groups is refused unless the serving
    layout asked to gather them (`DataPart.gather_groups`), whatever the
    autograd mode: an evaluation without gradient under a training layout
    is refused as its step is."""
    from repro_torch.models.layers import Ctx
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding.tensor_parallel import DataPart
    ctx = Ctx(dp=DataPart(offset=1, size=3, transport=None))
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="cuts the 2 MoE groups"):
        moe_ffn(torch.zeros(1, 4, 8), {}, ctx, n_experts=2, top_k=1,
                n_groups=2)
