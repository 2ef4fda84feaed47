"""Tensor, sequence and expert parallelism in training (`make_step(...,
mesh=make_host_mesh(model=M), seq_parallel=)`, `init_train_state(...,
mesh=step.layout)`, `Trainer`) on gloo CPU ranks against one process on
the full batch.

gemma2 smoke in f32 (S = 32) under HBFP8 on the sim path with 32 × 32
weight tiles, so that the tile-aligned layout shards every projection at
model 2 (attention by heads, the FFN on d_ff, the vocab-parallel
embedding and head); at model 4 the kv projection's 64 columns are 16 a
rank and the attention group stays replicated. The ranks run as
processes started once for the module, on {data 1, model 2}, {data 2,
model 2} and {data 1, model 4} at the same time.

  * the narrow copy on the mesh is the model part of the one-process
    narrowing, bit for bit; a row split over the model ranks and
    quantized on the all-reduced row amax (the operand of a row-parallel
    product, the gradient of a column-parallel one) is the model part of
    the whole row's quantization, bit for bit, on the sim path and in
    B3's plain version; the first loss within 1e-6 relative of one
    process's (the f32 order of a row-parallel product's partial sums);
  * 3 steps of global batch 4 × 32: the losses within 1e-5 relative of
    one process, every gathered master leaf and moment within 1e-5 /
    1e-4 relative Frobenius (`tests/test_torch_dp_train.py`'s bounds;
    the FP leaves move in their last ulps where the ranks add partial
    sums in another order), with sequence parallelism off and on;
  * the leaves the model ranks hold alike are bit-identical across them;
  * grad_accum 2; the kernel path (the kernels' plain versions) in bf16,
    held to the HBFP tolerances of `tests/test_torch_train.py` (losses
    2e-3, updates 0.25, moments 0.1): the kernels' per-K-block partials
    carry per-block scales, so a split contraction adds them in another
    order and a downstream BFP rounding flips now and then (ROADMAP C6);
  * one step of every architecture's `.smoke()` on {1, 2}, against one
    process within the f32 bounds (the MoE archs under expert
    parallelism, hymba's and xlstm's concatenated mixers replicated);
  * the Trainer on {2, 2} preempted and resumed bit for bit, its
    checkpoint loading in one process and in `repro.checkpoint`;
  * telemetry on the mesh equals one process's (the weight tap on the
    shards' narrowing, the grad tap on the reduced gradients, the act
    taps): counts, exponent spreads and histograms exactly, SQNR within
    1e-3 dB (ROADMAP C9); the controller takes the same decisions on
    every rank as in one process.

The ranks are `python tests/torch_dist_worker.py tp RANK N PORT DIR
MODEL`, one mesh at a time. Summed case time under `-n 6 --dist
loadfile` beside the tier-1 run's heaviest files: 42 s (the
one-process fixture pinned to one intra-op thread; on the default
threads it took 189 s there).
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import load_checkpoint
from repro_torch.numerics import (ControllerConfig, PrecisionController,
                                  TapConfig)
from repro_torch.numerics.stats import stats_to_host
from repro_torch.train import init_train_state, make_step
from torch_dist_worker import (ARCHS, STEPS, TP_MESHES, accum_batch, arch,
                               arch_batch, batch, np_tree, sched, smoke,
                               tp_policy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
TOL = dict(loss=1e-5, master=1e-5, moments=1e-4)
TOL_BF16 = dict(loss=2e-3, updates=0.25, moments=0.1)
SQNR_DB = 1e-3
MESH_IDS = [f"{d}x{m}" for d, m in TP_MESHES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results by mesh: {(data, model): [rank 0's, ...]}."""
    d = tmp_path_factory.mktemp("tp_train")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + 300
    for data, model in TP_MESHES:
        # one mesh at a time: ten single-threaded ranks at once on a
        # loaded host spend their time waiting for each other
        n, port = data * model, _free_port()
        procs = [subprocess.Popen(
            [sys.executable, WORKER, "tp", str(r), str(n), str(port),
             str(d), str(model)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
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
    res = {"dir": d}
    for data, model in TP_MESHES:
        res[data, model] = []
        for r in range(data * model):
            with open(d / f"tp{data}x{model}_{r}.pkl", "rb") as f:
                res[data, model].append(pickle.load(f))
    return res


def _single(a, pol, steps, data, **kw):
    state = init_train_state(0, a, device="cpu")
    step = make_step(a, pol, sched(), device="cpu", **kw)
    losses, metrics = [], []
    for i in range(steps):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
        metrics.append(m)
    return dict(losses=losses, params=np_tree(state.params),
                mu=np_tree(state.opt.mu), nu=np_tree(state.opt.nu),
                metrics=metrics)


@pytest.fixture(scope="module")
def single():
    """One process on the full batch: every run the ranks make, on one
    intra-op thread (small ops on many threads of a loaded host wait for
    each other: this fixture took 189 s so beside the tier-1 run's other
    workers, ~5 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _single_runs()
    finally:
        torch.set_num_threads(n)


def _single_runs():
    a, pol = arch(), tp_policy()
    out = dict(steps=_single(a, pol, STEPS, batch),
               accum=_single(a, pol, 1, accum_batch, grad_accum=2),
               bf16=_single(arch("bfloat16"), tp_policy("pallas"), STEPS,
                            batch),
               init_bf16=np_tree(init_train_state(0, arch("bfloat16"),
                                                  device="cpu").params))
    out["archs"] = {n: _single(smoke(n), pol, 1,
                               lambda i, sa=smoke(n): arch_batch(sa, i))
                    for n in ARCHS}
    tel = _single(a, pol, 1, batch, tap=TapConfig(cadence=1))
    out["numerics"] = stats_to_host(tel["metrics"][0]["numerics"])
    ctl = PrecisionController(ControllerConfig(patience=1, cooldown=0),
                              base_bits=4)
    c = _single(a, tp_policy(bits=4), STEPS, batch, controller=ctl)
    out["controller"] = {"log": ctl.log, "overrides": ctl.overrides(),
                         "losses": c["losses"]}
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want):
    assert np.allclose(got["losses"], want["losses"], rtol=TOL["loss"],
                       atol=0), (got["losses"], want["losses"])
    for what, tol in (("params", TOL["master"]), ("mu", TOL["moments"]),
                      ("nu", TOL["moments"])):
        assert set(got[what]) == set(want[what])
        for n, a in got[what].items():
            assert a.shape == want[what][n].shape, (what, n)
            assert _rel(a, want[what][n]) <= tol, (what, n,
                                                   _rel(a, want[what][n]))


@pytest.mark.parametrize("mesh", TP_MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("run", ["steps", "sp"])
def test_steps_match_one_process(runs, single, mesh, run):
    """Sequence parallelism off ("steps") and on ("sp")."""
    _close(runs[mesh][0][run], single["steps"])
    for r in runs[mesh]:
        assert r[run]["losses"] == runs[mesh][0][run]["losses"]


@pytest.mark.parametrize("mesh", TP_MESHES, ids=MESH_IDS)
def test_narrow_copy_and_quantized_operands_exact(runs, single, mesh):
    want = single["steps"]["losses"][0]
    for r in runs[mesh]:
        assert r["narrow_equal"] and r["operands_equal"]
        for run in ("steps", "sp"):
            assert abs(r[run]["losses"][0] - want) <= 1e-6 * want


@pytest.mark.parametrize("mesh", TP_MESHES, ids=MESH_IDS)
def test_replicas_bit_identical_across_model_ranks(runs, mesh):
    data, model = mesh
    ranks = runs[mesh]
    for run in ("steps", "sp"):
        for d in range(data):
            first = ranks[d * model][run]["replicas"]
            assert first
            for r in ranks[d * model + 1:(d + 1) * model]:
                got = r[run]["replicas"]
                assert set(got) == set(first)
                for n, v in got.items():
                    assert np.array_equal(v.view(np.uint8),
                                          first[n].view(np.uint8)), (run, n)


@pytest.mark.parametrize("mesh", TP_MESHES, ids=MESH_IDS)
def test_layout_and_collectives(runs, mesh):
    """The tile-aligned layout keeps every smoke projection sharded at
    model 2; at model 4 the attention group stays whole. A step's
    model-axis collectives are sums and row-amax maxes, nothing staged."""
    rep = runs[mesh][0]["replicated"]
    if mesh[1] == 2:
        assert rep == {}
    else:
        assert sorted(rep) == ["layers/attn_wk", "layers/attn_wo",
                               "layers/attn_wq", "layers/attn_wv"]
    kinds = runs[mesh][0]["step_kinds"]
    assert kinds["all_reduce"] > 0 and kinds["all_reduce_max"] > 0
    assert set(kinds) <= {"all_reduce", "all_reduce_max", "all_gather"}


def test_grad_accum_matches_one_process(runs, single):
    _close(runs[1, 2][0]["accum"], single["accum"])


def test_kernel_path_bf16_matches_one_process(runs, single):
    got, want = runs[1, 2][0]["bf16"], single["bf16"]
    assert np.allclose(got["losses"], want["losses"], rtol=TOL_BF16["loss"],
                       atol=0), (got["losses"], want["losses"])
    p0 = single["init_bf16"]
    for n, a in got["params"].items():
        assert _rel(a - p0[n], want["params"][n] - p0[n]) \
            <= TOL_BF16["updates"], n
    for what in ("mu", "nu"):
        for n, a in got[what].items():
            assert _rel(a, want[what][n]) <= TOL_BF16["moments"], (what, n)


@pytest.mark.parametrize("name", ARCHS)
def test_every_arch_one_step(runs, single, name):
    _close(runs[1, 2][0]["archs"][name], single["archs"][name])


def test_trainer_resume_and_cross_load(runs):
    ranks = runs[2, 2]
    res = ranks[0]
    assert res["preempted"] == "simulated preemption at step 3"
    assert res["resumed_from"] == 2
    assert all(r["resume_exact"] for r in ranks)
    ckpt = str(runs["dir"] / "tp_ckpt")
    want = res["final"]
    state, meta = load_checkpoint(ckpt, init_train_state(0, arch(),
                                                         device="cpu"))
    assert meta["step"] == 4 and state.step == 4 and state.opt.step == 4
    for tree, key in ((state.params, "params"), (state.opt.mu, "mu"),
                      (state.opt.nu, "nu")):
        got = np_tree(tree)
        for k, v in want[key].items():
            assert np.array_equal(got[k], v), (key, k)
    ja = dataclasses.replace(jget_arch("gemma2-2b").smoke(), dtype="float32")
    jstate = jinit_train_state(jax.random.key(0), ja, jinit_params)
    jrestored, _ = jload(ckpt, jstate)
    flat = jax.tree_util.tree_flatten_with_path(jrestored.params)[0]
    for p, v in flat:
        name = "/".join(str(k.key) for k in p)
        assert np.array_equal(np.asarray(v), want["params"][name]), name
    assert int(jrestored.step) == 4


def test_telemetry_equals_one_process(runs, single):
    want = single["numerics"]
    for r in runs[1, 2]:
        got = r["numerics"]
        assert set(got) == set(want) == {"weights", "grads", "acts"}
        for source in want:
            assert set(got[source]) == set(want[source]), source
            for n, w in want[source].items():
                g = got[source][n]
                for k in ("clip_frac", "sat_tile_frac", "ftz_frac",
                          "exp_spread", "n", "exp_hist"):
                    assert g[k] == w[k], (source, n, k)
                assert abs(g["sqnr_db"] - w["sqnr_db"]) <= SQNR_DB, \
                    (source, n)


def test_controller_decides_alike(runs, single):
    want = single["controller"]
    assert want["log"]
    for r in runs[1, 2]:
        got = r["controller"]
        assert got["log"] == want["log"]
        assert got["overrides"] == want["overrides"]
        assert np.allclose(got["losses"], want["losses"], rtol=TOL["loss"],
                           atol=0)
