"""Data-parallel ZeRO-1 training (`make_step(..., mesh=)`,
`init_train_state(..., mesh=)`, `Trainer`) on gloo CPU ranks against one
process on the full batch.

gemma2 smoke in f32 (S = 32, so the 16-token local window masks) under
HBFP8 on the pallas backend (the kernels' plain versions here) with
64 × 64 weight tiles: on 2 ranks every shard boundary leaves the tiles
whole (D = 128 splits into 64); on 4 it cuts them (32 of a 64-tile), as
gemma2-2b's D = 2304 over 4 ranks cuts its 128-tiles. The ranks run as
processes started once for the module, 2 and 4 at the same time.

  * shards: each rank's init shard is the reference's
    `master_param_specs` slice on {data N, model 1};
  * the narrow copy under the mesh equals the one-process narrowing, and
    the wide rounding of an update on the shards the one-process
    rounding, bit for bit, cut tiles included;
  * 3 steps of global batch 4 × 32 (2 or 1 rows a rank): the losses
    within 1e-5 relative of one process on the full batch, every
    gathered master leaf and moment within 1e-5 / 1e-4 relative
    Frobenius (measured worst 7.1e-8, 9.8e-8 and 1.9e-7). That is the
    f32 sum order: a rank sums its half of the tokens' weight gradients
    and the reduce adds the halves, so FP leaves (norm scales, the
    embedding) move in their last ulps, and a BFP weight only where such
    an ulp crosses a rounding boundary;
  * the same 3 steps in gemma2's own bf16 on 2 ranks: each rank's weight
    gradient is rounded to bf16 and the reduce adds the halves in bf16
    (as the reference all-reduces its bf16 gradients), where one process
    rounds the whole sum once, so an element moves by up to a bf16 ulp
    and now and then a BFP rounding with it: losses within 2e-3
    relative, the updates p3 - p0 within 0.25 and the moments within 0.1
    relative Frobenius per leaf (the HBFP tolerances of
    `tests/test_torch_train.py`; measured worst 6.5e-4, 0.121 and
    0.053). The card's run (`chip_smoke.py --phase dist`) is held to
    these;
  * a step of grad_accum = 2 under the mesh (its moments are the
    reduced gradients), within the f32 tolerances;
  * the Trainer: a 2-rank run preempted at step 3 and resumed from its
    step-2 checkpoint equals the uninterrupted run bit for bit, and its
    checkpoint (gathered whole on rank 0) loads in one process and in
    `repro.checkpoint`;
  * the collectives of a step, as the transport records them;
  * the combinations that raised until ROADMAP slice 19 (stochastic
    rounding and the "pod" axis under a mesh) lay out a step, on the fake
    process group; they train in `tests/test_torch_sr_mesh.py`.

The ranks are `python tests/torch_dist_worker.py dp RANK N PORT DIR`.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.checkpoint import load_checkpoint as jload
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.sharding import master_param_specs as jmaster_specs
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import load_checkpoint
from repro_torch.precision import as_policy
from repro_torch.train import init_train_state, make_step
from repro_torch.train.train_step import make_train_step
from torch_dist_worker import STEPS
from torch_dist_worker import accum_batch as _accum_batch
from torch_dist_worker import arch as _arch
from torch_dist_worker import batch as _batch
from torch_dist_worker import np_tree as _np_tree
from torch_dist_worker import policy as _policy
from torch_dist_worker import sched as _sched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
RANKS = (2, 4)
TOL = dict(loss=1e-5, master=1e-5, moments=1e-4)
TOL_BF16 = dict(loss=2e-3, updates=0.25, moments=0.1)


def _run_single(arch, steps, data, accum=1):
    state = init_train_state(0, arch, device="cpu")
    step = make_step(arch, _policy(), _sched(), device="cpu",
                     grad_accum=accum)
    losses = []
    for i in range(steps):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
    return dict(losses=losses, params=_np_tree(state.params),
                mu=_np_tree(state.opt.mu), nu=_np_tree(state.opt.nu))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results by world size: {N: [rank 0's, rank 1's, ...]}."""
    d = tmp_path_factory.mktemp("dp_train")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = []
    for n in RANKS:
        port = _free_port()
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, "dp", str(r), str(n), str(port),
                 str(d)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    res = {}
    for n in RANKS:
        res[n] = []
        for r in range(n):
            with open(d / f"rank{n}_{r}.pkl", "rb") as f:
                res[n].append(pickle.load(f))
    res["dir"] = d
    return res


@pytest.fixture(scope="module")
def single():
    """One process on the full batch: 3 steps (f32 and bf16), and a step
    of grad_accum 2."""
    arch = _arch()
    return dict(steps=_run_single(arch, STEPS, _batch),
                bf16=_run_single(_arch("bfloat16"), STEPS, _batch),
                accum=_run_single(arch, 1, _accum_batch, accum=2),
                init=_np_tree(init_train_state(0, arch, device="cpu").params),
                init_bf16=_np_tree(init_train_state(
                    0, _arch("bfloat16"), device="cpu").params))


def _close(got, want):
    assert np.allclose(got["losses"], want["losses"], rtol=TOL["loss"],
                       atol=0), (got["losses"], want["losses"])
    for what, tol in (("params", TOL["master"]), ("mu", TOL["moments"]),
                      ("nu", TOL["moments"])):
        assert set(got[what]) == set(want[what])
        for n, a in got[what].items():
            assert a.shape == want[what][n].shape, (what, n)
            assert _rel(a, want[what][n]) <= tol, (what, n)


@pytest.mark.parametrize("n", RANKS)
def test_steps_match_one_process(runs, single, n):
    _close(runs[n][0]["steps"], single["steps"])
    for r in runs[n]:
        assert r["losses"] == runs[n][0]["losses"]   # one global loss


@pytest.mark.parametrize("n", RANKS)
def test_shards_follow_reference_specs(runs, single, n):
    """Rank r's init shard of every leaf is the slice the reference's
    master_param_specs on {data N, model 1} gives it."""

    class FakeMesh:
        shape = {"data": n, "model": 1}
        axis_names = ("data", "model")

    ja = dataclasses.replace(jget_arch("gemma2-2b").smoke(), dtype="float32")
    jp = jax.eval_shape(lambda s: jinit_params(jax.random.key(s), ja), 0)
    flat = jax.tree_util.tree_flatten_with_path(
        jmaster_specs(jp, FakeMesh()),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    specs = {"/".join(str(k.key) for k in p): tuple(s) for p, s in flat}
    assert set(specs) == set(single["init"])
    for rank, res in enumerate(runs[n]):
        for name, full in single["init"].items():
            want = full
            for d, s in enumerate(specs[name]):
                if s == "data":
                    k = full.shape[d] // n
                    want = np.take(full, range(rank * k, (rank + 1) * k),
                                   axis=d)
            assert np.array_equal(res["init_shards"][name], want), name


@pytest.mark.parametrize("n", RANKS)
def test_narrowing_and_wide_rounding_exact(runs, n):
    """The narrow copy and the wide rounding on shards equal the
    one-process ones bit for bit; at 4 ranks shard boundaries cut tiles
    (those leaves take the gathered path), at 2 none does."""
    for res in runs[n]:
        assert res["narrow_equal"] and res["update_equal"]
        cut = sorted(k for k, whole in res["whole"].items() if not whole)
        if n == 2:
            assert cut == []
        else:
            assert "layers/attn_wq" in cut and "layers/attn_wk" in cut


def test_bf16_steps_match_one_process(runs, single):
    got, want = runs[2][0]["bf16"], single["bf16"]
    assert np.allclose(got["losses"], want["losses"], rtol=TOL_BF16["loss"],
                       atol=0), (got["losses"], want["losses"])
    p0 = single["init_bf16"]
    for n, a in got["params"].items():
        assert _rel(a - p0[n], want["params"][n] - p0[n]) \
            <= TOL_BF16["updates"], n
    for what in ("mu", "nu"):
        for n, a in got[what].items():
            assert _rel(a, want[what][n]) <= TOL_BF16["moments"], (what, n)


def test_grad_accum_matches_one_process(runs, single):
    _close(runs[2][0]["accum"], single["accum"])


def test_step_collectives(runs):
    """One gloo step: the f32 gradient reduce (an all-reduce, gloo's
    reduce-scatter) of every parameter plus the loss and clip scalars,
    and the all-gather of the narrow copy's shards; nothing staged on
    the CPU."""
    n_params = sum(v.size for v in runs[2][0]["init_shards"].values()) * 2
    per_step = runs[2][0]["step_bytes"]
    assert per_step["all_reduce"] == 4 * n_params + 4 + 4
    assert per_step["all_gather"] == 4 * n_params // 2
    assert runs[2][0]["staged"] == {}


def test_checkpoint_resume_and_cross_load(runs):
    res = runs[2][0]
    assert res["preempted"] == "simulated preemption at step 3"
    assert res["resumed_from"] == 2
    assert all(r["resume_exact"] for r in runs[2])
    ckpt = str(runs["dir"] / "ckpt")
    want = res["final"]
    arch = _arch()
    state, meta = load_checkpoint(ckpt, init_train_state(0, arch,
                                                         device="cpu"))
    assert meta["step"] == 4 and state.step == 4 and state.opt.step == 4
    for tree, key in ((state.params, "params"), (state.opt.mu, "mu"),
                      (state.opt.nu, "nu")):
        got = _np_tree(tree)
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


def test_raises_under_a_mesh():
    """Stochastic rounding and the "pod" axis train under a mesh since
    ROADMAP slice 19 (`test_builds_under_a_mesh`,
    `tests/test_torch_sr_mesh.py`). What still raises is a part that no
    index base can name, rather than a wrong stream: a kernel operand
    whose rows are not one contiguous run of the one-process rows, a data
    shard that cuts the MoE groups, a row-parallel product given another
    part of x than its own."""
    import torch
    from types import SimpleNamespace

    from repro_torch.kernels.common import flat_base, index_base
    from repro_torch.models.layers import Ctx
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding.tensor_parallel import DataPart, TPGroup
    with pytest.raises(ValueError, match="contiguous"):
        flat_base(index_base((4, 6, 8), (0, 2, 0)), (2, 2, 8), 8)
    ctx = Ctx(dp=DataPart(offset=1, size=3, transport=None))
    with pytest.raises(ValueError, match="cuts the 2 MoE groups"):
        moe_ffn(torch.zeros(1, 4, 8), {}, ctx, n_experts=2, top_k=1,
                n_groups=2)
    tp = TPGroup(SimpleNamespace(size=2, rank=0))
    with pytest.raises(ValueError, match="row-parallel"):
        tp.matmul(torch.zeros(3, 4), torch.zeros(4, 5), -2,
                  lambda *a: None,
                  x_base=index_base((3, 8), (0, 4)))


# (mesh shape, axis names, spec) that raised before stochastic rounding
# and the "pod" axis trained under a mesh (ROADMAP slice 19)
MESH_CASES = (
    ((2, 2, 1), ("pod", "data", "model"), "8; backend=pallas"),
    ((2, 2, 1), ("pod", "data", "model"), "8~stochastic"),
    ((2, 1, 2), ("pod", "data", "model"), "8~stochastic; backend=pallas"),
    ((2, 1), ("data", "model"), "8~stochastic; backend=pallas"),
    ((1, 2), ("data", "model"), "8~stochastic"))


@pytest.mark.parametrize("shape,names,spec", MESH_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-{i}"
                              for i, c in enumerate(MESH_CASES)])
def test_builds_under_a_mesh(shape, names, spec):
    """The combinations that raised until slice 19 now lay out a step, on
    PyTorch's fake process group (no ranks): the data axes are ("pod",
    "data") flattened pod-major where there is a pod axis, each leaf's
    index base is this rank's part of the master spec, and the batch's
    rows are this rank's `Ctx.dp` part. Training on them:
    `tests/test_torch_sr_mesh.py`."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        pol = as_policy(spec)
        lay = make_step(_arch(), pol, _sched(), device="cpu",
                        mesh=mesh).layout
        n = math.prod(shape[:-1])
        assert lay.axis == (("pod", "data") if "pod" in names else "data")
        assert lay.n == lay.transport.size == n and lay.m == shape[-1]
        specs = dict(_np_tree_specs(mesh))
        for name, full in lay.shapes.items():
            base = lay.leaf_base(name)
            assert base.shape == full and not any(base.offset), name
            assert (lay.dims[name] is None) == (n == 1 or all(
                s not in (lay.axis,) for s in specs[name])), name
        b = _batch(0)
        dp = lay.data_part(b)
        assert (dp is None) == (n == 1)
        if dp is not None:
            assert (dp.offset, dp.size) == (0, b["labels"].shape[0])
        seg = pol.resolve_segment(0)
        assert make_train_step(_arch(), seg, _sched(), device="cpu",
                               mesh=lay).layout is lay
    finally:
        dist.destroy_process_group()


def _np_tree_specs(mesh):
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.sharding.partitioning import master_param_specs
    return named_leaves(master_param_specs(
        init_params(0, _arch(), device="meta"), mesh))
