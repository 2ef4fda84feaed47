"""The port's partitioning rules (`repro_torch.sharding`) give the
reference's specs (`repro.sharding`), element for element, for every
architecture at full width on five meshes: {data 16, model 16}, {pod 2,
data 16, model 16}, {data 2, model 1}, {data 4, model 1} and {data 1,
model 1024}. Both trees are shapes only: the reference's through
`jax.eval_shape`, the port's on the "meta" device. Covered: the forward
specs (with and without `ep_only`), the master specs (ZeRO-1 on and
off), the optimizer-state specs, the train batch's specs (M-RoPE
positions put the batch at dim 1) and the decode cache's (with and
without `seq_shard`). `n_params` / `n_active_params` match the
reference's for every architecture. `launch.mesh` and `to_shardings` run
on PyTorch's fake process group (no ranks, no collectives).
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import sharding as jsh
from repro.configs import arch_ids as jarch_ids
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models import make_cache as jmake_cache
from repro.train import init_train_state as jinit_train_state
from repro_torch import sharding as tsh
from repro_torch.configs import arch_ids, get_arch
from repro_torch.models import init_params, make_cache
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding.partitioning import Spec, to_shardings

MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
          "data2": {"data": 2, "model": 1},
          "data4": {"data": 4, "model": 1},
          "model1024": {"data": 1, "model": 1024}}
BATCH, SEQ, CTX = 256, 4096, 1024


class FakeMesh:
    """Duck-typed mesh: partitioning only reads .shape and .axis_names."""
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


def _jflat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {_jname(p): tuple(s) for p, s in flat}


def _tflat(tree, path=()) -> dict:
    if tree is None:
        return {}
    if isinstance(tree, Spec):
        return {"/".join(path): tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    else:
        items = [(str(i), v) for i, v in enumerate(tree)]
    for k, v in items:
        out.update(_tflat(v, path + (k,)))
    return out


def _batches(arch):
    """The train batch by shape in both packages (dryrun's layout)."""
    tok = (BATCH, SEQ) + ((arch.n_codebooks,) if arch.n_codebooks > 1
                          else ())
    shapes = {"labels": tok}
    if arch.input_kind == "embeddings":
        shapes["embeds"] = (BATCH, SEQ, arch.d_model)
    else:
        shapes["tokens"] = tok
    shapes["positions"] = (3, BATCH, SEQ) if arch.mrope else (BATCH, SEQ)
    jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    tb = {k: torch.empty(s, dtype=torch.int32, device="meta")
          for k, s in shapes.items()}
    return jb, tb


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name in jarch_ids():
        ja = jget_arch(name)
        state = jax.eval_shape(
            lambda s: jinit_train_state(jax.random.key(s), ja, jinit_params),
            0)
        jcache = jax.eval_shape(
            lambda s: jmake_cache(jinit_params(jax.random.key(s), ja), ja,
                                  128, CTX), 0)
        ta = get_arch(name)
        tparams = init_params(0, ta, device="meta")
        out[name] = dict(jparams=state.params, jopt=state.opt,
                         jcache=jcache, tparams=tparams,
                         topt=adamw_init(tparams),
                         tcache=make_cache(tparams, ta, 128, CTX),
                         batches=_batches(ta))
    return out


def test_every_arch_is_covered():
    assert tuple(arch_ids()) == tuple(jarch_ids())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(jarch_ids()))
def test_specs_match_reference(trees, arch, mesh_name):
    t = trees[arch]
    mesh = FakeMesh(MESHES[mesh_name])
    assert tsh.dp_axes(mesh) == jsh.dp_axes(mesh)
    pairs = [
        (jsh.fwd_param_specs(t["jparams"], mesh),
         tsh.fwd_param_specs(t["tparams"], mesh)),
        (jsh.fwd_param_specs(t["jparams"], mesh, ep_only=True),
         tsh.fwd_param_specs(t["tparams"], mesh, ep_only=True)),
        (jsh.master_param_specs(t["jparams"], mesh),
         tsh.master_param_specs(t["tparams"], mesh)),
        (jsh.master_param_specs(t["jparams"], mesh, zero1=False),
         tsh.master_param_specs(t["tparams"], mesh, zero1=False)),
        (jsh.batch_specs(t["batches"][0], mesh),
         tsh.batch_specs(t["batches"][1], mesh)),
        (jsh.cache_specs(t["jcache"], mesh),
         tsh.cache_specs(t["tcache"], mesh)),
        (jsh.cache_specs(t["jcache"], mesh, seq_shard=True),
         tsh.cache_specs(t["tcache"], mesh, seq_shard=True)),
    ]
    for want, got in pairs:
        want, got = _jflat(want), _tflat(got)
        assert got == want
    jo = jsh.opt_state_specs(t["jopt"], t["jparams"], mesh)
    to = tsh.opt_state_specs(t["topt"], t["tparams"], mesh)
    assert tuple(to.step) == tuple(jo.step) == ()
    assert _tflat(to.mu) == _jflat(jo.mu) and _tflat(to.nu) == _jflat(jo.nu)


@pytest.mark.parametrize("arch", list(jarch_ids()))
def test_param_counts_match_reference(arch):
    ja, ta = jget_arch(arch), get_arch(arch)
    assert ta.n_params() == ja.n_params()
    assert ta.n_active_params() == ja.n_active_params()
    small = ta.smoke()
    assert small.n_params() == ja.smoke().n_params()


def test_zero1_shard_dims_on_two_ranks(trees):
    """gemma2-2b on {data 2, model 1}: ZeRO-1 takes the largest dim the
    tensor-parallel rule left free (on a model-1 mesh that rule still
    names "model", which splits nothing), so every matrix splits its
    D = 2304 into 1152."""
    specs = _tflat(tsh.master_param_specs(trees["gemma2-2b"]["tparams"],
                                          FakeMesh(MESHES["data2"])))
    # [26, 2304, 2048], [26, 9216, 2304], [256000, 2304], [2304, 256000]
    assert specs["layers/attn_wq"] == (None, "data", "model")
    assert specs["layers/ffn_wo"] == (None, "model", "data")
    assert specs["embed_table"] == ("model", "data")
    assert specs["head_w"] == ("data", "model")
    assert specs["final_norm_scale"] == ("data",)


@pytest.fixture
def fake_world():
    """PyTorch's fake process group of a given world size (no ranks)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    started = []

    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        started.append(n)

    yield start
    if started:
        dist.destroy_process_group()


def test_meshes_and_placements(fake_world):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh()
    fake_world(512)
    m3 = make_production_mesh(multi_pod=True)
    assert m3.mesh_dim_names == ("pod", "data", "model")
    assert tuple(m3.shape) == (2, 16, 16)
    m2 = make_production_mesh()
    assert tuple(m2.shape) == (16, 16)
    assert m2.mesh_dim_names == ("data", "model")
    assert tsh.dp_axes(m3) == ("pod", "data")
    specs = {"w": Spec(None, ("pod", "data"), "model"), "b": Spec(),
             "kv": Spec(None, "data", "model")}
    from torch.distributed.tensor import Replicate, Shard
    got = to_shardings(specs, m3)
    assert got["w"] == (Shard(1), Shard(1), Shard(2))
    assert got["b"] == (Replicate(),) * 3
    assert got["kv"] == (Replicate(), Shard(1), Shard(2))
    host = make_host_mesh(model=16)
    assert tuple(host.shape) == (32, 16)


def test_production_mesh_needs_its_ranks(fake_world):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    fake_world(4)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    mesh = make_host_mesh()
    assert tuple(mesh.shape) == (4, 1)
    specs = tsh.master_param_specs(init_params(0, get_arch("gemma2-2b"),
                                               device="meta"), mesh)
    assert _tflat(specs)["layers/attn_wq"] == (None, "data", "model")
