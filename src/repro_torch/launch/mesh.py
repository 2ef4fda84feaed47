"""Production mesh definitions (port of `repro.launch.mesh`).

Defined as FUNCTIONS so importing this module never touches the device
or the process group. Single pod: 16×16 = 256 ranks (data, model).
Multi-pod: 2 pods × 256 = 512 ranks (pod, data, model); the pod axis is
an extra pure-DP axis. Each mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group (started first, e.g. by `launch.transport.
init_process_group` in every rank of a `torchrun` launch), on the CUDA
devices when there are any, else on the CPU. On PyTorch's fake process
group (`launch.transport.init_fake_process_group(256 or 512)`) one
process builds the production mesh as its rank 0 (the dry run's,
`launch/dryrun.py`), on the CPU's device type: it places nothing.
"""
from __future__ import annotations

import math

import torch


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start one in every rank first "
            "(repro_torch.launch.transport.init_process_group, or a "
            "torchrun launch)")
    # a fake group (the dry run's) places nothing: its mesh is the CPU's
    fake = str(dist.get_backend()) == "fake"
    dev = "cuda" if torch.cuda.is_available() and not fake else "cpu"
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {world} — launch {n} "
            f"processes (torchrun --nnodes=... --nproc-per-node=... so "
            f"that the world size is {n})")
    return _mesh(shape, axes)


def make_host_mesh(model: int = 1):
    """Small mesh over the ranks that exist (tests / local runs):
    (world // model, model) as ("data", "model")."""
    data = _world() // model
    return _mesh((data, model), ("data", "model"))
