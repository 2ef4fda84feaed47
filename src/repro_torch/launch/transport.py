"""The data-parallel path's collectives, through one small helper.

`init_process_group(rank, world_size, port, device)` starts the default
group over `tcp://localhost:<port>` on the backend that `pick_backend`
picks from the placement: NCCL where every rank has a card of its own,
gloo where ranks share a card (NCCL refuses two ranks on one device) or
run on the CPU. The choice is made from the counts, never by catching a
failure.

The training step holds one transport per mesh axis: "data" (the ZeRO-1
reduces and gathers) and "model" (tensor and sequence parallelism,
`sharding/tensor_parallel.py`: the row-parallel sums, the column
products' input-gradient sums and the row-amax MAX reduces as
"all_reduce" / "all_reduce_max", the vocab-parallel CE's scalars, the
gathers as "all_gather", the sequence's reduce-scatters as
"reduce_scatter").

`Transport(group)` issues every collective of the data-parallel step,
the checkpoint gathers and the compressed reduce, and records each one
it issues (kind, payload bytes, group size, host seconds until it
returned). Gloo runs only all-reduce and broadcast on CUDA tensors
(PyTorch's backend table); any other collective on a CUDA tensor under
gloo is staged through host memory explicitly, the same way on every
run, and counted in `staged`. The reduce-scatter is an all-reduce
followed by the rank's chunk (gloo has none on CUDA tensors, and on the
CPU only in recent PyTorch versions); NCCL's own, at half the bytes,
waits for a run with a card a rank (ROADMAP slice 18). A record of it
is the all-reduce it issues (the whole tensor's bytes), under the kind
its caller names.

PyTorch's fake process group (`init_fake_process_group`, backend
"fake") runs the dry run (`launch/dryrun.py`): one process is rank 0 of
a world of 256 or 512, every collective returns at once and moves
nothing, nothing is staged through host memory, and each is recorded as
on any backend (kind, payload bytes, group size, seconds), which
`analysis.roofline.collective_bytes_from_records` turns into the
reference's per-device wire bytes.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# collectives gloo runs on CUDA tensors; the rest are staged through host
GLOO_CUDA = frozenset({"all_reduce", "broadcast"})


def pick_backend(world_size: int, device) -> str:
    """"nccl" when each of the `world_size` ranks has a card of its own on
    this host, else "gloo"."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world_size: int, port: int,
                       device=None) -> str:
    """Start the default process group on `tcp://localhost:<port>` with
    the backend `pick_backend` gives (NCCL ranks take card `rank`);
    returns the backend's name. `device`: the CUDA device by default."""
    dev = resolve_device(device)
    backend = pick_backend(world_size, dev)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    return backend


def init_fake_process_group(world_size: int) -> None:
    """Start PyTorch's fake process group of `world_size` ranks in this
    process as rank 0 (no peers, no network: the dry run's)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


class Transport:
    """Collectives over one process group (the default group when None),
    with a record of each one issued."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        # (kind, payload bytes, group size, seconds)
        self.records: List[tuple] = []
        self.staged: dict = {}           # kind -> collectives via host

    def _staged(self, kind: str, t: torch.Tensor) -> bool:
        """True when a collective of `t` goes through host memory (gloo, a
        CUDA tensor, a kind gloo lacks there); counted."""
        staged = self.backend == "gloo" and t.is_cuda \
            and kind not in GLOO_CUDA
        if staged:
            self.staged[kind] = self.staged.get(kind, 0) + 1
        return staged

    def _record(self, kind: str, t: torch.Tensor, t0: float) -> None:
        self.records.append((kind, t.numel() * t.element_size(), self.size,
                             time.perf_counter() - t0))

    def bytes_by_kind(self, since: int = 0) -> dict:
        """Payload bytes of the records from index `since` on, by kind."""
        out = {}
        for kind, n, _, _ in self.records[since:]:
            out[kind] = out.get(kind, 0) + n
        return out

    def seconds_by_kind(self, since: int = 0) -> dict:
        """Host seconds of the records from index `since` on, by kind."""
        out = {}
        for kind, _, _, sec in self.records[since:]:
            out[kind] = out.get(kind, 0.0) + sec
        return out

    def all_reduce_(self, t: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum `t` over the group (or its max, op MAX), in place."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group)
        kind = "all_reduce_max" if op == dist.ReduceOp.MAX else \
            "all_reduce_min" if op == dist.ReduceOp.MIN else "all_reduce"
        self._record(kind, t, t0)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (equal shapes), in rank order, on t's device."""
        t0 = time.perf_counter()
        t = t.contiguous()
        src = t.cpu() if self._staged("all_gather", t) else t
        outs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(outs, src, group=self.group)
        outs = [o.to(t.device) for o in outs]
        self._record("all_gather", t, t0)
        return outs

    def gather_to_host(self, t: torch.Tensor, dim: int
                       ) -> Optional[torch.Tensor]:
        """The ranks' equal shards of `t` concatenated along `dim`, on the
        host of rank 0 (None on the others). Gloo gathers host copies (a
        CUDA shard staged); NCCL gathers on the device and copies the
        whole to the host."""
        t0 = time.perf_counter()
        src = t.detach().contiguous()
        if self._staged("gather", src):
            src = src.cpu()
        outs = [torch.empty_like(src) for _ in range(self.size)] \
            if self.rank == 0 else None
        dist.gather(src, outs, dst=dist.get_global_rank(self.group, 0)
                    if self.group is not None else 0, group=self.group)
        self._record("gather", src, t0)
        return None if outs is None else torch.cat(outs, dim=dim).cpu()

    def all_gather_dim(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' equal shards concatenated along `dim`."""
        return torch.cat(self.all_gather(shard), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int,
                       kind: str = "all_reduce") -> torch.Tensor:
        """This rank's chunk (of `size` equal chunks along `dim`) of the
        sum of `t` over the group (`t` is summed in place), recorded as
        `kind` (the data axis's gradient reduce as the all-reduce it is,
        the sequence's as "reduce_scatter")."""
        n = t.shape[dim] // self.size
        t0 = time.perf_counter()
        full = t.contiguous()
        dist.all_reduce(full, group=self.group)
        self._record(kind, full, t0)
        return full.narrow(dim, self.rank * n, n).clone()

    def barrier(self) -> None:
        dist.barrier(group=self.group)
