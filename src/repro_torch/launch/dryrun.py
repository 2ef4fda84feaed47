"""Multi-pod dry run (port of `repro.launch.dryrun`): build and run every
(arch × shape × mesh) cell on PyTorch's fake process group with fake
tensors, as rank 0 of the production mesh, and read its memory, cost and
collective statistics.

Two tracks per cell, as the reference's (DESIGN.md §7):
  * memory — the FULL model, rank 0's program of the cell on the fake
    process group under `FakeTensorMode`: the shardings of the port's
    layouts (ZeRO-1 and `tp_layout` for training, `ServeLayout` for
    prefill and decode) build, run and report per-device bytes:
    `argument_bytes` the rank's inputs (state or parameters, its batch
    rows, its cache part; the reference's step counters and PRNG key are
    host ints here), `output_bytes` the returned tensors (state updated
    in place counted as the reference counts its donated outputs),
    `temp_bytes` the peak of live fake-tensor bytes above the arguments
    (`_MemTrack`, a dispatch mode over every storage made), and
    `per_device_total_gib` their sum, as the reference sums them;
  * roofline — the same program at 2 and 4 layers with the reference's
    replacements (no scan, whole attention and CE, its SSM chunk); per
    layer costs from the (c4 - c2)/2 delta, extrapolated to the full
    depth, so `roofline_raw` means what the reference's means. FLOPs are
    `torch.utils.flop_counter.FlopCounterMode`'s: the products only
    (matmuls, attention, convolutions), where XLA's cost analysis also
    counts elementwise FLOPs; bytes the sum of each non-view aten op's
    input and output bytes (`_Bytes`); collective bytes the fake
    transport's records (`analysis.roofline.collective_bytes_from_records`:
    the result shapes at the reference's multipliers, a reduce-scatter
    counted as the all-reduce the transport issues).

Building and running a cell on fake tensors stands in for the reference's
lowering and compile: its wall time is `trace_s`. The cells run the sim
path (`Ctx`'s default backend, as the reference's `Ctx(cfg)`): fake
tensors hold no data for a kernel, so none is launched. The fake tensors
live on the device the caller names (`device`, the CUDA device by
default, "cpu" in the tests); nothing is allocated on either.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k \\
      --mesh single --device cpu
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch

from repro_torch.analysis.roofline import (collective_bytes_from_records,
                                           roofline_terms)
from repro_torch.configs import arch_ids, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import HBFP8_16, HBFPConfig
from repro_torch.device import dtype_of, resolve_device

SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,  batch=32),
    "decode_32k":  dict(kind="decode",  ctx=32768,  batch=128),
    "long_500k":   dict(kind="decode",  ctx=524288, batch=1),
}

FULL_ATTENTION_SKIP = "long_500k needs sub-quadratic attention; this arch " \
    "has full-attention layers (DESIGN.md §5) — skipped by assignment rule."

def _mesh(multi_pod: bool):
    """The production mesh on a fake process group of its 256 or 512 ranks
    (started here when no group runs; this process is rank 0)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.transport import init_fake_process_group
    need = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != need:
        dist.destroy_process_group()
    if not dist.is_initialized():
        init_fake_process_group(need)
    return make_production_mesh(multi_pod=multi_pod)


def _fake(tree, device):
    """A tree of meta tensors as fake tensors on `device` (under the
    caller's FakeTensorMode), keeping each tensor's `tp_dim`."""
    if isinstance(tree, dict):
        return {k: _fake(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake(v, device) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fake(v, device) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_fake(v, device) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    out = torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if hasattr(tree, "tp_dim"):
        out.tp_dim = tree.tp_dim
    return out


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _batch(arch: ArchConfig, kind: str, batch: int, seq: int, device):
    """The global batch of a cell (the reference's `_batch_struct`)."""
    pos_len = 1 if kind == "decode" else seq
    i32 = dict(dtype=torch.int32, device=device)
    b = {}
    if arch.input_kind == "embeddings":
        b["embeds"] = torch.empty((batch, pos_len, arch.d_model),
                                  dtype=dtype_of(arch.dtype), device=device)
    elif arch.n_codebooks > 1:
        b["tokens"] = torch.empty((batch, pos_len, arch.n_codebooks), **i32)
    else:
        b["tokens"] = torch.empty((batch, pos_len), **i32)
    b["positions"] = torch.empty((3, batch, pos_len) if arch.mrope
                                 else (batch, pos_len), **i32)
    if kind == "train":
        b["labels"] = torch.empty(
            (batch, pos_len, arch.n_codebooks) if arch.n_codebooks > 1
            else (batch, pos_len), **i32)
    return b


def _serving_params(arch: ArchConfig, layout, device):
    """A rank's serving parameters as fake tensors: the reference's
    `_serving_params_struct` (every >= 2-D leaf in the arch dtype) on the
    layout's shards."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from repro_torch.models.transformer import init_params
    dt = dtype_of(arch.dtype)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(dt) if t.ndim >= 2 else t

    # the shards' shapes on the meta device, outside the fake mode
    with unset_fake_temporarily():
        meta = layout.shard_params(cast(init_params(0, arch, device="meta")))
    return _fake(meta, device)


class Cell:
    """A built cell: `fn(*args)` runs rank 0's program; `arguments` are
    the rank's inputs whose bytes the memory track reports (the batch
    counted as the rank's rows); `replicated` {"params" or "cache": {leaf:
    reason}} the leaves the reference's specs shard over "model" and the
    port's layouts keep whole; `transports` the axes' transports, whose
    records are the cell's collectives."""

    def __init__(self, fn, args, arguments, replicated, transports):
        self.fn, self.args = fn, args
        self.arguments = arguments
        self.replicated = replicated
        self.transports = [t for t in transports if t is not None]


def build_cell(arch: ArchConfig, shape_name: str, mesh,
               hbfp: Optional[HBFPConfig], opts: Optional[dict] = None,
               device=None) -> Cell:
    """Rank 0's program of a cell on `mesh` (a DeviceMesh of the fake
    process group). Call it, and the cell's `fn`, under a
    `FakeTensorMode`.

    opts (the reference's levers; each the port's mechanism):
      grad_accum: int — microbatch accumulation (`make_train_step`);
      zero_grads: bool — the gradients into the ZeRO layout: always so
        in the port (`train.zero` reduces into the shards);
      seq_parallel: bool — the sequence-sharded residual stream on
        "model" (training and prefill);
      moe_shard: bool — the MoE groups on the data axes: always so in the
        port under a mesh (`Ctx.dp`);
      bfp_cache: bool — the 8-bit BFP KV cache (decode cells);
      ep_only: bool — MoE serving: only the experts shard (prefill).
    """
    from repro_torch.models.transformer import decode_step, prefill
    opts = opts or {}
    dev = resolve_device(device)
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    if kind == "train":
        from repro_torch.models.transformer import init_params
        from repro_torch.optim import make_schedule
        from repro_torch.train.train_step import (init_train_state,
                                                  layout_tile,
                                                  make_train_step)
        from repro_torch.train.zero import ZeroLayout
        from repro_torch.precision.policy import as_segment
        accum = int(opts.get("grad_accum", 1))
        seg = as_segment(hbfp, backend=arch.kernel_backend)
        zero = ZeroLayout(arch, mesh, dev, tile=layout_tile(seg),
                          seq_parallel=bool(opts.get("seq_parallel")))
        state = init_train_state(
            0, arch, lambda s, a, device: _fake(
                init_params(s, a, device="meta"), device),
            device=dev, mesh=zero)
        batch = _batch(arch, kind, sh["batch"], sh["seq"], dev)
        local = zero.local_batch(batch)
        if accum > 1:
            def micro(t, k):
                bdim = 1 if k == "positions" and t.ndim == 3 else 0
                shape = list(t.shape)
                shape[bdim] //= accum
                return torch.empty((accum, *shape), dtype=t.dtype,
                                   device=dev)
            batch = {k: micro(v, k) for k, v in batch.items()}
            local = zero.local_batch(batch, accum)
        sched = make_schedule(arch.lr_schedule, base_lr=3e-4,
                              warmup_steps=100, total_steps=10000)
        step = make_train_step(arch, hbfp, sched, grad_accum=accum,
                               device=dev, mesh=zero)
        return Cell(step, (state, batch),
                    {"state": state, "batch": local},
                    {"params": zero.replicated}, (zero.transport, zero.model))

    from repro_torch.train.serve_step import ServeLayout
    if kind == "prefill":
        lay = ServeLayout(arch, mesh, hbfp, dev,
                          ep_only=bool(opts.get("ep_only")),
                          seq_parallel=bool(opts.get("seq_parallel")))
        params = _serving_params(arch, lay, dev)
        batch = lay.local_batch(_batch(arch, kind, sh["batch"], sh["seq"],
                                       dev))
        ctx = lay.ctx(sh["batch"], prefill=True)

        def prefill_fn(params, batch):
            return prefill(params, batch, arch, ctx, std_pos=False)

        return Cell(prefill_fn, (params, batch),
                    {"params": params, "batch": batch},
                    {"params": lay.replicated}, (lay.data, lay.model))

    # decode: KV caches on the serving cache layout (the batch over the
    # data axes, kv heads over "model" where they divide it, else the
    # ring's slots: the flash-decoding layout)
    if opts.get("bfp_cache"):
        arch = dataclasses.replace(arch, bfp_kv_cache=True)
    lay = ServeLayout(arch, mesh, hbfp, dev)
    params = _serving_params(arch, lay, dev)
    batch = lay.local_batch(_batch(arch, kind, sh["batch"], 1, dev))
    cache = lay.make_cache(params, sh["batch"], sh["ctx"])
    ctx = lay.ctx(sh["batch"], sh["ctx"])

    def decode_fn(params, batch, cache):
        return decode_step(params, batch, cache, arch, ctx)

    return Cell(decode_fn, (params, batch, cache),
                {"params": params, "batch": batch, "cache": cache},
                {"params": lay.replicated,
                 "cache": lay.cache_layout(sh["batch"], sh["ctx"]).replicated},
                (lay.data, lay.model))


def applicable(arch: ArchConfig, shape_name: str) -> Optional[str]:
    """None if runnable, else skip reason."""
    if shape_name == "long_500k" and not arch.supports_long_context:
        return FULL_ATTENTION_SKIP
    return None


class _MemTrack(torch.utils._python_dispatch.TorchDispatchMode):
    """Live bytes of the storages every op makes (fake or real), and their
    peak: a storage counts from the op that makes it until it is freed
    (a weak reference's callback)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = {}

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def _add(self, t):
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            self._add(t)
        return out


class _Bytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The sum of each non-view aten op's tensor input and output bytes
    (the memory track's counterpart of XLA's "bytes accessed")."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
        return out


def _run_memory(arch, shape_name, mesh, hbfp, opts, device) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, shape_name, mesh, hbfp, opts, device)
        args = tree_bytes(cell.arguments)
        track = _MemTrack()
        with torch.no_grad() if SHAPES[shape_name]["kind"] != "train" \
                else torch.enable_grad(), track:
            out = cell.fn(*cell.args)
        outputs = tree_bytes(out)
    temp = track.peak
    return {"argument_bytes": int(args), "output_bytes": int(outputs),
            "temp_bytes": int(temp), "generated_code_bytes": 0,
            "per_device_total_gib": round((args + outputs + temp) / 2**30,
                                          3)}


def _run_costs(arch, shape_name, mesh, hbfp, opts, device) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, shape_name, mesh, hbfp, opts, device)
        flops, nbytes = FlopCounterMode(display=False), _Bytes()
        mark = [len(t.records) for t in cell.transports]
        with torch.no_grad() if SHAPES[shape_name]["kind"] != "train" \
                else torch.enable_grad(), flops, nbytes:
            cell.fn(*cell.args)
        recs = [r for t, k in zip(cell.transports, mark)
                for r in t.records[k:]]
    coll = collective_bytes_from_records(recs)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.total),
            "collective_bytes": coll["total_bytes"],
            "collective_detail": coll["by_kind"]}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             hbfp: Optional[HBFPConfig] = HBFP8_16,
             tracks=("memory", "roofline"), roofline_layers=(2, 4),
             opts: Optional[dict] = None, device=None):
    arch = get_arch(arch_id)
    skip = applicable(arch, shape_name)
    if skip:
        return {"arch": arch_id, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": skip}
    mesh = _mesh(multi_pod)
    dev = resolve_device(device)
    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single",
           "hbfp": None if hbfp is None else hbfp.name, "status": "ok",
           "opts": opts or {}}

    if "memory" in tracks:
        t0 = time.time()
        rec["memory"] = _run_memory(arch, shape_name, mesh, hbfp, opts, dev)
        rec["trace_s"] = round(time.time() - t0, 1)

    if "roofline" in tracks:
        costs = {}
        shp = SHAPES[shape_name]
        seq = shp.get("seq", shp.get("ctx", 4096))
        ssm_chunk = arch.ssm_chunk if shp["kind"] == "decode" \
            else max(arch.ssm_chunk, seq // 32)
        rec["roofline_ssm_chunk"] = ssm_chunk
        for L in roofline_layers:
            a2 = dataclasses.replace(arch, n_layers=L, scan_layers=False,
                                     q_chunk=1 << 30, loss_chunk=0,
                                     ssm_unroll=True, ssm_chunk=ssm_chunk)
            costs[L] = _run_costs(a2, shape_name, mesh, hbfp, opts, dev)
        L1, L2 = roofline_layers
        per_layer = {k: (costs[L2][k] - costs[L1][k]) / (L2 - L1)
                     for k in ("flops", "bytes", "collective_bytes")}
        fixed = {k: costs[L1][k] - L1 * per_layer[k] for k in per_layer}
        full = {k: fixed[k] + arch.n_layers * per_layer[k]
                for k in per_layer}
        rec["roofline_raw"] = {"per_layer": per_layer, "fixed": fixed,
                               "full": full,
                               "collective_detail": costs[L2]
                               ["collective_detail"]}
        n_chips = 512 if multi_pod else 256
        rec["roofline"] = roofline_terms(
            flops=full["flops"], bytes_hbm=full["bytes"],
            bytes_coll=full["collective_bytes"], n_chips=n_chips,
            arch=arch, shape_name=shape_name)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fp32-baseline", action="store_true",
                    help="disable HBFP (paper's fp32 reference)")
    ap.add_argument("--tracks", default="memory,roofline")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (the CUDA device by "
                    "default; nothing is allocated)")
    # the reference's hillclimb levers
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatch accumulation (train cells)")
    ap.add_argument("--zero-grads", action="store_true",
                    help="grads into the ZeRO layout: the port always "
                    "reduces into the shards (train/zero.py)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-shard the residual stream on 'model' "
                    "(train and prefill cells)")
    ap.add_argument("--moe-shard", action="store_true",
                    help="MoE groups on the data axes: the port always "
                    "routes a data rank's own groups under a mesh")
    ap.add_argument("--bfp-cache", action="store_true",
                    help="8-bit BFP KV cache (decode cells)")
    ap.add_argument("--ep-only", action="store_true",
                    help="MoE serving: shard only experts, replicate dense")
    ap.add_argument("--tag", default="",
                    help="suffix for the result key (optimized variants)")
    args = ap.parse_args(argv)
    opts = {}
    if args.grad_accum > 1:
        opts["grad_accum"] = args.grad_accum
    for name in ("zero_grads", "seq_parallel", "moe_shard", "bfp_cache",
                 "ep_only"):
        if getattr(args, name):
            opts[name] = True

    archs = list(arch_ids()) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    hbfp = None if args.fp32_baseline else HBFP8_16
    tracks = tuple(args.tracks.split(","))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch_id in archs:
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch_id}|{shape}|{'multi' if mp else 'single'}" \
                    + ("|fp32" if hbfp is None else "") \
                    + (f"|{args.tag}" if args.tag else "")
                if results.get(cell, {}).get("status") in ("ok", "skipped"):
                    print(f"[cached] {cell}")
                    continue
                print(f"[run] {cell}", flush=True)
                t0 = time.time()
                try:
                    rec = run_cell(arch_id, shape, mp, hbfp, tracks,
                                   opts=opts, device=args.device)
                except Exception as e:  # record failures, keep going
                    rec = {"arch": arch_id, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": f"{type(e).__name__}:"
                           f" {e}", "trace": traceback.format_exc()[-2000:]}
                rec["wall_s"] = round(time.time() - t0, 1)
                results[cell] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                print(f"  -> {rec['status']} ({rec['wall_s']}s)", flush=True)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")


if __name__ == "__main__":
    main()
