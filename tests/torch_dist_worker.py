"""Rank processes of the distributed CPU tests, on gloo:

    python tests/torch_dist_worker.py compress RANK N PORT DIR
    python tests/torch_dist_worker.py dp RANK N PORT DIR
    python tests/torch_dist_worker.py tp RANK N PORT DIR MODEL
    python tests/torch_dist_worker.py sr RANK N PORT DIR MESH
    python tests/torch_dist_worker.py serve RANK N PORT DIR

`compress` is one rank of `tests/test_torch_grad_compress.py`'s reduce,
`dp` one rank of `tests/test_torch_dp_train.py`'s ZeRO-1 runs, `tp` one
rank of `tests/test_torch_tp_train.py`'s runs on a {data N/MODEL, model
MODEL} mesh, `sr` one rank of `tests/test_torch_sr_mesh.py`'s stochastic
runs on the mesh named MESH (`SR_MESHES`), `serve` one rank of
`tests/test_torch_tp_serve.py`'s sharded prefill and decode on each mesh
of N ranks in `SERVE_MESHES`, one after another; each writes its results under DIR. This module imports torch and the port
only (no JAX), so a rank starts quickly; the tests import its settings
and hold the results against the reference and one process.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

from repro_torch.core import grad_compress as tgc
from repro_torch.core.formats import HBFPConfig
from repro_torch.configs import get_arch
from repro_torch.data import batch_for_arch
from repro_torch.optim import make_schedule
from repro_torch.optim.adamw import named_leaves
from repro_torch.precision import as_policy
from repro_torch.train import Trainer, init_train_state, make_step

# -- the compressed reduce -----------------------------------------------------

SHAPES = {"v": (1000,), "m": (24, 700), "t": (2, 8, 1024)}
MBITS = 8


def compress(rank: int, n: int, out: str) -> None:
    from repro_torch.launch.transport import Transport
    inp = dict(np.load(os.path.join(out, f"in{n}.npz")))
    g = {k: torch.from_numpy(inp["g:" + k][rank]) for k in SHAPES}
    r = {k: torch.from_numpy(inp["r:" + k][rank]) for k in SHAPES}
    tp = Transport()
    red, res = tgc.compressed_psum_tree(g, None, mantissa_bits=MBITS,
                                        residual=r, transport=tp)
    np.savez(os.path.join(out, f"port{n}_{rank}.npz"),
             **{"o:" + k: red[k].numpy() for k in SHAPES},
             **{"res:" + k: res[k].numpy() for k in SHAPES},
             kinds=np.array([x[0] for x in tp.records]),
             bytes=np.array([x[1] for x in tp.records]))


# -- ZeRO-1 training -----------------------------------------------------------

B, S, STEPS = 4, 32, 3
TILE = 64


def arch(dtype="float32"):
    return dataclasses.replace(get_arch("gemma2-2b").smoke(), dtype=dtype)


def cfg():
    return HBFPConfig(8, 16, tile=TILE)


def policy():
    return as_policy(cfg(), backend="pallas")


def sched():
    return make_schedule("constant", base_lr=1e-3, warmup_steps=0,
                         total_steps=10)


def batch(i):
    return batch_for_arch(arch(), B, S, step=i, device="cpu", kind="markov")


def accum_batch(i):
    parts = [batch(2 * i + a) for a in range(2)]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def np_tree(tree):
    return {n: t.detach().numpy().copy() for n, t in named_leaves(tree)}


def _exactness(layout, a):
    """(narrow copy equal, wide rounding equal) against one process."""
    from repro_torch.core.opt_shell import apply_update_
    from repro_torch.optim.adamw import slices
    from repro_torch.train.train_step import _narrow_copy
    c = cfg()
    shards = init_train_state(0, a, device="cpu", mesh=layout.mesh)
    full = init_train_state(0, a, device="cpu")
    got = layout.narrow_copy(shards.params, c, torch.float32)
    want = _narrow_copy(full.params, c, torch.float32)
    flat = lambda t: {**{f"layers/{i}/{k}": v for i, lp in
                         enumerate(t["layers"]) for k, v in lp.items()},
                      **{k: v for k, v in t.items() if k != "layers"}}
    narrow_equal = all(torch.equal(x, flat(want)[k])
                       for k, x in flat(got).items())
    rng = np.random.default_rng(5)
    sp, fp = dict(named_leaves(shards.params)), dict(named_leaves(
        full.params))
    for name, p in fp.items():
        u = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)
                             * 1e-3)
        many = p.ndim >= 3
        for i, us in enumerate(slices(u)):
            apply_update_(name, p, i if many else None, us, c)
        for i, us in enumerate(slices(layout.part(name, u))):
            layout.apply_update(name, sp[name], i if many else None, us, c)
    update_equal = all(torch.equal(sp[n], layout.part(n, fp[n]))
                       for n in fp)
    return narrow_equal, update_equal


def _run(step, state, steps, data):
    losses = []
    for i in range(steps):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
    return state, losses


def _gathered(layout, state, losses=None):
    g = layout.gather_state(state)
    if g is None:
        return None
    flat = lambda t: dict(named_leaves(t))
    return dict(params=flat(g.params), mu=flat(g.opt.mu), nu=flat(g.opt.nu),
                losses=losses)


def _states_equal(a, b) -> bool:
    pairs = [(a.params, b.params), (a.opt.mu, b.opt.mu),
             (a.opt.nu, b.opt.nu)]
    return a.step == b.step and a.opt.step == b.opt.step and all(
        torch.equal(x, dict(named_leaves(tb))[k])
        for ta, tb in pairs for k, x in named_leaves(ta))


def dp(rank: int, n: int, out: str) -> None:
    """3 steps (f32) and the exactness checks on every world size; on 2
    ranks also grad_accum, the bf16 run and the preempted resume: steps
    0-2 checkpointing at 2 and preempted at 3, step 3 from that state (the
    uninterrupted run), and a run resumed from the step-2 checkpoint."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    a = arch()
    res = {}
    step = make_step(a, policy(), sched(), device="cpu", mesh=mesh)
    layout = step.layout
    res["whole"] = {k: layout.whole_tiles(k, cfg())
                    for k, v in layout.shapes.items() if len(v) >= 2}
    state = init_train_state(0, a, device="cpu", mesh=mesh)
    res["init_shards"] = np_tree(state.params)
    res["narrow_equal"], res["update_equal"] = _exactness(layout, a)
    mark = len(layout.transport.records)
    state, res["losses"] = _run(step, state, 1, batch)
    res["step_bytes"] = layout.transport.bytes_by_kind(mark)
    res["staged"] = dict(layout.transport.staged)
    state, more = _run(step, state, STEPS - 1, lambda i: batch(i + 1))
    res["losses"] += more
    res["steps"] = _gathered(layout, state, res["losses"])
    if n == 2:
        astep = make_step(a, policy(), sched(), device="cpu", mesh=mesh,
                          grad_accum=2)
        st, losses = _run(astep, init_train_state(0, a, device="cpu",
                                                  mesh=mesh), 1, accum_batch)
        res["accum"] = _gathered(astep.layout, st, losses)
        b = arch("bfloat16")
        bstep = make_step(b, policy(), sched(), device="cpu", mesh=mesh)
        st, losses = _run(bstep, init_train_state(0, b, device="cpu",
                                                  mesh=mesh), STEPS, batch)
        res["bf16"] = _gathered(bstep.layout, st, losses)
        ckpt = os.path.join(out, "ckpt")
        kw = dict(train_step=step, data_fn=batch, ckpt_every=2,
                  device="cpu")
        first = Trainer(init_state=init_train_state(0, a, device="cpu",
                                                    mesh=mesh),
                        ckpt_dir=ckpt, **kw)
        try:
            first.run(4, fail_at_step=3, log_fn=None)
        except RuntimeError as e:
            res["preempted"] = str(e)
        whole = Trainer(init_state=first.state, **kw)
        whole.run(4, log_fn=None)
        resumed = Trainer(init_state=init_train_state(0, a, device="cpu",
                                                      mesh=mesh),
                          ckpt_dir=ckpt, **kw)
        res["resumed_from"] = resumed.start_step
        resumed.run(4, log_fn=None)
        res["resume_exact"] = _states_equal(resumed.state, whole.state)
        res["final"] = _gathered(layout, whole.state)
    with open(os.path.join(out, f"rank{n}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# -- tensor, sequence and expert parallelism -----------------------------------

TP_MESHES = ((1, 2), (2, 2), (1, 4))      # (data, model)
TP_TILE = 32                               # the sim path's weight tiles
ARCHS = ("qwen2-vl-72b", "yi-9b", "gemma2-2b", "minicpm-2b",
         "phi3-mini-3.8b", "arctic-480b", "llama4-scout-17b-a16e",
         "musicgen-large", "hymba-1.5b", "xlstm-350m")


def tp_policy(backend="sim", bits=8):
    """HBFP at tile 32 on the sim path (the layout then shards every
    smoke projection at model 2, attention included); tile 64 on the
    kernel path (the layout folds in the kernels' 128-tiles)."""
    return as_policy(HBFPConfig(bits, 16, tile=TP_TILE if backend == "sim"
                                else 64), backend=backend)


def smoke(name, dtype="float32"):
    return dataclasses.replace(get_arch(name).smoke(), dtype=dtype)


def arch_batch(a, i):
    return batch_for_arch(a, B, S, step=i, device="cpu", kind="markov")


def tp_run(a, pol, steps, data, mesh=None, **kw):
    """`steps` steps from the seed-0 init: (losses, the final state (the
    gathered whole under a mesh, None off rank 0), the step)."""
    step = make_step(a, pol, sched(), device="cpu", mesh=mesh, **kw)
    st = init_train_state(0, a, device="cpu",
                          mesh=None if mesh is None else step.layout)
    st, losses = _run(step, st, steps, data)
    return losses, st, step


def tp_result(layout, state, losses):
    """A mesh run's gathered state and its replicas: each leaf that the
    model ranks hold alike, as this rank's bytes."""
    out = _gathered(layout, state, losses) or {"losses": losses}
    p = dict(named_leaves(state.params))
    out["replicas"] = {n: p[n].numpy().copy() for n in p
                       if layout.tp_dims[n] is None}
    return out


def _narrow_exact(layout, a, pol):
    """The narrow copy on the mesh equals the model part of the
    one-process narrowing, bit for bit."""
    from repro_torch.train.train_step import _narrow_copy
    c = pol.resolve_segment(0).global_cfg
    got = layout.narrow_copy(init_train_state(0, a, device="cpu",
                                              mesh=layout).params,
                             c, torch.float32)
    want = _narrow_copy(init_train_state(0, a, device="cpu").params, c,
                        torch.float32)
    flat = lambda t: {**{f"layers/{k}": torch.stack([lp[k] for lp in
                                                     t["layers"]])
                         for k in t["layers"][0]},
                      **{k: v for k, v in t.items() if k != "layers"}}
    got, want = flat(got), flat(want)
    ok = True
    for n, w in want.items():
        d = layout.tp_dims[n]
        if d is not None:
            k = w.shape[d] // layout.m
            w = w.narrow(d, layout.rank_m * k, k)
        ok &= torch.equal(got[n].detach(), w.detach())
    return ok


def _operands_exact(tp, pol):
    """A row split over the model ranks, quantized on the all-reduced
    (MAX) row amax, equals the model part of the whole row's
    quantization, bit for bit: the sim path's Q_row, and B3's dequantized
    x at a one-group row (its plain version on the CPU)."""
    from repro_torch.core import bfp
    from repro_torch.kernels import hbfp_matmul as hm
    g = torch.Generator().manual_seed(7)
    x = torch.randn(16, 128, generator=g) * torch.exp2(
        torch.randint(-20, 20, (16, 1), generator=g).float())
    k = 128 // tp.size
    part = x[:, tp.rank * k:(tp.rank + 1) * k].contiguous()
    amax = tp.row_amax(part)
    c = pol.resolve_segment(0).global_cfg
    ok = torch.equal(bfp.quantize_act(part, c, amax=amax),
                     bfp.quantize_act(x, c)[:, tp.rank * k:(tp.rank + 1) * k])
    y = torch.randn(16, 8, generator=g)
    whole = hm.hbfp_wgrad(x, y, bm=16, bk=128, bn=8, operands=True)[1]
    mine = hm.hbfp_wgrad(part, y, bm=16, bk=k, bn=8, operands=True,
                         x_amax=amax)[1]
    return ok and torch.equal(mine, whole[:, tp.rank * k:(tp.rank + 1) * k])


def tp(rank: int, n: int, out: str, model: int) -> None:
    """Every mesh: the narrow copy, and 3 f32 steps with SP off and on.
    {1, 2} also: grad_accum 2, 3 bf16 steps on the kernel path, one step
    of every arch, telemetry and the controller. {2, 2}: the Trainer
    preempted and resumed."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.numerics import (ControllerConfig, PrecisionController,
                                      TapConfig)
    from repro_torch.numerics.stats import stats_to_host
    mesh = make_host_mesh(model=model)
    a, pol = arch(), tp_policy()
    res = {}
    losses, st, step = tp_run(a, pol, STEPS, batch, mesh)
    layout = step.layout
    res["replicated"] = dict(layout.replicated)
    res["narrow_equal"] = _narrow_exact(layout, a, pol)
    res["operands_equal"] = _operands_exact(layout.tp, pol)
    res["steps"] = tp_result(layout, st, losses)
    mark = len(layout.model.records)
    step(st, batch(0))
    res["step_kinds"] = layout.model.bytes_by_kind(mark)
    losses, st, step = tp_run(a, pol, STEPS, batch, mesh, seq_parallel=True)
    res["sp"] = tp_result(step.layout, st, losses)
    data = n // model
    if (data, model) == (1, 2):
        losses, st, step = tp_run(a, pol, 1, accum_batch, mesh, grad_accum=2)
        res["accum"] = tp_result(step.layout, st, losses)
        b = arch("bfloat16")
        losses, st, step = tp_run(b, tp_policy("pallas"), STEPS, batch, mesh)
        res["bf16"] = tp_result(step.layout, st, losses)
        res["archs"] = {}
        for name in ARCHS:
            sa = smoke(name)
            losses, st, step = tp_run(sa, pol, 1,
                                      lambda i: arch_batch(sa, i), mesh)
            res["archs"][name] = tp_result(step.layout, st, losses)
        # telemetry on every step, and the controller at 4 bits
        tel = make_step(a, pol, sched(), device="cpu", mesh=mesh,
                        tap=TapConfig(cadence=1))
        st = init_train_state(0, a, device="cpu", mesh=tel.layout)
        st, m = tel(st, batch(0))
        res["numerics"] = stats_to_host(m["numerics"])
        ctl = PrecisionController(ControllerConfig(patience=1, cooldown=0),
                                  base_bits=4)
        cstep = make_step(a, tp_policy(bits=4), sched(), device="cpu",
                          mesh=mesh, controller=ctl)
        st = init_train_state(0, a, device="cpu", mesh=cstep.layout)
        st, losses = _run(cstep, st, STEPS, batch)
        res["controller"] = {"log": ctl.log, "overrides": ctl.overrides(),
                             "losses": losses}
    if (data, model) == (2, 2):
        ckpt = os.path.join(out, "tp_ckpt")
        step = make_step(a, pol, sched(), device="cpu", mesh=mesh)
        kw = dict(train_step=step, data_fn=batch, ckpt_every=2,
                  device="cpu")
        init = lambda: init_train_state(0, a, device="cpu", mesh=step.layout)
        first = Trainer(init_state=init(), ckpt_dir=ckpt, **kw)
        try:
            first.run(4, fail_at_step=3, log_fn=None)
        except RuntimeError as e:
            res["preempted"] = str(e)
        whole = Trainer(init_state=first.state, **kw)
        whole.run(4, log_fn=None)
        resumed = Trainer(init_state=init(), ckpt_dir=ckpt, **kw)
        res["resumed_from"] = resumed.start_step
        resumed.run(4, log_fn=None)
        res["resume_exact"] = _states_equal(resumed.state, whole.state)
        res["final"] = _gathered(step.layout, whole.state)
    with open(os.path.join(out, f"tp{data}x{model}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# -- stochastic rounding under a mesh ------------------------------------------

# (name, pod, data, model)
SR_MESHES = (("d2", 1, 2, 1), ("m2", 1, 1, 2), ("p2d2", 2, 2, 1))
SR_SEED = 7
# the CE's loss chunk: 2 chunks of the 128 tokens, so a rank of {data 2}
# takes one whole chunk and a rank of {pod 2, data 2} half of one
SR_CHUNK = 64


def sr_arch(name="gemma2-2b"):
    return dataclasses.replace(get_arch(name).smoke(), dtype="float32",
                               loss_chunk=SR_CHUNK)


def sr_policy(backend="sim"):
    """8-bit stochastic HBFP: 32-tiles on the sim path (every smoke
    projection shards at model 2), 64 on the kernel path."""
    return as_policy(HBFPConfig(8, 16, tile=TP_TILE if backend == "sim"
                                else 64, rounding="stochastic"),
                     backend=backend)


def sr_key(i):
    """The key of step i (the Trainer's for seed SR_SEED)."""
    from repro_torch.kernels.common import fold_in
    return fold_in(fold_in(0, SR_SEED), i)


def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _base(b):
    return None if b is None else (tuple(b.shape), tuple(b.offset))


class OperandRecorder:
    """Within the block, every operand a product quantizes: the sim
    path's activation and weight quantizers (`core/hbfp_ops.py`) and the
    operands of B1-B3 (their plain versions' quantize passes, with the
    calls' index bases). Each record is (key, raw operand, quantized
    operand, base as (shape, offset) or None); on the kernel path the
    operands are padded 2-D, their base on the padded operand."""

    def __init__(self):
        self.records = []
        self.baseless = []

    def __enter__(self):
        from repro_torch.core import hbfp_ops
        from repro_torch.kernels import linear
        self._saved = [(hbfp_ops, "_q_act", hbfp_ops._q_act),
                       (hbfp_ops, "_q_w", hbfp_ops._q_w)] + [
            (linear, n, getattr(linear, n))
            for n in ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad")]
        rec = self.records
        q_act, q_w = hbfp_ops._q_act, hbfp_ops._q_w

        def act(x, cfg, key, contract_axis, tp=None, base=None):
            out = q_act(x, cfg, key, contract_axis, tp, base)
            rec.append((("act", key, contract_axis), _np(x), _np(out),
                        _base(base)))
            if tp is None and base is not None and any(base.offset):
                # the control: the same part drawn at its own indices
                # (where that takes no collective)
                self.baseless.append(torch.equal(
                    out, q_act(x, cfg, key, contract_axis, tp, None)))
            return out

        def wq(w, cfg, key, base=None):
            out = q_w(w, cfg, key, base)
            rec.append((("w", key), _np(w), _np(out), _base(base)))
            return out

        fwd, dgrad, wgrad = (getattr(linear, n) for n in
                             ("hbfp_matmul_fwd", "hbfp_dgrad", "hbfp_wgrad"))

        def b1(x, w, seed=None, **kw):
            y = fwd(x, w, seed, **kw)
            self._rows("fwd.x", x, seed, kw["bk"], kw, "x", 0)
            if kw.get("quantize_w", True):
                self._w("fwd.w", w, seed, kw)
            return y

        def b2(g, w, seed=None, **kw):
            dx = dgrad(g, w, seed, **kw)
            self._rows("dgrad.g", g, seed, kw["bn"], kw, "g", 0x20000000)
            if kw.get("quantize_w", True):
                self._w("dgrad.w", w, seed, kw)
            return dx

        def b3(x, g, seed=None, **kw):
            want = kw.pop("operands", False)
            dw, xh, gh = wgrad(x, g, seed, operands=True, **kw)
            for what, a, q, b in (("wgrad.x", x, xh, kw.get("x_base")),
                                  ("wgrad.g", g, gh, kw.get("g_base"))):
                rec.append(((what, int(seed)), _np(a), _np(q), _base(b)))
            return (dw, xh, gh) if want else dw

        hbfp_ops._q_act, hbfp_ops._q_w = act, wq
        linear.hbfp_matmul_fwd, linear.hbfp_dgrad, linear.hbfp_wgrad = \
            b1, b2, b3
        return self

    def _rows(self, what, a, seed, width, kw, name, stream):
        from repro_torch.kernels import ref
        af = a.to(torch.float32)
        out = torch.empty_like(af)
        C = af.shape[1]
        base = kw.get(f"{name}_base")
        for c0 in range(0, C, width):
            q, d = ref._quantize_rows(
                af, c0, width, C, kw["mantissa_bits"], kw.get("block", 0),
                kw["stochastic"], ref._seed_value(seed), stream,
                kw.get(f"{name}_amax"), base)
            out[:, c0:c0 + width] = q * d
        self.records.append(((what, int(seed)), _np(a), _np(out),
                             _base(base)))

    def _w(self, what, w, seed, kw):
        from repro_torch.kernels import ref
        base = kw.get("w_base")
        q, d = ref._quantize_w(w.to(torch.float32), 0, 0, w.shape[1],
                               kw["bk"], kw["bn"], kw["mantissa_bits"],
                               kw["stochastic"], ref._seed_value(seed),
                               base)
        self.records.append(((what, int(seed)), _np(w), _np(q * d),
                             _base(base)))

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _flat_narrow(t):
    out = {f"layers/{k}": torch.stack([lp[k] for lp in t["layers"]])
           for k in t["layers"][0]}
    out.update((k, v) for k, v in t.items() if k != "layers")
    return {k: v.detach() for k, v in out.items()}


def sr_narrow_exact(layout, a, pol) -> dict:
    """Step 1's narrow copy on the mesh against the model part of one
    process's (both on step 0's narrowing key), bit for bit; and the
    control: the same shards narrowed each as a whole leaf (no index
    base) differ somewhere on a rank whose shards have an offset."""
    from repro_torch.core.opt_shell import _weight_cfg, quantize_leaf
    from repro_torch.core.opt_shell import param_key
    from repro_torch.kernels.common import fold_in
    from repro_torch.train.train_step import _narrow_copy
    c = pol.resolve_segment(0).global_cfg
    nkey = fold_in(sr_key(0), 0x5EED)
    shards = init_train_state(0, a, device="cpu", mesh=layout).params
    got = _flat_narrow(layout.narrow_copy(shards, c, torch.float32, None,
                                          nkey))
    want = _flat_narrow(_narrow_copy(
        init_train_state(0, a, device="cpu").params, c, torch.float32,
        None, nkey))
    equal = True
    for n, w in want.items():
        d = layout.tp_dims[n]
        if d is not None:
            k = w.shape[d] // layout.m
            w = w.narrow(d, layout.rank_m * k, k)
        equal &= torch.equal(got[n], w)
    # the control, on the shards that keep their tiles whole and have an
    # offset (a shard that cuts a tile is gathered and rounded whole)
    differs = None
    for n, t in named_leaves(shards):
        cc = _weight_cfg(c, n, t)
        if cc is None or not any(layout.leaf_base(n).offset) \
                or not layout.whole_tiles(n, cc):
            continue
        own = quantize_leaf(t, cc, False, param_key(nkey, n, cc))
        differs = bool(differs) or not torch.equal(own, quantize_leaf(
            t, cc, False, param_key(nkey, n, cc), layout.leaf_base(n)))
    return dict(equal=bool(equal), differs_without_base=differs)


def sr_run(a, pol, steps, data, mesh=None, record=False, **kw):
    """`steps` steps from the seed-0 init on the keys `sr_key`: (losses,
    state, step, the first step's `OperandRecorder` or None)."""
    step = make_step(a, pol, sched(), device="cpu", mesh=mesh, **kw)
    st = init_train_state(0, a, device="cpu",
                          mesh=None if mesh is None else step.layout)
    losses, records = [], None
    for i in range(steps):
        if i == 0 and record:
            with OperandRecorder() as records:
                st, m = step(st, data(i), sr_key(i))
        else:
            st, m = step(st, data(i), sr_key(i))
        losses.append(float(m["loss"]))
    return losses, st, step, records


def _sr_mesh(name):
    from torch.distributed.device_mesh import init_device_mesh
    _, pod, data, model = next(m for m in SR_MESHES if m[0] == name)
    if pod > 1:
        return init_device_mesh("cpu", (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def sr(rank: int, n: int, out: str, name: str) -> None:
    """On mesh `name`: the sim and kernel paths' 3 steps under
    "8~stochastic" (their step-1 narrow copy and operand records), and
    per mesh: {data 2} grad_accum 2; {model 2} SP on; on both a step of
    llama4-scout (its MoE groups on the data axis, its experts sharded on
    E); {pod 2, data 2} the Trainer preempted and resumed."""
    mesh = _sr_mesh(name)
    a = sr_arch()
    res = {"runs": {}}
    runs = [("sim", "sim", {}), ("kernel", "pallas", {})]
    if name == "m2":
        runs.append(("sim_sp", "sim", {"seq_parallel": True}))
    for tag, backend, kw in runs:
        pol = sr_policy(backend)
        losses, st, step, rec = sr_run(a, pol, STEPS, batch, mesh,
                                       record=True, **kw)
        lay = step.layout
        res["runs"][tag] = dict(
            tp_result(lay, st, losses), records=rec.records,
            baseless_equal=rec.baseless,
            narrow=sr_narrow_exact(lay, a, pol), axis=lay.axis, n=lay.n,
            rank=lay.rank, rank_m=lay.rank_m)
    if name == "d2":
        losses, st, step, _ = sr_run(a, sr_policy(), 1, accum_batch, mesh,
                                     grad_accum=2)
        res["accum"] = tp_result(step.layout, st, losses)
    if name in ("d2", "m2"):
        # the experts: their groups on the data axis, or sharded on E
        la = sr_arch("llama4-scout-17b-a16e")
        losses, st, step, _ = sr_run(la, sr_policy(), 1,
                                     lambda i: arch_batch(la, i), mesh)
        res["llama4"] = tp_result(step.layout, st, losses)
    if name == "p2d2":
        ckpt = os.path.join(out, "sr_ckpt")
        step = make_step(a, sr_policy(), sched(), device="cpu", mesh=mesh)
        kw = dict(train_step=step, data_fn=batch, ckpt_every=2,
                  device="cpu", seed=SR_SEED)
        init = lambda: init_train_state(0, a, device="cpu", mesh=step.layout)
        first = Trainer(init_state=init(), ckpt_dir=ckpt, **kw)
        try:
            first.run(4, fail_at_step=3, log_fn=None)
        except RuntimeError as e:
            res["preempted"] = str(e)
        whole = Trainer(init_state=first.state, **kw)
        whole.run(4, log_fn=None)
        resumed = Trainer(init_state=init(), ckpt_dir=ckpt, **kw)
        res["resumed_from"] = resumed.start_step
        resumed.run(4, log_fn=None)
        res["resume_exact"] = _states_equal(resumed.state, whole.state)
        res["final"] = _gathered(step.layout, whole.state)
        res["ckpt"] = ckpt
    with open(os.path.join(out, f"sr_{name}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# -- sharded serving -----------------------------------------------------------

# (name, arch, data, model, options); yi-9b smoke has 4 query and 2 kv
# heads: at model 2 they shard, at model 4 the cache's ring does
SERVE_MESHES = (("y12", "yi-9b", 1, 2, {}),
                ("y14", "yi-9b", 1, 4, {}),
                ("y22", "yi-9b", 2, 2, {}),
                ("l12", "llama4-scout-17b-a16e", 1, 2, {"ep_only": True}),
                ("l22", "llama4-scout-17b-a16e", 2, 2, {"ep_only": True}),
                ("h12", "hymba-1.5b", 1, 2, {}),
                ("h14", "hymba-1.5b", 1, 4, {}))
SERVE_TILE = 32                 # the sim path's tiles: attention shards
SERVE_B, SERVE_S, SERVE_CTX, SERVE_TICKS = 4, 8, 16, 4
# (prompt, ring) where a mesh differs: hymba's sliding window (16 in the
# smoke arch) with a prompt longer than it, on the heads-sharded and the
# sequence-split ring
SERVE_DIMS = {"h12": (24, 32), "h14": (24, 32)}


def serve_dims(mesh=None):
    """(prompt length, ring length) of a serving case."""
    return SERVE_DIMS.get(mesh, (SERVE_S, SERVE_CTX))


def serve_cfg(act_block=None):
    return HBFPConfig(8, 16, tile=SERVE_TILE, act_block=act_block)


def serve_arch(name, bfp_kv=False, mesh=None):
    """The smoke arch of a serving case; on "l22" llama4 routes one MoE
    group over the global batch, which each data rank's tokens cut."""
    a = dataclasses.replace(get_arch(name).smoke(), dtype="float32",
                            bfp_kv_cache=bfp_kv)
    return dataclasses.replace(a, moe_groups=1) if mesh == "l22" else a


def serve_inputs(a, S=SERVE_S):
    """The global prompt [B, S] and the SERVE_TICKS decode tokens [B, 1]
    each, numpy int32, from a seed."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, a.vocab_size, (SERVE_B, S)).astype(np.int32)
    ticks = rng.integers(0, a.vocab_size,
                         (SERVE_TICKS, SERVE_B, 1)).astype(np.int32)
    return toks, ticks


class AttnRecorder:
    """Records attention's QK and PV products (x, w, result) in call order
    while installed (`models.attention.ctx_matmul` wrapped), and a
    ("stage",) entry where each stage (prefill, decode tick) begins."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod, self.calls = attention, []
        self.orig = attention.ctx_matmul

    def __enter__(self):
        def rec(x, w, ctx, site, *a, **kw):
            y = self.orig(x, w, ctx, site, *a, **kw)
            if site in ("qk", "pv"):
                self.calls.append((site, x.detach().numpy().copy(),
                                   w.detach().numpy().copy(),
                                   y.detach().numpy().copy()))
            return y
        self.mod.ctx_matmul = rec
        return self

    def __exit__(self, *exc):
        self.mod.ctx_matmul = self.orig

    def stage(self):
        self.calls.append(("stage",))


def serve_run(a, params, cfg, layout=None, record=True, S=SERVE_S,
              ctx_len=SERVE_CTX):
    """Prefill the S-token prompt, grow the cache to a ring of `ctx_len`
    and take the SERVE_TICKS decode steps, on one process (`layout` None)
    or this rank's part of a mesh: (logits [prefill, ticks...], the final
    cache's leaves as numpy, attention's recorded products)."""
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.train import serve_step as tss
    toks, ticks = serve_inputs(a, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32),
                          (SERVE_B, S)).copy()
    batch = {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos)}
    if layout is None:
        ctx_for = tss._serve_ctx(a, cfg, "cpu")
        pctx = dctx = ctx_for()
        local = lambda b: b
        p = params
    else:
        pctx = layout.ctx(SERVE_B, prefill=True)
        dctx = layout.ctx(SERVE_B, ctx_len)
        local = layout.local_batch
        p = layout.shard_params(params)
    rec = AttnRecorder()
    out = []
    with torch.no_grad(), rec:
        rec.stage()
        lg, cache = prefill(p, local(batch), a, pctx, device="cpu",
                            std_pos=False)
        out.append(lg.numpy().copy())
        cache = tss.prefill_to_decode_cache(cache, a, ctx_len) \
            if layout is None else \
            layout.decode_cache(cache, SERVE_B, ctx_len)
        for i in range(SERVE_TICKS):
            rec.stage()
            tb = {"tokens": torch.from_numpy(ticks[i]),
                  "positions": torch.full((SERVE_B, 1), S + i,
                                          dtype=torch.int32)}
            lg, cache = decode_step(p, local(tb), cache, a, dctx,
                                    device="cpu")
            out.append(lg.numpy().copy())
    leaves = {}
    for k, c in cache.items():
        fields = c._fields if hasattr(c, "_fields") else range(len(c))
        for f, t in zip(fields, c):
            if t is not None:
                leaves[f"{k}/{f}"] = t.numpy().copy()
    return out, leaves, rec.calls if record else None


def serve(rank: int, n: int, out: str) -> None:
    """Every mesh of N ranks in `SERVE_MESHES`, one at a time in these
    processes (`serve_mesh`)."""
    for name, _, data, model, _ in SERVE_MESHES:
        if data * model == n:
            serve_mesh(rank, out, name)


def serve_mesh(rank: int, out: str, name: str) -> None:
    """Mesh `name`'s cases: prefill and SERVE_TICKS decode ticks of its
    arch (yi-9b on {model 4} also with the 8-bit cache), and on {model 4}
    a ring of 8 whose runs of 2 slots cut 4-feature exponent groups
    (refused)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import from_jax_params
    from repro_torch.train.serve_step import (ServeLayout,
                                              narrow_serving_params)
    _, arch_name, data, model, opts = next(m for m in SERVE_MESHES
                                           if m[0] == name)
    mesh = init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))
    tree = dict(np.load(os.path.join(out, f"w_{arch_name}.npz")))
    res = {"cases": {}}
    cases = [False, True] if name == "y14" else [False]
    for bfp_kv in cases:
        a = serve_arch(arch_name, bfp_kv, name)
        params = narrow_serving_params(
            from_jax_params(_unflat(tree), device="cpu"), a, serve_cfg())
        lay = ServeLayout(a, mesh, serve_cfg(), device="cpu", **opts)
        S, ctx_len = serve_dims(name)
        logits, leaves, calls = serve_run(a, params, serve_cfg(), lay,
                                          S=S, ctx_len=ctx_len)
        clay = lay.cache_layout(SERVE_B, ctx_len)
        res["cases"][bfp_kv] = dict(
            logits=logits, cache=leaves, calls=calls, kv=clay.kv,
            cache_specs={k: tuple(v) for k, v in clay.specs.items()},
            cache_replicated=clay.replicated, replicated=lay.replicated,
            dims=lay.dims, rank_m=lay.rank_m, rank=lay.rank,
            records=list(lay.model.records) if lay.model else [])
    if name == "y12":
        # the reference's seq_parallel prefill: the residual stream's
        # tokens split over "model", the last token's hidden gathered
        from repro_torch.models.transformer import prefill
        a = serve_arch(arch_name)
        params = narrow_serving_params(
            from_jax_params(_unflat(tree), device="cpu"), a, serve_cfg())
        lay = ServeLayout(a, mesh, serve_cfg(), device="cpu",
                          seq_parallel=True)
        toks = torch.from_numpy(serve_inputs(a)[0])
        with torch.no_grad():
            lg, cache = prefill(lay.shard_params(params), {"tokens": toks},
                                a, lay.ctx(SERVE_B, prefill=True),
                                device="cpu", std_pos=False)
        res["sp"] = dict(logits=lg.numpy().copy(),
                         k=cache["kv"].k.numpy().copy(),
                         kinds=sorted({r[0] for r in lay.model.records}))
    if name == "y14":
        a = serve_arch(arch_name)
        params = narrow_serving_params(
            from_jax_params(_unflat(tree), device="cpu"), a, serve_cfg())
        lay = ServeLayout(a, mesh, serve_cfg(4), device="cpu")
        try:
            with torch.no_grad():
                from repro_torch.models.transformer import decode_step
                p = lay.shard_params(params)
                cache = lay.make_cache(p, SERVE_B, 8)
                decode_step(p, {"tokens": torch.zeros((SERVE_B, 1),
                                                      dtype=torch.int64),
                                "positions": torch.zeros((SERVE_B, 1),
                                                         dtype=torch.int32)},
                            cache, a, lay.ctx(SERVE_B, 8), device="cpu")
            res["refused"] = None
        except ValueError as e:
            res["refused"] = str(e)
    with open(os.path.join(out, f"serve_{name}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _unflat(flat: dict):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


if __name__ == "__main__":
    import torch.distributed as dist
    from repro_torch.launch.transport import init_process_group
    scenario, rank, n, port, out = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]),
                                    sys.argv[5])
    torch.set_num_threads(1)
    init_process_group(rank, n, port, device="cpu")
    if scenario == "tp":
        tp(rank, n, out, int(sys.argv[6]))
    elif scenario == "sr":
        sr(rank, n, out, sys.argv[6])
    elif scenario == "serve":
        serve(rank, n, out)
    else:
        {"compress": compress, "dp": dp}[scenario](rank, n, out)
    dist.destroy_process_group()
