"""The paper's accuracy claim on the port: final loss against fp32 over
the design-space grid, port against reference.

The loop mirrors `benchmarks/design_space.py: _final_loss` line for line:
yi-9b smoke, `SyntheticLM(vocab, 33, 8, seed=0)` markov batches, constant
LR 2e-3 with 2 warm-up steps, 40 steps, the mean of the last 5 losses.
The rows are `run_blocks`' (fp32, m in {4, 8} x b in {16, 32, 64, tile},
the block schedule "8; b=16@0,b=64@50%", "4; b=16; backend=pallas") and
`run()`'s tile-24 rows HBFPConfig(m, 16, tile=24) at m 4 and 8: 13 rows.
Both packages start from the reference's `init_train_state` (carried over
by `from_jax_train_state`) and see the reference's batches as numpy. The
reference runs its Pallas kernels in interpret mode, the port their plain
versions. `BENCH_design_space.json` is not the yardstick: the reference
no longer reproduces it, so it runs live here.

Tolerances.
* In the smoke's bf16, the tail loss and its delta against fp32 within
  `tail_tol`: 0.01 for fp32 and m 8, 0.06 for m 4. XLA keeps fused bf16
  intermediates in f32 (ROADMAP C1), which an eager framework does not
  reproduce, and at m 4 the coarse grid turns those ulps into rounding
  flips: the measured gaps are at most 0.054 (m 4, b 64).
* Where the reference's tail losses of two rows differ by more than twice
  the larger of their tolerances, the port ranks the two rows alike.
* In f32, the first 3 steps running freely give losses within 2e-3
  relative (the HBFP loss tolerance of `test_torch_train.py`) in every
  row but `hbfp4_btile`: m 4 with whole-tile exponents parts from the
  reference at step 3 (ROADMAP C15, pinned by `test_m4_tile_flip`). In
  every row, that row included, each of the 3 steps taken from the same
  state (the reference's state before that step, carried over) gives a
  loss within 2e-3. The shares of bit-equal steps are printed.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import HBFPConfig as JHBFPConfig
from repro.core.opt_shell import narrow_params as jnarrow
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_params as jinit_params
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import loss_fn as jloss_fn
from repro.optim import make_schedule as jmake_schedule
from repro.precision import as_policy as jas_policy
from repro.precision.policy import ResolvedPolicy as JResolvedPolicy
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro_torch.configs import get_arch
from repro_torch.core import HBFPConfig
from repro_torch.optim import make_schedule
from repro_torch.precision import as_policy
from repro_torch.train import from_jax_train_state, make_step

STEPS = 40
F32_STEPS = 3
LOSS_TOL = 2e-3           # f32 step loss, relative
C15_ROW = "hbfp4_btile"   # parts free-running at f32 step 3 (ROADMAP C15)
GRAD_TOL = 3e-2           # test_torch_train.py's TOL["hbfp"]["grads"]
# (name, mantissa bits, spec): spec is a policy string, or (block, tile)
# for HBFPConfig(m, 16).with_block(block) / HBFPConfig(m, 16, tile=tile)
ROWS = ([("fp32", 0, None)]
        + [(f"hbfp{m}_b{b or 'tile'}", m, (b, None))
           for m in (4, 8) for b in (16, 32, 64, None)]
        + [("sched8_b16_b64@50%", 8, "8; b=16@0,b=64@50%"),
           ("hbfp4_b16_pallas", 4, "4; b=16; backend=pallas"),
           ("hbfp4_16_t24", 4, (None, 24)), ("hbfp8_16_t24", 8, (None, 24))])
NAMES = [r[0] for r in ROWS]
_RESULTS = {}             # row name -> its losses in both packages


def tail_tol(m: int) -> float:
    return 0.06 if m == 4 else 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(spec, m, cfg_cls):
    if spec is None or isinstance(spec, str):
        return spec
    block, tile = spec
    if tile is not None:
        return cfg_cls(m, 16, tile=tile)
    return cfg_cls(m, 16).with_block(block)


def _archs(dtype):
    ja = dataclasses.replace(jget_arch("yi-9b").smoke(), dtype=dtype)
    ta = dataclasses.replace(get_arch("yi-9b").smoke(), dtype=dtype)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    return ja, ta


def _tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """Per dtype: the archs, the reference's init state and its batches."""
    out = {}
    for dtype, n in (("bfloat16", STEPS), ("float32", F32_STEPS)):
        ja, ta = _archs(dtype)
        pipe = JSyntheticLM(ja.vocab_size, 33, 8, seed=0)
        batches = [_np(pipe.batch(i)) for i in range(n)]
        s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
        out[dtype] = (ja, ta, s0, batches)
    return out


def _steppers(row, ja, ta, steps):
    name, m, spec = next(r for r in ROWS if r[0] == row)
    kw = dict(base_lr=2e-3, warmup_steps=2, total_steps=steps)
    jstep = jmake_step(ja, jas_policy(_spec(spec, m, JHBFPConfig),
                                      total_steps=steps),
                       jmake_schedule("constant", **kw))
    tstep = make_step(ta, as_policy(_spec(spec, m, HBFPConfig),
                                    total_steps=steps),
                      make_schedule("constant", **kw), device="cpu")
    return jstep, tstep


def _run_row(row, setup):
    """Both packages' bf16 losses over 40 steps and f32 losses over 3
    (free-running, and the port's from the reference's state before each
    step), computed once per row."""
    if row in _RESULTS:
        return _RESULTS[row]
    out = {}
    ja, ta, s0, batches = setup["bfloat16"]
    jstep, tstep = _steppers(row, ja, ta, STEPS)
    js, ts = s0, from_jax_train_state(_np(s0), device="cpu")
    jl, tl = [], []
    for i, b in enumerate(batches):
        js, jm = jstep(js, b, jax.random.fold_in(jax.random.key(1), i))
        ts, tm = tstep(ts, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    out["bf16"] = (jl, tl)
    ja, ta, s0, batches = setup["float32"]
    jstep, tstep = _steppers(row, ja, ta, STEPS)
    js, ts = s0, from_jax_train_state(_np(s0), device="cpu")
    jl, tl, forced = [], [], []
    for i, b in enumerate(batches):
        # the port's step from the reference's state before this step
        _, fm = tstep(from_jax_train_state(_np(js), device="cpu"), _tb(b))
        forced.append(float(fm["loss"]))
        js, jm = jstep(js, b, jax.random.fold_in(jax.random.key(1), i))
        ts, tm = tstep(ts, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    out["f32"] = (jl, tl, forced)
    _RESULTS[row] = out
    return out


def _tail(losses):
    return sum(losses[-5:]) / 5


@pytest.mark.parametrize("row", NAMES)
def test_row_matches_reference(row, setup):
    m = next(r[1] for r in ROWS if r[0] == row)
    tol = tail_tol(m)
    res, base = _run_row(row, setup), _run_row("fp32", setup)
    jl, tl = res["bf16"]
    assert len(tl) == STEPS and np.isfinite(tl).all()
    jt, tt = _tail(jl), _tail(tl)
    jd, td = jt - _tail(base["bf16"][0]), tt - _tail(base["bf16"][1])
    jf, tf, forced = res["f32"]
    same = sum(a == b for a, b in zip(jf, tf)) / F32_STEPS
    same_forced = sum(a == b for a, b in zip(jf, forced)) / F32_STEPS
    print(f"{row}: bf16 tail loss ref {jt:.4f} port {tt:.4f} (gap "
          f"{tt - jt:+.4f}), delta vs fp32 ref {jd:+.4f} port {td:+.4f}; "
          f"f32 first {F32_STEPS} steps ref {jf} port {tf} (bit-equal "
          f"share {same:.2f}), from the reference's state {forced} "
          f"(bit-equal share {same_forced:.2f})")
    assert abs(tt - jt) <= tol, (row, jt, tt)
    assert abs(td - jd) <= tol, (row, jd, td)
    for a, b in zip(jf, forced):
        assert abs(a - b) <= LOSS_TOL * abs(a), (row, jf, forced)
    if row != C15_ROW:
        for a, b in zip(jf, tf):
            assert abs(a - b) <= LOSS_TOL * abs(a), (row, jf, tf)


def test_port_ranks_rows_as_reference(setup):
    """Every pair of rows whose reference tail losses differ by more than
    twice the larger of their tolerances is ranked alike by the port."""
    tails = {}
    for name, m, _ in ROWS:
        jl, tl = _run_row(name, setup)["bf16"]
        tails[name] = (_tail(jl), _tail(tl), tail_tol(m))
    ranked = 0
    for a, b in itertools.combinations(NAMES, 2):
        (ja, ta, tola), (jb, tb, tolb) = tails[a], tails[b]
        if abs(ja - jb) > 2 * max(tola, tolb):
            ranked += 1
            assert (ja < jb) == (ta < tb), (a, b, tails[a], tails[b])
    order = sorted(NAMES, key=lambda n: tails[n][0])
    print(f"{ranked} pairs ranked; reference order {order}; port order "
          f"{sorted(NAMES, key=lambda n: tails[n][1])}")
    assert ranked > 0


def test_m4_tile_flip(setup):
    """ROADMAP C15: m 4 with whole-tile exponents, f32. Step 1's loss
    agrees to the last ulps; from one state (the reference's after step 1)
    step 2's loss agrees too, and its grads are the reference's within
    `test_torch_train.py`'s HBFP grad tolerance. The first gradient to
    differ is the last layer's attn_wk (that layer's other grads are
    bit-equal): the k side of attention's backward sums f32 products of
    rows with different exponents, so its last ulps depend on the order
    of the sum, a 4-bit rounding of the k projection's gradient flips, and
    the flip spreads to every leaf below it. Free-running, the two
    packages part at step 3 (printed by `test_row_matches_reference`)."""
    ja, ta, s0, batches = setup["float32"]
    jstep, tstep = _steppers(C15_ROW, ja, ta, STEPS)
    js1, jm = jstep(s0, batches[0], jax.random.fold_in(jax.random.key(1), 0))
    ts, tm = tstep(from_jax_train_state(_np(s0), device="cpu"),
                   _tb(batches[0]))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-6 * float(jm["loss"])
    cfg = JHBFPConfig(4, 16).with_block(None).with_(requantize_weights=False)
    ctx = JCtx(policy=JResolvedPolicy(global_cfg=cfg, backend="sim"))
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda n, b: jloss_fn(n, b, ja, ctx), has_aux=True))(
        jnarrow(js1.params, cfg), batches[1])
    tloss, _, tg = tstep.grads(from_jax_train_state(_np(js1), device="cpu"),
                               _tb(batches[1]))
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * float(jloss)
    errs, equal = {}, []
    for path, a in jax.tree_util.tree_flatten_with_path(_np(jg))[0]:
        b = tg
        for k in path:
            b = b[k.key]
        b = b.detach().numpy()
        errs["/".join(k.key for k in path)] = float(
            np.linalg.norm(a - b) / np.linalg.norm(a))
        if a.ndim == 3:   # stacked layers: which of them are bit-equal
            equal += [f"{path[-1].key}[{i}]" for i in range(a.shape[0])
                      if (a[i] == b[i]).all()]
    print(f"C15: step-2 grads rel-fro {errs}; bit-equal layer slices "
          f"{equal}")
    assert max(errs.values()) <= GRAD_TOL, errs
