"""The port's training step on gemma2 smoke against the JAX package.

Both packages start from the reference's `init_train_state` (carried over
by `from_jax_train_state`) and take two `make_step` steps on the same two
markov batches (the reference's, as numpy), in f32 with `loss_chunk=32`
so the chunked cross-entropy runs (2 chunks of the 64 tokens) and S = 32
so the 16-token local window masks. The reference runs its Pallas kernels
in interpret mode; the port runs the kernels' plain versions.

Tolerances. fp32: the two frameworks' f32 ops differ in the last ulps
(rsqrt, tanh, exp, summation order): loss within 1e-5 relative, grads,
moments and the parameter updates p2 - p0 within 1e-3 in relative
Frobenius norm per leaf. HBFP ("8", "8; backend=pallas"): an ulp moves a
value across a BFP rounding boundary now and then, a flip at the head's
input changes logits by ~1e-2 and every gradient behind them; the
measured worst leaves are 0.9% (grads), 4% (moments) and 10% (updates,
where a near-zero gradient's sign flips AdamW's first steps): loss within
2e-3 relative, grads within 3e-2, moments within 1e-1, updates within
0.25, and no parameter further than 8·lr from the reference's. The shares
of bit-equal elements are printed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.opt_shell import narrow_params as jnarrow
from repro.data.pipeline import batch_for_arch as jbatch
from repro.models import init_params as jinit_params
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import loss_fn as jloss_fn
from repro.optim import make_schedule as jmake_schedule
from repro.precision import parse_policy as jparse_policy
from repro.precision.policy import ResolvedPolicy as JResolvedPolicy
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro_torch.configs import get_arch
from repro_torch.data import batch_for_arch
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.optim import make_schedule
from repro_torch.train import (Trainer, from_jax_train_state,
                               init_train_state, make_step)

LR = 1e-3
_FINAL_LOSS = {}    # test_port_learns: mean of the last 5 losses per policy
POLICIES = ("8", "8; backend=pallas", "fp32")
TOL = {  # loss (rel), grads, moments, updates (rel Frobenius per leaf)
    "hbfp": dict(loss=2e-3, grads=3e-2, moments=1e-1, updates=0.25),
    "fp32": dict(loss=1e-5, grads=1e-3, moments=1e-3, updates=1e-3),
}


def _archs(**kw):
    ja = dataclasses.replace(jget_arch("gemma2-2b").smoke(), dtype="float32",
                             loss_chunk=32, **kw)
    ta = dataclasses.replace(get_arch("gemma2-2b").smoke(), dtype="float32",
                             loss_chunk=32, **kw)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    return ja, ta


def _schedules():
    kw = dict(base_lr=LR, warmup_steps=0, total_steps=10)
    return jmake_schedule("constant", **kw), make_schedule("constant", **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree.detach().float().numpy()
    else:
        yield prefix, np.asarray(tree, np.float32)


def _compare(what, ref, got, tol, base=None):
    """Relative Frobenius error per leaf <= tol; returns the bit-equal
    share over all elements."""
    base = dict(_flat(base)) if base is not None else {}
    same = total = 0
    for (n, a), (n2, b) in zip(_flat(ref), _flat(got)):
        assert n == n2 and a.shape == b.shape, (what, n, n2)
        if n in base:
            a, b = a - base[n], b - base[n]
        err = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert err <= tol, (what, n, err)
        same += int((a == b).sum())
        total += a.size
    return same / total


def _reference_grads(ja, spec, state, batch):
    """The reference's narrow -> value_and_grad of one train step, as its
    make_train_step composes them for a uniform policy."""
    seg = jparse_policy(spec).resolve_segment(0)
    act = pcfg = None
    if seg.global_cfg is not None:
        act = seg.global_cfg.with_(
            requantize_weights=seg.backend == "pallas")
        pcfg = seg.global_cfg.with_(requantize_weights=False)
    ctx = JCtx(policy=JResolvedPolicy(global_cfg=act, backend=seg.backend))
    grad = jax.jit(jax.value_and_grad(
        lambda n, b: jloss_fn(n, b, ja, ctx), has_aux=True))
    (loss, _), g = grad(jnarrow(state.params, pcfg), batch)
    return float(loss), _np(g)


@pytest.fixture(scope="module")
def setup():
    ja, ta = _archs()
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batches = [_np(jbatch(ja, 2, 32, step=i, kind="markov"))
               for i in range(2)]
    return ja, ta, s0, batches


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's two steps and step-1 grads per policy, computed
    once per module."""
    ja, _, s0, batches = setup
    jsched, _ = _schedules()
    runs = {}
    for spec in POLICIES:
        loss0, grads = _reference_grads(ja, spec, s0, batches[0])
        step = jmake_step(ja, spec, jsched)
        s1, m1 = step(s0, batches[0], jax.random.key(1))
        s2, m2 = step(s1, batches[1], jax.random.key(2))
        runs[spec] = dict(loss0=loss0, grads=grads, state=_np(s2),
                          losses=(float(m1["loss"]), float(m2["loss"])))
    return runs


@pytest.mark.parametrize("spec", POLICIES)
def test_two_steps_match_reference(spec, setup, reference):
    _, ta, s0, batches = setup
    ref = reference[spec]
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
    _, sched = _schedules()
    state = from_jax_train_state(_np(s0), device="cpu")
    step = make_step(ta, spec, sched, device="cpu")
    tb = [_torch_batch(b) for b in batches]
    loss0, _, grads = step.grads(state, tb[0])
    state, m1 = step(state, tb[0])
    state, m2 = step(state, tb[1])
    losses = (float(m1["loss"]), float(m2["loss"]))
    assert abs(float(loss0) - ref["loss0"]) <= tol["loss"] * ref["loss0"]
    for a, b in zip(ref["losses"], losses):
        assert abs(a - b) <= tol["loss"] * abs(a), (ref["losses"], losses)
    shares = {
        "grads": _compare("grads", ref["grads"], grads, tol["grads"]),
        "mu": _compare("mu", ref["state"].opt.mu, state.opt.mu,
                       tol["moments"]),
        "nu": _compare("nu", ref["state"].opt.nu, state.opt.nu,
                       tol["moments"]),
        "updates": _compare("updates", ref["state"].params, state.params,
                            tol["updates"], base=_np(s0).params),
    }
    worst = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
        _flat(ref["state"].params), _flat(state.params)))
    assert worst <= 8 * LR, worst
    assert state.step == 2 and state.opt.step == 2
    print(f"{spec}: losses ref {ref['losses']} port {losses}; bit-equal "
          f"shares {shares}; max |Δparam| {worst:.3g}")


def test_grad_accum_matches_reference(setup):
    """grad_accum=2 under the kernel backend: the two batches as
    microbatches of one step, mean grads accumulated in f32."""
    ja, ta, s0, batches = setup
    spec = "8; backend=pallas"
    jsched, sched = _schedules()
    micro = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    s1, m1 = jmake_step(ja, spec, jsched, grad_accum=2)(
        s0, micro, jax.random.key(1))
    state = from_jax_train_state(_np(s0), device="cpu")
    state, tm = make_step(ta, spec, sched, grad_accum=2, device="cpu")(
        state, _torch_batch(micro))
    tol = TOL["hbfp"]
    assert abs(float(tm["loss"]) - float(m1["loss"])) <= \
        tol["loss"] * float(m1["loss"])
    ref = _np(s1)
    share = _compare("mu", ref.opt.mu, state.opt.mu, tol["moments"])
    _compare("updates", ref.params, state.params, tol["updates"],
             base=_np(s0).params)
    print(f"grad_accum=2: loss ref {float(m1['loss'])} port "
          f"{float(tm['loss'])}, mu bit-equal share {share:.4f}")


def test_kernel_calls_per_step(setup):
    """On the CPU every projection and the head go through the three
    wrappers' plain versions: with per-layer recompute and 2 CE chunks a
    step makes 2·(7·L + 2) forward calls (forward + recompute) and
    7·L + 2 each of dgrad and wgrad."""
    _, ta, s0, batches = setup
    _, sched = _schedules()
    state = from_jax_train_state(_np(s0), device="cpu")
    step = make_step(ta, "8; backend=pallas", sched, device="cpu")
    hm.reset_counts()
    step(state, _torch_batch(batches[0]))
    per = 7 * ta.n_layers + 2
    assert hm.hbfp_matmul_fwd.plain_calls == 2 * per
    assert hm.hbfp_dgrad.plain_calls == per
    assert hm.hbfp_wgrad.plain_calls == per
    assert hm.hbfp_matmul_fwd.launches == hm.hbfp_dgrad.launches == 0
    hm.reset_counts()


def test_yi_step_matches_reference():
    """One make_step step of yi-9b smoke under "8; backend=pallas", port
    against reference from the reference's state and batch: its attention
    takes flash in both packages (the reference's Pallas kernels in
    interpret mode, the port's B4-B6 plain versions: B4 2·L times a step
    with the per-layer recompute, B5 and B6 L times). Bounds as for gemma2
    (TOL["hbfp"], the module docstring's reasons)."""
    spec = "8; backend=pallas"
    ja, ta = (dataclasses.replace(g("yi-9b").smoke(), dtype="float32",
                                  loss_chunk=32)
              for g in (jget_arch, get_arch))
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batch = _np(jbatch(ja, 2, 32, step=0, kind="markov"))
    jsched, sched = _schedules()
    loss0, grads = _reference_grads(ja, spec, s0, batch)
    s1, m1 = jmake_step(ja, spec, jsched)(s0, batch, jax.random.key(1))
    state = from_jax_train_state(_np(s0), device="cpu")
    step = make_step(ta, spec, sched, device="cpu")
    tb = _torch_batch(batch)
    tloss0, _, tgrads = step.grads(state, tb)
    fa.reset_counts()
    state, tm = step(state, tb)
    L = ta.n_layers
    assert (fa.hbfp_flash_fwd.plain_calls, fa.hbfp_flash_dq.plain_calls,
            fa.hbfp_flash_dkv.plain_calls) == (2 * L, L, L)
    tol = TOL["hbfp"]
    assert abs(float(tloss0) - loss0) <= tol["loss"] * loss0
    assert abs(float(tm["loss"]) - float(m1["loss"])) <= \
        tol["loss"] * float(m1["loss"])
    share = _compare("grads", grads, tgrads, tol["grads"])
    _compare("updates", _np(s1).params, state.params, tol["updates"],
             base=_np(s0).params)
    worst = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
        _flat(_np(s1).params), _flat(state.params)))
    assert worst <= 8 * LR, worst
    print(f"yi-9b smoke: loss ref {float(m1['loss'])} port "
          f"{float(tm['loss'])}; grads bit-equal share {share:.4f}; max "
          f"|Δparam| {worst:.3g}")


@pytest.mark.parametrize("spec", ["8", "fp32"])
def test_port_learns(spec):
    """The port alone: 30 Trainer steps on markov data at smoke size (the
    port's own init and data); the loss falls."""
    _, ta = _archs()
    sched = make_schedule("cosine", base_lr=3e-3, warmup_steps=5,
                          total_steps=30)
    state = init_train_state(0, ta, device="cpu")
    step = make_step(ta, spec, sched, device="cpu")
    lines = []
    trainer = Trainer(train_step=step, init_state=state, device="cpu",
                      data_fn=lambda i: batch_for_arch(
                          ta, 2, 32, step=i, kind="markov", device="cpu"))
    _, metrics = trainer.run(30, log_every=1, log_fn=lines.append)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    _FINAL_LOSS[spec] = np.mean(losses[-5:])
    if len(_FINAL_LOSS) == 2:
        gap = _FINAL_LOSS["8"] - _FINAL_LOSS["fp32"]
        print(f"final loss (mean of last 5): {_FINAL_LOSS}; "
              f"HBFP8 - fp32 gap {gap:+.4f}")


def test_adamw_and_wide_update_match_reference():
    """AdamW (clipped, decayed, scheduled) then Q_wide(p + u) on a small
    tree, port against reference: the f32 arithmetic per element is the
    reference's, so the moments and the widened params agree to the last
    ulps (the grad norm and b^t are summed and raised by different
    libraries: 1e-6 relative)."""
    from repro.core.opt_shell import hbfp_apply_updates as japply
    from repro.core.opt_shell import widen_params as jwiden
    from repro.optim.adamw import adamw_init as jinit
    from repro.optim.adamw import adamw_update as jupdate
    from repro_torch.core import HBFP8_16
    from repro_torch.core.opt_shell import hbfp_apply_updates, widen_params
    from repro_torch.optim import adamw_init, adamw_update
    from repro.core import formats as jfmt
    rng = np.random.default_rng(3)
    shapes = {"head_w": (64, 96), "final_norm_scale": (64,),
              "layers": {"attn_wq": (2, 64, 64), "ln1_norm_scale": (2, 64)}}

    def draw(t, scale):
        if isinstance(t, dict):
            return {k: draw(v, scale) for k, v in t.items()}
        return (rng.standard_normal(t) * scale).astype(np.float32)

    p0 = jwiden(draw(shapes, 0.1), jfmt.HBFPConfig(8, 16))
    p0 = _np(p0)
    jsched, sched = (f("cosine", base_lr=1e-2, warmup_steps=2,
                       total_steps=10)
                     for f in (jmake_schedule, make_schedule))
    jstate, jp = jinit(p0), p0
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p0)
    tstate = adamw_init(tp)
    assert _compare("widen", _np(jwiden(p0, jfmt.HBFPConfig(8, 16))),
                    widen_params(tp, HBFP8_16), 0.0) == 1.0
    for clip in (None, 1.0, 1.0):
        g = draw(shapes, 3.0)
        ju, jstate = jupdate(g, jstate, jp, lr=jsched, grad_clip=clip)
        jp = _np(japply(jp, ju, jfmt.HBFPConfig(8, 16)))
        tg = jax.tree.map(torch.from_numpy, g)
        tu, tstate = adamw_update(tg, tstate, tp, lr=sched, grad_clip=clip)
        tp = hbfp_apply_updates(tp, tu, HBFP8_16)
        if clip is None:   # no global norm: the moments are bit-equal
            assert _compare("mu", _np(jstate.mu), tstate.mu, 0.0) == 1.0
            assert _compare("nu", _np(jstate.nu), tstate.nu, 0.0) == 1.0
    assert tstate.step == int(jstate.step) == 3
    for what, a, b in (("mu", jstate.mu, tstate.mu),
                       ("nu", jstate.nu, tstate.nu),
                       ("params", jp, tp)):
        share = _compare(what, _np(a), b, 1e-6)
        print(f"adamw {what}: bit-equal share {share:.4f}")
