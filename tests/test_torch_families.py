"""minicpm-2b and phi3-mini-3.8b in the port against the JAX package, at
smoke size on the reference's weights (`from_jax_train_state`,
`from_jax_params`).

* Two `make_step` steps under "8", "8; backend=pallas" and "fp32" from the
  reference's `init_train_state`, on the reference's markov batches, in
  f32 with `loss_chunk=32`, held with `test_torch_train.py`'s tolerances
  (TOL below, the reasons in that file's docstring). minicpm brings the
  embedding scale, the residual scale and the logit divisor; phi3 MHA
  and, in one case at `head_dim=96` (smoke forces 32), phi3's full-width
  head dim through the flash plain versions B4-B6. One minicpm case at an
  odd vocabulary (1001) runs the head GEMM through B1-B3's pad-and-slice,
  as minicpm's 122753 does at full width.
* Prefill and decode logits of the port's serve steps against the
  reference's jitted ones under "8; backend=pallas", as
  `tests/test_torch_serve.py` holds yi-9b: max|d| <= 2e-3·max|ref| in
  f32, 2e-2·max|ref| in bf16 (that file's reasons), the reference
  compiled without XLA's excess precision (ROADMAP C1).
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro.train import serve_step as jss
from repro_torch.configs import get_arch
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import from_jax_params
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.train import from_jax_train_state, make_step
from repro_torch.train import serve_step as tss

FAMILIES = ("minicpm-2b", "phi3-mini-3.8b")
POLICIES = ("8", "8; backend=pallas", "fp32")
LR = 1e-3
TOL = {  # loss (rel), grads, moments, updates (rel Frobenius per leaf)
    "hbfp": dict(loss=2e-3, grads=3e-2, moments=1e-1, updates=0.25),
    "fp32": dict(loss=1e-5, grads=1e-3, moments=1e-3, updates=1e-3),
}
SERVE_SPEC = "8; backend=pallas"
SERVE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
# (family, policy, smoke overrides): the three policies on each family,
# phi3 at its full-width head dim, minicpm at an odd vocabulary
STEP_CASES = ([(f, p, ()) for f in FAMILIES for p in POLICIES]
              + [("phi3-mini-3.8b", "8; backend=pallas",
                  (("head_dim", 96),)),
                 ("minicpm-2b", "8; backend=pallas",
                  (("vocab_size", 1001),))])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archs(name, **kw):
    ja = dataclasses.replace(jget_arch(name).smoke(), **kw)
    ta = dataclasses.replace(get_arch(name).smoke(), **kw)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    return ja, ta


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


@pytest.mark.parametrize("family,spec,over", STEP_CASES)
def test_two_steps_match_reference(family, spec, over):
    ja, ta = _archs(family, dtype="float32", loss_chunk=32, **dict(over))
    kw = dict(base_lr=LR, warmup_steps=0, total_steps=10)
    jsched, sched = (f("constant", **kw)
                     for f in (jmake_schedule, make_schedule))
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batches = [_np(jbatch(ja, 2, 32, step=i, kind="markov"))
               for i in range(2)]
    loss0, grads = _reference_grads(ja, spec, s0, batches[0])
    jstep = jmake_step(ja, spec, jsched)
    s1, m1 = jstep(s0, batches[0], jax.random.key(1))
    s2, m2 = jstep(s1, batches[1], jax.random.key(2))
    ref = _np(s2)
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
    state = from_jax_train_state(_np(s0), device="cpu")
    step = make_step(ta, spec, sched, device="cpu")
    tb = [_torch_batch(b) for b in batches]
    tloss0, _, tgrads = step.grads(state, tb[0])
    fa.reset_counts()
    hm.reset_counts()
    state, tm1 = step(state, tb[0])
    L, per = ta.n_layers, 7 * ta.n_layers + 2
    flash = (fa.hbfp_flash_fwd.plain_calls, fa.hbfp_flash_dq.plain_calls,
             fa.hbfp_flash_dkv.plain_calls)
    gemm = (hm.hbfp_matmul_fwd.plain_calls, hm.hbfp_dgrad.plain_calls,
            hm.hbfp_wgrad.plain_calls)
    state, tm2 = step(state, tb[1])
    pallas = spec.endswith("pallas")
    # global causal attention without a softcap takes flash on the kernel
    # backend: B4 twice a layer (forward and recompute), B5 and B6 once
    assert flash == ((2 * L, L, L) if pallas else (0, 0, 0)), flash
    assert gemm == ((2 * per, per, per) if pallas else (0, 0, 0)), gemm
    losses = (float(m1["loss"]), float(m2["loss"]))
    tlosses = (float(tm1["loss"]), float(tm2["loss"]))
    assert abs(float(tloss0) - loss0) <= tol["loss"] * loss0
    for a, b in zip(losses, tlosses):
        assert abs(a - b) <= tol["loss"] * abs(a), (losses, tlosses)
    shares = {
        "grads": _compare("grads", grads, tgrads, tol["grads"]),
        "mu": _compare("mu", ref.opt.mu, state.opt.mu, tol["moments"]),
        "nu": _compare("nu", ref.opt.nu, state.opt.nu, tol["moments"]),
        "updates": _compare("updates", ref.params, state.params,
                            tol["updates"], base=_np(s0).params),
    }
    worst = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
        _flat(ref.params), _flat(state.params)))
    assert worst <= 8 * LR, worst
    assert state.step == 2 and state.opt.step == 2
    print(f"{family} {spec!r} {dict(over)}: losses ref {losses} port "
          f"{tlosses}; bit-equal shares {shares}; max |dparam| {worst:.3g}")


def _compile(fn, *args):
    """The reference's jitted stage without XLA's excess precision (C1)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


@pytest.mark.parametrize("family,dtype,over", [
    ("minicpm-2b", "float32", ()), ("minicpm-2b", "bfloat16", ()),
    ("phi3-mini-3.8b", "float32", ()), ("phi3-mini-3.8b", "bfloat16", ()),
    ("phi3-mini-3.8b", "float32", (("head_dim", 96),))])
def test_prefill_and_decode_logits_match_reference(family, dtype, over):
    ja, ta = _archs(family, dtype=dtype, **dict(over))
    jp = jinit_params(jax.random.key(0), dataclasses.replace(
        ja, dtype="float32"))
    jpol, tpol = jparse_policy(SERVE_SPEC), parse_policy(SERVE_SPEC)
    # both sides cast the f32 weights to the compute dtype first, then
    # narrow (round-to-nearest-even casts agree bit for bit)
    jparams = jss.narrow_serving_params(
        jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)) if a.ndim >= 2
                     else a, jp), ja, jpol)
    tparams = tss.narrow_serving_params(
        from_jax_params(_np(jp), device="cpu", dtype=getattr(torch, dtype)),
        ta, tpol)
    B, S, C = 2, 8, 16
    rng = np.random.default_rng(3)
    toks = rng.integers(0, ja.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    nxt = rng.integers(0, ja.vocab_size, (B, 1)).astype(np.int32)
    npos = np.full((B, 1), S, np.int32)
    pre = {"tokens": toks, "positions": pos}
    jl, jc = _compile(jss.make_prefill_fn(ja, jpol), jparams, pre)(
        jparams, pre)
    jc = jss.prefill_to_decode_cache(jc, ja, C)
    dec = {"tokens": nxt, "positions": npos}
    jd, _ = _compile(jss.make_decode_fn(ja, jpol), jparams, dec, jc)(
        jparams, dec, jc)
    tl, tc = tss.make_prefill_fn(ta, tpol, device="cpu")(
        tparams, _torch_batch(pre))
    tc = tss.prefill_to_decode_cache(tc, ta, C)
    td, _ = tss.make_decode_fn(ta, tpol, device="cpu")(
        tparams, _torch_batch(dec), tc)
    tol = SERVE_TOL[dtype]
    errs = []
    for ref, got in ((jl, tl), (jd, td)):
        ref = np.asarray(ref, np.float32)
        got = got.float().numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        errs.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
        assert errs[-1] <= tol, (family, dtype, errs)
    print(f"{family} {dtype} {dict(over)}: prefill/decode max|d|/max|ref| "
          f"{errs}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_scale_rounds_like_jax(dtype):
    """ROADMAP C14: minicpm's residual scale 1.4/√40 is not a bf16 number;
    jax rounds the Python scalar to the branch's dtype before it
    multiplies, and so does the port's `_residual`: bit for bit."""
    from repro_torch.models.transformer import _residual
    _, ta = _archs("minicpm-2b")
    rng = np.random.default_rng(1)
    x, a = (rng.standard_normal((4, 64)).astype(np.float32) for _ in "xa")
    jx, ja_ = (jnp.asarray(v, jnp.dtype(dtype)) for v in (x, a))
    # op by op (a jitted fusion may contract the f32 product and sum)
    ref = np.asarray(jx + ta.residual_scale * ja_, np.float32)
    tx, tb = (torch.from_numpy(v).to(getattr(torch, dtype)) for v in (x, a))
    got = _residual(tx, tb, ta).float().numpy()
    assert (got == ref).all()
    # a scale rounded only at the end (f32 opmath) misses in bf16
    if dtype == "bfloat16":
        late = (tx + ta.residual_scale * tb).float().numpy()
        assert (late != ref).any()
