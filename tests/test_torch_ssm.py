"""hymba, the hybrid family (attention and a mamba branch in parallel,
`models/ssm.py`, sliding-window attention over a ring), in the port
against the JAX package at smoke size (2 layers, window 16, ssm_chunk 8)
on the reference's weights.

* `ssm_branch` (and through it `_chunk_scan`) in its three state forms:
  a fresh scan, a scan seeded with a state (chunked prefill) and one
  recurrence step (decode), at S = 13, not a multiple of the chunk.
  Without HBFP in f32 the two frameworks differ only in op order and the
  ulps of exp/softplus: outputs and states within 1e-5·max|ref|, grads
  (fresh and seeded forms, against `jax.grad`) within 1e-4 in relative
  Frobenius norm; in bf16 the projections round their outputs to bf16 at
  different places, 2e-2·max|ref|. A steep decay (log a ≈ -28 a step,
  so exp(L_t - L_s) would reach e^196 above the diagonal) pins the mask
  going on before the exp: unmasked, exp overflows there and the
  backward sees inf·0.
* The model's loss and grads under "fp32", "8" and "8; backend=pallas"
  (the Pallas kernels in interpret mode; the port's plain versions), and
  two `make_step` steps, with `test_torch_train.py`'s tolerances and
  reasons (TOL below).
* Prefill then decode, and token-by-token decode past the window (the
  ring wraps), against the reference's logits: the serve steps'
  tolerances of `tests/test_torch_serve.py` (2e-3·max|ref| in f32, 2e-2
  in bf16), 1e-5·max|ref| for the fp32 decode chain.
* `ServeEngine` on the CPU: paged == slab token for token with one
  prompt longer than the window (chunked prefill through the ring); a
  chunked prefill leaves the SSM state, KV and logits of a one-shot
  prefill (1e-5·max|ref|) and the same tokens.
* The reference's init carried over at the arch's bf16 with
  `dtype=None`: every leaf keeps its name, shape and dtype, f32 leaves
  f32; the port's own init has the same layout.
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
from repro.models import ssm as jssm
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import decode_step as jdecode_step
from repro.models.transformer import loss_fn as jloss_fn
from repro.models.transformer import make_cache as jmake_cache
from repro.optim import make_schedule as jmake_schedule
from repro.precision import parse_policy as jparse_policy
from repro.precision.policy import ResolvedPolicy as JResolvedPolicy
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro.train import serve_step as jss
from repro_torch.configs import get_arch
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import (Ctx, decode_step, forward, from_jax_params,
                                init_params, make_cache, prefill)
from repro_torch.models import ssm as tssm
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.serve import ServeEngine
from repro_torch.train import from_jax_train_state, make_step
from repro_torch.train import serve_step as tss

ARCH = "hymba-1.5b"
POLICIES = ("fp32", "8", "8; backend=pallas")
LR = 1e-3
TOL = {  # loss (rel), grads, moments, updates (rel Frobenius per leaf)
    "hbfp": dict(loss=2e-3, grads=3e-2, moments=1e-1, updates=0.25),
    "fp32": dict(loss=1e-5, grads=1e-3, moments=1e-3, updates=1e-3),
}
SERVE_SPEC = "8; backend=pallas"
SERVE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archs(**kw):
    ja = dataclasses.replace(jget_arch(ARCH).smoke(), **kw)
    ta = dataclasses.replace(get_arch(ARCH).smoke(), **kw)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    return ja, ta


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    """A numpy (or bf16 ml_dtypes) array as a torch tensor, cast to
    `dtype` when given."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


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


def _close(ref, got, tol, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                               1e-30)
    assert err <= tol, (what, err)
    return err


def _rel_fro(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ----------------------------------------------------------------------------
# the branch and its scan
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("form,dtype", [
    ("fresh", "float32"), ("seeded", "float32"), ("step", "float32"),
    ("steep", "float32"), ("fresh", "bfloat16"), ("seeded", "bfloat16"),
    ("step", "bfloat16")])
def test_ssm_branch_matches_reference(form, dtype):
    _, ta = _archs()
    D, H, N, Q = ta.d_model, ta.n_heads, ta.ssm_state, ta.ssm_chunk
    B, S = 2, 1 if form == "step" else 13
    P = ta.d_inner // H
    jdt = jnp.dtype(dtype)
    jp = jssm.init_ssm(jax.random.key(3), D, ta.d_inner, H, N, jdt)
    rng = np.random.default_rng(5)
    if form == "steep":
        # A = -40, dt ~ 0.7: L_t - L_s above the diagonal overflows exp
        jp = dict(jp, ssm_a_log=jnp.full((H,), np.log(40.0), jnp.float32))
    u = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = None if form in ("fresh", "steep") else \
        (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
    r_y = rng.standard_normal((B, S, D)).astype(np.float32)
    r_h = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def jf(params, u_, h_):
        st = None if h_ is None else (h_,)
        y, (h,) = jssm.ssm_branch(u_.astype(jdt), params, JCtx(None),
                                  n_heads=H, d_state=N, chunk=Q, state=st)
        return (y.astype(jnp.float32) * r_y).sum() + (h * r_h).sum(), (y, h)

    jargs = (jp, jnp.asarray(u), None if h0 is None else jnp.asarray(h0))
    # compiled as the serving tests compile the reference (C1)
    (_, (jy, jh)), jg = _compile(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True), *jargs)(*jargs)
    tdt = getattr(torch, dtype)
    tp = {k: _t(v, tdt if v.ndim >= 2 else None).requires_grad_()
          for k, v in _np(jp).items()}
    tu = torch.from_numpy(u).requires_grad_()
    th = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    ty, (tho,) = tssm.ssm_branch(tu.to(tdt), tp, Ctx(device="cpu"),
                                 n_heads=H, d_state=N, chunk=Q,
                                 state=None if th is None else (th,))
    tol = SCAN_TOL[dtype]
    errs = [_close(jy, ty, tol, "y"), _close(jh, tho, tol, "h")]
    if dtype == "float32" and form != "step":
        obj = (ty.float() * torch.from_numpy(r_y)).sum() + \
            (tho * torch.from_numpy(r_h)).sum()
        obj.backward()
        jgp, jgu, jgh = jg
        for k in tp:
            assert _rel_fro(jgp[k], tp[k].grad) <= 1e-4, k
        assert _rel_fro(jgu, tu.grad) <= 1e-4
        if th is not None:
            assert _rel_fro(jgh, th.grad) <= 1e-4
        assert all(torch.isfinite(t.grad).all() for t in tp.values())
    print(f"{form} {dtype}: max|d|/max|ref| y, h {errs}")


# ----------------------------------------------------------------------------
# the model: loss, grads, steps
# ----------------------------------------------------------------------------

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
def train_setup():
    # S = 20: the chunk scan pads 20 to 24, the 16-token window masks
    ja, ta = _archs(dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batches = [_np(jbatch(ja, 2, 20, step=i, kind="markov"))
               for i in range(2)]
    return ja, ta, s0, batches


@pytest.mark.parametrize("spec", POLICIES)
def test_loss_and_grads_match_reference(spec, train_setup):
    ja, ta, s0, batches = train_setup
    loss, grads = _reference_grads(ja, spec, s0, batches[0])
    sched = make_schedule("constant", base_lr=LR, warmup_steps=0,
                          total_steps=10)
    step = make_step(ta, spec, sched, device="cpu")
    state = from_jax_train_state(_np(s0), device="cpu")
    hm.reset_counts()
    tloss, _, tgrads = step.grads(state, _torch_batch(batches[0]))
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
    # 9 projections a layer (4 attention, 2 ssm, 3 ffn) and the head, one
    # CE chunk (40 tokens, loss_chunk 32 does not divide them)
    per = 9 * ta.n_layers + 1
    calls = (hm.hbfp_matmul_fwd.plain_calls, hm.hbfp_dgrad.plain_calls,
             hm.hbfp_wgrad.plain_calls)
    assert calls == ((2 * per - 1, per, per) if spec.endswith("pallas")
                     else (0, 0, 0)), calls
    assert abs(float(tloss) - loss) <= tol["loss"] * loss
    share = _compare("grads", grads, tgrads, tol["grads"])
    print(f"{spec!r}: loss ref {loss:.6f} port {float(tloss):.6f}; "
          f"bit-equal grads {share:.3f}")


def test_two_steps_match_reference(train_setup):
    ja, ta, s0, batches = train_setup
    spec = "8; backend=pallas"
    kw = dict(base_lr=LR, warmup_steps=0, total_steps=10)
    jstep = jmake_step(ja, spec, jmake_schedule("constant", **kw))
    s1, m1 = jstep(s0, batches[0], jax.random.key(1))
    s2, m2 = jstep(s1, batches[1], jax.random.key(2))
    ref = _np(s2)
    step = make_step(ta, spec, make_schedule("constant", **kw), device="cpu")
    state = from_jax_train_state(_np(s0), device="cpu")
    tb = [_torch_batch(b) for b in batches]
    state, tm1 = step(state, tb[0])
    state, tm2 = step(state, tb[1])
    tol = TOL["hbfp"]
    for a, b in ((m1, tm1), (m2, tm2)):
        assert abs(float(a["loss"]) - float(b["loss"])) <= \
            tol["loss"] * abs(float(a["loss"]))
    _compare("mu", ref.opt.mu, state.opt.mu, tol["moments"])
    _compare("nu", ref.opt.nu, state.opt.nu, tol["moments"])
    _compare("updates", ref.params, state.params, tol["updates"],
             base=_np(s0).params)
    worst = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
        _flat(ref.params), _flat(state.params)))
    assert worst <= 8 * LR, worst
    assert state.step == 2 and state.opt.step == 2


# ----------------------------------------------------------------------------
# serving: prefill, decode, the engine
# ----------------------------------------------------------------------------

def _compile(fn, *args):
    """The reference's jitted stage without XLA's excess precision (C1)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _serve_params(ja, ta, dtype, spec):
    jp = jinit_params(jax.random.key(0), dataclasses.replace(
        ja, dtype="float32"))
    jpol, tpol = jparse_policy(spec), parse_policy(spec)
    # both sides cast the f32 weights to the compute dtype first, then
    # narrow (round-to-nearest-even casts agree bit for bit)
    jparams = jss.narrow_serving_params(
        jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)) if a.ndim >= 2
                     else a, jp), ja, jpol)
    tparams = tss.narrow_serving_params(
        from_jax_params(_np(jp), device="cpu", dtype=getattr(torch, dtype)),
        ta, tpol)
    return jparams, tparams, jpol, tpol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    ja, ta = _archs(dtype=dtype)
    jparams, tparams, jpol, tpol = _serve_params(ja, ta, dtype, SERVE_SPEC)
    B, S, C = 2, 12, 16
    rng = np.random.default_rng(3)
    toks = rng.integers(0, ja.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pre = {"tokens": toks, "positions": pos}
    jl, jc = _compile(jss.make_prefill_fn(ja, jpol), jparams, pre)(
        jparams, pre)
    jc = jss.prefill_to_decode_cache(jc, ja, C)
    tl, tc = tss.make_prefill_fn(ta, tpol, device="cpu")(
        tparams, _torch_batch(pre))
    tc = tss.prefill_to_decode_cache(tc, ta, C)
    jdec = None
    tdec = tss.make_decode_fn(ta, tpol, device="cpu")
    errs = [_close(jl, tl, SERVE_TOL[dtype], "prefill")]
    # 6 decode steps: positions 12..17 pass the 16-slot ring
    for t in range(6):
        nxt = rng.integers(0, ja.vocab_size, (B, 1)).astype(np.int32)
        dec = {"tokens": nxt, "positions": np.full((B, 1), S + t, np.int32)}
        if jdec is None:
            jdec = _compile(jss.make_decode_fn(ja, jpol), jparams, dec, jc)
        jd, jc = jdec(jparams, dec, jc)
        td, tc = tdec(tparams, _torch_batch(dec), tc)
        errs.append(_close(jd, td, SERVE_TOL[dtype], f"decode {t}"))
    errs.append(_close(jc["ssm"][0], tc["ssm"][0], SERVE_TOL[dtype], "ssm"))
    print(f"{dtype}: prefill, decode, ssm state max|d|/max|ref| {errs}")


def test_token_by_token_decode_matches_reference():
    """The port's counterpart of tests/test_models.py's
    test_decode_matches_forward: fp32 decode one token at a time from an
    empty cache, 21 tokens through a 16-slot ring, against the
    reference's decode chain and the port's own forward."""
    ja, ta = _archs(dtype="float32")
    jp = jinit_params(jax.random.key(0), ja)
    tp = from_jax_params(_np(jp), device="cpu")
    B, S = 2, 21
    toks = np.random.default_rng(4).integers(
        0, ja.vocab_size, (B, S)).astype(np.int32)
    jc = jmake_cache(jp, ja, B, 32)
    tc = make_cache(tp, ta, B, 32)
    jdec = jax.jit(lambda p, b, c: jdecode_step(p, b, c, ja, JCtx(None)))
    ctx = Ctx(device="cpu")
    for t in range(S):
        b = {"tokens": toks[:, t:t + 1],
             "positions": np.full((B, 1), t, np.int32)}
        jl, jc = jdec(jp, b, jc)
        tl, tc = decode_step(tp, _torch_batch(b), tc, ta, ctx)
        _close(jl, tl, SCAN_TOL["float32"], f"token {t}")
    full, _ = forward(tp, {"tokens": torch.from_numpy(toks)}, ta, ctx)
    _close(full[:, -1].numpy(), tl[:, 0], 1e-5, "decode vs forward")


def _engine_setup(dtype="float32"):
    ja, ta = _archs(dtype=dtype)
    _, tparams, _, tpol = _serve_params(ja, ta, dtype, SERVE_SPEC)
    return ta, tparams, tpol


def test_engine_paged_equals_slab_with_a_prompt_past_the_window():
    """ctx_len 32 gives a 16-slot lane (the window): the 21-token prompt
    takes the chunked prefill (two chunks, the second wraps the ring),
    the others the one-shot prefill; 3 requests on 2 lanes."""
    ta, params, pol = _engine_setup()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, ta.vocab_size, n).tolist()
               for n in (21, 5, 9)]
    out = {}
    for paged in (False, True):
        eng = ServeEngine(ta, params, pol, max_batch=2, ctx_len=32,
                          paged=paged, device="cpu")
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        res = eng.drain()
        out[paged] = [res[r] for r in rids]
        assert "ssm" in eng.cache
        if paged:
            assert eng.pool.used_pages == 0
    assert out[True] == out[False]
    assert all(len(t) == 6 for t in out[False])


def test_chunked_prefill_equals_oneshot():
    """The extend stage streaming a 12-token prompt in chunks of 5 into a
    B=1 slab (the SSM state carried, S > 1 with a state) leaves the state,
    KV and last logits of a one-shot prefill, in fp32 (under HBFP the
    attention's activation blocks group other tokens in a chunk, so the
    two differ by BFP roundings); the engine's tokens agree under the
    serving policy."""
    ta, params, pol = _engine_setup()
    prompt = np.random.default_rng(7).integers(1, ta.vocab_size, 12)
    ctx = Ctx(device="cpu")
    toks = torch.from_numpy(prompt.astype(np.int32))[None]
    pos = torch.arange(12, dtype=torch.int32)[None]
    l1, c1 = prefill(params, {"tokens": toks, "positions": pos}, ta, ctx,
                     std_pos=False)
    c1 = tss.prefill_to_decode_cache(c1, ta, 16)
    pf = make_cache(params, ta, 1, 32)
    addr = pf["ssm"][0].data_ptr()
    for s0 in range(0, 12, 5):
        l2, pf = decode_step(params, {"tokens": toks[:, s0:s0 + 5],
                                      "positions": pos[:, s0:s0 + 5]},
                             pf, ta, ctx)
    assert pf["ssm"][0].data_ptr() == addr          # written in place
    _close(c1["ssm"][0].numpy(), pf["ssm"][0], 1e-5, "ssm state")
    _close(c1["kv"].k.numpy(), pf["kv"].k, 1e-5, "k")
    assert torch.equal(c1["kv"].slot_pos, pf["kv"].slot_pos)
    _close(l1[:, -1].numpy(), l2[:, -1], 1e-5, "logits")
    toks_out = []
    for chunk in (None, 5):
        eng = ServeEngine(ta, params, pol, max_batch=1, ctx_len=32,
                          prefill_chunk=chunk, device="cpu")
        rid = eng.submit(prompt.tolist(), max_new_tokens=5)
        toks_out.append(eng.drain()[rid])
    assert toks_out[0] == toks_out[1]


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def test_reference_init_carries_over_at_bf16():
    """`from_jax_params` of the reference's init at hymba's own bf16 with
    dtype=None keeps every leaf's name, shape and dtype (`ssm_a_log`,
    `ssm_dt_bias`, `ssm_d` and the norm scales stay f32); `dtype=` would
    cast the stacked [L, H] f32 leaves too (the docstring's caveat). The
    port's own init has the same names, shapes and dtypes."""
    ja, ta = _archs()
    jp = _np(jinit_params(jax.random.key(0), ja))
    got = from_jax_params(jp, device="cpu")
    ref = {n: a for n, a in _flat_np(jp)}
    port = {n: t for n, t in _flat_torch(got)}
    assert list(ref) == list(port)
    for n, a in ref.items():
        t = port[n]
        assert tuple(t.shape) == a.shape, n
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, n
    assert port["layers/ssm_a_log"].dtype == torch.float32
    assert port["layers/ssm_in_w"].dtype == torch.bfloat16
    cast = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    assert cast["layers"]["ssm_a_log"].dtype == torch.bfloat16
    own = {n: t for n, t in _flat_torch(init_params(0, ta, device="cpu"))}
    assert sorted(own) == sorted(port)
    for n, t in own.items():
        assert t.shape == port[n].shape and t.dtype == port[n].dtype, n
    assert torch.equal(own["layers/ssm_a_log"], port["layers/ssm_a_log"])


def _flat_np(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_np(v, name)
        else:
            yield name, v


def _flat_torch(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_torch(v, name)
        else:
            yield name, v
