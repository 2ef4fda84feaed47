"""xlstm, the xLSTM family (`models/xlstm.py`: chunkwise mLSTM, sequential
sLSTM), in the port against the JAX package at smoke size (4 layers,
every second one sLSTM, ssm_chunk 8) on the reference's weights.

* `mlstm_chunkwise` (S = 13, not a multiple of the chunk, from a nonzero
  state), `mlstm_step` and `slstm_seq`, outputs, states and grads against
  `jax.grad` in f32: the frameworks differ only in op order and the ulps
  of exp/softplus/tanh, outputs within 1e-5·max|ref|, grads within 1e-4
  in relative Frobenius norm. `mlstm_block` and `slstm_block` in bf16
  (weights and activations), where the two round their bf16 products at
  different places: outputs within 2e-2·max|ref|, grads within 5e-2.
* The model's loss and grads under "fp32", "8" and "8; backend=pallas"
  (the Pallas kernels in interpret mode; the port's plain versions), with
  `test_torch_train.py`'s tolerances and reasons (TOL below); the grads
  of each layer's inactive branch are exactly zero in both packages; two
  `make_step` steps.
* Prefill then decode, and token-by-token decode, against the
  reference's logits: 2e-3·max|ref| in f32 and 2e-2 in bf16 under
  "8; backend=pallas" (`tests/test_torch_serve.py`'s reasons),
  1e-5·max|ref| for the fp32 decode chain.
* `ServeEngine`: paged raises, slab (the default) serves the greedy
  tokens of the port's own prefill and decode chain.
* The reference's init carried over at bf16 with `dtype=None` keeps
  every leaf's name, shape and dtype; the port's own init matches it.
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
from repro.models import xlstm as jx
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
from repro_torch.models import (Ctx, decode_step, from_jax_params,
                                init_params, make_cache, make_paged_cache,
                                prefill)
from repro_torch.models import xlstm as tx
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.serve import ServeEngine
from repro_torch.train import from_jax_train_state, make_step
from repro_torch.train import serve_step as tss

ARCH = "xlstm-350m"
POLICIES = ("fp32", "8", "8; backend=pallas")
LR = 1e-3
TOL = {  # loss (rel), grads, moments, updates (rel Frobenius per leaf)
    "hbfp": dict(loss=2e-3, grads=3e-2, moments=1e-1, updates=0.25),
    "fp32": dict(loss=1e-5, grads=1e-3, moments=1e-3, updates=1e-3),
}
SERVE_SPEC = "8; backend=pallas"
SERVE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
MLSTM = ("mlstm_up_w", "mlstm_qkv_w", "mlstm_gates_w", "mlstm_gates_bias",
         "mlstm_down_w")
SLSTM = ("slstm_in_w", "slstm_r_w", "slstm_out_w")


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
# the recurrences and the blocks
# ----------------------------------------------------------------------------

def _mlstm_inputs(S, rng):
    B, H, dk = 2, 4, 16
    q, k, v = (rng.standard_normal((B, S, H, dk)).astype(np.float32)
               for _ in "qkv")
    li = rng.standard_normal((B, S, H)).astype(np.float32)
    lf = (-np.abs(rng.standard_normal((B, S, H))) * 0.3).astype(np.float32)
    st = ((rng.standard_normal((B, H, dk, dk)) * 0.3).astype(np.float32),
          (rng.standard_normal((B, H, dk)) * 0.3).astype(np.float32),
          rng.standard_normal((B, H)).astype(np.float32))
    return (q, k, v, li, lf), st


@pytest.mark.parametrize("fn", ["mlstm_chunkwise", "mlstm_step",
                                "slstm_seq"])
def test_recurrence_matches_reference_f32(fn):
    rng = np.random.default_rng(11)
    if fn == "slstm_seq":
        B, S, H, dh = 2, 13, 4, 8
        D = H * dh
        args = (rng.standard_normal((B, S, 4 * D)).astype(np.float32),
                (rng.standard_normal((H, dh, 4 * dh)) * dh ** -0.5
                 ).astype(np.float32))
        st = tuple((rng.standard_normal((B, D)) * 0.3).astype(np.float32)
                   for _ in range(3)) + (
            rng.standard_normal((B, D)).astype(np.float32),)
        jcall = lambda a, s: jx.slstm_seq(*a, *s, n_heads=H)
        tcall = lambda a, s: tx.slstm_seq(*a, *s, n_heads=H)
    else:
        args, st = _mlstm_inputs(13 if fn == "mlstm_chunkwise" else 1, rng)
        if fn == "mlstm_chunkwise":
            jcall = lambda a, s: jx.mlstm_chunkwise(*a, s, 8)
            tcall = lambda a, s: tx.mlstm_chunkwise(*a, s, 8)
        else:
            jcall = lambda a, s: jx.mlstm_step(*a, s)
            tcall = lambda a, s: tx.mlstm_step(*a, s)
    shapes = jax.eval_shape(jcall, args, st)
    rs = [rng.standard_normal(t.shape).astype(np.float32)
          for t in jax.tree.leaves(shapes)]

    def jobj(a, s):
        return sum((t * r).sum() for t, r in zip(
            jax.tree.leaves(jcall(a, s)), rs))

    # compiled as the serving tests compile the reference (C1)
    jout, jg = _compile(lambda a, s: (jcall(a, s), jax.grad(
        jobj, argnums=(0, 1))(a, s)), args, st)(args, st)
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    ts = [torch.from_numpy(a).requires_grad_() for a in st]
    tout = tcall(ta, tuple(ts))
    tleaves = [tout[0], *tout[1]]
    for j, t in zip(jax.tree.leaves(jout), tleaves):
        _close(j, t, 1e-5, fn)
    sum((t * torch.from_numpy(r)).sum()
        for t, r in zip(tleaves, rs)).backward()
    for j, t in zip(jax.tree.leaves(jg), ta + ts):
        assert _rel_fro(j, t.grad) <= 1e-4, fn


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_matches_reference_bf16(block):
    _, ta = _archs()
    D, H = ta.d_model, ta.n_heads
    jp = {**jx.init_mlstm(jax.random.key(1), D, H, jnp.bfloat16),
          **jx.init_slstm(jax.random.key(2), D, H, jnp.bfloat16)}
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 13, D)).astype(np.float32)
    r = rng.standard_normal((2, 13, D)).astype(np.float32)
    names = ("norm_scale",) + (MLSTM if block == "mlstm" else SLSTM)
    jp = {k: jp[k] for k in names}
    if block == "mlstm":
        jf = lambda p, x_: jx.mlstm_block(x_, p, JCtx(None), n_heads=H,
                                          chunk=8)[0]
        tf = lambda p, x_: tx.mlstm_block(x_, p, Ctx(device="cpu"),
                                          n_heads=H, chunk=8)[0]
    else:
        jf = lambda p, x_: jx.slstm_block(x_, p, JCtx(None), n_heads=H)[0]
        tf = lambda p, x_: tx.slstm_block(x_, p, Ctx(device="cpu"),
                                          n_heads=H)[0]
    jx_ = jnp.asarray(x, jnp.bfloat16)
    obj = lambda p: (jf(p, jx_).astype(jnp.float32) * r).sum()
    # compiled as the serving tests compile the reference (C1)
    jy, jg = _compile(lambda p: (jf(p, jx_), jax.grad(obj)(p)), jp)(jp)
    tp = {k: _t(v, torch.bfloat16 if v.dtype == jnp.bfloat16 else None)
          .requires_grad_() for k, v in _np(jp).items()}
    ty = tf(tp, torch.from_numpy(x).to(torch.bfloat16))
    err = _close(jy, ty, 2e-2, block)
    (ty.float() * torch.from_numpy(r)).sum().backward()
    for k in names:
        assert _rel_fro(jg[k], tp[k].grad) <= 5e-2, k
    print(f"{block} bf16: max|d|/max|ref| {err:.3g}")


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
    # S = 20: the mLSTM chunk scan pads 20 to 24
    ja, ta = _archs(dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batches = [_np(jbatch(ja, 2, 20, step=i, kind="markov"))
               for i in range(2)]
    return ja, ta, s0, batches


def _inactive(ta):
    """(layer, parameter) of every inactive branch's parameter."""
    out = []
    for i in range(ta.n_layers):
        slstm = i % ta.slstm_every == ta.slstm_every - 1
        out += [(i, n) for n in (MLSTM if slstm else SLSTM)]
    return out


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
    # 4 projections an mLSTM layer, 2 an sLSTM layer (the active branch
    # only), and the head once (one CE chunk: 40 tokens)
    n_s = ta.n_layers // ta.slstm_every
    per = 4 * (ta.n_layers - n_s) + 2 * n_s + 1
    calls = (hm.hbfp_matmul_fwd.plain_calls, hm.hbfp_dgrad.plain_calls,
             hm.hbfp_wgrad.plain_calls)
    assert calls == ((2 * per - 1, per, per) if spec.endswith("pallas")
                     else (0, 0, 0)), calls
    assert abs(float(tloss) - loss) <= tol["loss"] * loss
    for i, n in _inactive(ta):
        assert not np.any(grads["layers"][n][i])
        assert not torch.any(tgrads["layers"][n][i])
    share = _compare("grads", grads, tgrads, tol["grads"])
    print(f"{spec!r}: loss ref {loss:.6f} port {float(tloss):.6f}; "
          f"bit-equal grads {share:.3f}")


def test_two_steps_match_reference(train_setup):
    """Two steps under "8; backend=pallas": the inactive branches' zero
    grads still let weight decay move their parameters, as in the
    reference."""
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
    p0 = _np(s0).params["layers"]
    for i, n in _inactive(ta):
        moved = state.params["layers"][n][i].numpy() - p0[n][i]
        if n != "mlstm_gates_bias":      # FP, no decay: 1-D
            assert np.any(moved), (i, n)
    assert state.step == 2 and state.opt.step == 2


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def _compile(fn, *args):
    """The reference's jitted stage without XLA's excess precision (C1)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _serve_params(ja, ta, dtype, spec):
    jp = jinit_params(jax.random.key(0), dataclasses.replace(
        ja, dtype="float32"))
    jpol, tpol = jparse_policy(spec), parse_policy(spec)
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
    B, S = 2, 12
    rng = np.random.default_rng(3)
    toks = rng.integers(0, ja.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pre = {"tokens": toks, "positions": pos}
    jl, jc = _compile(jss.make_prefill_fn(ja, jpol), jparams, pre)(
        jparams, pre)
    tl, tc = tss.make_prefill_fn(ta, tpol, device="cpu")(
        tparams, _torch_batch(pre))
    assert sorted(tc) == ["mlstm", "slstm"]
    errs = [_close(jl, tl, SERVE_TOL[dtype], "prefill")]
    jdec = None
    tdec = tss.make_decode_fn(ta, tpol, device="cpu")
    for t in range(4):
        nxt = rng.integers(0, ja.vocab_size, (B, 1)).astype(np.int32)
        dec = {"tokens": nxt, "positions": np.full((B, 1), S + t, np.int32)}
        if jdec is None:
            jdec = _compile(jss.make_decode_fn(ja, jpol), jparams, dec, jc)
        jd, jc = jdec(jparams, dec, jc)
        td, tc = tdec(tparams, _torch_batch(dec), tc)
        errs.append(_close(jd, td, SERVE_TOL[dtype], f"decode {t}"))
    print(f"{dtype}: prefill, decode max|d|/max|ref| {errs}")


def test_token_by_token_decode_matches_reference():
    """The port's counterpart of tests/test_models.py's
    test_decode_matches_forward for xlstm: fp32 decode one token at a time
    from an empty cache against the reference's decode chain, and the
    last logits against the port's forward."""
    from repro_torch.models import forward
    ja, ta = _archs(dtype="float32")
    jp = jinit_params(jax.random.key(0), ja)
    tp = from_jax_params(_np(jp), device="cpu")
    B, S = 2, 13
    toks = np.random.default_rng(4).integers(
        0, ja.vocab_size, (B, S)).astype(np.int32)
    jc = jmake_cache(jp, ja, B, 32)
    tc = make_cache(tp, ta, B, 32)
    addr = [t.data_ptr() for c in tc.values() for t in c]
    jdec = jax.jit(lambda p, b, c: jdecode_step(p, b, c, ja, JCtx(None)))
    ctx = Ctx(device="cpu")
    for t in range(S):
        b = {"tokens": toks[:, t:t + 1],
             "positions": np.full((B, 1), t, np.int32)}
        jl, jc = jdec(jp, b, jc)
        tl, tc = decode_step(tp, _torch_batch(b), tc, ta, ctx)
        _close(jl, tl, 1e-5, f"token {t}")
    assert [t.data_ptr() for c in tc.values() for t in c] == addr
    for key in ("mlstm", "slstm"):
        for j, t in zip(jc[key], tc[key]):
            _close(j, t, 1e-5, key)
    full, _ = forward(tp, {"tokens": torch.from_numpy(toks)}, ta, ctx)
    _close(full[:, -1].numpy(), tl[:, 0], 1e-5, "decode vs forward")


def test_engine_paged_raises_and_slab_serves():
    ja, ta = _archs()
    _, params, _, pol = _serve_params(ja, ta, "float32", SERVE_SPEC)
    with pytest.raises(ValueError, match="xlstm"):
        ServeEngine(ta, params, pol, max_batch=2, ctx_len=32, paged=True,
                    device="cpu")
    with pytest.raises(ValueError, match="xlstm"):
        make_paged_cache(params, ta, 2, 32, 8, 4)
    eng = ServeEngine(ta, params, pol, max_batch=2, ctx_len=32,
                      device="cpu")
    assert not eng.paged and sorted(eng.cache) == ["mlstm", "slstm"]
    prompts = [[5, 9, 2], [7, 7, 7, 7, 1], [3, 8]]
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    res = eng.drain()
    # the greedy chain of the port's own prefill and decode, one request
    ctx = tss._serve_ctx(ta, pol, "cpu")()
    sparams = eng.params
    for rid, p in zip(rids, prompts):
        toks = torch.tensor([p], dtype=torch.int32)
        pos = torch.arange(len(p), dtype=torch.int32)[None]
        lg, c = prefill(sparams, {"tokens": toks, "positions": pos}, ta, ctx,
                        std_pos=False)
        want = [int(lg[0, -1].argmax())]
        for t in range(3):
            lg, c = decode_step(sparams, {
                "tokens": torch.tensor([[want[-1]]], dtype=torch.int32),
                "positions": torch.tensor([[len(p) + t]],
                                          dtype=torch.int32)}, c, ta, ctx)
            want.append(int(lg[0, -1].argmax()))
        assert res[rid] == want, (rid, res[rid], want)


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_tree(v, name)
        else:
            yield name, v


def test_reference_init_carries_over_at_bf16():
    """`from_jax_params` of the reference's init at xlstm's bf16 with
    dtype=None keeps every leaf's name, shape and dtype (the stacked
    [L, 2H] `mlstm_gates_bias` and the norm scales stay f32, the 4-D
    `slstm_r_w` bf16); the port's own init has the same layout and the
    reference's constants (its gate bias and norm scales)."""
    ja, ta = _archs()
    jp = _np(jinit_params(jax.random.key(0), ja))
    ref = dict(_flat_tree(jp))
    port = dict(_flat_tree(from_jax_params(jp, device="cpu")))
    assert list(ref) == list(port)
    for n, a in ref.items():
        assert tuple(port[n].shape) == a.shape, n
        assert str(port[n].dtype).replace("torch.", "") == a.dtype.name, n
    assert port["layers/mlstm_gates_bias"].dtype == torch.float32
    assert port["layers/slstm_r_w"].ndim == 4
    own = dict(_flat_tree(init_params(0, ta, device="cpu")))
    assert sorted(own) == sorted(port)
    for n, t in own.items():
        assert t.shape == port[n].shape and t.dtype == port[n].dtype, n
    for n in ("layers/mlstm_gates_bias", "layers/norm_scale",
              "final_norm_scale"):
        assert torch.equal(own[n], port[n]), n
