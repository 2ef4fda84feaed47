"""The MoE family (`models/moe.py`: llama4-scout's top-1 routing with a
shared expert, arctic's top-2 routing with a dense residual) in the port
against the JAX package, at smoke size (2 layers, 4 experts,
moe_groups 2) on the reference's weights.

Every call of the reference's MoE here routes at least `moe_groups`
tokens: with fewer, its group search never ends (ROADMAP C16), and the
port's clamp is pinned against the reference at n_groups 1 instead.

* `route` and `make_dispatch`: the expert choices and the dispatch
  tensor bit-equal in f32 and bf16; the gates, the aux loss and the
  combine tensor within a few f32 ulps (GATE_TOL), because the two
  frameworks' exp differ in the last ulps (as C13 records for cos, sin
  and pow) and their softmax sums in another order; fed the reference's
  gates and choices, the port's dispatch and combine are bit-equal.
  Past the capacity later tokens are dropped (zero rows), slots go token
  major at top-2, and exact ties go to the lower index.
* `moe_ffn` at both smoke configs under "fp32", "8" and "8;
  backend=pallas" (the shared expert and the dense residual through the
  Pallas kernels in interpret mode and the port's plain versions; the
  expert GEMMs on the sim path, with no kernel call): outputs within
  1e-5·max|ref| in f32, grads of x, the router, the experts and the
  shared/dense weights against `jax.value_and_grad` with
  `test_torch_train.py`'s tolerances (TOL below); the group search.
* Both smoke models: logits and aux, loss and grads, and two `make_step`
  steps against the reference's under the three policies; remat on and
  off bit-equal under "8~stochastic; backend=pallas"; the init's layout
  (router in f32) and `from_jax_params` keeping every dtype; a telemetry
  step bit-equal to the plain one, its expert weight stats equal to the
  reference's; checkpoints with the 4-D expert leaves across both ways.
* Serving: prefill and decode logits; `ServeEngine` tokens equal to the
  reference engine's at max_batch 4 with lane reuse, slab and paged; the
  chunked prefill against the reference's chunked prefill (each chunk is
  a routing group of its own, so it is not the one-shot prefill).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_arch as jget_arch
from repro.core.opt_shell import narrow_params as jnarrow
from repro.data.pipeline import batch_for_arch as jbatch
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import decode_step as jdecode_step
from repro.models.transformer import forward as jforward
from repro.models.transformer import loss_fn as jloss_fn
from repro.models.transformer import make_cache as jmake_cache
from repro.numerics import stats_to_host as jhost
from repro.numerics.collect import weight_stats as jweight_stats
from repro.optim import make_schedule as jmake_schedule
from repro.precision import parse_policy as jparse_policy
from repro.precision.policy import ResolvedPolicy as JResolvedPolicy
from repro.serve import ServeEngine as JServeEngine
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro.train import serve_step as jss
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import batch_for_arch
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import (Ctx, decode_step, forward, from_jax_params,
                                init_params, make_cache)
from repro_torch.models import moe as tmoe
from repro_torch.numerics import TapConfig, stats_to_host
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.serve import ServeEngine
from repro_torch.train import (TrainState, from_jax_train_state,
                               init_train_state, make_step)
from repro_torch.train import serve_step as tss

FAMILIES = ("llama4-scout-17b-a16e", "arctic-480b")
POLICIES = ("fp32", "8", "8; backend=pallas")
LR = 1e-3
TOL = {  # loss (rel), grads, moments, updates (rel Frobenius per leaf)
    "hbfp": dict(loss=2e-3, grads=3e-2, moments=1e-1, updates=0.25),
    "fp32": dict(loss=1e-5, grads=1e-3, moments=1e-3, updates=1e-3),
}
# the gates, the aux and the combine: within 8 f32 ulps of 1 (the gates
# lie in (0, 1]); measured at most 3
GATE_TOL = 8 * 2.0 ** -24
FFN_TOL = 1e-5
SERVE_SPEC = "8; backend=pallas"
SERVE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


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


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, _f32(tree)


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
    ref, got = _f32(ref), _f32(got)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                               1e-30)
    assert err <= tol, (what, err)
    return err


def _compile(fn, *args):
    """The reference's jitted stage without XLA's excess precision (C1)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _moe_kw(arch, **over):
    kw = dict(n_experts=arch.n_experts, top_k=arch.top_k,
              capacity_factor=arch.capacity_factor, n_groups=arch.moe_groups,
              dense_residual=arch.moe_dense_residual,
              shared_expert=arch.shared_expert)
    kw.update(over)
    return kw


def _layer0(ja):
    """Layer 0's MoE parameters of the reference's f32 init, as numpy."""
    jp = _np(jinit_params(jax.random.key(0), ja))["layers"]
    return {k: v[0] for k, v in jp.items()
            if k.startswith(("router", "moe_", "shared_", "ffn_"))}


def _ctxs(spec):
    return (JCtx(policy=jparse_policy(spec).resolve_segment(0)),
            Ctx(policy=parse_policy(spec).resolve_segment(0), device="cpu"))


# ----------------------------------------------------------------------------
# routing and dispatch
# ----------------------------------------------------------------------------

def _reference_route(x, w, E, k, cap, dtype):
    gates, idx, aux = jax.jit(jmoe.route, static_argnums=(2, 3))(
        jnp.asarray(x).astype(dtype), jnp.asarray(w), E, k)
    d, c = jax.jit(jmoe.make_dispatch, static_argnums=(2, 3, 4))(
        gates, idx, E, cap, jnp.dtype(dtype))
    return gates, idx, aux, d, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (128, 2)])
def test_route_and_dispatch_match_reference(dtype, E, k):
    G, T, D = (2, 8, 128) if E == 4 else (3, 33, 256)
    rng = np.random.default_rng(E + k)
    x = rng.standard_normal((G, T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    cap = tmoe.capacity_for(T, k, 1.25, E)
    jg, ji, ja, jd, jc = _reference_route(x, w, E, k, cap, dtype)
    tdt = getattr(torch, dtype)
    tg, ti, ta = tmoe.route(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                            E, k)
    td, tc = tmoe.make_dispatch(tg, ti, E, cap, tdt)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert td.dtype == tc.dtype == tdt
    assert np.array_equal(_f32(jd), _f32(td))
    assert float(np.abs(_f32(jg) - _f32(tg)).max()) <= GATE_TOL
    assert abs(float(ja) - float(ta)) <= GATE_TOL * float(ja)
    # the combine carries the gates (rounded to bf16 in a bf16 model)
    assert float(np.abs(_f32(jc) - _f32(tc)).max()) <= max(
        GATE_TOL, 2.0 ** -8 if dtype == "bfloat16" else 0.0)
    # from the reference's gates and choices: bit for bit
    td2, tc2 = tmoe.make_dispatch(torch.tensor(_f32(jg)),
                                  torch.tensor(np.asarray(ji)), E, cap, tdt)
    assert np.array_equal(_f32(jd), _f32(td2))
    assert np.array_equal(_f32(jc), _f32(tc2))
    if k == 1:     # one gate renormalized by itself
        assert torch.equal(tg, torch.ones_like(tg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_drops_later_tokens_token_major(dtype):
    """Top-2 over 3 experts, capacity 2: slots go token by token, each
    token's first choice before its second. Experts 0 and 1 are taken
    by tokens 0 and 1, expert 2 by tokens 2 and 3; the later choices of
    each are dropped (zero rows in dispatch and combine), so token 4
    reaches no expert."""
    idx = np.array([[[0, 1], [1, 0], [0, 2], [1, 2], [2, 0]]], np.int32)
    gates = np.random.default_rng(0).uniform(
        0.1, 0.9, idx.shape).astype(np.float32)
    E, cap = 3, 2
    jd, jc = jmoe.make_dispatch(jnp.asarray(gates), jnp.asarray(idx), E,
                                cap, jnp.dtype(dtype))
    td, tc = tmoe.make_dispatch(torch.from_numpy(gates),
                                torch.from_numpy(idx).long(), E, cap,
                                getattr(torch, dtype))
    assert np.array_equal(_f32(jd), _f32(td))
    assert np.array_equal(_f32(jc), _f32(tc))
    d = _f32(td)[0]                                 # [T, E, Cap]
    # (token, expert) -> slot, token-major
    kept = {(0, 0): 0, (0, 1): 0, (1, 1): 1, (1, 0): 1, (2, 2): 0,
            (3, 2): 1}
    for t in range(5):
        for e in range(E):
            want = np.zeros(cap, np.float32)
            if (t, e) in kept:
                want[kept[(t, e)]] = 1.0
            assert np.array_equal(d[t, e], want), (t, e)
    assert not d[2, 0].any() and not d[3, 1].any() and not d[4].any()
    assert not _f32(tc)[0, 4].any() and _f32(tc)[0, 3, 2, 1] > 0


def test_exact_ties_go_to_the_lower_index():
    """Integer tokens and router columns make the logits exact, so equal
    columns give bit-equal probabilities: columns 1 and 3 tie for the
    lead, 0 and 2 for the rest; a zero router ties every expert."""
    rng = np.random.default_rng(1)
    x = rng.integers(1, 3, (2, 6, 16)).astype(np.float32)
    col = rng.integers(1, 3, 16).astype(np.float32)
    w = np.stack([0 * col, col, 0 * col, col], axis=1)
    for router, want in ((w, [1, 3]), (np.zeros_like(w), [0, 1])):
        _, ji, _ = jmoe.route(jnp.asarray(x), jnp.asarray(router), 4, 2)
        _, ti, _ = tmoe.route(torch.from_numpy(x), torch.from_numpy(router),
                              4, 2)
        assert np.array_equal(np.asarray(ji), ti.numpy())
        assert (ti.numpy() == np.array(want)).all()


# ----------------------------------------------------------------------------
# the MoE FFN
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("T_all", [2, 3, 4, 6, 7, 12])
def test_group_search_matches_reference(T_all, monkeypatch):
    """The group count (seen in the router's grouped input) and the
    output of llama4 smoke's MoE FFN on [T_all, 1, D] at its n_groups 2
    (never more groups than tokens: C16)."""
    ja, ta = _archs(FAMILIES[0], dtype="float32")
    p = _layer0(ja)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = np.random.default_rng(T_all).standard_normal(
        (T_all, 1, ja.d_model)).astype(np.float32)
    seen = []
    route = jmoe.route
    monkeypatch.setattr(jmoe, "route", lambda xg, *a: (
        seen.append(xg.shape[0]), route(xg, *a))[1])
    jy, _ = jmoe.moe_ffn(jnp.asarray(x), p, JCtx(None), **_moe_kw(ja))
    ty, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, Ctx(device="cpu"),
                         **_moe_kw(ta))
    assert seen == [tmoe.n_groups_for(T_all, 2)]
    _close(jy, ty, FFN_TOL, f"T_all {T_all}")


def test_one_token_clamps_the_group_count():
    """C16: at n_groups 2 the reference's search never ends for one
    token (its clamp comes after the loop); the port clamps first and
    equals the reference at n_groups 1."""
    assert tmoe.n_groups_for(1, 2) == 1
    assert tmoe.n_groups_for(3, 8) == 3
    for fam in FAMILIES:
        ja, ta = _archs(fam, dtype="float32")
        p = _layer0(ja)
        x = np.random.default_rng(9).standard_normal(
            (1, 1, ja.d_model)).astype(np.float32)
        jy, jaux = jmoe.moe_ffn(jnp.asarray(x), p, JCtx(None),
                                **_moe_kw(ja, n_groups=1))
        ty, taux = tmoe.moe_ffn(torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in p.items()},
                                Ctx(device="cpu"), **_moe_kw(ta, n_groups=2))
        _close(jy, ty, FFN_TOL, fam)
        assert abs(float(jaux) - float(taux)) <= GATE_TOL * float(jaux)


@pytest.mark.parametrize("spec", POLICIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_moe_ffn_and_grads_match_reference(family, spec):
    ja, ta = _archs(family, dtype="float32")
    p = _layer0(ja)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, ja.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    jctx, tctx = _ctxs(spec)
    kw = _moe_kw(ja)

    def jf(params, x_):
        y, aux = jmoe.moe_ffn(x_, params, jctx, **kw)
        return (y * r).sum() + aux, y

    (_, jy), (jgp, jgx) = _compile(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True), p, x)(p, x)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    hm.reset_counts()
    ty, taux = tmoe.moe_ffn(tx, tp, tctx, **kw)
    ((ty * torch.from_numpy(r)).sum() + taux).backward()
    err = _close(jy, ty, FFN_TOL, "moe_ffn output")
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]["grads"]
    assert _compare("grad x", {"x": jgx}, {"x": tx.grad}, tol) >= 0
    share = _compare("grads", jgp, {k: t.grad for k, t in tp.items()}, tol)
    # the shared expert or dense residual on the kernels' plain versions
    # (forward, dgrad, wgrad once each of its three projections); the
    # 3-D expert GEMMs on the sim path, never the kernels
    calls = (hm.hbfp_matmul_fwd.plain_calls, hm.hbfp_dgrad.plain_calls,
             hm.hbfp_wgrad.plain_calls)
    assert calls == ((3, 3, 3) if spec.endswith("pallas") else (0, 0, 0))
    print(f"{family} {spec!r}: max|d|/max|ref| {err:.3g}, bit-equal grads "
          f"{share:.3f}")


# ----------------------------------------------------------------------------
# the models: forward, loss and grads, steps
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
    narrow = jnarrow(state.params, pcfg)
    grad = jax.jit(jax.value_and_grad(
        lambda n, b: jloss_fn(n, b, ja, ctx), has_aux=True))
    (loss, metrics), g = grad(narrow, batch)
    logits, aux = jax.jit(lambda n, b: jforward(n, b, ja, ctx))(narrow,
                                                                batch)
    return float(loss), float(metrics["aux"]), _np(g), logits, aux


@pytest.fixture(scope="module", params=FAMILIES)
def train_setup(request):
    ja, ta = _archs(request.param, dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batches = [_np(jbatch(ja, 2, 16, step=i, kind="markov"))
               for i in range(2)]
    return ja, ta, s0, batches


@pytest.mark.parametrize("spec", POLICIES)
def test_forward_loss_and_grads_match_reference(spec, train_setup):
    ja, ta, s0, batches = train_setup
    loss, aux, grads, jlogits, jaux = _reference_grads(ja, spec, s0,
                                                       batches[0])
    sched = make_schedule("constant", base_lr=LR, warmup_steps=0,
                          total_steps=10)
    step = make_step(ta, spec, sched, device="cpu")
    state = from_jax_train_state(_np(s0), device="cpu")
    hm.reset_counts()
    fa.reset_counts()
    tloss, tm, tgrads = step.grads(state, _torch_batch(batches[0]))
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
    # 7 projections a layer through the kernels (4 attention, 3 of the
    # shared expert or dense residual) and the head, one CE chunk
    per = 7 * ta.n_layers + 1
    calls = (hm.hbfp_matmul_fwd.plain_calls, hm.hbfp_dgrad.plain_calls,
             hm.hbfp_wgrad.plain_calls, fa.hbfp_flash_fwd.plain_calls)
    assert calls == ((2 * per - 1, per, per, 2 * ta.n_layers)
                     if spec.endswith("pallas") else (0, 0, 0, 0)), calls
    assert abs(float(tloss) - loss) <= tol["loss"] * loss
    assert abs(float(tm["aux"]) - aux) <= tol["loss"] * aux
    # the aux of each layer near the balanced router's 1 (the reference's
    # own check on arctic smoke: within (0.5, 2.5))
    assert 0.5 < float(tm["aux"]) / ta.n_layers < 2.5
    share = _compare("grads", grads, tgrads, tol["grads"])
    # logits and aux of the port's forward on the same compute copy
    narrow = from_jax_params(_np(jnarrow(
        s0.params, None if spec == "fp32" else
        jparse_policy(spec).resolve_segment(0).global_cfg)), device="cpu")
    seg = parse_policy(spec).resolve_segment(0)
    ctx = Ctx(cfg=None if seg.global_cfg is None else
              seg.global_cfg.with_(requantize_weights=seg.backend == "pallas"),
              backend=seg.backend, device="cpu")
    with torch.no_grad():
        tlogits, taux = forward(narrow, _torch_batch(batches[0]), ta, ctx)
    _close(jlogits, tlogits, 2e-3 if spec != "fp32" else 1e-5, "logits")
    assert abs(float(taux) - float(jaux)) <= tol["loss"] * float(jaux)
    print(f"{ta.name} {spec!r}: loss ref {loss:.6f} port {float(tloss):.6f},"
          f" aux ref {aux:.6f} port {float(tm['aux']):.6f}; bit-equal grads "
          f"{share:.3f}")


@pytest.mark.parametrize("spec", POLICIES)
def test_two_steps_match_reference(spec, train_setup):
    ja, ta, s0, batches = train_setup
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
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
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
    # the master's router stays f32 and is never narrowed: wide-rounded
    # it would sit on a 16-bit grid
    assert state.params["layers"]["router_w"].dtype == torch.float32
    assert state.step == 2 and state.opt.step == 2


def test_remat_on_and_off_bit_equal_stochastic():
    """The routing and dispatch recomputed in each layer's backward draw
    what the forward drew: loss and grads bit-equal with remat on and
    off, from one key."""
    spec = "8~stochastic; backend=pallas"
    out = []
    for remat in (True, False):
        _, ta = _archs(FAMILIES[0], dtype="float32", loss_chunk=16,
                       remat=remat)
        state = init_train_state(3, ta, device="cpu")
        step = make_step(ta, spec, make_schedule(
            "constant", base_lr=LR, warmup_steps=0, total_steps=10),
            device="cpu")
        batch = batch_for_arch(ta, 2, 16, kind="markov", device="cpu")
        loss, m, grads = step.grads(state, batch, 1234)
        out.append((loss, m["aux"], dict(_flat(grads))))
    (l1, a1, g1), (l2, a2, g2) = out
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert g1.keys() == g2.keys()
    for n in g1:
        assert np.array_equal(g1[n], g2[n]), n


def _leaf_layout(tree, prefix=""):
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _leaf_layout(tree[k], name)
        else:
            v = tree[k]
            yield name, tuple(v.shape), str(v.dtype).replace("torch.", "")


@pytest.mark.parametrize("family", FAMILIES)
def test_init_layout_matches_reference(family):
    """The port's init has the reference's names, shapes and dtypes at the
    arch's bf16 (router_w and the norm scales f32, the 4-D stacked
    experts bf16); `from_jax_params` with dtype=None keeps every
    dtype."""
    ja, ta = _archs(family)
    jp = _np(jinit_params(jax.random.key(0), ja))
    ref = list(_leaf_layout(jp))
    own = list(_leaf_layout(init_params(0, ta, device="cpu")))
    assert own == ref
    got = list(_leaf_layout(from_jax_params(jp, device="cpu")))
    assert got == ref
    layout = {n: (s, d) for n, s, d in own}
    E, D, F = ta.n_experts, ta.d_model, ta.d_ff
    assert layout["layers/router_w"] == ((2, D, E), "float32")
    assert layout["layers/moe_wg"] == ((2, E, D, F), "bfloat16")
    assert layout["layers/moe_wo"] == ((2, E, F, D), "bfloat16")
    extra = "ffn_wg" if ta.moe_dense_residual else "shared_wg"
    assert layout[f"layers/{extra}"] == ((2, D, F), "bfloat16")


def test_telemetry_step_equals_plain_and_expert_stats_match():
    """llama4 smoke: a telemetry step (weights narrowed through B7's plain
    version with their stats) leaves the plain step's state bit for bit;
    the stats of the three 4-D expert leaves, per [D, F] slice tiles,
    equal the reference's `weight_stats` on the same master."""
    ja, ta = _archs(FAMILIES[0], dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batch = _torch_batch(_np(jbatch(ja, 2, 16, kind="markov")))
    sched = make_schedule("constant", base_lr=LR, warmup_steps=0,
                          total_steps=10)
    out = {}
    for tap in (None, TapConfig(cadence=1)):
        step = make_step(ta, "8; backend=pallas", sched, tap=tap,
                         device="cpu")
        state, m = step(from_jax_train_state(_np(s0), device="cpu"), batch)
        out[tap is not None] = (state, m)
    (sp, mp), (st, mt) = out[False], out[True]
    assert float(mp["loss"]) == float(mt["loss"])
    for (n, a), (_, b) in zip(_flat(sp.params), _flat(st.params)):
        assert np.array_equal(a, b), n
    host = stats_to_host(mt["numerics"]["weights"])
    ref = jhost(jweight_stats(s0.params,
                              jparse_policy("8").resolve_segment(0)))
    for name in ("layers/moe_wg", "layers/moe_wi", "layers/moe_wo"):
        got, want = host[name], ref[name]
        assert got["exp_hist"] == want["exp_hist"], name
        assert abs(got["sqnr_db"] - want["sqnr_db"]) <= 1e-3, name
        for k in ("clip_frac", "sat_tile_frac", "ftz_frac", "exp_spread",
                  "n"):
            assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), \
                (name, k)
    assert "layers/router_w" not in host


@pytest.mark.parametrize("packed", [False, True])
def test_checkpoints_cross_load_with_expert_leaves(tmp_path, packed):
    """llama4 smoke's train state, 4-D expert leaves included, written by
    either package loads in the other, plain and packed at 8 bits."""
    ja, _ = _archs(FAMILIES[0])
    js = jinit_train_state(jax.random.key(0), ja, jinit_params)
    like = from_jax_train_state(_np(js), device="cpu")
    assert like.params["layers"]["moe_wg"].ndim == 4
    jsave(str(tmp_path / "ref"), 3, js, hbfp=jparse_policy("8"),
          packed=packed)
    restored, _ = load_checkpoint(str(tmp_path / "ref"), like)
    jback, _ = jload(str(tmp_path / "ref"), js)
    want = from_jax_train_state(_np(jback), device="cpu")
    for (n, a), (_, b) in zip(_flat(want.params), _flat(restored.params)):
        assert np.array_equal(a, b), n
    state = TrainState(like.params, like.opt, 0)
    save_checkpoint(str(tmp_path / "port"), 3, state,
                    hbfp=parse_policy("8"), packed=packed)
    jgot, _ = jload(str(tmp_path / "port"), js)
    for (n, a), (_, b) in zip(_flat(_np(jback.params)),
                              _flat(_np(jgot.params))):
        assert np.array_equal(a, b), n


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def _serve_params(ja, ta, dtype, spec=SERVE_SPEC):
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
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_then_decode_matches_reference(family, dtype):
    ja, ta = _archs(family, dtype=dtype)
    jparams, tparams, jpol, tpol = _serve_params(ja, ta, dtype)
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
    # one decode tick routes its B = 2 tokens as the reference's 2 groups
    for t in range(3):
        nxt = rng.integers(0, ja.vocab_size, (B, 1)).astype(np.int32)
        dec = {"tokens": nxt, "positions": np.full((B, 1), S + t, np.int32)}
        if jdec is None:
            jdec = _compile(jss.make_decode_fn(ja, jpol), jparams, dec, jc)
        jd, jc = jdec(jparams, dec, jc)
        td, tc = tdec(tparams, _torch_batch(dec), tc)
        errs.append(_close(jd, td, SERVE_TOL[dtype], f"decode {t}"))
    print(f"{family} {dtype}: prefill, decode max|d|/max|ref| {errs}")


# 5 requests on 4 lanes, then two more after the first drain (lane reuse);
# every prompt, and every decode tick (4 lanes), routes >= moe_groups
# tokens (C16)
TRACE = [([428, 133, 55, 152, 211], 5), ([416, 231, 47], 4),
         ([171, 307, 416, 373, 508], 5), ([9, 90, 400, 12], 3),
         ([300, 301], 4)]
LATER = [([4, 4], 3), ([8, 1, 6], 4)]


def _drive(eng):
    res = {}
    for p, n in TRACE:
        eng.submit(p, max_new_tokens=n)
    res.update(eng.drain())
    for p, n in LATER:
        eng.submit(p, max_new_tokens=n)
    res.update(eng.drain())
    return res


@pytest.fixture(scope="module")
def engine_weights():
    """Per family: the archs, the reference's f32 weights in both
    packages, and the reference engine's tokens on the trace (slab)."""
    out = {}
    for fam in FAMILIES:
        ja, ta = _archs(fam, dtype="float32")
        jp = jinit_params(jax.random.key(0), ja)
        want = _drive(JServeEngine(ja, jp, jparse_policy(SERVE_SPEC),
                                   max_batch=4, ctx_len=32))
        out[fam] = (ja, ta, jp, from_jax_params(_np(jp), device="cpu"), want)
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_tokens_match_reference(family, paged, engine_weights):
    """Greedy tokens of the port's engine, slab and paged, equal the
    reference engine's. Capacity couples the lanes: a tick's 4 tokens
    (idle lanes included) route as moe_groups = 2 groups of 2, alike in
    both."""
    ja, ta, jp, tp, want = engine_weights[family]
    got = _drive(ServeEngine(ta, tp, parse_policy(SERVE_SPEC), max_batch=4,
                             ctx_len=32, paged=paged, device="cpu"))
    assert got == want
    assert sorted(got) == list(range(len(TRACE) + len(LATER)))


def test_chunked_prefill_matches_reference_chunked(engine_weights):
    """A 12-token prompt streamed in chunks of 5 (5, 5, 2: each chunk its
    own routing groups) into a B = 1 slab: the logits of every chunk
    against the reference's decode steps, and the engines' tokens with
    prefill_chunk 5 (2 lanes: a one-lane tick would route one token)."""
    ja, ta, jp, tp, _ = engine_weights[FAMILIES[1]]
    prompt = np.random.default_rng(7).integers(1, ja.vocab_size, 12)
    toks = prompt.astype(np.int32)[None]
    pos = np.arange(12, dtype=np.int32)[None]
    jc = jmake_cache(jp, ja, 1, 32)
    tc = make_cache(tp, ta, 1, 32)
    jdec = jax.jit(lambda p, b, c: jdecode_step(p, b, c, ja, JCtx(None)))
    ctx = Ctx(device="cpu")
    for s0 in range(0, 12, 5):
        b = {"tokens": toks[:, s0:s0 + 5], "positions": pos[:, s0:s0 + 5]}
        jl, jc = jdec(jp, b, jc)
        tl, tc = decode_step(tp, _torch_batch(b), tc, ta, ctx)
        _close(jl, tl, 1e-5, f"chunk at {s0}")
    _close(jc["kv"].k, tc["kv"].k, 1e-5, "k")
    kw = dict(max_batch=2, ctx_len=32, prefill_chunk=5)
    jeng = JServeEngine(ja, jp, jparse_policy(SERVE_SPEC), **kw)
    teng = ServeEngine(ta, tp, parse_policy(SERVE_SPEC), device="cpu", **kw)
    outs = []
    for eng in (jeng, teng):
        rid = eng.submit(prompt.tolist(), max_new_tokens=5)
        outs.append(eng.drain()[rid])
    assert outs[0] == outs[1]


def test_engines_share_one_narrowed_copy(engine_weights):
    """`narrowed=True` serves params that already are the serving copy as
    they are (no second copy: the chip phase serves arctic's 27-GB layer
    from one), with the tokens of an engine that narrows them itself."""
    ja, ta, jp, tp, want = engine_weights[FAMILIES[0]]
    pol = parse_policy(SERVE_SPEC)
    narrow = tss.narrow_serving_params(tp, ta, pol)
    eng = ServeEngine(ta, narrow, pol, max_batch=4, ctx_len=32,
                      device="cpu", narrowed=True)
    assert eng.params is narrow
    assert _drive(eng) == want


# ----------------------------------------------------------------------------
# the memory of a full-width step: the optimizer and the wide rounding
# ----------------------------------------------------------------------------

def test_adamw_in_place_chain_is_the_reference_arithmetic():
    """llama4's 1-B-parameter head and embedding make every f32 temporary
    of the update 4 GB, so `adamw_update` runs its chain in place: bit for
    bit the out-of-place expression of the reference's operations."""
    from repro_torch.optim.adamw import OptState, adamw_update
    rng = np.random.default_rng(5)
    p = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32)).to(torch.bfloat16)}
    mu = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32)) * 0.1}
    nu = {"w": torch.from_numpy(rng.random((64, 48)).astype(np.float32))}
    b1, b2, eps, wd, lr, step = 0.9, 0.95, 1e-8, 0.1, 1e-3, 3
    gf = g["w"].to(torch.float32)
    gnorm = torch.sqrt(torch.zeros(()) + torch.sum(gf * gf))
    gf = gf * torch.clamp(1.0 / (gnorm + 1e-9), max=1.0)
    m = mu["w"] * b1 + gf * (1 - b1)
    v = nu["w"] * b2 + gf * (1 - b2) * gf
    s = torch.tensor(float(step), dtype=torch.float32)
    f32 = lambda x: float(torch.as_tensor(x, dtype=torch.float32))
    bc1 = f32(1 - torch.tensor(b1, dtype=torch.float32) ** s)
    bc2 = f32(1 - torch.tensor(b2, dtype=torch.float32) ** s)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    u = -f32(lr) * (u + wd * p["w"])
    got, st = adamw_update(g, OptState(step - 1, mu, nu), p, lr=lr, b1=b1,
                           b2=b2, eps=eps, weight_decay=wd, grad_clip=1.0)
    assert torch.equal(st.mu["w"], m) and torch.equal(st.nu["w"], v)
    assert torch.equal(got["w"], u)


@pytest.mark.parametrize("rows,tile", [(1000, 128), (640, 24)])
def test_wide_rounding_in_row_blocks_equals_whole(rows, tile, monkeypatch):
    """A matrix larger than one block is narrowed and wide-rounded in
    blocks of whole tile rows (the same tiles: bit for bit the whole
    matrix's), so llama4's head keeps its temporaries a block large."""
    from repro_torch.core import HBFPConfig, bfp
    from repro_torch.core import opt_shell
    w = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, 300)).astype(np.float32))
    c = HBFPConfig(8, 16, tile=tile)
    monkeypatch.setattr(opt_shell, "_ROW_BLOCK_ELEMS", 300 * 3 * tile)
    for wide in (False, True):
        got = opt_shell.quantize_leaf(w, c, wide)
        assert torch.equal(got, bfp.quantize_weight(w, c, wide=wide))
