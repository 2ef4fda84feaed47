"""The port's serving path on yi-9b smoke against the JAX package, with
the reference's weights carried across by `from_jax_params`.

* prefill and decode logits against the reference's jitted
  make_prefill_fn / make_decode_fn under "8; backend=pallas" (the Pallas
  kernel in interpret mode), with the BFP KV cache on and off. Tolerance
  max|Δ| <= 2e-3·max|ref| in f32: the two frameworks' rsqrt, sin/cos and
  exp differ by ulps, which now and then moves a value across a BFP
  rounding boundary; 2e-2·max|ref| in bf16, where the frameworks also
  round intermediate bf16 results at different places;
* the engine's greedy token streams equal the reference ServeEngine's on
  an overload trace, slab and paged; every step's top-2 logit margin is
  asserted above the f32 tolerance, so a flip would explain itself;
* inside the port: paged == slab on a longer trace, preemption resume,
  (rid, pos) sampling solo == crowded, and the matmul wrapper's plain
  calls per stage on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.precision import parse_policy as jparse_policy
from repro.serve import ServeEngine as JServeEngine
from repro.train import serve_step as jss
from repro_torch.configs import get_arch
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import from_jax_params
from repro_torch.precision import parse_policy
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.train import serve_step as tss

SPEC = "8; backend=pallas"
F32_TOL = 2e-3
BF16_TOL = 2e-2
# 3 requests on 2 lanes (overload), 2 distinct prompt lengths; drawn from
# np.random.default_rng(2), where every greedy step's top-2 margin is
# several times the f32 tolerance
TRACE = [([428, 133, 55, 152, 211], 5), ([416, 231, 47], 4),
         ([171, 307, 416, 373, 508], 5)]


def _archs(dtype="float32", **kw):
    ja = dataclasses.replace(jget_arch("yi-9b").smoke(), dtype=dtype, **kw)
    ta = dataclasses.replace(get_arch("yi-9b").smoke(), dtype=dtype, **kw)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    return ja, ta


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded params (f32 arch) as numpy + the port's."""
    ja, _ = _archs()
    jp = jinit_params(jax.random.key(0), ja)
    return jp, jax.tree.map(np.asarray, jp)


def _compile(fn, *args):
    """The reference's jitted stage, compiled without XLA's default excess
    precision: by default XLA may keep fused bf16 intermediates in f32,
    which no eager framework reproduces (in bf16 that alone moves the
    smoke logits by ~3% of their range through BFP rounding flips)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _steps(dtype, bfp_kv, weights):
    """(ref prefill, ref decode, port prefill, port decode) logits."""
    ja, ta = _archs(dtype, bfp_kv_cache=bfp_kv)
    jp, np_tree = weights
    jpol, tpol = jparse_policy(SPEC), parse_policy(SPEC)
    jparams = jss.narrow_serving_params(
        jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)) if a.ndim >= 2
                     else a, jp), ja, jpol)
    # both sides cast the f32 weights to the compute dtype first, then
    # narrow (round-to-nearest-even casts agree bit for bit)
    tparams = tss.narrow_serving_params(
        from_jax_params(np_tree, device="cpu",
                        dtype=getattr(torch, dtype)), ta, tpol)
    B, S, C = 2, 8, 16
    rng = np.random.default_rng(3)
    toks = rng.integers(0, ja.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    nxt = rng.integers(0, ja.vocab_size, (B, 1)).astype(np.int32)
    npos = np.full((B, 1), S, np.int32)

    pre_batch = {"tokens": toks, "positions": pos}
    jl, jc = _compile(jss.make_prefill_fn(ja, jpol), jparams,
                      pre_batch)(jparams, pre_batch)
    jc = jss.prefill_to_decode_cache(jc, ja, C)
    dec_batch = {"tokens": nxt, "positions": npos}
    jd, _ = _compile(jss.make_decode_fn(ja, jpol), jparams, dec_batch,
                     jc)(jparams, dec_batch, jc)

    tpre = tss.make_prefill_fn(ta, tpol, device="cpu")
    tdec = tss.make_decode_fn(ta, tpol, device="cpu")
    tl, tc = tpre(tparams, {"tokens": torch.from_numpy(toks),
                            "positions": torch.from_numpy(pos)})
    tc = tss.prefill_to_decode_cache(tc, ta, C)
    td, _ = tdec(tparams, {"tokens": torch.from_numpy(nxt),
                           "positions": torch.from_numpy(npos)}, tc)
    f = lambda a: np.asarray(a, np.float32)
    return f(jl), f(jd), tl.float().numpy(), td.float().numpy()


@pytest.mark.parametrize("dtype,bfp_kv", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", False)])
def test_prefill_and_decode_logits_match_reference(dtype, bfp_kv, weights):
    jl, jd, tl, td = _steps(dtype, bfp_kv, weights)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for ref, got in ((jl, tl), (jd, td)):
        assert got.shape == ref.shape
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


class _MarginTap:
    """Records the top-2 logit margin of every greedy draw the port engine
    makes for a live request."""

    def __init__(self, monkeypatch):
        self.margins = []
        self.scale = 0.0
        orig = tengine.sample_tokens

        def tap(logits, rids, poss, sp):
            live = torch.as_tensor(rids) >= 0
            top = torch.topk(logits[live].float(), 2, dim=-1).values
            self.margins += (top[:, 0] - top[:, 1]).tolist()
            self.scale = max(self.scale, float(logits[live].abs().max()))
            return orig(logits, rids, poss, sp)

        monkeypatch.setattr(tengine, "sample_tokens", tap)


def _drive(eng):
    for p, n in TRACE:
        eng.submit(p, max_new_tokens=n)
    return eng.drain()


@pytest.fixture(scope="module")
def reference_tokens(weights):
    ja, _ = _archs()
    eng = JServeEngine(ja, weights[0], jparse_policy(SPEC), max_batch=2,
                       ctx_len=32)
    return _drive(eng)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_greedy_tokens_match_reference(paged, weights,
                                              reference_tokens, monkeypatch):
    _, ta = _archs()
    tap = _MarginTap(monkeypatch)
    eng = ServeEngine(ta, from_jax_params(weights[1], device="cpu"),
                      parse_policy(SPEC), max_batch=2, ctx_len=32,
                      paged=paged, device="cpu")
    got = _drive(eng)
    assert min(tap.margins) > F32_TOL * tap.scale, \
        "a top-2 margin is inside the tolerance; tokens may flip"
    assert got == reference_tokens


@pytest.fixture(scope="module")
def port_setup(weights):
    _, ta = _archs()
    return ta, from_jax_params(weights[1], device="cpu")


def _engine(port_setup, **kw):
    ta, params = port_setup
    kw.setdefault("max_batch", 2)
    kw.setdefault("ctx_len", 32)
    return ServeEngine(ta, params, parse_policy(SPEC), device="cpu", **kw)


def test_paged_equals_slab_with_lane_reuse(port_setup):
    def run(eng):
        res = {}
        for p, n in TRACE:
            eng.submit(p, max_new_tokens=n)
        for _ in range(3):
            eng.step()
        eng.submit([4, 4], max_new_tokens=3)
        res.update(eng.drain())
        eng.submit([8, 1, 6], max_new_tokens=4)
        res.update(eng.drain())
        return res, eng

    slab, _ = run(_engine(port_setup, paged=False))
    paged, eng = run(_engine(port_setup, paged=True))
    assert paged == slab
    assert eng.pool.used_pages == 0


def test_preempted_request_resumes_to_isolated_output(port_setup):
    """Mirrors tests/test_serve_paged.py::test_preemption_oldest_wins: a
    6-page pool under two growing lanes; the younger lane is preempted,
    re-queued at the front and resumed; both outputs equal their isolated
    runs."""
    prompts = [([5, 9, 2], 16), ([7, 7, 7], 16)]
    kw = dict(paged=True, page_size=4, ctx_len=64)
    alone = []
    for p, n in prompts:
        e = _engine(port_setup, **kw)
        rid = e.submit(p, max_new_tokens=n)
        alone.append(e.drain()[rid])
    eng = _engine(port_setup, n_pages=6, **kw)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in prompts]
    res = eng.drain()
    assert eng.metrics.get("serve_preemptions_total").value >= 1
    assert [res[r] for r in rids] == alone
    assert eng.pool.used_pages == 0


def test_sampling_keyed_by_rid_and_pos(port_setup):
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=11)
    solo = _engine(port_setup, sampling=sp)
    r0 = solo.submit([5, 9, 2], max_new_tokens=6)
    solo_out = solo.drain()[r0]
    crowded = _engine(port_setup, sampling=sp)
    r0c = crowded.submit([5, 9, 2], max_new_tokens=6)
    crowded.submit([1, 1, 1, 1], max_new_tokens=6)
    crowded.submit([8, 3], max_new_tokens=6)
    out = crowded.drain()
    assert r0c == r0 and out[r0c] == solo_out
    other = _engine(port_setup, sampling=dataclasses.replace(sp, seed=12))
    other.submit([5, 9, 2], max_new_tokens=6)
    assert other.drain()[0] != solo_out


def test_plain_calls_per_stage_on_cpu(port_setup, monkeypatch):
    """On the CPU every projection and the head go through the matmul
    wrapper's plain version: 7 per layer + 1 per stage call."""
    ta, _ = port_setup
    eng = _engine(port_setup, prefill_chunk=4, async_prefill=True)
    calls = {"n": 0}
    for name in ("_prefill", "_extend", "_generate"):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, **k):
            calls["n"] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(eng, name, counted)
    hm.reset_counts()
    eng.submit(list(range(1, 11)), max_new_tokens=3)
    eng.submit([4, 2], max_new_tokens=2)
    res = eng.drain()
    assert [len(t) for t in res.values()] == [3, 2]
    assert calls["n"] > 0
    assert hm.hbfp_matmul_fwd.plain_calls == (7 * ta.n_layers + 1) * calls["n"]
    assert hm.hbfp_matmul_fwd.launches == 0


@pytest.mark.parametrize("k,p", [(0, 1.0), (5, 1.0), (0, 0.9), (20, 0.5)])
def test_sampling_filters_match_reference(k, p):
    """top-k / top-p masks keep exactly the reference's tokens; greedy is
    the reference's argmax."""
    from repro.serve import sampling as jsamp
    from repro_torch.serve import sampling as tsamp
    logits = np.random.default_rng(k + int(p * 10)).standard_normal(
        (3, 512)).astype(np.float32)
    ref = np.stack([np.asarray(jsamp._mask_top_p(jsamp._mask_top_k(
        jnp.asarray(row), k), p)) for row in logits])   # reference: per lane
    got = tsamp._mask_top_p(tsamp._mask_top_k(torch.from_numpy(logits), k),
                            p).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    greedy = tsamp.sample_tokens(torch.from_numpy(logits), [0, 1, 2],
                                 [4, 4, 4], tsamp.GREEDY).numpy()
    assert np.array_equal(greedy, np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits), jnp.arange(3), jnp.full(3, 4), jsamp.GREEDY)))
