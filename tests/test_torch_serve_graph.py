"""The port's generate tick with static shapes, the way a CUDA graph
captures it (`serve/graph.py`, `serve/engine.py`), against the JAX
package. Every comparison is bit for bit.

* `_paged_append`'s fixed-shape write (dropped writes land on the pool's
  spare last page) and its gather equal the reference's `mode="drop"`
  write and gather: free lanes, unallocated pages, the BFP KV cache on
  and off, S = 1 and S > 1;
* the engine, driven on the CPU through the same static tick buffers and
  copy-in / copy-out code as the graph, gives the reference engine's
  greedy tokens, slab and paged, with lane reuse and preemption; the
  cache and tick buffers keep their `data_ptr()` across that trace;
* `GraphedStage`'s counting: the capture's launches are taken back out
  and added once per replay (CUDA graph faked on the CPU);
* `cuda_graph=True` on the CPU raises.

JAX is imported inside the tests that run the reference, so the `gpu`
cases run where JAX is not installed. Those cases (graphed == eager:
tokens, every tick's logits, the cache; launches per replay; capture
under sync-debug "error"; solo == crowded sampling under the graph) skip
where there is no CUDA device. Run them on the card:
    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_serve_graph.py
"""
import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import from_jax_params, init_params
from repro_torch.models.attention import PagedKVCache, _paged_append
from repro_torch.precision import parse_policy
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.serve import graph as tgraph

SPEC = "8; backend=pallas"
F32_TOL = 2e-3
# 3 requests on 2 lanes (tests/test_torch_serve.py's trace, whose greedy
# top-2 margins are several times the f32 tolerance)
TRACE = [([428, 133, 55, 152, 211], 5), ([416, 231, 47], 4),
         ([171, 307, 416, 373, 508], 5)]
# a 4-page pool of 4-token pages under the same trace: lanes outgrow it
PREEMPT = dict(paged=True, page_size=4, n_pages=4)


# -- the fixed-shape paged write --------------------------------------

def _pool(rng, P, Hkv, ps, hd, bfp):
    """Random pool contents (k, v, slot_pos, k_exp, v_exp) of P pages."""
    if bfp:
        k = rng.integers(-127, 128, (P, Hkv, ps, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (P, Hkv, ps, hd)).astype(np.int8)
        ke = rng.integers(-20, 10, (P, Hkv, ps)).astype(np.int8)
        ve = rng.integers(-20, 10, (P, Hkv, ps)).astype(np.int8)
    else:
        k = rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32)
        v = rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32)
        ke = ve = None
    sp = rng.integers(-1, 64, (P, ps)).astype(np.int32)
    return k, v, sp, ke, ve


@pytest.mark.parametrize("bfp", [False, True])
@pytest.mark.parametrize("S", [1, 3])
def test_paged_append_equals_reference_drop(bfp, S):
    import jax.numpy as jnp

    from repro.models import attention as jatt
    rng = np.random.default_rng(10 + 2 * S + bfp)
    B, Hkv, hd, ps, NP, P = 4, 2, 8, 4, 3, 7
    C = NP * ps
    k, v, sp, ke, ve = _pool(rng, P, Hkv, ps, hd, bfp)
    # lane 0: all pages; lane 1: its first page only (later slots drop);
    # lane 2: free (no pages, pos 0, as the engine leaves a free lane);
    # lane 3: pages out of order, one hole
    pt = np.array([[0, 1, 2], [3, -1, -1], [-1, -1, -1], [6, -1, 4]],
                  np.int32)
    pos = np.stack([np.arange(S) + 2, np.arange(S) + 3, np.zeros(S),
                    np.arange(S) + 3]).astype(np.int32)
    kn = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)

    jc = jatt.PagedKVCache(*(None if a is None else jnp.asarray(a)
                             for a in (k, v, sp, pt, ke, ve)))
    jnew, jkd, jvd, jpos = jatt._paged_append(
        jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), bfp,
        jnp.float32)

    # the port's pool has a spare last page; give it garbage
    spare = _pool(rng, 1, Hkv, ps, hd, bfp)
    t = lambda a, b: None if a is None else torch.from_numpy(
        np.concatenate([a, b]))
    tc = PagedKVCache(t(k, spare[0]), t(v, spare[1]), t(sp, spare[2]),
                      torch.from_numpy(pt), t(ke, spare[3]),
                      t(ve, spare[4]))
    ptrs = [x.data_ptr() for x in tc if x is not None]
    tnew, tkd, tvd, tpos = _paged_append(
        tc, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(pos), bfp, torch.float32)

    assert tnew is tc and [x.data_ptr() for x in tc if x is not None] \
        == ptrs                                        # written in place
    for got, want in ((tkd, jkd), (tvd, jvd), (tpos, jpos)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for name in ("k", "v", "slot_pos", "k_exp", "v_exp"):
        want = getattr(jnew, name)
        if want is None:
            assert getattr(tnew, name) is None
            continue
        got = getattr(tnew, name).numpy()
        assert np.array_equal(got[:P], np.asarray(want)), name
    assert np.array_equal(tnew.page_table.numpy(), pt)
    assert tkd.shape == (B, Hkv, C, hd) and tpos.shape == (B, C)


# -- the engine on the CPU against the reference -----------------------

def _archs():
    from repro.configs import get_arch as jget_arch
    ja = dataclasses.replace(jget_arch("yi-9b").smoke(), dtype="float32")
    ta = dataclasses.replace(get_arch("yi-9b").smoke(), dtype="float32")
    return ja, ta


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded params (f32 arch), as jax and as numpy."""
    import jax

    from repro.models import init_params as jinit_params
    ja, _ = _archs()
    jp = jinit_params(jax.random.key(0), ja)
    return jp, jax.tree.map(np.asarray, jp)


def _drive(eng):
    for p, n in TRACE:
        eng.submit(p, max_new_tokens=n)
    return eng.drain()


class _MarginTap:
    """The top-2 logit margin of every greedy draw for a live request."""

    def __init__(self, monkeypatch):
        self.margins, self.scale = [], 0.0
        orig = tengine.sample_tokens

        def tap(logits, rids, poss, sp):
            live = torch.as_tensor(rids) >= 0
            top = torch.topk(logits[live].float(), 2, dim=-1).values
            self.margins += (top[:, 0] - top[:, 1]).tolist()
            self.scale = max(self.scale, float(logits[live].abs().max()))
            return orig(logits, rids, poss, sp)

        monkeypatch.setattr(tengine, "sample_tokens", tap)


def _cache_ptrs(eng):
    return [t.data_ptr() for c in eng.cache.values() for t in c
            if t is not None] + [t.data_ptr() for t in (
                eng._tok, eng._pos, eng._rids, eng._lanes_host)]


@pytest.mark.parametrize("kw", [dict(paged=False), dict(paged=True),
                                PREEMPT], ids=["slab", "paged", "preempt"])
def test_static_tick_engine_matches_reference(kw, weights, monkeypatch):
    """Greedy tokens equal the reference engine's; the cache and the tick
    buffers are never reallocated, whatever the trace does to lanes and
    pages."""
    from repro.precision import parse_policy as jparse_policy
    from repro.serve import ServeEngine as JServeEngine
    ja, ta = _archs()
    jeng = JServeEngine(ja, weights[0], jparse_policy(SPEC), max_batch=2,
                        ctx_len=32, **kw)
    want = _drive(jeng)
    tap = _MarginTap(monkeypatch)
    eng = ServeEngine(ta, from_jax_params(weights[1], device="cpu"),
                      parse_policy(SPEC), max_batch=2, ctx_len=32,
                      device="cpu", **kw)
    assert not isinstance(eng._tick, tgraph.GraphedStage)
    ptrs = _cache_ptrs(eng)
    for p, n in TRACE:
        eng.submit(p, max_new_tokens=n)
    got = {s.rid: s.tokens for s in eng.slots if s}
    while any(eng.slots) or eng.pending:
        eng.step()
        for s in eng.slots:
            if s is not None:
                got.setdefault(s.rid, s.tokens)
        assert _cache_ptrs(eng) == ptrs
    assert min(tap.margins) > F32_TOL * tap.scale, \
        "a top-2 margin is inside the tolerance; tokens may flip"
    assert got == want
    preempted = eng.metrics.get("serve_preemptions_total").value
    assert preempted == jeng.metrics.get("serve_preemptions_total").value
    assert (preempted >= 1) == (kw is PREEMPT)
    if kw.get("paged"):
        assert eng.pool.used_pages == 0


def test_cuda_graph_refused_on_cpu(weights):
    _, ta = _archs()
    params = from_jax_params(weights[1], device="cpu")
    with pytest.raises(ValueError, match="cuda_graph"):
        ServeEngine(ta, params, parse_policy(SPEC), max_batch=2,
                    ctx_len=32, device="cpu", cuda_graph=True)
    for flag in (None, False):
        eng = ServeEngine(ta, params, parse_policy(SPEC), max_batch=2,
                          ctx_len=32, device="cpu", cuda_graph=flag)
        assert eng._tick == eng._generate_tick


# -- GraphedStage's counting, with the CUDA graph faked on the CPU -----

class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def fake_cuda_graph(monkeypatch):
    """torch.cuda's graph API replaced by a capture that runs the body
    (as a real capture runs its Python) and a replay that runs nothing."""
    modes = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    _FakeGraph.replays = 0
    hm.reset_counts()
    yield modes
    hm.reset_counts()


def _launching_body(n):
    """A stage body that 'launches' B1 n times, as the wrapper counts."""
    fn = hm.hbfp_matmul_fwd

    def body():
        fn.launches += n
        fn.launches_by_route["bf16_wgmma"] += n
        return torch.arange(3)
    return body


def test_graphed_stage_counts_replays_not_captures(fake_cuda_graph):
    gc_during = []
    body = _launching_body(5)

    def watched():
        gc_during.append(gc.isenabled())
        return body()

    stage = tgraph.GraphedStage(watched)
    fn = hm.hbfp_matmul_fwd
    stage()                                   # eager warm-up
    assert (stage.graph, fn.launches) == (None, 5)
    for i in range(1, 4):                     # capture + replay, replays
        out = stage()
        assert out is stage.out
        assert (stage.calls, stage.replays) == (i + 1, i)
        assert fn.launches == 5 + 5 * i
        assert fn.launches_by_route["bf16_wgmma"] == 5 + 5 * i
    assert _FakeGraph.replays == 3
    assert stage.per_replay["hbfp_matmul_fwd"] == (
        5, {"int8_wgmma": 0, "bf16_wgmma": 5, "cuda_core": 0})
    assert all(n == 0 for k, (n, _) in stage.per_replay.items()
               if k != "hbfp_matmul_fwd")
    # the body was captured under sync-debug "error", then restored, and
    # with the cyclic garbage collector off (a dead engine's graph or
    # pinned buffer freed inside a capture invalidates it)
    assert fake_cuda_graph == ["error", 0]
    assert gc_during == [gc.isenabled(), False] and gc.isenabled()


def test_graphed_stage_capture_error_propagates(fake_cuda_graph):
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("capture refused")
        return torch.zeros(1)

    stage = tgraph.GraphedStage(body)
    stage()
    with pytest.raises(RuntimeError, match="capture refused"):
        stage()
    assert stage.graph is None and stage.replays == 0
    assert fake_cuda_graph == ["error", 0] and gc.isenabled()


# -- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph captures the kernels, "
                    "which build and run only on the card")


def _card_engines(paged, sampling=None, max_batch=4):
    arch = get_arch("yi-9b").smoke()
    params = init_params(0, arch)
    kw = dict(max_batch=max_batch, ctx_len=64, paged=paged,
              sampling=sampling)
    pol = parse_policy(SPEC)
    return (ServeEngine(arch, params, pol, **kw),
            ServeEngine(arch, params, pol, cuda_graph=False, **kw), arch)


_CARD_TRACE = [(list(range(3 + 2 * i, 10 + 3 * i)), 6 + i) for i in range(6)]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_graphed_tick_equals_eager_on_card(paged):
    _need_card()
    g, e, arch = _card_engines(paged)
    assert isinstance(g._tick, tgraph.GraphedStage)
    for eng in (g, e):
        for p, n in _CARD_TRACE:
            eng.submit(p, max_new_tokens=n)
    ptrs = _cache_ptrs(g)
    ticks = 0
    while any(g.slots) or g.pending:
        assert g.step() == e.step()
        ticks += 1
        assert torch.equal(g.tick_logits, e.tick_logits)
        assert _cache_ptrs(g) == ptrs
    assert not (any(e.slots) or e.pending)
    for cg, ce in zip(g.cache.values(), e.cache.values()):
        for name, a, b in zip(cg._fields, cg, ce):
            if a is None:
                continue
            if paged and name != "page_table":
                # the spare page takes dropped writes in no defined order
                # and is never read
                a, b = a[:, :-1], b[:, :-1]
            assert torch.equal(a, b), name
    assert (g._tick.calls, g._tick.replays) == (ticks, ticks - 1)
    per = g._tick.per_replay["hbfp_matmul_fwd"]
    assert per[0] == 7 * arch.n_layers + 1 == sum(per[1].values())


@pytest.mark.gpu
def test_graphed_tick_launch_counts_on_card():
    """The counters move by the recorded launches per replay, and not at
    capture."""
    _need_card()
    g, _, arch = _card_engines(True)
    g.submit([1, 2, 3, 4], max_new_tokens=8)
    g.step()                                  # eager warm-up tick
    hm.reset_counts()
    g.step()                                  # capture + first replay
    per_call = 7 * arch.n_layers + 1
    assert hm.hbfp_matmul_fwd.launches == per_call
    g.step()
    assert hm.hbfp_matmul_fwd.launches == 2 * per_call
    assert g._tick.replays == 2 and hm.hbfp_matmul_fwd.plain_calls == 0


@pytest.mark.gpu
def test_graphed_sampling_solo_equals_crowded_on_card():
    _need_card()
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=11)
    crowded, _, _ = _card_engines(True, sampling=sp)
    for p, n in _CARD_TRACE:
        crowded.submit(p, max_new_tokens=n)
    want = crowded.drain()
    solo, _, _ = _card_engines(True, sampling=sp)
    for rid, (p, n) in enumerate(_CARD_TRACE):
        assert solo.submit(p, max_new_tokens=n) == rid
        assert solo.drain()[rid] == want[rid]
    assert solo._tick.replays > 0 and crowded._tick.replays > 0


@pytest.mark.gpu
def test_capture_refuses_a_host_sync_on_card():
    """A body that syncs with the host cannot be captured: the stage
    raises (sync-debug "error" names the op) and never replays."""
    _need_card()
    x = torch.ones(4, device="cuda")
    stage = tgraph.GraphedStage(lambda: x * float(x.sum().item()))
    stage()                                   # eager: the sync is fine
    with pytest.raises(RuntimeError):
        stage()
    assert stage.graph is None and stage.replays == 0
