"""The port's numerics observatory and closed adaptive-precision loop
against the JAX package on the CPU.

`quantize_with_stats` runs B7 (its plain version on the CPU) and a few
torch reductions; it is held to the reference's jnp stats field by field
and its dequantized tensor to `bfp.quantize` bit for bit. Tolerance:
`sqnr_db`'s two sums run in float64 in the port and in f32 in the
reference, so they differ by the reference's summation error, well inside
1e-3 dB at these sizes; the fractions are ratios of equal counts, equal
to an f32 ulp. The controller is plain Python in both packages: the same
stats dicts give the same decisions, logs and metas. The closed loop runs
on yi-9b smoke in the port alone, as the reference's own tests run it,
and once beside the reference for the decisions of its first steps.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import HBFPConfig as JHBFPConfig
from repro.core import bfp as jbfp
from repro.core.schedule_precision import ResolvedPrecision as JResolved
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_params as jinit_params
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import loss_fn as jloss_fn
from repro.numerics import ControllerConfig as JCC
from repro.numerics import PrecisionController as JPC
from repro.numerics import TapConfig as JTapConfig
from repro.numerics import quantize_with_stats as jqws
from repro.numerics import stats_to_host as jhost
from repro.numerics.collect import grad_stats as jgrad_stats
from repro.numerics.collect import narrow_params_with_stats as jnpws
from repro.numerics.collect import weight_stats as jweight_stats
from repro.numerics.controller import merge_sources as jmerge
from repro.optim import make_schedule as jmake_schedule
from repro.precision import parse_policy as jparse
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro_torch.configs import get_arch
from repro_torch.core import HBFPConfig, bfp
from repro_torch.core.opt_shell import narrow_params
from repro_torch.core.schedule_precision import ResolvedPrecision
from repro_torch.data import SyntheticLM
from repro_torch.kernels import bfp_quantize as bq
from repro_torch.models import from_jax_params
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import loss_fn
from repro_torch.numerics import (ControllerConfig, PrecisionController,
                                  RingBuffer, TapConfig,
                                  make_adaptive_train_step,
                                  narrow_params_with_stats,
                                  quantize_with_stats, stats_to_host)
from repro_torch.numerics.collect import grad_stats, weight_stats
from repro_torch.numerics.controller import merge_sources
from repro_torch.obs import ManualClock, MemorySink, Recorder
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.train import (Trainer, from_jax_train_state,
                               init_train_state, make_step, make_train_step)

SQNR_TOL_DB = 1e-3


FIELDS = ("clip_frac", "sat_tile_frac", "ftz_frac", "exp_spread", "n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _x(shape, seed, scale=2.7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_stats_close(got: dict, want: dict, sqnr_tol=SQNR_TOL_DB,
                        frac_tol=1e-6):
    assert abs(got["sqnr_db"] - want["sqnr_db"]) <= sqnr_tol, (got, want)
    for k in FIELDS:
        assert abs(got[k] - want[k]) <= frac_tol * max(1.0, abs(want[k])), \
            (k, got[k], want[k])
    assert got["exp_hist"] == want["exp_hist"]


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [(1, None), (64, 64), (None, None),
                                  (24, 24), (1, 24, 24)])
@pytest.mark.parametrize("m", [4, 8])
def test_quantize_with_stats_matches_reference(tile, m):
    shape = (3, 100, 48) if len(tile) == 3 else (100, 130)
    x = _x(shape, m * 100 + len(tile))
    q, s = quantize_with_stats(torch.from_numpy(x), m, tile)
    jq, js = jqws(jnp.asarray(x), m, tile)
    assert torch.equal(q, bfp.quantize(torch.from_numpy(x), m, tile))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _assert_stats_close(stats_to_host(s), jhost(js))


def test_stats_track_width_outliers_and_identity():
    w = _x((128, 256), 1, 1.0)
    host = {m: stats_to_host(quantize_with_stats(
        torch.from_numpy(w), m, bfp.weight_tile_shape(2, 64))[1])
        for m in (4, 8, 12)}
    assert host[4]["sqnr_db"] < host[8]["sqnr_db"] < host[12]["sqnr_db"]
    assert host[4]["ftz_frac"] > host[8]["ftz_frac"] > host[12]["ftz_frac"]
    assert sum(host[4]["exp_hist"]) == (128 // 64) * (256 // 64)
    w[0, 0] = 1e4
    s = stats_to_host(quantize_with_stats(torch.from_numpy(w), 4,
                                          (None, None))[1])
    assert s["ftz_frac"] > 0.9 and s["exp_spread"] == 0.0
    x = torch.from_numpy(_x((32, 32), 0))
    q, s = quantize_with_stats(x, 24, (None, None))
    assert torch.equal(q, x) and float(s.sqnr_db) == 200.0
    # stochastic: B7 at the key's seed, the tensor of bfp.quantize with
    # the same key, and a key is needed
    q, s = quantize_with_stats(x, 4, (8, 8), "stochastic", 77)
    assert torch.equal(q, bfp.quantize(x, 4, (8, 8), "stochastic", 77))
    assert not torch.equal(q, quantize_with_stats(x, 4, (8, 8))[0])
    assert float(s.n) == x.numel() and float(s.sqnr_db) < 200.0
    with pytest.raises(ValueError, match="key"):
        quantize_with_stats(x, 4, (8, 8), "stochastic")


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yi_params():
    arch = jget_arch("yi-9b").smoke()
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jinit_params(jax.random.key(0), arch))
    return arch, jp, from_jax_params(jp, device="cpu")


def test_weight_tap_is_the_narrowing(yi_params):
    """Tree-level weight tap: the narrow copy equals `narrow_params` (and
    the reference's), one TensorStats per BFP weight, FP params untouched
    and unmeasured; one B7 call per leaf view."""
    _, jp, tp = yi_params
    jrp = JResolved(global_cfg=JHBFPConfig(4, 16),
                    overrides=(("head_w", JHBFPConfig(12, 16)),))
    trp = ResolvedPrecision(global_cfg=HBFPConfig(4, 16),
                            overrides=(("head_w", HBFPConfig(12, 16)),))
    bq.reset_counts()
    narrow, stats = narrow_params_with_stats(tp, trp)
    assert bq.bfp_quantize.plain_calls == len(stats) == 8
    plain = narrow_params(tp, trp)
    jnarrow_tree, jstats = jnpws(jax.tree.map(jnp.asarray, jp), jrp)
    assert set(stats) == set(jstats)
    assert not any("norm" in k or "embed" in k for k in stats)
    for name in ("head_w", "embed_table"):
        assert torch.equal(narrow[name], plain[name])
        np.testing.assert_array_equal(narrow[name].numpy(),
                                      np.asarray(jnarrow_tree[name]))
    for n, t in narrow["layers"].items():
        assert torch.equal(t, plain["layers"][n])
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jnarrow_tree["layers"][n]))
    host, jh = stats_to_host(stats), jhost(jstats)
    for name in stats:
        _assert_stats_close(host[name], jh[name])
    assert host["head_w"]["sqnr_db"] > host["layers/ffn_wg"]["sqnr_db"] + 20


def test_weight_and_grad_taps_at_role_widths(yi_params):
    """weight_stats at the fwd width, grad_stats at the wgrad width of a
    "4; wgrad+4" segment, equal to the reference's."""
    _, jp, tp = yi_params
    jseg = jparse("4; wgrad+4").resolve_segment(0)
    tseg = parse_policy("4; wgrad+4").resolve_segment(0)
    g = jax.tree.map(lambda a: a * np.float32(0.01), jp)
    ws = weight_stats(tp, tseg)
    gs = grad_stats(from_jax_params(g, device="cpu"), tseg)
    jws = jweight_stats(jax.tree.map(jnp.asarray, jp), jseg)
    jgs = jgrad_stats(jax.tree.map(jnp.asarray, g), jseg)
    assert set(ws) == set(gs) == set(jws) == set(jgs) and ws
    for mine, ref in ((ws, jws), (gs, jgs)):
        h, jh = stats_to_host(mine), jhost(ref)
        for name in h:
            _assert_stats_close(h[name], jh[name])
    assert stats_to_host(gs)["layers/ffn_wg"]["sqnr_db"] > \
        stats_to_host(ws)["layers/ffn_wg"]["sqnr_db"] + 20


def test_activation_tap_matches_reference(yi_params):
    """`Ctx(act_tap=True)`: loss_fn returns the residual stream's stats
    at the stack's entry and exit, the loss itself unchanged (f32)."""
    arch, jpf, tp = yi_params
    arch = dataclasses.replace(arch, dtype="float32")
    pipe = JSyntheticLM(arch.vocab_size, 17, 2, seed=4)
    batch = pipe.batch(0)
    cfg = JHBFPConfig(4, 16, act_block=32)
    jl, jm = jloss_fn(jax.tree.map(jnp.asarray, jpf), batch, arch,
                      JCtx(cfg=cfg, act_tap=True))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tcfg = HBFPConfig(4, 16, act_block=32)
    tl, tm = loss_fn(tp, tb, arch, Ctx(cfg=tcfg, act_tap=True),
                     device="cpu")
    l0, _ = loss_fn(tp, tb, arch, Ctx(cfg=tcfg), device="cpu")
    assert float(tl) == float(l0)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    h, jh = stats_to_host(tm["act_stats"]), jhost(jm["act_stats"])
    assert set(h) == {"embed_out", "final_hidden"}
    _assert_stats_close(h["embed_out"], jh["embed_out"])
    # the stack's exit went through both frameworks' f32 ops: equal up
    # to rounding flips of a few elements (ROADMAP C6)
    _assert_stats_close(h["final_hidden"], jh["final_hidden"],
                        sqnr_tol=0.05, frac_tol=0.01)


# ---------------------------------------------------------------------------
# controller: port and reference fed the same stats dicts
# ---------------------------------------------------------------------------

def _obs(sqnr, clip=0.0, ftz=0.0):
    return {"sqnr_db": sqnr, "clip_frac": clip, "sat_tile_frac": clip,
            "ftz_frac": ftz}


def _scenario_stats():
    """Per-step observations of the stationary case: a fixed tensor
    re-measured at the controller's width by the reference's stats."""
    w = jnp.asarray(_x((96, 96), 5, 1.7))
    return lambda m: jhost(jqws(w, m, jbfp.weight_tile_shape(2, 24))[1])


SCENARIOS = {
    "clip_widen_patience2": (dict(patience=2, cooldown=1), 4,
                             [{"l": _obs(30.0, clip=0.2)}] * 3),
    "blip_breaks_streak": (dict(patience=3), 4,
                           [{"l": _obs(5.0)}] * 2 + [{"l": _obs(50.0)}]),
    "sqnr_floor_widen": (dict(patience=1, cooldown=0), 8,
                         [{"l": _obs(10.0)}]),
    "headroom_narrow": (dict(patience=1, cooldown=0), 12,
                        [{"l": _obs(60.0)}]),
    "ftz_widen": (dict(patience=1, cooldown=0), 4,
                  [{"l": _obs(80.0, ftz=0.95)}]),
    "ftz_deadband": (dict(patience=1, cooldown=0), 8,
                     [{"l": _obs(80.0, ftz=0.3)}] * 5),
    "ratchet": (dict(patience=1, cooldown=0), 4,
                [{"l": _obs(5.0)}] + [{"l": _obs(199.0)}] * 9),
    "two_layers": (dict(patience=1, cooldown=0), 4,
                   [{"a": _obs(5.0), "b": _obs(30.0, clip=0.5)},
                    {"a": _obs(5.0)}, {"a": _obs(5.0), "b": _obs(30.0)}]),
    "block_ladder_ftz": (dict(patience=1, cooldown=0,
                              block_ladder=(16, 32, 64)), 4,
                         [{"l": _obs(80.0, ftz=0.95)},
                          {"l": _obs(5.0)}, {"l": _obs(199.0)}]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["stationary"])
def test_controller_decisions_match_reference(name):
    """The controller cases of the reference's tests: clipping with
    patience, a broken streak, the SQNR floor, headroom narrowing, FTZ and
    its deadband, the ratchet, two layers, the block ladder, and the
    stationary closed loop (no oscillation): the port's decisions, log,
    overrides and meta equal the reference's."""
    if name == "stationary":
        stats = _scenario_stats()
        for base in (4, 8, 12, 16):
            t = PrecisionController(ControllerConfig(patience=1, cooldown=0),
                                    base_bits=base)
            j = JPC(JCC(patience=1, cooldown=0), base_bits=base)
            trace = [base]
            for step in range(30):
                s = stats(t.width("l"))
                assert t.observe(step, {"l": s}) == j.observe(step,
                                                              {"l": s})
                trace.append(t.width("l"))
            assert len(set(trace[-10:])) == 1 and t.to_meta() == j.to_meta()
        return
    kw, base, seq = SCENARIOS[name]
    t = PrecisionController(ControllerConfig(**kw), base_bits=base)
    j = JPC(JCC(**kw), base_bits=base)
    for step, obs in enumerate(seq):
        assert t.observe(step, obs) == j.observe(step, obs)
    assert t.log == j.log and t.overrides() == j.overrides()
    assert t.to_meta() == j.to_meta()
    assert t.log or name in ("blip_breaks_streak", "ftz_deadband")


def test_controller_meta_cap_resolution_and_events():
    c = PrecisionController(ControllerConfig(patience=1, cooldown=0),
                            base_bits=4, meta_log_cap=4)
    c.observe(0, {f"layer_{i}": _obs(5.0) for i in range(10)})
    meta = json.loads(json.dumps(c.to_meta()))
    assert meta["log"] == c.log[-4:] and meta["log_dropped"] == 6
    c2 = PrecisionController.from_meta(meta)
    obs = {"layer_0": _obs(5.0), "fresh": _obs(5.0)}
    assert c.observe(1, obs) == c2.observe(1, obs) != []
    with pytest.raises(ValueError, match="meta_log_cap"):
        PrecisionController(meta_log_cap=0)
    # exact-name overrides never substring-capture a sibling
    c = PrecisionController(ControllerConfig(patience=1, cooldown=0),
                            base_bits=4)
    c.observe(0, {"layers/ffn_w": _obs(5.0)})
    rp = c.resolved(HBFPConfig(4, 16))
    assert rp.for_param("layers/ffn_w").mantissa_bits == 8
    assert rp.for_param("layers/ffn_w2").mantissa_bits == 4
    seg = parse_policy("4").resolve_segment(0).with_controller(c.overrides())
    assert seg.for_param("layers/ffn_w", "wgrad").mantissa_bits == 8
    assert seg.for_param("layers/ffn_w2").mantissa_bits == 4
    # decisions and snapshots stream to a recorder
    ms = MemorySink()
    rec = Recorder([ms], clock=ManualClock())
    c = PrecisionController(ControllerConfig(patience=1, cooldown=0),
                            base_bits=4, recorder=rec)
    c.observe(3, {"layers/ffn_w": _obs(5.0)})
    (ev,) = ms.of_kind("precision/decision")
    assert ev.step == 3 and ev.data["to"] == 8 and "step" not in ev.data
    rb = RingBuffer(maxlen=2, recorder=rec)
    snap = {"weights": {"l": dict(_obs(20.0), exp_spread=2, n=64,
                                  exp_hist=[1, 2, 3])},
            "widths": {"weights": {"l": 4}}}
    for i in range(3):
        rb.append(i, snap)
    ev = ms.of_kind("numerics/snapshot")[-1]
    assert "exp_hist" not in ev.data["weights"]["l"]
    assert len(rb) == 2 and rb.latest() == (2, snap)
    merged = {"weights": {"l": _obs(40.0, clip=0.01)},
              "grads": {"l": _obs(12.0, clip=0.2)},
              "acts": {"embed_out": _obs(50.0)}}
    assert merge_sources(merged) == jmerge(merged)


# ---------------------------------------------------------------------------
# the closed loop (port, yi-9b smoke, CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_setup():
    arch = get_arch("yi-9b").smoke()
    pipe = SyntheticLM(arch.vocab_size, 17, 4, seed=3, device="cpu")
    lrs = make_schedule("constant", base_lr=2e-3, warmup_steps=2,
                        total_steps=30)
    return arch, pipe, lrs


def _params_equal(a, b) -> bool:
    if isinstance(a, dict):
        return all(_params_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_telemetry_off_and_on_bit_identical_to_static(loop_setup):
    arch, pipe, lrs = loop_setup
    base = HBFPConfig(8, 16)
    static = make_train_step(arch, base, lrs, device="cpu")
    s_ref = init_train_state(0, arch, device="cpu")
    for i in range(3):
        s_ref, m_ref = static(s_ref, pipe.batch(i))
    for cadence in (None, 1):
        ctrl = PrecisionController(ControllerConfig(patience=10 ** 6),
                                   base_bits=8)
        step = make_adaptive_train_step(arch, base, lrs, controller=ctrl,
                                        tap=TapConfig(cadence=cadence),
                                        device="cpu")
        s = init_train_state(0, arch, device="cpu")
        for i in range(3):
            s, m = step(s, pipe.batch(i))
        assert len(step.buffer) == (3 if cadence else 0)
        assert float(m["loss"]) == float(m_ref["loss"])
        assert _params_equal(s.params, s_ref.params)


def test_adaptive_loop_survives_all_taps_disabled(loop_setup):
    arch, pipe, lrs = loop_setup
    step = make_step(arch, HBFPConfig(8, 16), lrs,
                     controller=PrecisionController(base_bits=8),
                     tap=TapConfig(cadence=1, weights=False, grads=False,
                                   acts=False), device="cpu")
    bq.reset_counts()
    s, m = step(init_train_state(0, arch, device="cpu"), pipe.batch(0))
    assert torch.isfinite(m["loss"]) and len(step.buffer) == 0
    assert bq.bfp_quantize.plain_calls == 0


def test_adaptive_loop_widens_and_reuses_variants(loop_setup):
    """Widen decisions and variants cached per (overrides, telemetry); a
    telemetry step converts each weight slice, each grad slice (24 divides
    no K of yi-9b smoke) and the two activation views through B7."""
    arch, pipe, lrs = loop_setup
    ms = MemorySink()
    ctrl = PrecisionController(ControllerConfig(patience=1, cooldown=1),
                               base_bits=4)
    step = make_step(arch, HBFPConfig(4, 16, tile=24), lrs, controller=ctrl,
                     tap=TapConfig(cadence=2), recorder=Recorder([ms]),
                     device="cpu")
    s = init_train_state(0, arch, device="cpu")
    L = arch.n_layers
    for i in range(6):
        bq.reset_counts()
        s, m = step(s, pipe.batch(i))
        assert torch.isfinite(m["loss"])
        assert bq.bfp_quantize.plain_calls == \
            (2 * (7 * L + 1) + 2 if i % 2 == 0 else 0)
    assert any(d["action"] == "widen" for d in ctrl.log)
    assert int(float(m["n_overrides"])) == len(ctrl.overrides()) > 0
    assert float(m["min_mantissa_bits"]) == 4.0
    assert len(step.variants) <= 2 * (len(ctrl.log) + 1)
    assert len(ms.of_kind("train/recompile")) == len(step.variants)
    assert len(ms.of_kind("numerics/snapshot")) == 3
    assert len(ms.of_kind("precision/decision")) == len(ctrl.log)
    snap = step.buffer.latest()[1]
    assert set(snap) == {"weights", "grads", "acts", "widths"}


def test_adaptive_decisions_bit_identical_across_restore(tmp_path,
                                                         loop_setup):
    """Preempt an adaptive run mid-flight; the resumed run's decision log,
    controller state and final params equal the uninterrupted run's."""
    arch, pipe, lrs = loop_setup
    base = HBFPConfig(4, 16, tile=24)

    def build():
        ctrl = PrecisionController(ControllerConfig(patience=2, cooldown=1),
                                   base_bits=4)
        return make_step(arch, base, lrs, controller=ctrl,
                         tap=TapConfig(cadence=3), device="cpu"), ctrl

    step_a, ctrl_a = build()
    s_straight, _ = Trainer(
        train_step=step_a, init_state=init_train_state(0, arch, device="cpu"),
        data_fn=pipe.batch, hbfp=base, controller=ctrl_a,
        device="cpu").run(12, log_every=0)
    d = str(tmp_path / "ckpt")
    step_b, ctrl_b = build()
    tr1 = Trainer(train_step=step_b,
                  init_state=init_train_state(0, arch, device="cpu"),
                  data_fn=pipe.batch, ckpt_dir=d, ckpt_every=6, hbfp=base,
                  controller=ctrl_b, device="cpu")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        tr1.run(12, fail_at_step=9, log_every=0)
    step_c, ctrl_c = build()
    tr2 = Trainer(train_step=step_c,
                  init_state=init_train_state(0, arch, device="cpu"),
                  data_fn=pipe.batch, ckpt_dir=d, ckpt_every=6, hbfp=base,
                  controller=ctrl_c, device="cpu")
    assert tr2.start_step == 6
    assert ctrl_c.log == [e for e in ctrl_a.log if e["step"] < 6]
    s_resumed, _ = tr2.run(12, log_every=0)
    assert ctrl_c.log == ctrl_a.log and ctrl_c.widths == ctrl_a.widths
    assert ctrl_c.to_meta() == ctrl_a.to_meta()
    assert _params_equal(s_resumed.params, s_straight.params)
    assert _params_equal(s_resumed.opt.mu, s_straight.opt.mu)


def test_closed_loop_decisions_match_reference():
    """Two steps of the loop beside the reference's from the same f32
    weights and batches (sim backend, "4; wgrad+4", tile 24): the step-0
    snapshot within the stated tolerances, the same decisions."""
    ja = dataclasses.replace(jget_arch("yi-9b").smoke(), dtype="float32")
    ta = dataclasses.replace(get_arch("yi-9b").smoke(), dtype="float32")
    pipe = JSyntheticLM(ja.vocab_size, 17, 4, seed=3)
    kw = dict(base_lr=2e-3, warmup_steps=2, total_steps=30)
    spec = "4; wgrad+4"
    jc = JPC(JCC(patience=1, cooldown=1), base_bits=4)
    tc = PrecisionController(ControllerConfig(patience=1, cooldown=1),
                             base_bits=4)
    js = jmake_step(ja, jparse(spec, base=JHBFPConfig(4, 16, tile=24)),
                    jmake_schedule("constant", **kw), controller=jc,
                    tap=JTapConfig(cadence=2))
    ts = make_step(ta, parse_policy(spec, base=HBFPConfig(4, 16, tile=24)),
                   make_schedule("constant", **kw), controller=tc,
                   tap=TapConfig(cadence=2), device="cpu")
    jst = jinit_train_state(jax.random.key(0), ja, jinit_params)
    tst = from_jax_train_state(jax.tree.map(np.asarray, jst), device="cpu")
    for i in range(2):
        b = pipe.batch(i)
        jst, _ = js(jst, b, jax.random.fold_in(jax.random.key(1), i))
        tst, _ = ts(tst, {k: torch.from_numpy(np.array(v))
                          for k, v in b.items()})
        if i == 0:
            jsnap, tsnap = js.buffer.latest()[1], ts.buffer.latest()[1]
            assert tsnap["widths"] == jsnap["widths"]
            for name in jsnap["weights"]:
                _assert_stats_close(tsnap["weights"][name],
                                    jsnap["weights"][name])
            for src in ("grads", "acts"):   # rounding flips (ROADMAP C6)
                for name in jsnap[src]:
                    _assert_stats_close(tsnap[src][name], jsnap[src][name],
                                        sqnr_tol=1.0, frac_tol=0.05)
    assert tc.log and [(d["step"], d["layer"], d["action"], d["to"])
                       for d in tc.log] == \
        [(d["step"], d["layer"], d["action"], d["to"]) for d in jc.log]
