"""The port's checkpoints and fault-tolerant Trainer against the JAX
package on the CPU.

The cases of the reference's trainer tests on yi-9b smoke: round trip,
packed checkpoints (B7's plain version packs on the CPU), preemption and
a bit-exact resume, retention and atomicity, background saves, the
run-log events and the manual clock. The on-disk format is the
reference's, so a checkpoint written by either package loads in the
other (plain and packed, with the precision spec in meta); schedules and
policies round-trip through meta and packed checkpoints pack at the
step-resolved widths.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import load_precision as jload_precision
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.precision import parse_policy as jparse
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    load_precision, save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.core import HBFP8_16, HBFPConfig, bfp
from repro_torch.core.opt_shell import widen_params
from repro_torch.core.schedule_precision import staircase, warmup_then_narrow
from repro_torch.data import SyntheticLM
from repro_torch.kernels import bfp_quantize as bq
from repro_torch.obs import ManualClock, MemorySink, Recorder
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.train import (Trainer, TrainState, from_jax_train_state,
                               init_train_state, make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def setup():
    arch = get_arch("yi-9b").smoke()
    pipe = SyntheticLM(arch.vocab_size, 17, 4, seed=7, device="cpu")
    sched = make_schedule("constant", base_lr=1e-3, warmup_steps=2,
                          total_steps=30)
    step = make_train_step(arch, HBFP8_16, sched, device="cpu")
    return arch, pipe, step


def _state(arch):
    return init_train_state(0, arch, device="cpu")


def _leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _equal(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _size(d):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def test_checkpoint_roundtrip(tmp_path, setup):
    arch, pipe, step = setup
    state, _ = step(_state(arch), pipe.batch(0))
    save_checkpoint(str(tmp_path), 3, state)
    restored, meta = load_checkpoint(str(tmp_path), _state(arch))
    assert meta["step"] == 3 and _equal(restored, state)
    assert isinstance(restored.step, int) and restored.step == 1
    assert isinstance(restored.opt.step, int)


def test_packed_checkpoint_compresses(tmp_path, setup):
    """Packed HBFP leaves store int16 mantissas (wide 16 bits) and int8
    exponents: less than 0.55 of their f32 files, one B7 call per leaf
    view, and they reload to the wide-BFP values."""
    arch, _, _ = setup
    params = _state(arch).params
    d1, d2 = str(tmp_path / "plain"), str(tmp_path / "packed")
    save_checkpoint(d1, 1, params)
    bq.reset_counts()
    save_checkpoint(d2, 1, params, hbfp=HBFP8_16, packed=True)
    assert bq.bfp_quantize.plain_calls == 8     # 7 stacked layers + head
    s1, s2 = (os.path.join(d, "step_00000001") for d in (d1, d2))
    packed = [f for f in os.listdir(s2) if f.endswith(".npz")]
    assert len(packed) == 8
    for f in packed:
        ratio = os.path.getsize(os.path.join(s2, f)) / os.path.getsize(
            os.path.join(s1, f[:-4] + ".npy"))
        assert ratio < 0.55, (f, ratio)
    assert _size(d2) < _size(d1)
    restored, meta = load_checkpoint(d2, params)
    assert meta["packed"]
    assert _equal(restored, widen_params(restored, HBFP8_16))
    assert _equal(restored["embed_table"], params["embed_table"])


def test_preemption_resume_bit_exact(tmp_path, setup):
    arch, pipe, step = setup
    d = str(tmp_path / "ckpt")
    tr = Trainer(train_step=step, init_state=_state(arch), data_fn=pipe.batch,
                 ckpt_dir=d, ckpt_every=3, hbfp=HBFP8_16, device="cpu")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        tr.run(8, fail_at_step=5, log_every=0)
    assert latest_step(d) == 3
    ms = MemorySink()
    tr2 = Trainer(train_step=step, init_state=_state(arch),
                  data_fn=pipe.batch, ckpt_dir=d, ckpt_every=3,
                  hbfp=HBFP8_16, recorder=Recorder([ms]), device="cpu")
    assert tr2.start_step == 3
    s_resumed, _ = tr2.run(8, log_every=0)
    s_straight, _ = Trainer(train_step=step, init_state=_state(arch),
                            data_fn=pipe.batch, device="cpu").run(
                                8, log_every=0)
    assert _equal(s_resumed, s_straight)
    # the cadence saved step 6, the end of the run step 8, each once
    assert [e.step for e in ms.of_kind("ckpt/save")] == [6, 8]
    assert sorted(int(p[5:]) for p in os.listdir(d)) == [3, 6, 8]


def test_retention_and_atomicity(tmp_path):
    d = str(tmp_path / "r")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, {"x": torch.ones(3) * s}, keep=2)
    steps = sorted(int(p[5:]) for p in os.listdir(d)
                   if p.startswith("step_") and not p.endswith(".tmp"))
    assert steps == [4, 5]
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a cut save
    assert latest_step(d) == 5


def test_background_checkpoint(tmp_path):
    d = str(tmp_path / "bg")
    x = torch.arange(10, dtype=torch.int32)
    t = save_checkpoint(d, 7, {"x": x}, background=True)
    x += 100        # the snapshot was taken before the save returned
    t.join()
    restored, meta = load_checkpoint(d, {"x": torch.zeros(10,
                                                          dtype=torch.int32)})
    assert meta["step"] == 7
    assert torch.equal(restored["x"], torch.arange(10, dtype=torch.int32))


def test_trainer_timing_deterministic_with_manual_clock(setup):
    arch, pipe, step = setup
    clk = ManualClock()
    ms = MemorySink()
    synced = []
    rec = Recorder([ms], clock=clk, sync=synced.append)

    def data(i):
        clk.advance(0.25)
        return pipe.batch(i)

    def stepped(s, b, key):
        clk.advance(0.1)
        return step(s, b, key)

    lines = []
    Trainer(train_step=stepped, init_state=_state(arch), data_fn=data,
            recorder=rec, device="cpu").run(6, log_every=5,
                                            log_fn=lines.append)
    spans = ms.of_kind("span")
    assert len(spans) == 6
    assert all(e.data["dur_us"] == pytest.approx(0.1e6) for e in spans)
    assert [e.data["synced"] for e in spans] == [True, False, False,
                                                False, False, True]
    assert len(synced) == 2
    prog = ms.of_kind("train/progress")
    assert [e.step for e in prog] == [0, 5]
    assert prog[1].data["elapsed_s"] == pytest.approx(6 * 0.35)
    assert "(0.3s)" in lines[0] and "(2.1s)" in lines[1]


def test_trainer_checkpoint_events_flow_to_recorder(tmp_path, setup):
    arch, pipe, step = setup
    d = str(tmp_path / "obs_ckpt")
    ms = MemorySink()
    Trainer(train_step=step, init_state=_state(arch), data_fn=pipe.batch,
            ckpt_dir=d, ckpt_every=2, hbfp=HBFP8_16, recorder=Recorder([ms]),
            device="cpu").run(3, log_every=0)
    saves = ms.of_kind("ckpt/save")
    assert [e.step for e in saves] == [2, 3]
    assert all(e.data["bytes"] > 0 and e.data["dur_s"] >= 0 for e in saves)
    ms2 = MemorySink()
    tr2 = Trainer(train_step=step, init_state=_state(arch),
                  data_fn=pipe.batch, ckpt_dir=d, ckpt_every=2,
                  hbfp=HBFP8_16, recorder=Recorder([ms2]), device="cpu")
    assert tr2.start_step == 3
    (load,) = ms2.of_kind("ckpt/load")
    assert load.step == 3 and load.data["bytes"] == saves[-1].data["bytes"]


# ---------------------------------------------------------------------------
# cross-load with the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jstate():
    arch = jget_arch("yi-9b").smoke()
    return jinit_train_state(jax.random.key(0), arch, jinit_params)


@pytest.mark.parametrize("packed", [False, True])
def test_reference_checkpoint_loads_in_port(tmp_path, jstate, packed):
    pol = "4@0,8@5; lm_head:12; wgrad+2"
    jsave(str(tmp_path), 7, jstate, hbfp=jparse(pol), packed=packed,
          extra_meta={"numerics_controller": {"log": []}})
    like = from_jax_train_state(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    restored, meta = load_checkpoint(str(tmp_path), like)
    jrestored, _ = jload(str(tmp_path), jstate)
    want = from_jax_train_state(jax.tree.map(np.asarray, jrestored),
                                device="cpu")
    assert _equal(restored, want)
    assert load_precision(meta) == parse_policy(pol)
    assert meta["numerics_controller"] == {"log": []}


@pytest.mark.parametrize("packed", [False, True])
def test_port_checkpoint_loads_in_reference(tmp_path, jstate, packed):
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    state = TrainState(state.params, state.opt, 3)
    pol = parse_policy("4@0,8@5; lm_head:12; wgrad+2")
    d1, d2 = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(d1, 7, state, hbfp=pol, packed=packed)
    jsave(d2, 7, jstate._replace(step=jnp.asarray(3, jnp.int32)),
          hbfp=jparse("4@0,8@5; lm_head:12; wgrad+2"), packed=packed)
    s1, s2 = (os.path.join(d, "step_00000007") for d in (d1, d2))
    assert sorted(os.listdir(s1)) == sorted(os.listdir(s2))
    m1, m2 = (json.load(open(os.path.join(s, "meta.json")))
              for s in (s1, s2))
    assert m1 == m2
    jrestored, meta = jload(d1, jstate)
    assert jload_precision(meta).to_dict() == pol.to_dict()
    want, _ = jload(d2, jstate)
    for a, b in zip(jax.tree.leaves(jrestored), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_bf16_leaf_loads_in_port(tmp_path):
    """The reference writes a bf16 leaf as 2-byte void (`|V2`); the port
    reads its bytes back as bf16, bit for bit."""
    rng = np.random.default_rng(11)
    src = jnp.asarray(rng.standard_normal((3, 4)).astype(np.float32),
                      jnp.bfloat16)
    jsave(str(tmp_path), 2, {"w": src})
    like = {"w": torch.zeros((3, 4), dtype=torch.bfloat16)}
    restored, _ = load_checkpoint(str(tmp_path), like)
    got = restored["w"]
    assert got.dtype == torch.bfloat16 and got.shape == (3, 4)
    want = np.asarray(src).view(np.int16)
    assert np.array_equal(got.view(torch.int16).numpy(), want)


# ---------------------------------------------------------------------------
# schedules and policies through meta; packing at the resolved width
# ---------------------------------------------------------------------------

def test_schedule_roundtrips_through_checkpoint(tmp_path):
    sched = staircase(((0, 4), (30, 8), (40, 16)),
                      base=HBFPConfig(8, 16, tile=24),
                      overrides=(("lm_head", 12), ("gate", None)))
    state = {"w": torch.ones((8, 8))}
    save_checkpoint(str(tmp_path), 7, state, hbfp=sched)
    _, meta = load_checkpoint(str(tmp_path), state)
    assert load_precision(meta) == sched
    save_checkpoint(str(tmp_path), 8, state, hbfp=HBFPConfig(12, 16))
    _, meta = load_checkpoint(str(tmp_path), state, step=8)
    assert load_precision(meta) == HBFPConfig(12, 16)
    save_checkpoint(str(tmp_path), 9, state, hbfp=None)
    _, meta = load_checkpoint(str(tmp_path), state, step=9)
    assert load_precision(meta) is None
    pol = parse_policy("4@0,8@30; wgrad+2; lm_head:12; backend=pallas")
    save_checkpoint(str(tmp_path), 10, state, hbfp=pol)
    _, meta = load_checkpoint(str(tmp_path), state, step=10)
    assert load_precision(meta) == pol


def test_packed_checkpoint_uses_resolved_width(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    sched = warmup_then_narrow(16, 8, 10, base=HBFPConfig(8, 8))
    save_checkpoint(str(tmp_path / "n"), 20, {"w": w}, hbfp=sched,
                    packed=True)
    restored, _ = load_checkpoint(str(tmp_path / "n"), {"w": w}, step=20)
    assert torch.equal(restored["w"],
                       bfp.quantize_weight(w, sched.resolve(20), wide=True))
    pol = parse_policy("8@0,4@10; lm_head:12", base=HBFPConfig(8, 8, tile=24))
    save_checkpoint(str(tmp_path / "p"), 20, {"w": w, "lm_head": h},
                    hbfp=pol, packed=True)
    restored, _ = load_checkpoint(str(tmp_path / "p"),
                                  {"w": w, "lm_head": h}, step=20)
    seg = pol.resolve_segment(pol.segment_index(20))
    for name, t in (("w", w), ("lm_head", h)):
        assert torch.equal(restored[name], bfp.quantize_weight(
            t, seg.for_param(name), wide=True))
