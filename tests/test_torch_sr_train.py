"""Stochastic rounding through the port's training path (ROADMAP A5) on
gemma2 smoke, on both backends ("sim", and "pallas" through the kernels'
plain versions).

The keys are host ints, folded per layer and site (`Ctx.fold`,
`Ctx.key_for`), per parameter and layer slice (`opt_shell.param_key`) and
per step (`Trainer(seed=)`), so, bit for bit:

  * a step's loss and grads with `arch.remat` on (every layer and CE
    chunk recomputed in the backward) equal those with it off: the
    recompute draws the forward's noise;
  * a telemetry step (B7 narrows the weights with their stats) equals the
    plain step in params, moments and loss;
  * a run preempted and resumed from its checkpoint equals the
    uninterrupted run.

And a stochastic step adds no device-to-host copy (`_local_scalar_dense`)
to the nearest step's: the kernels' seeds are derived on the host.

Run on the CPU:
    PYTHONPATH=src python -m pytest tests/test_torch_sr_train.py
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.core import hbfp_ops
from repro_torch.data import batch_for_arch
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.kernels.common import fold_in
from repro_torch.models.layers import Ctx
from repro_torch.numerics import TapConfig
from repro_torch.optim import make_schedule
from repro_torch.optim.adamw import named_leaves
from repro_torch.precision import parse_policy
from repro_torch.train import Trainer, init_train_state, make_step

SPECS = ("8~stochastic", "8~stochastic; backend=pallas")
KEY = fold_in(fold_in(0, 11), 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arch(**kw):
    # S = 32 tokens a row, 2 rows: 2 CE chunks of 32, the 16-token local
    # window masks
    return dataclasses.replace(get_arch("gemma2-2b").smoke(), loss_chunk=32,
                               **kw)


def _sched():
    return make_schedule("constant", base_lr=1e-3, warmup_steps=0,
                         total_steps=10)


def _batch(arch, step=0):
    return batch_for_arch(arch, 2, 32, step=step, kind="markov",
                          device="cpu")


def _equal_trees(a, b) -> bool:
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_ctx_carries_an_int_key():
    pol = parse_policy("8~stochastic").resolve_segment(0)
    ctx = Ctx(policy=pol, key=5)
    assert not hasattr(ctx, "generator")
    site = int.from_bytes(b"ffn_", "little")
    assert ctx.fold(2).key_for("ffn_wi") == fold_in(fold_in(5, 2), site)
    assert ctx.key_for("ffn_wi") == ctx.key_for("ffn_wo")   # 4 bytes
    assert ctx.fold(2).key_for("wq") != ctx.fold(3).key_for("wq")
    assert Ctx(policy=parse_policy("8").resolve_segment(0),
               key=5).key_for("wq") is None
    assert Ctx(policy=pol).fold(1).key_for("wq") is None


@pytest.mark.parametrize("spec", SPECS)
def test_remat_recompute_replays_the_forward_draws(spec, monkeypatch):
    calls = {"q": 0}
    q_act = hbfp_ops._q_act

    def counted(*a, **k):
        calls["q"] += 1
        return q_act(*a, **k)

    monkeypatch.setattr(hbfp_ops, "_q_act", counted)
    out, work = {}, {}
    for remat in (True, False):
        arch = _arch(remat=remat)
        step = make_step(arch, spec, _sched(), device="cpu")
        state = init_train_state(0, arch, device="cpu")
        calls["q"] = 0
        hm.reset_counts()
        loss, _, grads = step.grads(state, _batch(arch), KEY)
        work[remat] = (calls["q"], hm.hbfp_matmul_fwd.plain_calls)
        out[remat] = (loss, grads)
        if remat:
            other = step.grads(init_train_state(0, arch, device="cpu"),
                               _batch(arch), KEY + 1)
    # the recompute ran: more forward quantizations (sim attention) and
    # more B1 calls (kernel path) with remat on
    assert work[True][0] > work[False][0]
    if "pallas" in spec:
        assert work[True][1] > work[False][1] > 0
    assert torch.equal(out[True][0], out[False][0])
    assert _equal_trees(out[True][1], out[False][1])
    # and the rounding is stochastic: another key draws other noise
    assert not _equal_trees(out[True][1], other[2])


@pytest.mark.parametrize("spec", SPECS)
def test_telemetry_step_equals_plain_step(spec):
    arch = _arch()
    runs = {}
    for tap in (None, TapConfig(cadence=1)):
        step = make_step(arch, spec, _sched(), tap=tap, device="cpu")
        state = init_train_state(0, arch, device="cpu")
        state, m = step(state, _batch(arch), KEY)
        runs[tap is not None] = (state, m)
    (tel, mt), (pln, mp) = runs[True], runs[False]
    assert "numerics" in mt and "numerics" not in mp
    assert set(mt["numerics"]["weights"]) == {
        n for n, _ in named_leaves(tel.params)
        if n.startswith("layers/attn_w") or n.startswith("layers/ffn_w")
        or n == "head_w"}
    assert torch.equal(mt["loss"], mp["loss"])
    assert _equal_trees(tel.params, pln.params)
    assert _equal_trees(tel.opt.mu, pln.opt.mu)
    assert _equal_trees(tel.opt.nu, pln.opt.nu)


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    arch = _arch()
    spec = "8~stochastic; backend=pallas"
    data = lambda i: _batch(arch, i)

    def trainer(seed=3, ckpt_dir=None):
        return Trainer(train_step=make_step(arch, spec, _sched(),
                                            device="cpu"),
                       init_state=init_train_state(0, arch, device="cpu"),
                       data_fn=data, ckpt_dir=ckpt_dir, ckpt_every=2,
                       seed=seed, device="cpu")

    straight, _ = trainer().run(4, log_fn=None)
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="preemption"):
        trainer(ckpt_dir=d).run(4, fail_at_step=3, log_fn=None)
    tr = trainer(ckpt_dir=d)
    assert tr.start_step == 2
    resumed, _ = tr.run(4, log_fn=None)
    assert resumed.step == straight.step == 4
    assert _equal_trees(resumed.params, straight.params)
    assert _equal_trees(resumed.opt.mu, straight.opt.mu)
    assert _equal_trees(resumed.opt.nu, straight.opt.nu)
    other, _ = trainer(seed=4).run(4, log_fn=None)
    assert not _equal_trees(other.params, straight.params)


def _host_copies(spec: str, key) -> int:
    arch = _arch()
    step = make_step(arch, spec, _sched(), device="cpu")
    state = init_train_state(0, arch, device="cpu")
    batch = _batch(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, key)
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_local_scalar_dense")


def test_stochastic_step_adds_no_host_sync():
    """The step's keys and the kernels' seeds are host ints: a stochastic
    step copies no more scalars from the device than the nearest step."""
    nearest = _host_copies("8; backend=pallas", None)
    assert _host_copies("8~stochastic; backend=pallas", KEY) <= nearest


@pytest.mark.parametrize("spec", ["8~stochastic; ffn:fp32",
                                  "8~stochastic; wgrad+2; backend=pallas",
                                  "12@0,4@1~stochastic"])
def test_every_variant_takes_the_key(spec):
    """Per-layer overrides, per-role widths and a schedule into a
    stochastic segment, under the controller and the telemetry cadence:
    each variant gets the key, and a stochastic one refuses a step
    without it."""
    from repro_torch.numerics import PrecisionController
    arch = _arch()
    step = make_step(arch, spec, _sched(), device="cpu",
                     controller=PrecisionController(base_bits=8),
                     tap=TapConfig(cadence=1))
    state = init_train_state(0, arch, device="cpu")
    stochastic_at0 = parse_policy(spec).resolve_segment(0).any_stochastic
    if not stochastic_at0:
        state, _ = step(state, _batch(arch, 0))
    with pytest.raises(ValueError, match="key"):
        step(state, _batch(arch, state.step))
    a = step(state, _batch(arch, state.step), KEY)
    assert torch.isfinite(a[1]["loss"]) and a[0].step == state.step + 1
