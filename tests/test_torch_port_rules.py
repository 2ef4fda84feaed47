"""Rules of the port: it imports neither jax nor the reference package,
its entry points (serving and training) run on the card unless the CPU is
asked for, every architecture of the reference resolves and builds, and its
kernels are held to their plain versions on the card (the `gpu`-marked
test, which skips where there is no CUDA device). The schedules, the
controller loop and checkpoints, which raised until they were ported, are
held to working here.

Run the card test on a machine with an H100:
    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_port_rules.py
"""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    for m in ("repro_torch.kernels.hbfp_matmul",
              "repro_torch.kernels.hbfp_flash_attn",
              "repro_torch.kernels.bfp_quantize", "repro_torch.numerics.stats",
              "repro_torch.checkpoint.checkpointing",
              "repro_torch.core.schedule_precision", "repro_torch.serve.engine",
              "repro_torch.train.train_step", "repro_torch.train.trainer",
              "repro_torch.optim.adamw", "repro_torch.data.pipeline",
              "repro_torch.core.grad_compress", "repro_torch.launch.mesh",
              "repro_torch.launch.transport", "repro_torch.sharding",
              "repro_torch.sharding.partitioning", "repro_torch.train.zero",
              "repro_torch.analysis.roofline", "repro_torch.launch.dryrun"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "import torch.distributed as dist\n"
        "started = dist.is_available() and dist.is_initialized()\n"
        "print('PROCESS GROUP', started)\n"
        "sys.exit(1 if bad or started else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_entry_points_need_a_gpu():
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import from_jax_params, init_params
    from repro_torch.precision import parse_policy
    from repro_torch.serve import ServeEngine
    arch = get_arch("yi-9b").smoke()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(0, arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"head_w": torch.zeros(2, 2).numpy()})
    params = init_params(0, arch, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(arch, params, parse_policy("8; backend=pallas"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_training_entry_points_need_a_gpu():
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for_arch
    from repro_torch.optim import make_schedule
    from repro_torch.train import Trainer, init_train_state, make_step
    arch = get_arch("gemma2-2b").smoke()
    if torch.cuda.is_available():
        return
    sched = make_schedule("constant", base_lr=1e-3, warmup_steps=0,
                          total_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(0, arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step(arch, "8; backend=pallas", sched)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_for_arch(arch, 2, 8)
    state = init_train_state(0, arch, device="cpu")
    step = make_step(arch, "8; backend=pallas", sched, device="cpu")
    data = lambda i: batch_for_arch(arch, 2, 8, step=i, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(train_step=step, init_state=state, data_fn=data)
    state, metrics = Trainer(train_step=step, init_state=state,
                             data_fn=data, device="cpu").run(1, log_fn=None)
    assert state.step == 1 and torch.isfinite(metrics["loss"])


def test_unported_parts_raise_with_their_roadmap_item():
    """Every model family of the reference is ported: qwen2-vl's (M-RoPE,
    embeddings input) and musicgen's (multi-codebook heads) configs,
    which raised until A12.4-5 were done, resolve with the reference's
    smoke fields and build (no embedding table, musicgen's [K, D, V]
    head), and so does every other registered arch. The MoE family,
    which raised until A12.3 was done, resolves and builds. Step and
    block schedules, which raised until ROADMAP A9 was done, resolve as
    the reference's."""
    from repro.configs import arch_ids as jarch_ids
    from repro.configs import get_arch as jget_arch
    from repro.precision import parse_policy as jparse
    from repro_torch.configs import arch_ids, get_arch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    import dataclasses
    assert sorted(arch_ids()) == sorted(jarch_ids())
    for name in arch_ids():
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(
            jget_arch(name))
    for name, head in (("qwen2-vl-72b", (128, 512)),
                       ("musicgen-large", (4, 128, 512))):
        arch = get_arch(name).smoke()
        assert dataclasses.asdict(arch) == dataclasses.asdict(
            jget_arch(name).smoke())
        params = init_params(0, arch, device="cpu")
        assert "embed_table" not in params
        assert tuple(params["head_w"].shape) == head
    moe = get_arch("llama4-scout-17b-a16e").smoke()
    assert dataclasses.asdict(moe) == dataclasses.asdict(
        jget_arch("llama4-scout-17b-a16e").smoke())
    assert get_arch("arctic-480b").n_experts == 128
    params = init_params(0, moe, device="cpu")
    assert params["layers"]["moe_wg"].shape == (2, 4, 128, 256)
    asd = lambda c: None if c is None else dataclasses.asdict(c)
    for spec in ("4@0,8@90%", "8; b=16@0,b=64@50%"):
        t, j = parse_policy(spec, total_steps=100), jparse(spec,
                                                          total_steps=100)
        assert t.boundaries() == j.boundaries() == (0, 50 if "b=" in spec
                                                    else 90)
        for step in (0, 49, 50, 89, 90, 99):
            for role in ("fwd", "wgrad"):
                assert asd(t.resolve(("layers/ffn_wg"), step).cfg) == \
                    asd(j.resolve("layers/ffn_wg", step).cfg)
                assert asd(t.resolve_segment(t.segment_index(step))
                           .for_param("head_w", role)) == \
                    asd(j.resolve_segment(j.segment_index(step))
                        .for_param("head_w", role))
    pol = parse_policy("8; lm_head:12; wgrad+2; b=16; backend=pallas")
    seg = pol.resolve_segment(0)
    assert seg.backend == "pallas" and seg.global_cfg.act_block == 16
    assert seg.for_param("lm_head").mantissa_bits == 12
    assert seg.for_param("layers/ffn_wg", "wgrad").mantissa_bits == 10


def test_unported_training_parts_raise_with_their_roadmap_item(tmp_path):
    """Stochastic rounding in training (A5) runs a step from a key and
    refuses a step without one; the controller loop (A10) runs a step and
    the Trainer's checkpoints (A8) save and resume: each raised until it
    was ported."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for_arch
    from repro_torch.numerics import PrecisionController, TapConfig
    from repro_torch.optim import make_schedule
    from repro_torch.train import Trainer, init_train_state, make_step
    arch = get_arch("gemma2-2b").smoke()
    sched = make_schedule("constant", base_lr=1e-3, warmup_steps=0,
                          total_steps=1)
    data = lambda i: batch_for_arch(arch, 2, 8, step=i, device="cpu")
    step = make_step(arch, "8~stochastic", sched, device="cpu")
    state, metrics = step(init_train_state(0, arch, device="cpu"), data(0),
                          12345)
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    with pytest.raises(ValueError, match="key"):
        step(init_train_state(0, arch, device="cpu"), data(0))
    ctrl = PrecisionController(base_bits=8)
    step = make_step(arch, "8", sched, controller=ctrl,
                     tap=TapConfig(cadence=1), device="cpu")
    state, metrics = step(init_train_state(0, arch, device="cpu"), data(0))
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    assert len(step.buffer) == 1 and "n_overrides" in metrics
    d = str(tmp_path / "ckpt")
    step = make_step(arch, "8", sched, device="cpu")
    Trainer(train_step=step, init_state=init_train_state(0, arch,
                                                         device="cpu"),
            data_fn=data, ckpt_dir=d, device="cpu").run(2, log_fn=None)
    tr = Trainer(train_step=step, init_state=init_train_state(0, arch,
                                                              device="cpu"),
                 data_fn=data, ckpt_dir=d, device="cpu")
    assert tr.start_step == 2 and tr.state.step == 2


def test_policy_resolution_matches_reference():
    from repro.precision import parse_policy as jparse
    from repro_torch.precision import parse_policy as tparse
    import dataclasses
    for spec in ("8", "12", "8; backend=pallas", "8; lm_head:12",
                 "8; wgrad+2; dgrad=10", "8~stochastic; ffn:fp32",
                 "fp32", "8; b=32; backend=pallas"):
        j, t = jparse(spec).resolve_segment(0), tparse(spec).resolve_segment(0)
        asd = lambda c: None if c is None else dataclasses.asdict(c)
        assert asd(j.global_cfg) == asd(t.global_cfg), spec
        assert j.backend == t.backend
        for name in ("layers/attn_wq", "lm_head", "layers/ffn_wo"):
            for role in ("fwd", "dgrad", "wgrad"):
                assert asd(j.for_param(name, role)) == \
                    asd(t.for_param(name, role)), (spec, name, role)


@pytest.mark.gpu
def test_chip_smoke_kernel_phase_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    cases = (chip_smoke.phase_kernels() + chip_smoke.phase_bwd()
             + chip_smoke.phase_flash() + chip_smoke.phase_quantize())
    assert cases and all(c["ok"] for c in cases)
