"""Rules of the port: it imports neither jax nor the reference package,
its entry points run on the card unless the CPU is asked for, and its
kernels are held to their plain versions on the card (the `gpu`-marked
test, which skips where there is no CUDA device).

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
    assert "repro_torch.kernels.hbfp_matmul" in mods
    assert "repro_torch.serve.engine" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
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


def test_unported_parts_raise_with_their_roadmap_item():
    from repro_torch.configs import get_arch
    from repro_torch.precision import parse_policy
    with pytest.raises(NotImplementedError, match="A12"):
        get_arch("gemma2-2b")
    with pytest.raises(NotImplementedError, match="A9"):
        parse_policy("4@0,8@90%")
    with pytest.raises(NotImplementedError, match="A9"):
        parse_policy("8; b=16@0,b=64@50%")
    pol = parse_policy("8; lm_head:12; wgrad+2; b=16; backend=pallas")
    seg = pol.resolve_segment(0)
    assert seg.backend == "pallas" and seg.global_cfg.act_block == 16
    assert seg.for_param("lm_head").mantissa_bits == 12
    assert seg.for_param("layers/ffn_wg", "wgrad").mantissa_bits == 10


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
    cases = chip_smoke.phase_kernels()
    assert cases and all(c["ok"] for c in cases)
