"""Smoke-size runs of each traffic kind on the CPU against the
reference: the shape of the result line, `correct` true on the sound
path, and false with the timed path broken underneath."""
import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT, tiny_bench, write_root

from harness.runner import run_cell

# limits for the smoke sizes, set from CPU readings of the sound program
# and of the faults below (bench/tools/calibrate.py --device cpu on the
# tiny cells, five seeds): sound loss1_gap <= 0.014, grad_gap <= 0.011,
# change_gap <= 0.008, logit_gap <= 0.13; half a batch reads change_gap
# >= 0.21, HBFP4 grad_gap >= 0.061 and logit_gap >= 2.19
TINY_LIMITS = {"train": {"loss1_gap": 0.025, "grad_gap": 0.03,
                         "change_gap": 0.1},
               "serve": {"logit_gap": 0.5}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_root(tmp_path_factory.mktemp("tiny"),
                      *tiny_bench(TINY_LIMITS))


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-batch", "tiny-chat"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct_and_well_formed(root, cell, trace):
    res, lines = run_cell(root, cell, 2**31 + 11, 0.6, trace, device="cpu")
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["count"] == 1
    units = {"train_tokens_per_s": "tokens/s", "serve_tokens_per_s":
             "tokens/s", "setup_s": "s", "ttft_p50_ms": "ms",
             "itl_p95_ms": "ms"}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
        if trace:
            assert name not in units
        else:
            assert units[name] == m["unit"]
    if not trace:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert lines == [f"check {n}: {c['value']!r} limit {c['limit']!r}"
                     for n, c in res["checks"].items()]
    json.dumps(res)


def _unchanged(step):
    """A step that returns its state unchanged."""
    def broken(state, batch, key=None):
        _, metrics = step(state, batch, key)
        return state, metrics
    return broken


def _half_batch(data_fn):
    def fn(step):
        b = data_fn(step)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()}
    return fn


def _altered(vocab):
    """Every token changed where the engine produces it."""
    def hook(fn):
        def out(d):
            return {rid: (t + 1) % vocab for rid, t in fn(d).items()}
        return out
    return hook


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_training_is_not_correct(root, fault):
    hooks = {"train_step": _unchanged} if fault == "unchanged" else \
        {"data_fn": _half_batch}
    res, _ = run_cell(root, "tiny-train", 2**31 + 12, 0.3, 0, device="cpu",
                      hooks=hooks)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny-batch", "tiny-chat"])
def test_altered_tokens_are_not_correct(root, cell):
    res, _ = run_cell(root, cell, 2**31 + 13, 0.5, 0, device="cpu",
                      hooks={"step_out": lambda f: _altered(512)(f)})
    assert not res["correct"], res["checks"]


def test_control_separates_at_smoke_size(root):
    """The next lower precision (the configuration's control, HBFP4)
    fails the smoke limits where HBFP8 passes them."""
    sys.path.insert(0, os.path.join(ROOT, "bench", "tools"))
    import calibrate
    out = []
    calibrate.train_seed(root, "tiny-train", 2**31 + 14,
                         ["sound", "control"],
                         lambda s, v, n: out.append((v, n)), "cpu")
    got = dict(out)
    lim = TINY_LIMITS["train"]
    assert all(got["sound"][k] <= lim[k] for k in lim)
    assert any(got["control"][k] > lim[k] for k in lim)


def _run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, os.path.join(cwd, "bench",
                                                        "run.py"), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_without_a_card_prints_no_result():
    r = _run_py(ROOT, "--workload", "yi9b-train-16k", "--seed",
                str(2**31 + 5), "--seconds", "10", "--trace", "0")
    assert r.returncode != 0
    assert "correct" not in r.stdout
    assert "CUDA" in r.stderr


def test_run_in_a_bare_benchmark_directory_fails(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = _run_py(str(tmp_path), "--workload", "yi9b-train-16k", "--seed",
                "1", "--seconds", "10", "--trace", "0")
    assert r.returncode != 0 and "correct" not in r.stdout
