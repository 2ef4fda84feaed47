"""On the card: the control, the next lower precision (HBFP4), fails a
cell's check where the program at its stated precision (HBFP8) passes,
with every cell's own traffic and limits and the configuration cut to a
depth a test run holds. Run on the chip:

    python3 -m pytest -q -m gpu bench/tests/test_bench_gpu.py
"""
import json
import os
import sys

import pytest
from conftest import ROOT, write_root

BENCH_DOC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH_DOC["workloads"]]
DEPTH = {"yi-9b-16of48": 2}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card")


@pytest.fixture
def shallow_root(tmp_path):
    """The benchmark with each configuration at a test run's depth."""
    files = {}
    for c in BENCH_DOC["configs"]:
        d = json.load(open(os.path.join(ROOT, c["file"])))
        d["n_layers"] = DEPTH[c["name"]]
        files[c["file"]] = d
    root = write_root(tmp_path, BENCH_DOC, {})
    for path, obj in files.items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    return root


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, shallow_root, cell):
    sys.path.insert(0, os.path.join(ROOT, "bench", "tools"))
    import calibrate
    from harness.cells import load_cell
    c = load_cell(shallow_root, cell)
    got = {}
    emit = lambda seed, v, n: got.setdefault(v, n)
    if c.kind == "train":
        calibrate.train_seed(shallow_root, cell, 2**31 + 21,
                             ["sound", "control"], emit)
    else:
        calibrate.serve_seed(shallow_root, cell, 2**31 + 21, 5.0,
                             ["sound", "control"], emit)
    assert all(got["sound"][k] <= v for k, v in c.limits.items())
    assert any(got["control"][k] > v for k, v in c.limits.items())
