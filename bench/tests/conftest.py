"""Test set-up of the benchmark's own tests: `bench/` (the harness, the
reference) and `src/` (the port) on the path, and `tiny_root`, a copy of
the benchmark in a temporary checkout with smoke-size configurations,
mixes and cells that run on the CPU."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"family": "dense", "n_layers": 2, "d_model": 128,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 256,
              "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-6,
              "dtype": "bfloat16", "q_chunk": 32}
TINY_SERVE = {"kind": "serve", "lanes": 4, "ctx_len": 128, "pool": 64,
              "sizes_seed": 1,
              "prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 64},
              "output": {"median": 6, "sigma": 0.5, "min": 3, "max": 12},
              "trace_steps": 2}


def tiny_bench(limits=None):
    """A BENCHMARK.json document and its files (path -> object) for three
    smoke-size cells, one of each traffic kind and loop."""
    lim = limits or {}
    cfg = lambda name, model: dict(model, name=name, source="smoke",
                                   precision="8; backend=pallas",
                                   control_precision="4; backend=pallas")
    files = {
        "bench/configs/tiny-dense.json": cfg("tiny-dense", TINY_MODEL),
        "bench/traffic/tiny_train.json": {
            "kind": "train", "batch": 2, "seq_len": 64, "lr": 3e-4,
            "check_steps": 3, "trace_steps": 1},
        "bench/traffic/tiny_closed.json": dict(TINY_SERVE, loop="closed",
                                               clients=8,
                                               warmup_completions=4),
        "bench/traffic/tiny_open.json": dict(TINY_SERVE, loop="open",
                                             rate=40.0, warmup_s=0.2),
        "bench/workloads/tiny-train.json": {"limits": lim.get(
            "train", {"loss1_gap": 0.05, "grad_gap": 0.2,
                      "change_gap": 0.5})},
        "bench/workloads/tiny-batch.json": {
            "limits": lim.get("serve", {"logit_gap": 0.5}),
            "check": {"requests": 3}},
        "bench/workloads/tiny-chat.json": {
            "limits": lim.get("serve", {"logit_gap": 0.5}),
            "check": {"requests": 3}},
    }
    real = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cells = [("tiny-train", "tiny-dense", "tiny_train"),
             ("tiny-batch", "tiny-dense", "tiny_closed"),
             ("tiny-chat", "tiny-dense", "tiny_open")]
    rename = {"yi9b-train-16k": ["tiny-train"],
              "yi9b-serve-batch": ["tiny-batch"],
              "yi9b-serve-chat": ["tiny-chat"]}

    def moved(m):
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = [t for w in m["workloads"]
                              for t in rename.get(w, [])]
        return m

    doc = dict(real)
    doc["configs"] = [{"name": n, "source": "smoke",
                       "file": f"bench/configs/{n}.json", "reduced": [],
                       "why": "smoke"}
                      for n in ("tiny-dense",)]
    doc["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                         "why": "smoke"} for n, c, t in cells]
    doc["end_to_end"] = [moved(m) for m in real["end_to_end"]]
    doc["per_layer"] = [moved(m) for m in real["per_layer"]]
    return doc, files


def write_root(root, doc, files):
    shutil.copytree(BENCH, os.path.join(root, "bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "src"), os.path.join(root, "src"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    for path, obj in files.items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    return str(root)


@pytest.fixture
def tiny_root(tmp_path):
    doc, files = tiny_bench()
    return write_root(tmp_path, doc, files)
