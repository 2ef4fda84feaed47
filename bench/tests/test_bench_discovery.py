"""Cells, configurations, traffic mixes and metric readers are found by
name, and a new one is added by adding files alone; BENCHMARK.json keeps
to the benchmark's contract."""
import json
import os
import re

import pytest
from conftest import ROOT, tiny_bench, write_root

from harness.cells import load_cell

BENCH_DOC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH_DOC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    c = load_cell(ROOT, cell)
    assert c.name == cell
    assert c.kind in ("train", "serve")
    assert c.generator.run is not None
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and all(hasattr(m.reader, "read")
                               for m in c.per_layer)


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="yi9b-train-16k"):
        load_cell(ROOT, "no-such-cell")


def test_a_cell_config_mix_and_metric_added_as_files(tmp_path):
    """A throwaway configuration, mix, cell and per-layer metric, each a
    new file and a new entry, run without an edit to any file there."""
    doc, files = tiny_bench()
    files["bench/configs/tiny-wide.json"] = dict(
        files["bench/configs/tiny-dense.json"], name="tiny-wide", d_ff=384)
    files["bench/traffic/tiny_train_long.json"] = dict(
        files["bench/traffic/tiny_train.json"], seq_len=96, batch=1)
    files["bench/workloads/tiny-extra.json"] = {
        "limits": {"loss1_gap": 0.05, "grad_gap": 0.5, "change_gap": 0.1}}
    doc["configs"].append({"name": "tiny-wide", "source": "smoke",
                           "file": "bench/configs/tiny-wide.json",
                           "reduced": [], "why": "smoke"})
    doc["workloads"].append({"name": "tiny-extra", "config": "tiny-wide",
                             "traffic": "tiny_train_long", "chips": 1,
                             "why": "smoke"})
    doc["per_layer"].append({"name": "steps_seen.extra", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "train step",
                             "moves": "train_tokens_per_s",
                             "workloads": ["tiny-extra"]})
    for m in doc["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-extra")
    root = write_root(tmp_path, doc, files)
    with open(os.path.join(root, "bench/metrics/steps_seen.extra.py"),
              "w") as f:
        f.write("def read(r):\n    return float(r.window['steps'])\n")
    before = {p: open(os.path.join(ROOT, "bench", p)).read()
              for p in ("harness/cells.py", "traffic/train.py")}
    from harness.runner import run_cell
    c = load_cell(root, "tiny-extra")
    assert c.config.model["d_ff"] == 384 and c.mix["seq_len"] == 96
    assert [m.name for m in c.per_layer] == ["steps_seen.extra"]
    res, _ = run_cell(root, "tiny-extra", 7, 0.5, True, device="cpu")
    assert res["metrics"]["steps_seen.extra"]["value"] >= 1
    assert res["correct"], res["checks"]
    assert before == {p: open(os.path.join(ROOT, "bench", p)).read()
                      for p in before}


def test_benchmark_json_keeps_to_the_contract():
    d = BENCH_DOC
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["bench"] and d["command"][1] == "bench/run.py"
    assert 1 <= d["run_seconds"] <= 51
    n = 24                   # the most cells a later PR may reach
    assert (2 + 14 * n) * (d["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in d[k]]
    assert len(names) == len(set(names))
    for x in names:
        assert NAME.match(x), x
    cfgs = {c["name"]: c for c in d["configs"]}
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|d_model|d_ff|head|state|"
                                 r"expand)", k), k
    used = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1
        assert TEXT.match(w["why"]), w["name"]
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in d["end_to_end"]}
    layers = {}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "bench", "metrics",
                                           m["name"] + ".py"))
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer
    for w in CELLS:
        assert any(w in m.get("workloads", CELLS) for m in d["per_layer"])
    assert len(json.dumps(d)) < 64 * 1024
