"""Find a cell and everything that belongs to it by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics; the files beside it
hold the rest, one file per thing:

    bench/configs/<config>.json     the model as run (`Config`)
    bench/traffic/<mix>.json        a traffic mix's parameters; its "kind"
                                    names the generator bench/traffic/<kind>.py
    bench/workloads/<cell>.json     the limits of the cell's output check
    bench/metrics/<metric>.py       a per-layer metric's reader

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none of these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional

def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file loaded by path under a private module name (metric
    readers are named like `mfu.train.py`, which `import` cannot spell)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# keys of a configuration file that are not the model's
META_KEYS = ("name", "source", "paper", "precision", "control_precision",
             "published", "assumed", "deployment", "departures")


@dataclasses.dataclass(frozen=True)
class Config:
    """A model configuration as it is run: `model` holds the file's model
    keys, named as the port's `ArchConfig` fields (the reference reads
    the same dict), `precision` the policy string the program runs it at
    and `control` the next lower precision, which the output check's
    control runs."""
    name: str
    source: str
    precision: str
    control: str
    model: Dict[str, Any]

    @classmethod
    def load(cls, path: str) -> "Config":
        d = _read_json(path)
        return cls(name=d["name"], source=d["source"],
                   precision=d["precision"], control=d["control_precision"],
                   model={k: v for k, v in d.items() if k not in META_KEYS})

    def arch(self, **changes):
        """The port's ArchConfig of this configuration."""
        from repro_torch.configs.base import ArchConfig
        return dataclasses.replace(
            ArchConfig(name=self.name, **self.model), **changes)


@dataclasses.dataclass
class Metric:
    """A metric of BENCHMARK.json as a run reports it."""
    name: str
    unit: str
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None
    reader: Any = None          # the per-layer metric's module


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's `workloads` with its files."""
    name: str
    config: Config
    mix: Dict[str, Any]
    chips: int
    limits: Dict[str, float]
    check: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    generator: Any

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _metric(d: dict) -> Metric:
    return Metric(name=d["name"], unit=d["unit"], moves=d.get("moves"),
                  workloads=d.get("workloads"))


def _reports(m: Metric, cell: str) -> bool:
    return m.workloads is None or cell in m.workloads


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json: its configuration, mix,
    limits, end-to-end metrics, per-layer metrics with their readers, and
    its traffic generator. Raises KeyError for an unknown cell and
    FileNotFoundError for a missing file."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[x['name'] for x in bench['workloads']]}")
    bdir = os.path.join(root, "bench")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = Config.load(os.path.join(root, cfg_entry["file"]))
    mix = _read_json(os.path.join(bdir, "traffic", w["traffic"] + ".json"))
    cell_file = _read_json(os.path.join(bdir, "workloads", name + ".json"))
    e2e = [m for m in map(_metric, bench["end_to_end"]) if _reports(m, name)]
    moved = {m.name for m in e2e}
    per_layer = []
    for d in bench["per_layer"]:
        m = _metric(d)
        # without a workloads key a metric is read in every cell that
        # reports the end-to-end metric it moves
        if (m.workloads is None and m.moves in moved) or \
                (m.workloads is not None and name in m.workloads):
            m.reader = load_module(
                os.path.join(bdir, "metrics", m.name + ".py"),
                "bench_metric_" + m.name.replace(".", "_").replace("-", "_"))
            per_layer.append(m)
    generator = load_module(
        os.path.join(bdir, "traffic", mix["kind"] + ".py"),
        "bench_traffic_" + mix["kind"])
    return Cell(name=name, config=config, mix=mix,
                chips=int(w["chips"]), limits=dict(cell_file["limits"]),
                check=dict(cell_file.get("check", {})), end_to_end=e2e,
                per_layer=per_layer, generator=generator)


def regions_of(metrics: List[Metric]) -> Dict[str, tuple]:
    """The program regions ({name: (module, function)}) that the cell's
    readers ask the traced run to mark."""
    out = {}
    for m in metrics:
        out.update(getattr(m.reader, "REGIONS", {}))
    return out


def patterns_of(metrics: List[Metric]) -> List[str]:
    """Every kernel-name pattern the cell's readers match."""
    out = []
    for m in metrics:
        out.extend(getattr(m.reader, "PATTERNS", ()))
    return out
