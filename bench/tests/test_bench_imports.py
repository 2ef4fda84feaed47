"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names, and the reference imports nothing of
the port."""
import ast
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness.runner import FORBIDDEN, forbidden_modules

SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(BENCH)
           for f in fs if f.endswith(".py")
           and os.sep + "tests" not in d]


def tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(tops(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(tops(path))
    assert set(tops(path)) <= {"__future__", "contextlib", "dataclasses",
                               "importlib", "typing", "torch", "reference"}


def test_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "jaxtyping",
                 "reproducible", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert forbidden_modules() == ["jaxlib", "repro"]


def test_a_run_loads_neither(tmp_path):
    """A smoke run in a fresh process ends with neither JAX nor the JAX
    package in sys.modules."""
    code = f"""
import sys, tempfile
sys.path[:0] = [{os.path.join(BENCH, 'tests')!r}, {BENCH!r},
                {os.path.join(ROOT, 'src')!r}]
from conftest import tiny_bench, write_root
from harness.runner import forbidden_modules, run_cell
root = write_root({str(tmp_path)!r}, *tiny_bench())
res, _ = run_cell(root, "tiny-batch", 3, 0.3, 0, device="cpu")
assert "repro_torch" in sys.modules
print("FORBIDDEN", forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FORBIDDEN []" in r.stdout
