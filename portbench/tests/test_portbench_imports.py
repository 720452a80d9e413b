"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``marlin_tpu_torch`` begins with ``marlin_tpu``),
and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import harness


def _top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(harness.PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_source_imports_jax(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")))
def test_reference_imports_nothing_of_the_program(path):
    assert _top_level_imports(path) <= {"__future__", "math", "numpy",
                                        "torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "marlin_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "marlin_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert harness.forbidden_modules() == ["flax", "marlin_tpu"]


_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests import _tiny
if __name__ == "__main__":
    for name in ("dense_20k.mm", "dense_20k.lu", "tall_10m.lr"):
        out = _tiny.run(_tiny.cell(name))
        assert out["correct"], name
    print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    """A process that runs the cells (as the benchmark does, without the
    test suite's JAX) holds none of the forbidden modules after."""
    r = subprocess.run([sys.executable, "-c", _RUN.format(root=harness.ROOT)],
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
