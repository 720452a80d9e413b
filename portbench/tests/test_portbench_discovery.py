"""The harness finds configurations, traffic mixes, limits and metrics by
the names in BENCHMARK.json, so a cell is added by files and entries
alone; and BENCHMARK.json keeps to the shape the harness reads."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import harness
from portbench.tests import _tiny

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.resolve(cell)
    assert NAME.match(c.name)
    assert harness.load_op(c.pkg, c.traffic["op"]).Case
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())
    world = 1
    for d in c.traffic["mesh"]:
        world *= d
    assert world == c.chips
    assert {m["name"] for m in c.end_to_end} >= {"gflop_s", "setup_s"}
    assert c.per_layer


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(harness.PKG, "metrics",
                                           m["name"] + ".py"))


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and metric from new files and
    new entries: no file the benchmark has is edited."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "portbench"
    (pkg / "configs" / "tiny_rect.json").write_text(json.dumps(
        {"name": "tiny_rect", "m": 48, "k": 32, "n": 80, "chunk_rows": 16,
         "reduced": []}))
    (pkg / "traffic" / "mm_bcast.json").write_text(json.dumps(
        {"op": "multiply", "strategy": "broadcast", "mesh": [1, 1]}))
    (pkg / "limits" / "tiny_rect.mm_bcast.json").write_text(
        json.dumps({"c_gap": 1e-5}))
    (pkg / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return run.calls\n")
    # a metric that reads the profiler's events itself: the harness's call
    # spans in rank 0's trace, and the host time of the program's products
    (pkg / "metrics" / "call_spans.py").write_text(
        "def read(run):\n"
        "    if not run.trace:\n"
        "        return None\n"
        "    host = run.trace[0]['host']\n"
        "    mm = sum(e - s for s, e, n in host if n == 'aten::mm')\n"
        "    assert 0 < mm <= run.trace[0]['window_s']\n"
        "    return sum(1 for _, _, n in host if n == 'portbench.call')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny_rect", "source": "a test",
                             "file": "portbench/configs/tiny_rect.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_rect.mm_bcast",
                               "config": "tiny_rect", "traffic": "mm_bcast",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_done", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry (matrix/dense.py)",
                               "moves": "gflop_s",
                               "workloads": ["tiny_rect.mm_bcast"]})
    bench["per_layer"].append({"name": "call_spans", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "entry (matrix/dense.py)",
                               "moves": "gflop_s",
                               "workloads": ["tiny_rect.mm_bcast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve("tiny_rect.mm_bcast", str(tmp_path))
    assert [m["name"] for m in cell.per_layer][-2:] == ["calls_done",
                                                         "call_spans"]
    out = _tiny.run(cell, trace=True)
    assert out["correct"], out["compared"]
    assert out["metrics"]["calls_done"]["value"] == out["attempted"]
    assert out["metrics"]["call_spans"]["value"] == out["attempted"]
    out = _tiny.run(cell)
    assert out["metrics"]["gflop_s"]["value"] > 0
    # the metric stays out of the cells that do not list it
    assert "calls_done" not in {
        m["name"] for m in harness.resolve("dense_20k.mm",
                                           str(tmp_path)).per_layer}
