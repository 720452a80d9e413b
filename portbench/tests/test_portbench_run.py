"""A run end to end on the CPU at small sizes: the look for a card, a sound
run, and the faults the check has to catch."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.ranks_world import WorldFailed
from portbench.tests import _tiny, faults


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_run_fails_without_a_card():
    r = _cli(harness.ROOT, "--workload", "dense_20k.mm", "--seed",
             str(2 ** 31 + 3), "--seconds", "1", "--trace", "0")
    assert r.returncode == 2
    assert r.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in r.stderr


def test_run_fails_in_a_bare_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(tmp_path, "--workload", "dense_20k.mm", "--seed", "7",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("name, prep", [
    ("dense_20k.mm", None),
    ("dense_20k.lu", faults.blocked_lu),
    ("tall_10m.lr", None),
])
def test_sound_run_is_correct(name, prep, monkeypatch):
    if prep is not None:
        prep(monkeypatch.setattr)
    out = _tiny.run(_tiny.cell(name))
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {"gflop_s", "setup_s"}
    assert out["device"]["count"] == 1
    json.dumps(out)


def test_traced_run_reads_the_trace():
    out = _tiny.run(_tiny.cell("dense_20k.mm"), trace=True)
    assert out["correct"]
    # a CPU run has no peak to share and no device operations
    assert set(out["metrics"]) == {"idle_share"}
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name, fault", [
    ("dense_20k.mm", faults.mm_half_rows),
    ("dense_20k.mm", faults.mm_altered),
    ("tall_10m.lr", faults.lr_skip_step),
    ("tall_10m.lr", faults.lr_half_batch),
    ("tall_10m.lr", faults.lr_altered),
    ("dense_20k.lu", faults.lu_skip_step),
    ("dense_20k.lu", faults.lu_altered),
])
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch.setattr)
    out = _tiny.run(_tiny.cell(name))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


@pytest.mark.parametrize("fault, correct", [
    (None, True),
    ("exchange_dropped", False),
])
def test_four_ranks(fault, correct):
    """The four-card cell's world, over gloo on the CPU."""
    out = _tiny.run(_tiny.cell("dense_20k.mm.4chip"), fault=fault)
    assert out["correct"] is correct
    assert out["device"]["count"] == 4
    assert out["attempted"] >= 1


def test_a_failed_rank_is_named_with_its_log(capsys):
    with pytest.raises(WorldFailed) as e:
        _tiny.run(_tiny.cell("dense_20k.mm.4chip"),
                  fault="rank2_raises")
    assert e.value.ranks == [2] and not e.value.timed_out
    err = capsys.readouterr().err
    assert "--- rank 2 FAILED ---" in err
    assert "planted failure on rank 2" in err


def test_a_rank_past_the_deadline_is_killed(monkeypatch, capsys):
    monkeypatch.setattr(harness, "DEADLINE_S", 30.0)
    with pytest.raises(WorldFailed) as e:
        _tiny.run(_tiny.cell("dense_20k.mm.4chip"),
                  fault="rank1_hangs")
    assert e.value.timed_out and 1 in e.value.ranks
    assert "--- rank 1 FAILED ---" in capsys.readouterr().err
