"""On the card, at each cell's own size: sound runs of the program read
within the cell's limits, and the control (the computation one precision
below the configuration's, in the program's place) reads past one of them.
The driver does not collect this file: run it on the card with

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_control.py

(``--noconftest``: the repository's root conftest imports JAX, which the
machine with the cards need not have).
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dense_20k.mm", "tall_10m.lr",
                                  "dense_20k.mm.4chip", "dense_20k.lu"])
def test_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    c = harness.resolve(cell)
    if torch.cuda.device_count() < c.chips:
        pytest.skip(f"needs {c.chips} cards")
    r = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", cell,
         "--seeds", *map(str, SEEDS), "--control-seeds", *map(str, SEEDS)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=3000)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(x) for x in (r.stdout + r.stderr).splitlines()
             if x.startswith("{")]
    assert len(lines) == 2 * len(SEEDS)
    for line in lines:
        over = [n for n, lim in c.limits.items() if line[n] > lim]
        if line["side"] == "program":
            assert not over, line
        else:
            assert over, line
