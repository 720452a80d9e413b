"""Cells of ``BENCHMARK.json`` at sizes a CPU test run holds."""

from __future__ import annotations

import time

from portbench import harness
from portbench.tests import faults

SEED = 2 ** 31 + 11
TINY = {"dense_20k": dict(m=64, k=64, n=64, lu_shift=64, chunk_rows=16),
        "tall_10m": dict(m=2000, d=16, chunk_rows=500)}


def cell(name: str, root: str = harness.ROOT):
    c = harness.resolve(name, root)
    c.cfg.update(TINY.get(c.cfg["name"], {}))
    return c


def run(c, fault=None, trace=False, seconds=0.2, seed=SEED) -> dict:
    """One run of ``c`` on the CPU, the look for a card skipped; ``fault``
    names a function of :mod:`portbench.tests.faults` planted on each
    rank."""
    entry = harness.run_rank if fault is None else faults.planted(fault)
    return harness.run_cell(c, seed, seconds, trace, time.time(),
                            device="cpu", entry=entry)
