"""Each operation's FLOPs and bytes a call, against hand arithmetic at the
cells' sizes."""

from __future__ import annotations

import pytest

from portbench import harness


@pytest.mark.parametrize("name, flops, nbytes", [
    # 2 m k n; A, B read and C written once, 4 bytes each
    ("dense_20k.mm", 2 * 20000.0 ** 3, 3 * 20000.0 ** 2 * 4),
    ("dense_20k.mm.4chip", 2 * 20000.0 ** 3, 3 * 20000.0 ** 2 * 4),
    # 2 n^3 / 3; A read, L and U written once
    ("dense_20k.lu", 2 * 20000.0 ** 3 / 3, 3 * 20000.0 ** 2 * 4),
    # two mat-vecs of 10^7 x 513 an iteration, 100 iterations; the matrix
    # read once an iteration
    ("tall_10m.lr", 100 * 4 * 1e7 * 513, 100 * 1e7 * 513 * 4),
])
def test_counts(name, flops, nbytes):
    cell = harness.resolve(name)
    op = harness.load_op(cell.pkg, cell.traffic["op"])
    f, b = op.counts(cell.cfg, cell.traffic)
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == pytest.approx(nbytes, rel=1e-12)


def test_bounds_of_a_call():
    """The least time a call takes on one H100 at its peaks: FLOP-bound
    products, byte-bound lr."""
    peak = harness.load_json(f"{harness.PKG}/peaks.json")[
        "NVIDIA H100 80GB HBM3"]
    mm = harness.load_op(harness.PKG, "multiply").counts(
        harness.resolve("dense_20k.mm").cfg, {})
    assert mm[0] / peak["flop_s"] == pytest.approx(16.18e-3, rel=1e-3)
    assert mm[0] / peak["flop_s"] > mm[1] / peak["byte_s"]
    cell = harness.resolve("tall_10m.lr")
    lr = harness.load_op(harness.PKG, "lr").counts(cell.cfg, cell.traffic)
    assert lr[1] / peak["byte_s"] == pytest.approx(0.6125, rel=1e-3)
    assert lr[1] / peak["byte_s"] > lr[0] / peak["flop_s"]
