"""The readers of the program's spans (``program_idle_share``,
``rmm_idle_share``, ``lu_loop_idle_share``, ``host_waits_per_call``) on
made-up ranks, and on the trace of a tiny traced run."""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests import _tiny


def _reader(name):
    return harness._module(os.path.join(harness.PKG, "metrics", name + ".py"),
                           "portbench_metric_" + name)


def _rank(device, host, window_s=10.0):
    """A rank's summary from its events, seconds from the window's
    start."""
    return {"window_s": window_s, "busy_s": 0.0, "kernel_s": 0.0,
            "device": [(s, e, "kernel") for s, e in device], "host": host}


def _run(*ranks):
    return SimpleNamespace(calls=1, window_s=ranks[0]["window_s"],
                           setup_s=1.0, flops=1.0, bytes=1.0,
                           chips=len(ranks), peak=None, trace=list(ranks))


# device busy over [0, 2], [3, 6] and [6.5, 10]: gaps [2, 3] (middle 2.5)
# and [6, 6.5] (middle 6.25)
DEVICE = [(0.0, 2.0), (3.0, 6.0), (6.5, 10.0)]


def test_a_gap_counts_by_its_middle():
    read = _reader("program_idle_share").read
    inside = _rank(DEVICE, [(2.4, 2.6, "marlin.multiply")])
    assert read(_run(inside)) == pytest.approx(100 * 1.0 / 10)
    # the span covers most of the gap [2, 3] but ends just before its
    # middle, and holds no other gap
    short = _rank(DEVICE, [(1.0, 2.499, "marlin.multiply")])
    assert read(_run(short)) == 0.0
    both = _rank(DEVICE, [(2.0, 7.0, "marlin.lu_decompose")])
    assert read(_run(both)) == pytest.approx(100 * 1.5 / 10)


def test_nested_and_overlapping_spans_count_a_gap_once():
    host = [(1.0, 7.0, "marlin.rmm.fetch"),
            (2.0, 3.0, "marlin.remap.plan"),
            (2.2, 2.8, "marlin.rmm.product"),   # nested in fetch
            (5.0, 8.0, "marlin.rmm.place"),     # overlaps fetch
            (0.0, 10.0, "portbench.call")]
    assert _reader("rmm_idle_share").read(_run(_rank(DEVICE, host))) == \
        pytest.approx(100 * 1.5 / 10)
    # remap's spans count only inside an RMM step
    alone = [(2.0, 3.0, "marlin.remap.plan")]
    assert _reader("rmm_idle_share").read(_run(_rank(DEVICE, alone))) is None


def test_the_idlest_of_four_ranks():
    ranks = [_rank(DEVICE, [(0.0, 10.0, "marlin.multiply")]),
             _rank([(0.0, 9.0)], [(0.0, 10.0, "marlin.multiply")]),
             _rank([(0.0, 10.0)], [(0.0, 10.0, "marlin.multiply")]),
             _rank(DEVICE, [(2.4, 2.6, "marlin.multiply")])]
    assert _reader("program_idle_share").read(_run(*ranks)) == \
        pytest.approx(100 * 1.5 / 10)
    # the LU's reader takes rank 0 alone
    ranks = [_rank([(0.0, 10.0)], [(0.0, 10.0, "marlin.lu.step")]),
             _rank(DEVICE, [(0.0, 10.0, "marlin.lu.step")])]
    assert _reader("lu_loop_idle_share").read(_run(*ranks)) == 0.0


def test_waits_count_inside_whole_calls():
    host = [(1.0, 4.0, "marlin.multiply"), (5.0, 9.0, "marlin.multiply"),
            (9.5, 10.0, "marlin.multiply"),   # cut by the window's end
            (1.5, 1.6, "cudaStreamSynchronize"),
            (6.0, 6.1, "cudaDeviceSynchronize"),
            (6.2, 6.3, "cudaEventSynchronize"),
            (6.4, 6.5, "cudaLaunchKernel"),
            (4.5, 4.6, "cudaDeviceSynchronize"),   # between calls
            (3.95, 4.25, "cudaStreamSynchronize"),  # middle after the call
            (9.6, 9.7, "cudaStreamSynchronize")]    # in the cut call
    read = _reader("host_waits_per_call").read
    assert read(_run(_rank(DEVICE, host))) == pytest.approx(3 / 2)
    # the largest over the ranks
    quiet = _rank(DEVICE, [(1.0, 4.0, "marlin.lr")])
    assert read(_run(quiet, _rank(DEVICE, host))) == pytest.approx(3 / 2)
    assert read(_run(quiet)) == 0.0


@pytest.mark.parametrize("name", ["program_idle_share", "rmm_idle_share",
                                  "lu_loop_idle_share",
                                  "host_waits_per_call"])
def test_no_span_reads_nothing(name):
    host = [(0.0, 10.0, "portbench.call"),
            (1.0, 1.1, "cudaDeviceSynchronize")]
    assert _reader(name).read(_run(_rank(DEVICE, host))) is None
    assert _reader(name).read(SimpleNamespace(trace=None)) is None


def test_a_traced_run_reports_them():
    """A tiny traced run on the CPU: the program's entry spans reach the
    harness's trace and both entry readers report. A CPU run has no device
    events, so its window is one gap, inside a call or not, and it waits
    on no device."""
    out = _tiny.run(_tiny.cell("dense_20k.mm"), trace=True)
    assert out["correct"]
    got = out["metrics"]
    assert got["program_idle_share"]["value"] in (0.0, 100.0)
    assert got["host_waits_per_call"]["value"] == 0.0
