"""The trace's reduction and the per-layer readers, on made-up events."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from portbench import harness

S = 1_000_000_000  # ns a second


def _reader(name):
    return harness._module(os.path.join(harness.PKG, "metrics", name + ".py"),
                           "portbench_metric_" + name)


def test_summarize_unions_clips_and_names_gaps():
    device = [(-S, S // 2, "before the window, clipped"),
              (S // 4, S, "ampere_sgemm_128x64_nn"),
              (2 * S, 3 * S, "ncclDevKernel_AllReduce"),
              (int(2.5 * S), 3 * S, "getrf_kernel")]
    host = [(0, 4 * S, "portbench.call"), (S, 2 * S, "aten::linalg_lu"),
            (int(3.5 * S), int(3.6 * S), "cudaDeviceSynchronize")]
    t = harness.summarize(device, host, (0, 4 * S))
    assert t["window_s"] == 4.0
    assert t["busy_s"] == pytest.approx(2.0)  # [0, 1] and [2, 3]
    assert t["kernel_s"] == pytest.approx(0.5 + 0.75 + 1.0 + 0.5)
    assert t["ops"][0] == ["ncclDevKernel_AllReduce", pytest.approx(1.0)]
    # the events themselves, clipped, in seconds from the window's start
    assert t["device"][0] == (0.0, 0.5, "before the window, clipped")
    assert t["device"][1] == (0.25, 1.0, "ampere_sgemm_128x64_nn")
    assert t["host"][1] == (1.0, 2.0, "aten::linalg_lu")
    # gaps [1, 2] (inside the LU call) and [3, 4] (middle 3.5: the sync)
    assert dict((n, v) for n, v in t["gaps"]) == {
        "aten::linalg_lu": pytest.approx(1.0),
        "cudaDeviceSynchronize": pytest.approx(1.0)}


def test_events_cross_a_file_packed():
    device = [(0, S, "sgemm"), (S, 2 * S, "getrf"), (2 * S, 3 * S, "sgemm")]
    host = [(0, 3 * S, "portbench.call")]
    t = harness.summarize(device, host, (0, 4 * S))
    packed = json.loads(json.dumps(harness._packed(t)))
    assert packed["names"] == ["sgemm", "getrf", "portbench.call"]
    assert packed["device"][2] == [2.0, 3.0, 0]
    back = harness._unpacked(packed)
    assert back["device"] == t["device"] and back["host"] == t["host"]


def _trace(window_s, busy_s, events):
    """A rank's summary with its device events ``(name, seconds)`` laid end
    to end."""
    dev, at = [], 0.0
    for name, d in events:
        dev.append((at, at + d, name))
        at += d
    return {"window_s": window_s, "busy_s": busy_s,
            "kernel_s": sum(d for _, d in events), "device": dev,
            "host": []}


def _run(**kw):
    base = dict(calls=10, window_s=4.0, setup_s=12.0, flops=16e12,
                bytes=4.8e9, chips=1,
                peak={"flop_s": 989e12, "byte_s": 3.35e12}, trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_end_to_end_readers():
    run = _run()
    assert _reader("gflop_s").read(run) == pytest.approx(10 * 16e12 / 4 / 1e9)
    assert _reader("setup_s").read(run) == 12.0
    assert _reader("gflop_s").read(_run(calls=0)) is None


def test_shares_are_of_the_peak_and_read_nothing_without_it():
    tr = _trace(4.0, 3.8, [("cutlass_80_simt_sgemm_256x128", 3.0),
                           ("getrf_pivot", 0.6), ("trsm_right", 0.3)])
    run = _run(trace=[tr])
    least = 10 * 16e12 / 989e12
    assert _reader("mfu").read(run) == pytest.approx(100 * least / 4.0)
    assert _reader("kernel_roofline").read(run) == pytest.approx(
        100 * least / 3.9)
    assert _reader("idle_share").read(run) == pytest.approx(5.0)
    assert _reader("lu_panel_share").read(run) == pytest.approx(
        100 * 0.9 / 3.9)
    assert _reader("comm_share").read(run) is None  # no NCCL kernel
    for name in ("mfu", "kernel_roofline"):
        assert _reader(name).read(_run(trace=[tr], peak=None)) is None
    for name in ("kernel_roofline", "idle_share", "lu_panel_share"):
        assert _reader(name).read(_run()) is None  # untraced


def test_four_cards_share_the_bound_and_report_the_idlest():
    trs = [_trace(1.0, b, [("sm80_xmma_gemm_f32f32", 0.7),
                           ("ncclDevKernel_SendRecv", 0.06),
                           ("ncclDevKernel_AllReduce_Sum_f32", 0.04),
                           ("elementwise_add", 0.1)])
           for b in (0.9, 0.8, 0.95, 0.9)]
    run = _run(calls=10, window_s=1.0, chips=4, trace=trs)
    assert _reader("mfu").read(run) == pytest.approx(
        100 * 10 * 16e12 / 989e12 / 4 / 1.0)
    assert _reader("idle_share").read(run) == pytest.approx(20.0)
    assert _reader("comm_share").read(run) == pytest.approx(100 / 9)
    # the NCCL kernels count as neither GEMM nor panel work
    assert _reader("lu_panel_share").read(run) == pytest.approx(100 / 9)
