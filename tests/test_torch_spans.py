"""The port's spans (``obs.trace.span``) in ``torch.profiler`` traces, on the
CPU at tiny sizes: the entry spans of ``multiply``, ``lu_decompose`` and
``lr``, the blocked LU's block steps and their children, what a span costs
and records with the profiler off, ``annotate`` as the same mechanism, and
``lazy.fuse`` still one trace with spans in the fused methods. The
multiply's collective spans over four ranks are in
``tests/test_torch_dist_matrix.py``."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import marlin_tpu_torch as tm
from marlin_tpu_torch.obs import trace
from marlin_tpu_torch.utils import EventLog, annotate


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


def _spans(fn):
    """``(start, end, name)`` of every ``marlin.*`` range ``fn`` records
    under a CPU profiler, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("marlin."))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("schedule, pivot", [("shrinking", "block"),
                                             ("masked", "block"),
                                             ("masked", "panel")])
def test_lu_block_steps(schedule, pivot):
    """64 x 64 in blocks of 16: one ``marlin.lu_decompose`` holding the
    padding, four block steps and the unpacking, in that order; each step
    holds one pivot, stripe and update span, in that order."""
    a = tm.DenseVecMatrix.random(0, 64, 64)
    ev = _spans(lambda: a.lu_decompose(mode="dist", block_size=16,
                                       schedule=schedule, pivot=pivot))
    top = [e for e in ev if e[2] == "marlin.lu_decompose"]
    assert len(top) == 1
    assert all(_inside(e, top[0]) for e in ev)
    steps = [e for e in ev if e[2] == "marlin.lu.step"]
    assert len(steps) == 4
    outer = [e[2] for e in ev if e[2] in ("marlin.lu.pad", "marlin.lu.step",
                                          "marlin.lu.unpack")]
    assert outer == ["marlin.lu.pad"] + ["marlin.lu.step"] * 4 + \
        ["marlin.lu.unpack"]
    for step in steps:
        kids = [e[2] for e in ev if e is not step and _inside(e, step)]
        assert kids == ["marlin.lu.pivot", "marlin.lu.stripe",
                        "marlin.lu.update"]


def test_multiply_one_span_in_a_world_of_one():
    a = tm.DenseVecMatrix.random(0, 12, 8)
    b = tm.DenseVecMatrix.random(1, 8, 6)
    ev = _spans(lambda: a.multiply(b))
    assert [e[2] for e in ev] == ["marlin.multiply"]


def test_lr_prepare_iterate_read():
    """One ``marlin.lr`` holding the preparation (the intercept's copy and
    the step sizes' upload), the whole loop as one span, then the host's
    read of the weights, in that order."""
    x = np.random.default_rng(0).standard_normal((40, 5)).astype(np.float32)
    x[:, 0] = x[:, 0] > 0
    mat = tm.DenseVecMatrix.from_array(x)
    ev = _spans(lambda: mat.lr(1.0, 7))
    assert ev[0][2] == "marlin.lr"
    assert all(_inside(e, ev[0]) for e in ev)
    names = [e[2] for e in ev[1:]]
    assert [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n] \
        == ["marlin.lr.prepare", "marlin.lr.iterate", "marlin.lr.read"]
    assert names.count("marlin.lr.iterate") == 1


def test_profiler_off_records_nothing_and_ids_propagate(tmp_path,
                                                        monkeypatch):
    """With no profiler on a span opens no profiler range; on or off, an
    event logged inside nested spans carries the inner span's ids, its
    parent the outer span."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    log = EventLog(str(tmp_path / "events.jsonl"))
    try:
        for on in (False, True):
            with profile(activities=[ProfilerActivity.CPU]) if on \
                    else contextlib.nullcontext():
                with trace.span("outer") as outer:
                    with trace.span("inner") as inner:
                        log.event("step", on=on)
            assert inner.parent_id == outer.span_id
            assert inner.trace_id == outer.trace_id
            rec = log.read()[-1]
            assert (rec["trace_id"], rec["span_id"], rec["parent_id"]) == (
                outer.trace_id, inner.span_id, outer.span_id)
            assert opened == (["marlin.outer", "marlin.inner"] if on else [])
    finally:
        log.close()
    assert trace.current() is None


def test_annotate_is_span():
    assert annotate is trace.span

    def region():
        with annotate("region"):
            torch.ones(3).sum()

    assert [e[2] for e in _spans(region)] == ["marlin.region"]


def test_fuse_single_trace_with_spans():
    """A fused chain through ``multiply`` (which opens a span) is one
    dynamo compile, with the profiler off and then on, and its compiled
    calls record no span: the graph is one dispatch."""
    from torch._dynamo.testing import CompileCounter

    a = tm.DenseVecMatrix.random(0, 12, 8)
    b = tm.DenseVecMatrix.random(1, 8, 6)
    c = tm.DenseVecMatrix.random(2, 12, 6)
    cnt = CompileCounter()

    @tm.fuse(backend=cnt)
    def chain(a, b, c):
        return a.multiply(b).add(c)

    r1 = chain(a, b, c)
    ev = _spans(lambda: chain(a, b, c))
    assert cnt.frame_count == 1
    assert ev == []
    np.testing.assert_allclose(
        r1.to_numpy(), a.to_numpy() @ b.to_numpy() + c.to_numpy(),
        rtol=1e-5, atol=1e-5)
