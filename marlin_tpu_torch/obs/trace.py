"""Spans: request-scoped trace ids, and named ranges in a profiler's trace.

Counterpart of ``marlin_tpu/obs/trace.py``. A span is the port's one way to
mark a unit of work; :func:`span` opens one and does two things with it:

- It carries ``trace_id``/``span_id``/``parent_id`` (a :class:`SpanContext`)
  in a :mod:`contextvars` variable, so *everything* a request (or a
  checkpoint save, or a streamed op) causes — across the serving worker
  thread, prefetch producer threads, retry loops — lands in the EventLog's
  JSONL with the same ``trace_id`` and a parent/child span edge.
  ``EventLog.event`` merges :func:`context_fields` into every record
  automatically; subsystems only need to *activate* the right context.
- While a ``torch.profiler`` capture is on in this thread, it also records
  the body as a host range named ``"marlin." + name``
  (``torch.profiler.record_function``). The range is on the profiler's
  clock, the clock of the device's events, so an idle gap of the device
  can be laid against what the host was doing in the program. With no
  capture on, the cost over the ids is one check of the profiler's state.

Inside a ``torch.compile`` trace (:func:`marlin_tpu_torch.lazy.fuse`) a span
is a no-op: a graph can hold neither a context variable nor a profiler
range, and a compiled chain is one dispatch with nothing inside to name.

Thread handoff is explicit (contextvars do not cross ``threading.Thread``
boundaries): the spawning side calls :func:`capture`, the worker wraps its
loop in ``with use(ctx): ...``. See ``ChunkPrefetcher`` (producer threads)
and ``ServeEngine`` (per-request contexts inside the worker loop) for the
two canonical uses. :func:`use` re-activates ids only; it opens no range.

No locks: contextvars are per-thread/per-context by construction, and ids
come from a generator seeded by ``os.urandom`` (:func:`new_id`). The module
imports no torch: a span looks for it in ``sys.modules`` (with no torch
loaded no profiler can be on).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import random
import sys

__all__ = ["SpanContext", "new_id", "current", "root", "child_of_current",
           "span", "use", "capture", "context_fields"]


# the ids' own generator, seeded from the OS (again in a forked child, which
# would otherwise repeat its parent's ids)
_ids = random.Random(os.urandom(16))
os.register_at_fork(after_in_child=lambda: _ids.seed(os.urandom(16)))


def new_id() -> str:
    """16 hex chars from a generator of this module's own, seeded with OS
    randomness — collision-safe at any realistic event volume, free of the
    seeded-RNG interference the global ``random`` would risk in tests that
    pin global seeds, and with no system call: a span opens where a call
    starts, often just after the host waited on the device, where one
    ``getrandom`` took 0.2 ms on an H100's host."""
    return "%016x" % _ids.getrandbits(64)


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """One span's identity. ``trace_id`` is shared by every span in the
    trace; ``span_id`` names this span; ``parent_id`` is the causal edge
    (None for a root). ``name`` is advisory (shows up in nothing but
    repr — the *records* carry their own ``kind``)."""

    trace_id: str
    span_id: str
    parent_id: str | None = None
    name: str = ""

    def child(self, name: str = "") -> "SpanContext":
        return SpanContext(self.trace_id, new_id(), self.span_id, name)


_current: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "marlin_obs_span", default=None)


def current() -> SpanContext | None:
    """The active span context, or None outside any span."""
    return _current.get()


def capture() -> SpanContext | None:
    """Alias of :func:`current` that reads as intent at thread-handoff
    sites: ``ctx = trace.capture()`` on the spawning thread, ``with
    trace.use(ctx):`` on the worker."""
    return _current.get()


def root(name: str = "") -> SpanContext:
    """A fresh root span: new trace_id, span_id == trace_id (so a trace's
    root is recognizable without a parent-pointer walk), no parent."""
    tid = new_id()
    return SpanContext(tid, tid, None, name)


def child_of_current(name: str = "") -> SpanContext:
    """A child of the active span, or a fresh root when there is none —
    the standard way a subsystem starts its own unit of work: it joins the
    caller's trace when the caller has one, and becomes a trace of its own
    otherwise (e.g. each served request with no client-side span)."""
    cur = _current.get()
    return cur.child(name) if cur is not None else root(name)


@contextlib.contextmanager
def use(ctx: SpanContext | None):
    """Activate an existing (usually captured) context for the body.
    ``use(None)`` is a no-op — callers can hand through an optional
    context without branching."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


class _Span:
    """The context manager :func:`span` returns: a child context for the
    body, inside ``record`` (a profiler range, or ``None``)."""

    __slots__ = ("_name", "_record", "_token")

    def __init__(self, name: str, record=None):
        self._name = name
        self._record = record

    def __enter__(self) -> SpanContext:
        ctx = child_of_current(self._name)
        self._token = _current.set(ctx)
        if self._record is not None:
            self._record.__enter__()
        return ctx

    def __exit__(self, *exc) -> bool:
        if self._record is not None:
            self._record.__exit__(*exc)
        _current.reset(self._token)
        return False


def span(name: str = ""):
    """Open a new span (child of the active one, else a root) for the
    body. Events emitted inside carry its ids; under a ``torch.profiler``
    capture the body is the host range ``"marlin." + name``. Inside a
    ``torch.compile`` trace it does nothing (and yields ``None``)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return _Span(name)
    if torch.compiler.is_compiling():
        return contextlib.nullcontext()
    if torch._C._autograd._profiler_enabled():
        return _Span(name, torch.profiler.record_function("marlin." + name))
    return _Span(name)


def context_fields() -> dict:
    """The active span as EventLog record fields ({} outside any span).
    ``parent_id`` only appears on non-root spans, keeping root records
    one field lighter and the root recognizable."""
    ctx = _current.get()
    if ctx is None:
        return {}
    fields = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if ctx.parent_id is not None:
        fields["parent_id"] = ctx.parent_id
    return fields
