"""Request-scoped trace propagation: ``trace_id``/``span_id``/``parent_id``.

Counterpart of ``marlin_tpu/obs/trace.py``, copied (the module is stdlib-only).

The EventLog gives the repo one post-mortem stream, but until now its records
were correlated only by hand-carried keys (``rid`` on serving records,
nothing at all on checkpoint/prefetch/retry records). This module adds the
missing join key: a :class:`SpanContext` carried in a :mod:`contextvars`
variable, so *everything* a request (or a checkpoint save, or a streamed op)
causes — across the serving worker thread, prefetch producer threads, retry
loops — lands in the JSONL with the same ``trace_id`` and a parent/child
span edge. ``EventLog.event`` merges :func:`context_fields` into every
record automatically; subsystems only need to *activate* the right context.

Thread handoff is explicit (contextvars do not cross ``threading.Thread``
boundaries): the spawning side calls :func:`capture`, the worker wraps its
loop in ``with use(ctx): ...``. See ``ChunkPrefetcher`` (producer threads)
and ``ServeEngine`` (per-request contexts inside the worker loop) for the
two canonical uses.

Pure stdlib, no locks: contextvars are per-thread/per-context by
construction, and ids come from ``os.urandom``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os

__all__ = ["SpanContext", "new_id", "current", "root", "child_of_current",
           "span", "use", "capture", "context_fields"]


def new_id() -> str:
    """16 hex chars of OS randomness — collision-safe at any realistic
    event volume, and free of the seeded-RNG interference a ``random``-based
    id would risk in tests that pin global seeds."""
    return os.urandom(8).hex()


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


@contextlib.contextmanager
def span(name: str = ""):
    """Open a new span (child of the active one, else a root) for the
    body. Events emitted inside carry its ids."""
    ctx = child_of_current(name)
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


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
