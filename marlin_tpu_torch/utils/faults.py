"""Deterministic fault injection for chaos-testing the recovery paths.

Counterpart of ``marlin_tpu/utils/faults.py``, copied (the module is
stdlib-only). The registry here is the port's own: a fault injected through
``marlin_tpu_torch.utils.faults`` fires only at the port's fault points, and
the JAX package's registry never sees it. The points the port fires:

==================  =========================================================
point               fires from
==================  =========================================================
``ckpt.write``      :func:`~marlin_tpu_torch.io.checkpoint.save_checkpoint`
                    entry and each payload-file write (ctx carries ``path``);
                    :meth:`~marlin_tpu_torch.io.orbax_ckpt.OrbaxCheckpointer.save`
``ckpt.manifest``   just before an integrity/shard manifest write
``fs.open``         :func:`~marlin_tpu_torch.io.fs.open_path` (every open;
                    write handles also pass through :func:`wrap_file`)
``fs.list``         :func:`~marlin_tpu_torch.io.fs.list_names`
``step.run``        :class:`~marlin_tpu_torch.utils.failure.ResilientLoop`
                    before each step (raise/delay) and on each metric
                    (mutation)
``device.probe``    each per-device probe in
                    :func:`~marlin_tpu_torch.utils.failure.heartbeat`
``prefetch.produce``
                    :class:`~marlin_tpu_torch.parallel.prefetch.ChunkPrefetcher`
                    before each source-chunk read (ctx carries
                    ``path="chunk-<i>"``)
``dataplane.read``  :meth:`~marlin_tpu_torch.io.chunkstore.ChunkStore.read_rows`
                    before each native window read (ctx carries
                    ``path="<store name>@<row>"`` and ``index=<row>``)
``serve.enqueue``   :meth:`~marlin_tpu_torch.serving.engine.ServeEngine.submit`
                    entry (ctx carries ``path=<rid>``) — a raise here
                    surfaces to the submitting caller
``serve.prefill``   the paged scheduler, just before each bounded prefill
                    CHUNK (ctx carries ``path="bucket-<P>x<steps>"``) — a
                    raise fails only the rows prefilling in that chunk;
                    already-decoded rows and queued requests keep serving
``serve.decode_step``
                    the paged scheduler, just before each single-token
                    decode step over a bucket's rows (ctx carries
                    ``path="bucket-<P>x<steps>"``) — a raise fails (or
                    retries) only that step's live rows and leaves the
                    page pool consistent; queued requests keep serving
``serve.program_step``
                    the program-row lane, just before each one-shot program
                    batch (ctx carries ``path="<program>-<rows>"``)
``serve.worker_crash``
                    the serving worker loop, once per iteration OUTSIDE the
                    per-chunk/per-step failure envelopes (ctx carries
                    ``path=<worker thread name>``) — a raise kills the whole
                    worker thread; an engine with no crash hook attached
                    fails every held request with an ``error`` Result
==================  =========================================================

Behaviors are :class:`Fault` subclasses — :class:`RaiseFault` (raise once /
N times / forever), :class:`DelayFault` (latency), :class:`TornWriteFault`
(a write handle that stops persisting after N bytes, simulating a crash
mid-write), :class:`MutateFault` (e.g. NaN into a step's metric) — optionally
gated by a seeded :class:`Schedule` so probabilistic chaos runs are exactly
reproducible.

Faults auto-deregister once their budget is consumed; tests should still use
:func:`injected` (a context manager) or :func:`clear` so nothing leaks across
tests.

Everything here is stdlib-only.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, Iterator

__all__ = [
    "KNOWN_POINTS", "FaultInjected", "Schedule", "Fault", "RaiseFault",
    "DelayFault", "TornWriteFault", "MutateFault", "inject", "clear",
    "active", "injected", "fire", "wrap_file", "mutate",
]

KNOWN_POINTS = frozenset({
    "ckpt.write", "ckpt.manifest", "fs.open", "fs.list", "step.run",
    "device.probe", "prefetch.produce", "dataplane.read", "serve.enqueue",
    "serve.step", "serve.prefill", "serve.decode_step", "serve.worker_crash",
    "serve.router_route", "serve.migrate", "serve.fleet",
    "serve.program_step",
})


class FaultInjected(RuntimeError):
    """Default exception raised by injected faults."""


class Schedule:
    """Seeded, reproducible firing schedule.

    Decides, per *arrival* at the fault point, whether the fault triggers:

    - ``Schedule(fire_on=[0, 2])`` — fire on the 1st and 3rd arrivals only.
    - ``Schedule(seed=7, rate=0.3)`` — fire each arrival with probability 0.3,
      drawn from ``random.Random(7)`` so two schedules with the same seed
      produce the identical firing pattern.
    """

    def __init__(self, fire_on=None, seed: int | None = None,
                 rate: float | None = None):
        if fire_on is None and rate is None:
            raise ValueError("Schedule needs fire_on=... or seed=/rate=...")
        self.fire_on = None if fire_on is None else frozenset(fire_on)
        self.rate = rate
        self._rng = random.Random(seed)
        self.arrivals = 0

    def should_fire(self) -> bool:
        i = self.arrivals
        self.arrivals += 1
        if self.fire_on is not None:
            return i in self.fire_on
        return self._rng.random() < self.rate


class Fault:
    """One injected behavior at one point.

    ``times`` bounds how often it triggers (-1 = unbounded); ``match`` gates
    on a substring of the context's ``path`` (file path, device string, …);
    ``schedule`` gates on a :class:`Schedule`. A fault whose budget is spent
    auto-deregisters, so a consumed fault never leaks into the next test.
    """

    #: which dispatch consumes this fault: "fire" (raise/delay at the point),
    #: "wrap" (wrap a writable file handle), "mutate" (transform a value).
    kind = "fire"

    def __init__(self, times: int = 1, match: str | None = None,
                 schedule: Schedule | None = None):
        self.times = times
        self.match = match
        self.schedule = schedule
        self.fired = 0

    def exhausted(self) -> bool:
        return self.times >= 0 and self.fired >= self.times

    def applies(self, ctx: dict) -> bool:
        if self.exhausted():
            return False
        if self.match is not None and self.match not in str(ctx.get("path", "")):
            return False
        if self.schedule is not None and not self.schedule.should_fire():
            return False
        return True

    # behavior hooks — exactly one is meaningful per `kind`
    def on_fire(self, point: str, ctx: dict) -> None:
        pass

    def wrap(self, f, ctx: dict):
        return f

    def mutate_value(self, value):
        return value

    def __repr__(self):
        return (f"{type(self).__name__}(times={self.times}, fired={self.fired}"
                + (f", match={self.match!r}" if self.match else "") + ")")


class RaiseFault(Fault):
    """Raise an exception at the point. ``exc`` may be an exception class, a
    zero-arg factory, or an instance (re-raised each time)."""

    def __init__(self, exc: Any = FaultInjected, **kw):
        super().__init__(**kw)
        self.exc = exc

    def on_fire(self, point, ctx):
        e = self.exc
        if isinstance(e, type) and issubclass(e, BaseException):
            e = e(f"injected fault at {point} (ctx={ctx})")
        elif callable(e) and not isinstance(e, BaseException):
            e = e()
        raise e


class DelayFault(Fault):
    """Sleep ``seconds`` at the point — a slow device / laggy filesystem."""

    def __init__(self, seconds: float, sleep: Callable[[float], None] = time.sleep,
                 **kw):
        super().__init__(**kw)
        self.seconds = seconds
        self._sleep = sleep

    def on_fire(self, point, ctx):
        self._sleep(self.seconds)


class _TornFile:
    """A write handle that stops persisting after ``keep`` bytes. The bytes
    that did land are flushed (a real crash leaves its durable prefix behind);
    with ``then_raise`` the crossing write raises, simulating the process
    dying mid-write rather than silently truncating."""

    def __init__(self, f, keep: int, then_raise: bool):
        self._f = f
        self._left = keep
        self._then_raise = then_raise

    def write(self, data):
        n = len(data)
        if n <= self._left:
            self._left -= n
            return self._f.write(data)
        kept = data[: self._left]
        self._left = 0
        if kept:
            self._f.write(kept)
        try:
            self._f.flush()
        except Exception:
            pass
        if self._then_raise:
            raise FaultInjected(
                f"torn write: stream truncated {n - len(kept)} bytes short")
        return n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self._f.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self._f, name)


class TornWriteFault(Fault):
    """Truncate a written file to ``keep_bytes`` — the canonical torn-write /
    kill-mid-save failure. Applied to write handles via :func:`wrap_file`."""

    kind = "wrap"

    def __init__(self, keep_bytes: int, then_raise: bool = True, **kw):
        super().__init__(**kw)
        self.keep_bytes = keep_bytes
        self.then_raise = then_raise

    def wrap(self, f, ctx):
        return _TornFile(f, self.keep_bytes, self.then_raise)


class MutateFault(Fault):
    """Replace a value flowing past the point — e.g. NaN into a step metric.
    ``value`` may be a constant or a one-arg callable of the original."""

    kind = "mutate"

    def __init__(self, value: Any = float("nan"), **kw):
        super().__init__(**kw)
        self.value = value

    def mutate_value(self, old):
        return self.value(old) if callable(self.value) else self.value


_LOCK = threading.Lock()
_REGISTRY: dict[str, list[Fault]] = {}


def inject(point: str, fault: Fault) -> Fault:
    """Register ``fault`` at ``point``; returns the fault (for assertions on
    ``.fired``). Unknown point names are rejected — a typo'd point would
    silently never fire."""
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r} (known: "
                         f"{sorted(KNOWN_POINTS)})")
    with _LOCK:
        _REGISTRY.setdefault(point, []).append(fault)
    return fault


def clear(point: str | None = None) -> None:
    """Drop every registered fault (or just ``point``'s)."""
    with _LOCK:
        if point is None:
            _REGISTRY.clear()
        else:
            _REGISTRY.pop(point, None)


def active() -> dict[str, list[Fault]]:
    """Registered, not-yet-exhausted faults by point (exhausted faults
    auto-deregister at consumption, so anything here is still pending)."""
    with _LOCK:
        out = {p: [f for f in fl if not f.exhausted()]
               for p, fl in _REGISTRY.items()}
    return {p: fl for p, fl in out.items() if fl}


@contextlib.contextmanager
def injected(point: str, fault: Fault) -> Iterator[Fault]:
    """Scoped injection: registers on entry, removes on exit regardless of
    how many times it fired — the leak-proof way to inject in tests."""
    inject(point, fault)
    try:
        yield fault
    finally:
        with _LOCK:
            fl = _REGISTRY.get(point)
            if fl is not None and fault in fl:
                fl.remove(fault)
            if not fl:
                _REGISTRY.pop(point, None)


def _consume(point: str, kind: str, ctx: dict) -> list[Fault]:
    """The faults at ``point`` of ``kind`` that trigger for this arrival;
    bookkeeping (fired counts, auto-deregistration) happens here under the
    lock, the behavior itself runs outside it (it may sleep or raise)."""
    with _LOCK:
        fl = _REGISTRY.get(point)
        if not fl:
            return []
        hits = []
        for f in list(fl):
            if f.kind != kind or not f.applies(ctx):
                continue
            f.fired += 1
            hits.append(f)
            if f.exhausted():
                fl.remove(f)
        if not fl:
            _REGISTRY.pop(point, None)
    return hits


def fire(point: str, **ctx) -> None:
    """Trigger raise/delay faults at ``point``. No-ops in nanoseconds when
    nothing is registered — safe on hot IO paths."""
    if not _REGISTRY:
        return
    for f in _consume(point, "fire", ctx):
        f.on_fire(point, ctx)


def wrap_file(point: str, fobj, **ctx):
    """Pass a writable handle through any torn-write faults at ``point``."""
    if not _REGISTRY:
        return fobj
    for f in _consume(point, "wrap", ctx):
        fobj = f.wrap(fobj, ctx)
    return fobj


def mutate(point: str, value, **ctx):
    """Pass a value through any mutation faults at ``point``."""
    if not _REGISTRY:
        return value
    for f in _consume(point, "mutate", ctx):
        value = f.mutate_value(value)
    return value
