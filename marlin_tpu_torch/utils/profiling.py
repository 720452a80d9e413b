"""Timing and profiling hooks.

Counterpart of ``marlin_tpu/utils/profiling.py``. PyTorch returns from a
CUDA call before the card has finished it, so a host clock around device
work measures only the enqueue unless the work is forced first:

- :func:`evaluate` — that barrier (the analog of ``MTUtils.evaluate``,
  utils/MTUtils.scala:218-220);
- :func:`timer` — wall-clock context manager that prints millis like the
  reference's examples do, and lands a ``kind="timer"`` record in the
  default EventLog when one is installed;
- :class:`StepTimer` — per-iteration timing for training loops; ``stop``
  waits for the card when given the step's tensors;
- :class:`StageTimes` — per-stage wall-clock aggregation across threads,
  each sample also counted in the metrics registry;
- :func:`trace` — a ``torch.profiler`` capture of the body (CPU, and CUDA
  where there is a card) written as a Chrome trace under ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

import torch


def _tensors(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def evaluate(*xs):
    """Wait until the given tensors (or matrices, vectors, or containers of
    them) are computed; returns them. ``torch.cuda.synchronize`` on each CUDA
    device they live on; CPU tensors are already done."""
    devices = {t.device for x in xs for t in _tensors(x) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return xs[0] if len(xs) == 1 else xs


@contextlib.contextmanager
def timer(label: str = "", results: list | None = None, quiet: bool = False):
    """Wall-clock the body and print millis like the reference's examples do
    (e.g. examples/BLAS3.scala:34-56). Call :func:`evaluate` on the body's
    results inside it, or the time is the enqueue's."""
    t0 = time.perf_counter()
    yield
    dt_ms = (time.perf_counter() - t0) * 1000.0
    if results is not None:
        results.append(dt_ms)
    from .tracing import get_default_event_log

    log = get_default_event_log()
    if log is not None:
        log.event("timer", label=label or "elapsed",
                  seconds=round(dt_ms / 1e3, 6))
    if not quiet:
        print(f"{label or 'elapsed'}: {dt_ms:.1f} ms")


class StepTimer:
    """Records per-step wall-clock; use around the body of an iterative loop.
    ``stop(sync)`` first waits for the tensors of ``sync`` (:func:`evaluate`),
    so a step on the card is timed to its end, not to its enqueue."""

    def __init__(self):
        self.times_ms: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None):
        if sync is not None:
            evaluate(sync)
        self.times_ms.append((time.perf_counter() - self._t0) * 1000.0)

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / max(1, len(self.times_ms))

    def summary(self) -> str:
        if not self.times_ms:
            return "no steps recorded"
        return (
            f"{len(self.times_ms)} steps, mean {self.mean_ms:.1f} ms, "
            f"min {min(self.times_ms):.1f} ms, max {max(self.times_ms):.1f} ms"
        )


_stage_families = None  # lazy (registry import stays off the module path)


def _stage_metrics():
    global _stage_families
    if _stage_families is None:
        from ..obs.metrics import get_registry

        reg = get_registry()
        _stage_families = (
            reg.counter("marlin_stage_seconds_total",
                        "Wall-clock accumulated per pipeline stage "
                        "(StageTimes: produce/transfer/stall/compute/drain)",
                        labelnames=("stage",)),
            reg.counter("marlin_stage_events_total",
                        "StageTimes samples per pipeline stage",
                        labelnames=("stage",)),
        )
    return _stage_families


class StageTimes:
    """Aggregate wall-clock by named stage across threads.

    A pipeline records its stages (the JAX package's streaming prefetch
    uses ``produce``, ``transfer``, ``stall``, ``compute`` and ``drain``)
    from producer threads and the consumer at once, hence the lock. Every
    sample also lands in the process metrics registry
    (``marlin_stage_seconds_total{stage=...}``), so stage budgets are
    scrapeable, not just printable."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.seconds[stage] = self.seconds.get(stage, 0.0) + seconds
            self.counts[stage] = self.counts.get(stage, 0) + 1
        secs, events = _stage_metrics()
        secs.labels(stage=stage).inc(seconds)
        events.labels(stage=stage).inc()

    @contextlib.contextmanager
    def timed(self, stage: str):
        t0 = time.perf_counter()
        yield
        self.add(stage, time.perf_counter() - t0)

    def summary(self) -> str:
        with self._lock:
            if not self.seconds:
                return "no stages recorded"
            return ", ".join(
                f"{k} {self.seconds[k]:.3f}s/{self.counts[k]}"
                for k in sorted(self.seconds))

    def emit(self, kind: str = "stage_times", log=None, **fields) -> None:
        """Write one summary event to ``log`` (or the process-default
        EventLog); silently no-ops when neither exists."""
        from .tracing import get_default_event_log

        log = log or get_default_event_log()
        if log is None:
            return
        with self._lock:
            secs = {f"{k}_s": round(v, 6) for k, v in self.seconds.items()}
            counts = dict(self.counts)
        log.event(kind, **secs, counts=counts, **fields)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the body with ``torch.profiler`` (CPU activity, plus CUDA
    where there is a card) and write it as a Chrome trace,
    ``<logdir>/trace-<pid>-<n>.json`` (``logdir`` defaults to
    ``<tempdir>/marlin_tpu_torch_trace``); yields ``logdir``.

    This is the wrap-your-own-code spelling. For a running process the
    same capture is :func:`marlin_tpu_torch.obs.perf.capture_profile`
    (single-flight, size-capped capture dir, ``kind="profile"`` EventLog
    record)."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "marlin_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    n = len([f for f in os.listdir(logdir) if f.startswith("trace-")])
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace-{os.getpid()}-{n}.json"))
