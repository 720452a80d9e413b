"""Structured tracing/observability beyond wall-clock prints.

Counterpart of ``marlin_tpu/utils/tracing.py``. This module holds:

- :func:`annotate` — the reference's name for
  :func:`marlin_tpu_torch.obs.trace.span`, the port's one span mechanism:
  a region under a ``torch.profiler`` capture shows up in its trace as the
  range ``"marlin." + name``.
- :class:`EventLog` — append-only JSON-lines event log (step timings, bytes
  moved, custom counters) for post-hoc analysis without a profiler UI. Every
  record automatically carries the active span context
  (:mod:`marlin_tpu_torch.obs.trace` — ``trace_id``/``span_id``/``parent_id``), so
  records across threads and subsystems join into traces; the analyzer
  (``python -m marlin_tpu_torch.obs.report``) reconstructs them.
- :func:`matmul_flops` / :func:`effective_gflops` — the FLOP bookkeeping the
  examples print, centralized.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Any

from ..config import get_config as _get_config
from ..obs.trace import context_fields as _span_fields
from ..obs.trace import span as annotate

__all__ = ["annotate", "EventLog", "matmul_flops", "effective_gflops",
           "set_default_event_log", "get_default_event_log"]


def matmul_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def effective_gflops(flops: float, seconds: float) -> float:
    return flops / max(seconds, 1e-12) / 1e9


class EventLog:
    """JSON-lines event log: ``log.event("step", step=i, loss=x)``. Each line
    carries a monotonic timestamp plus the active span context; flushes per
    event so crashes keep history (this doubles as the post-mortem record
    for the failure subsystem).

    ``max_bytes`` bounds the file via rotation: a write that would cross the
    bound first shifts ``path`` → ``path.1`` → ``path.2`` (``backups``
    generations kept, oldest dropped) — per-event flush with unbounded
    growth is not serve-loop safe for long-running engines. ``None`` defers
    to ``config.obs_log_max_bytes`` *at write time* (so ``config_context``
    scoping works); 0 disables rotation."""

    def __init__(self, path: str, max_bytes: int | None = None,
                 backups: int = 2):
        self.path = path
        self.max_bytes = max_bytes
        self.backups = int(backups)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        # append mode: tell() is not the size on every platform until the
        # first write — ask the filesystem
        self._size = os.path.getsize(path)
        self.last_read_skipped = 0
        # writers are concurrent (serving workers, prefetch producers, the
        # submitting thread): a shared handle without a lock interleaves
        # partial lines, corrupting the JSONL stream
        self._lock = threading.Lock()

    def _limit(self) -> int:
        if self.max_bytes is not None:
            return self.max_bytes
        return _get_config().obs_log_max_bytes

    def _maybe_rotate(self, nbytes: int) -> None:
        """Rotate (under the write lock) when the next line would cross the
        bound. A single line larger than the whole bound still writes — an
        event is never dropped, the NEXT write rotates."""
        limit = self._limit()
        if not limit or self._size == 0 or self._size + nbytes <= limit:
            return
        self._f.close()
        for i in range(self.backups - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if self.backups >= 1:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._f = open(self.path, "a")
        self._size = 0

    def event(self, kind: str, **fields: Any) -> None:
        # span context first so an explicit field of the same name (a
        # caller restamping trace_id) wins
        rec = {"t": time.time(), "kind": kind, **_span_fields(), **fields}
        line = json.dumps(rec) + "\n"
        with self._lock:
            if self._f.closed:
                return  # a worker racing close() drops its record rather
                # than killing its thread — observability must stay passive
            self._maybe_rotate(len(line))
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    @contextlib.contextmanager
    def timed(self, kind: str, **fields: Any):
        """Times the body; the record lands even when the body raises
        (tagged ``ok=False``) — a crash is exactly when the post-mortem
        needs the timing, not when it should vanish."""
        t0 = time.perf_counter()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            self.event(kind, seconds=time.perf_counter() - t0, ok=ok,
                       **fields)

    def close(self) -> None:
        # under the write lock: closing mid-event from another thread would
        # raise "I/O operation on closed file" inside the writer
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def read(self, include_rotated: bool = False) -> list[dict]:
        """Parsed records, oldest first. A torn line — a process killed
        mid-``write`` leaves a partial JSON tail, exactly the crash this
        log is the post-mortem for — is skipped and flagged (a
        ``RuntimeWarning`` plus ``self.last_read_skipped``) instead of
        raising ``JSONDecodeError`` and taking the whole record down with
        it. ``include_rotated`` prepends the ``.2``/``.1`` backups that
        exist, so a rotated stream reads as one."""
        from ..obs.report import load_events  # one torn-line-tolerant parse

        paths = [self.path]
        if include_rotated:
            paths = [p for i in range(self.backups, 0, -1)
                     for p in [f"{self.path}.{i}"] if os.path.exists(p)
                     ] + paths
        records = []
        skipped = 0
        for p in paths:
            recs, sk = load_events(p)
            records.extend(recs)
            skipped += sk
        self.last_read_skipped = skipped
        if skipped:
            warnings.warn(
                f"{self.path}: skipped {skipped} torn/partial JSONL "
                f"line(s) (process killed mid-write?)", RuntimeWarning,
                stacklevel=2)
        return records


# Process-default event log: subsystems without a log handle of their own
# (the serving metrics, the memory ledger) report here when one is
# installed, so a run's post-mortem record is one stream rather than
# per-module fragments.
_default_log: EventLog | None = None


def set_default_event_log(log: EventLog | None) -> EventLog | None:
    """Install (or, with None, remove) the process-default event log;
    returns the previous one so callers can restore it."""
    global _default_log
    prev = _default_log
    _default_log = log
    return prev


def get_default_event_log() -> EventLog | None:
    return _default_log
