"""Supervised worker recovery for :class:`~marlin_tpu_torch.serving.engine
.ServeEngine`.

Counterpart of ``marlin_tpu/serving/supervisor.py``, copied (it drives the
engine's own recovery hooks and imports no device code).

A bare engine dies with its worker thread: one uncaught exception in the
``marlin-serve`` loop (or a wedged device call) would permanently kill the
engine. A :class:`Supervisor` turns that one-shot failure into a supervised
restart loop:

- **Crash detection** is prompt: the engine's crash handler stashes the
  undone in-flight entries and kicks the supervisor's monitor thread (no
  poll latency); a worker that dies without reaching its handler is caught
  by the thread-liveness poll.
- **Stuck detection** is the watchdog: a worker whose ``_heartbeat`` stamp
  (stamped once per loop iteration, real clock) is older than
  ``watchdog_s`` while work is pending is declared stuck — the engine's
  worker *generation* is superseded (the stale thread exits at its next
  check and can never retire a superseded entry) and a fresh generation
  takes over. A ``warmup()`` in progress is exempt (``engine._warming``):
  its first call builds the CUDA kernels with ``nvcc``, which can outlast
  any sane watchdog, and a freshly scaled-out replica must not be
  "recovered" mid-warmup — crash detection stays on throughout.
- **Recovery** (``ServeEngine._recover``) drops the page pool (its block
  tables died with the worker; it rebuilds zeroed on the next admission),
  re-queues live rows that never emitted a Result within their per-request
  ``max_attempts`` budget (exactly-once is preserved by attempt accounting:
  a superseded entry can never set the handle, and the admission
  reservation is carried — never released, never re-charged), and spawns a
  fresh worker thread. The decode backend is the engine's, resolved once at
  construction: a restart never switches it. Greedy retries are
  bit-identical to an uninterrupted run; sampled retries re-derive the same
  per-row ``fold_in(key(seed), step)`` stream.
- **The restart budget** is a circuit breaker: restarts are timestamped
  into a sliding ``restart_window_s`` window and each restart backs off
  exponentially (``backoff_s * 2^k``, capped); more than ``restart_max``
  restarts in the window OPENS the breaker — the engine is failed
  permanently (closed; queued work gets clean terminal Results) instead of
  crash-looping against a deterministic bug.

Every transition lands in the EventLog (``kind="serve"``,
``ev="restart"`` / ``ev="breaker"``) and the process metrics registry:
``marlin_serve_restarts_total{engine=...}`` and
``marlin_serve_breaker_state{engine=...}`` (0 closed / 1 open). The
monitor thread is named ``marlin-serve-sup-*`` — the tests' thread-leak
check watches the prefix; :meth:`Supervisor.close` joins it.

Knobs default from the config: ``serve_watchdog_s``,
``serve_restart_max``, ``serve_restart_window_s``,
``serve_restart_backoff_s``.
"""

from __future__ import annotations

import collections
import threading
import time

from ..config import get_config
from ..obs.metrics import get_registry
from ..utils.tracing import get_default_event_log

__all__ = ["Supervisor"]


def _emit(log, **fields) -> None:
    log = log or get_default_event_log()
    if log is not None:
        log.event("serve", **fields)


class Supervisor:
    """Watch one engine's worker; restart it under a bounded budget.

    ``Supervisor(engine)`` attaches immediately: the engine's crash handler
    now stashes-and-kicks instead of failing its held requests, and a
    ``marlin-serve-sup-*`` monitor thread polls thread liveness plus the
    heartbeat watchdog every ``poll_s`` (the crash kick wakes it early).
    ``watchdog_s=0`` disables the stuck check; crash detection stays on.
    ``sleep`` is injectable so tests drive backoff deterministically.

    Usable as a context manager; :meth:`close` detaches, joins the monitor,
    and leaves the engine running (closing the engine is the owner's call —
    except after the breaker opened, when the engine is already closed)."""

    def __init__(self, engine, *, watchdog_s: float | None = None,
                 restart_max: int | None = None,
                 restart_window_s: float | None = None,
                 backoff_s: float | None = None,
                 poll_s: float = 0.05, log=None, start: bool = True,
                 sleep=time.sleep):
        cfg = get_config()
        self.engine = engine
        self.watchdog_s = float(cfg.serve_watchdog_s if watchdog_s is None
                                else watchdog_s)
        self.restart_max = int(cfg.serve_restart_max if restart_max is None
                               else restart_max)
        self.restart_window_s = float(
            cfg.serve_restart_window_s if restart_window_s is None
            else restart_window_s)
        self.backoff_s = float(cfg.serve_restart_backoff_s if backoff_s is
                               None else backoff_s)
        self.poll_s = float(poll_s)
        self._log = log
        self._sleep = sleep
        self._lock = threading.Lock()
        self._restarts: collections.deque = collections.deque()
        self.restart_count = 0
        self.breaker_open = False
        self._kick = threading.Event()
        self._stop = threading.Event()
        reg = get_registry()
        self._m_restarts = reg.counter(
            "marlin_serve_restarts_total",
            "Supervised serving-worker restarts", labelnames=("engine",)
        ).labels(engine=engine._name)
        self._m_breaker = reg.gauge(
            "marlin_serve_breaker_state",
            "Restart circuit breaker (0 closed / 1 open = engine failed "
            "permanently)", labelnames=("engine",)
        ).labels(engine=engine._name)
        self._m_breaker.set(0)
        engine.attach_supervisor(self._kick.set)
        self._thread = threading.Thread(
            target=self._monitor, daemon=True,
            name=f"marlin-serve-sup-{engine._name}")
        if start:
            self._thread.start()

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        """Detach from the engine and join the monitor. Idempotent."""
        self.engine.detach_supervisor()
        self._stop.set()
        self._kick.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ the watch

    def _monitor(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.poll_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                if not self.check():
                    return  # engine terminal (closed or breaker-opened)
            except Exception:
                # supervision must never die of its own bug; next poll
                # retries (the engine's own failure paths still resolve
                # every handle)
                pass

    def check(self) -> bool:
        """One inspection cycle (unit-testable without the thread): detect
        a crashed, dead, or stuck worker and recover. Returns False once
        the engine is terminal — the monitor loop exits."""
        eng = self.engine
        if self.breaker_open or eng._state in ("closing", "closed"):
            return False
        if eng._state in ("freezing", "frozen"):
            # migration pause: the worker parks (or has parked) on purpose
            # and freeze_rows() owns every resident row — a recovery here
            # would respawn a generation under the migration's feet and
            # double-deliver rows. A crash mid-freeze is stashed by the
            # crash handler and consumed by freeze_rows() itself (those
            # rows ride the retry fallback); keep polling — the router
            # closes the engine when the handoff ends
            return True
        crash = eng._crash  # read once: close()'s _fail_crash_stash may
        if crash is not None:  # null the attribute between our reads
            self._recover("worker crashed: "
                          f"{type(crash[0]).__name__}: {crash[0]}")
            return not self.breaker_open
        thread = eng._thread
        if eng._started and not thread.is_alive() \
                and eng._state in ("running", "draining"):
            # died without reaching the crash handler (SystemExit-class);
            # nothing stashed — _recover steals the pools/inflight mirrors
            self._recover("worker thread died")
            return not self.breaker_open
        hb = eng._heartbeat
        if (self.watchdog_s > 0 and eng._started and hb is not None
                and not eng._warming
                and time.monotonic() - hb > self.watchdog_s
                and eng._state in ("running", "draining")
                and eng.pending() > 0):
            self._recover(f"worker stuck: heartbeat "
                          f"{time.monotonic() - hb:.1f}s old "
                          f"(watchdog {self.watchdog_s}s)")
            return not self.breaker_open
        return True

    # ------------------------------------------------------------- recovery

    def _recover(self, reason: str) -> None:
        with self._lock:
            now = time.monotonic()
            self._restarts.append(now)
            while self._restarts and \
                    self._restarts[0] < now - self.restart_window_s:
                self._restarts.popleft()
            in_window = len(self._restarts)
            if in_window > self.restart_max:
                self._open_breaker(reason, in_window)
                return
            # exponential backoff within the window, capped at 16x — a
            # tight crash loop must not spin the device
            delay = self.backoff_s * min(2 ** (in_window - 1), 16)
        if delay > 0:
            self._sleep(delay)
        info = self.engine._recover(reason)
        with self._lock:
            self.restart_count += 1
        self._m_restarts.inc()
        _emit(self._log, ev="restart", engine=self.engine._name,
              reason=reason, gen=info["gen"], requeued=info["requeued"],
              failed=info["failed"], backoff_s=delay,
              restarts_in_window=in_window)

    def _open_breaker(self, reason: str, in_window: int) -> None:
        """Too many restarts in the window: fail the engine permanently.
        The current generation is superseded WITHOUT a respawn (a wedged
        thread is abandoned, never joined — it may sit in a device call
        forever, and close() must not hang on it), everything it held
        fails with ``error``, queued requests retire with clean
        ``shutting_down`` Results — nothing is stranded, and nothing
        restarts again."""
        # analyze: single-writer — a monotonic one-way latch (never reset);
        # readers tolerate a stale False for one poll interval
        self.breaker_open = True
        self._m_breaker.set(1)
        _emit(self._log, ev="breaker", engine=self.engine._name,
              state="open", reason=reason, restarts_in_window=in_window,
              window_s=self.restart_window_s)
        eng = self.engine
        eng.detach_supervisor()
        try:
            eng._recover(f"breaker open: {reason}", respawn=False)
            eng.close()
        except Exception:
            pass

    def info(self) -> dict:
        """Supervisor state for health aggregation (router / tests)."""
        with self._lock:
            return {"restarts": self.restart_count,
                    "restarts_in_window": len(self._restarts),
                    "breaker": "open" if self.breaker_open else "closed",
                    "watchdog_s": self.watchdog_s}
