"""Retrying IO: exponential backoff + jitter + deadline, built for seam tests.

Counterpart of ``marlin_tpu/utils/retry.py``, over the port's own fault
registry and EventLog.

The reference leans on Spark/Hadoop client retries for every HDFS hiccup
(SURVEY.md §5.3); the JAX package's remote-filesystem hook (io/fs.py) talks
to object stores and network filesystems directly, so transient failures are
this library's problem. :class:`RetryPolicy` is the one shared answer there,
and the port's remote opens and listings (:mod:`marlin_tpu_torch.io.fs`)
route through it too.

Design points:

- **Seam-tested determinism** — the clock, the sleep, and the jitter RNG are
  all injectable (``clock=``, ``sleep=``, ``seed=``), so tests assert the
  exact backoff sequence without real waiting.
- **Observability** — every retry emits a ``retry`` event to the policy's
  :class:`~marlin_tpu_torch.utils.tracing.EventLog` (or the process-default log,
  :func:`~marlin_tpu_torch.utils.tracing.set_default_event_log`); silent retries
  hide degraded storage until it becomes an outage.
- **Deadline** — a wall-clock budget caps total time across attempts; a
  policy with generous attempt counts still fails fast when the budget is
  spent (the last error is re-raised, never swallowed).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Iterator

from .faults import FaultInjected
from .tracing import get_default_event_log

__all__ = ["RetryPolicy", "get_retry_policy", "set_retry_policy"]

#: Exceptions worth retrying by default: transient IO. TimeoutError and
#: ConnectionError are OSError subclasses; FaultInjected is included so chaos
#: tests exercise the same code path production errors take.
DEFAULT_RETRY_ON: tuple[type[BaseException], ...] = (OSError, FaultInjected)


class RetryPolicy:
    """Exponential backoff with jitter and an overall deadline.

    ``delay(i)`` for attempt i (0-based) is
    ``min(max_delay, base_delay * multiplier**i)`` scaled by a random factor
    in ``[1, 1 + jitter]`` drawn from ``random.Random(seed)`` — seeded
    policies produce identical delay sequences run-to-run.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        multiplier: float = 2.0,
        jitter: float = 0.25,
        deadline: float | None = None,
        retry_on: tuple[type[BaseException], ...] = DEFAULT_RETRY_ON,
        seed: int | None = None,
        clock: Callable[[], float] | None = None,
        sleep: Callable[[float], None] | None = None,
        event_log=None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline = deadline
        self.retry_on = retry_on
        self.clock = clock or time.monotonic
        self.sleep = sleep or time.sleep
        self.event_log = event_log
        self._rng = random.Random(seed)
        #: total retries performed through this policy (across calls)
        self.retries = 0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt + 1`` (0-based)."""
        d = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * self._rng.random()
        return d

    def delays(self) -> Iterator[float]:
        """The at-most ``max_attempts - 1`` backoff delays, in order."""
        for i in range(self.max_attempts - 1):
            yield self.delay(i)

    def call(self, fn: Callable[[], Any], describe: str = "",
             retry_on: tuple[type[BaseException], ...] | None = None) -> Any:
        """Run ``fn()`` with retries; re-raises the last error when the
        attempt budget or deadline is exhausted."""
        retry_on = retry_on or self.retry_on
        log = self.event_log or get_default_event_log()
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                attempt += 1
                if attempt >= self.max_attempts:
                    if log is not None:
                        log.event("retry_exhausted", op=describe,
                                  attempts=attempt, error=repr(e))
                    raise
                d = self.delay(attempt - 1)
                if (self.deadline is not None
                        and self.clock() - start + d > self.deadline):
                    if log is not None:
                        log.event("retry_deadline", op=describe,
                                  attempts=attempt, error=repr(e))
                    raise
                self.retries += 1
                if log is not None:
                    log.event("retry", op=describe, attempt=attempt,
                              delay_s=d, error=repr(e))
                self.sleep(d)


_policy = RetryPolicy()


def get_retry_policy() -> RetryPolicy:
    """The process-wide policy remote IO retries through."""
    return _policy


def set_retry_policy(policy: RetryPolicy | None) -> RetryPolicy:
    """Swap the process-wide policy (None restores the default); returns the
    previous one so tests can put it back."""
    global _policy
    prev = _policy
    _policy = policy if policy is not None else RetryPolicy()
    return prev
