"""Request/Result contracts and bounded admission for the serving engine.

Counterpart of ``marlin_tpu/serving/request.py``, copied (the module is
stdlib + numpy). This module is the serving engine's wire format: a :class:`Request` carries one prompt plus its serving policy
(deadline, priority, sampling knobs), a :class:`Result` is the exactly-once
answer every submitted request eventually receives — completed, rejected,
expired, errored, or shut down, but never silently dropped — and
:class:`AdmissionQueue` is the backpressure gate in front of the batch
former: a submission is admitted only while both the queue-depth bound and
the in-flight KV-cache HBM budget (defaulting to the planner's measured
:func:`~marlin_tpu_torch.models.planner.usable_hbm_bytes`) have room, and a full
queue rejects with a reason instead of blocking the caller.

Everything here is stdlib + numpy; the engine (engine.py) owns the device
side.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any

import numpy as np

__all__ = ["Request", "Result", "ResultHandle", "AdmissionQueue",
           "SHED_REASON_PREFIX",
           "STATUS_OK", "STATUS_REJECTED", "STATUS_EXPIRED", "STATUS_ERROR",
           "STATUS_SHUTTING_DOWN"]

#: rejection reasons produced by SLO-driven load shedding start with this —
#: the engine keys its marlin_slo_shed_total accounting off the prefix and
#: callers can distinguish "shed under breach, retry elsewhere/later" from
#: a structurally full queue
SHED_REASON_PREFIX = "shedding load"

#: terminal statuses a :class:`Result` can carry
STATUS_OK = "ok"                          # decoded; ``tokens`` is set
STATUS_REJECTED = "rejected"              # refused at admission (see reason)
STATUS_EXPIRED = "expired"                # deadline passed before decode
STATUS_ERROR = "error"                    # the batch it rode in failed
STATUS_SHUTTING_DOWN = "shutting_down"    # queued at close(); never decoded

_rid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One serving request.

    ``program`` names the :class:`~marlin_tpu_torch.serving.programs
    .BucketProgram` that answers it — ``"lm"`` (the default, token
    generation) or any program the engine was constructed with (``"als"``,
    ``"pagerank"``, ``"classify"``, ...). Non-LM programs take their input
    through ``payload`` (a small host-side dict, e.g. ``{"user": 7,
    "k": 10}``) and need no ``prompt``; every request, whatever its
    program, shares the same deadline/priority/retry policy surface and
    the same exactly-once :class:`Result` contract.

    ``prompt`` is a 1-D int32 token array (required for ``program="lm"``,
    ignored elsewhere); ``steps`` how many tokens to generate (the bucket
    rounds it up for execution, the :class:`Result` slices back down). ``deadline`` is an *absolute* time on the engine's
    clock (``None`` = no deadline): a request whose deadline has passed when
    its batch forms is retired with :data:`STATUS_EXPIRED` rather than
    decoded late. ``priority`` orders dispatch within a bucket (higher
    first; FIFO among equals). Sampling knobs mirror
    :func:`~marlin_tpu_torch.models.transformer.lm_generate_batch`.

    ``seed`` feeds the sampling PRNG: each row draws its own
    ``fold_in(key(seed), step)`` stream, so a sampled output replays from
    (seed, prompt) alone — composition-independent across batch makeup,
    bucket padding, page boundaries, and prefix sharing — and any knob mix
    shares a decode step (the knobs are per-row traced). Greedy decode,
    the default, ignores the key entirely.

    ``eos`` names a stop token: a row retires the step it EMITS that token
    (its slot refills from the queue on the next step), so
    ``Result.tokens`` may carry fewer than ``steps`` generated tokens,
    ending with the eos. Detection looks only at GENERATED tokens — an
    eos-valued token inside the prompt or its pad region never stops a
    row.

    ``deadline_s`` is the *relative* form of ``deadline``: seconds from
    submission, resolved to an absolute engine-clock deadline inside
    ``submit()`` (at most one of the two may be set; with neither set,
    ``config.serve_default_deadline_s`` applies when configured). The
    resolved deadline survives router failover and worker restarts — a
    retried attempt does not get a fresh budget.

    ``max_attempts`` is the request's total execution budget: rows failed
    by a decode-step/prefill fault or lost to a worker crash are
    transparently re-queued until they have consumed ``max_attempts``
    attempts, then retired with an ``error`` Result. The default (1) keeps
    the pre-resilience semantics — first failure is final. Replays are
    attempt-independent: greedy retries are bit-identical to an
    uninterrupted run, sampled retries re-derive the same per-row
    ``fold_in(key(seed), step)`` stream."""

    prompt: Any = None
    steps: int = 1
    deadline: float | None = None
    deadline_s: float | None = None
    max_attempts: int = 1
    priority: int = 0
    temperature: float = 0.0
    top_p: float | None = None
    top_k: int | None = None
    seed: int = 0
    eos: int | None = None
    program: str = "lm"
    payload: Any = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    def __post_init__(self):
        if self.prompt is None:
            if self.program == "lm":
                raise ValueError("program 'lm' needs a token prompt")
        else:
            self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
            if self.prompt.size < 1:
                raise ValueError("empty prompt")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.deadline is not None and self.deadline_s is not None:
            raise ValueError("set deadline (absolute) or deadline_s "
                             "(relative to submit), not both")


@dataclasses.dataclass
class Result:
    """The exactly-once answer to one :class:`Request`. ``tokens`` (status
    :data:`STATUS_OK` only) is prompt + the generated tokens — exactly the
    requested ``steps`` of them, or fewer ending in the stop token when
    ``Request.eos`` fired under the row-level scheduler. Non-LM programs
    answer through ``value`` instead (the program-shaped payload, e.g.
    ALS's ``{"items": ..., "scores": ...}``). ``metrics``
    carries the per-request timings on the engine clock (``queue_s``,
    ``ttft_s`` — time to the first generated token, which row-level prefill
    makes genuinely earlier than ``total_s``), the ``bucket`` that executed
    it, and under row-level scheduling the ``slot`` it occupied."""

    rid: int
    status: str
    tokens: np.ndarray | None = None
    reason: str = ""
    metrics: dict = dataclasses.field(default_factory=dict)
    value: Any = None

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class ResultHandle:
    """Caller-side future for one request: ``result(timeout)`` blocks until
    the engine retires the request. The engine sets each handle exactly once
    — a second ``_set`` is a scheduler bug and raises."""

    def __init__(self, request: Request):
        self.request = request
        self._event = threading.Event()
        self._result: Result | None = None

    def _set(self, result: Result) -> None:
        if self._event.is_set():  # pragma: no cover - guards engine bugs
            raise RuntimeError(
                f"request {self.request.rid} retired twice "
                f"(had {self._result.status}, got {result.status})")
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Result:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} not done within {timeout}s")
        return self._result

    def __repr__(self):
        state = self._result.status if self.done() else "pending"
        return f"ResultHandle(rid={self.request.rid}, {state})"


class AdmissionQueue:
    """Depth + HBM-byte admission gate with reject-with-reason backpressure.

    Tracks every admitted-but-not-retired request: ``depth`` bounds how many
    may be pending or in flight at once, ``budget_bytes`` bounds the summed
    KV-cache cost the engine would hold if everything admitted ran (cost per
    request = its bucket row's cache bytes, :func:`..serving.batcher
    .bucket_kv_bytes`). ``try_admit`` returns ``None`` on admission or the
    rejection reason string; ``release`` returns the request's capacity when
    the engine retires it. ``close(reason)`` flips the gate shut (drain /
    shutdown) — everything after is rejected with that reason.

    **Graceful degradation** — :meth:`set_shed` arms an SLO-breach shed
    level: while armed, ``try_admit`` additionally rejects the *least
    protected* new arrivals (reason prefixed :data:`SHED_REASON_PREFIX`).
    A request's protection score is its ``priority`` plus 1 when its
    deadline is imminent (slack ≤ ``protect_slack_s`` — work the fleet is
    about to owe an answer for is never the first shed); a request is shed
    iff score < level, so level 1 drops only priority-0 slack-rich
    traffic and each further level reaches one priority tier higher.
    In-flight work is untouched — shedding gates admission only, so
    exactly-once delivery is preserved: every shed request still gets its
    clean ``rejected`` Result. :meth:`clear_shed` disarms on SLO clear."""

    def __init__(self, depth: int, budget_bytes: int):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._count = 0
        self._bytes = 0
        self._closed_reason: str | None = None
        self._shed_level = 0
        self._shed_reason = ""
        self._shed_slack_s = 0.0
        self._shed_count = 0

    def set_shed(self, level: int, reason: str = "",
                 protect_slack_s: float = 0.0) -> None:
        """Arm (level ≥ 1) or disarm (level 0) SLO-driven shedding.
        ``reason`` names the breached objective(s) for the rejection
        string; ``protect_slack_s`` is the deadline-slack bound under
        which a request counts as imminent and gains a protection point."""
        with self._lock:
            self._shed_level = max(0, int(level))
            self._shed_reason = str(reason)
            self._shed_slack_s = float(protect_slack_s)

    def clear_shed(self) -> None:
        self.set_shed(0)

    @property
    def shed_level(self) -> int:
        with self._lock:
            return self._shed_level

    @property
    def shed_count(self) -> int:
        """Total requests rejected by shedding since construction."""
        with self._lock:
            return self._shed_count

    def try_admit(self, cost_bytes: int, priority: int = 0,
                  deadline_slack_s: float | None = None) -> str | None:
        with self._lock:
            if self._closed_reason is not None:
                return self._closed_reason
            if self._shed_level > 0:
                score = int(priority)
                if (deadline_slack_s is not None
                        and deadline_slack_s <= self._shed_slack_s):
                    score += 1
                if score < self._shed_level:
                    self._shed_count += 1
                    why = (f" ({self._shed_reason})" if self._shed_reason
                           else "")
                    return (f"{SHED_REASON_PREFIX}: SLO error budget "
                            f"burning{why}; retry later or raise priority")
            if self._count >= self.depth:
                return (f"queue full ({self._count}/{self.depth} requests "
                        f"pending or in flight)")
            # at least one request is always admissible, else an oversized
            # budgetless config would deadlock the whole engine
            if (self._count and self.budget_bytes
                    and self._bytes + cost_bytes > self.budget_bytes):
                return (f"HBM admission budget exhausted ({self._bytes} + "
                        f"{cost_bytes} > {self.budget_bytes} bytes of "
                        f"in-flight KV cache)")
            self._count += 1
            self._bytes += cost_bytes
            return None

    def release(self, cost_bytes: int) -> None:
        with self._lock:
            self._count -= 1
            self._bytes -= cost_bytes
            assert self._count >= 0 and self._bytes >= 0, \
                "admission release without admit"

    def adopt(self, cost_bytes: int) -> None:
        """Force-admit a MIGRATED request's reservation (cross-engine
        handoff): the fleet already admitted this work on the source
        engine, whose queue is released by the migration caller — the
        reservation moves, it is never re-judged, so depth/budget/closed
        do not gate it (a frozen row must land even on a briefly-over-
        budget target; the normal ``release`` path drains the charge)."""
        with self._lock:
            self._count += 1
            self._bytes += cost_bytes

    def close(self, reason: str) -> None:
        with self._lock:
            if self._closed_reason is None:
                self._closed_reason = reason

    @property
    def closed_reason(self) -> str | None:
        """The drain/shutdown reason once the gate is shut, else None —
        submit() turns post-drain arrivals into deterministic
        ``shutting_down`` Results instead of generic rejections."""
        with self._lock:
            return self._closed_reason

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def bytes_in_flight(self) -> int:
        with self._lock:
            return self._bytes
