"""Serving observability: counters + per-request latencies through EventLog
and the process metrics registry.

Counterpart of ``marlin_tpu/serving/metrics.py``, copied with its imports
pointed at the port's ``obs`` and ``utils.tracing``: the same records and the
same ``marlin_serve_*`` families.

Every record goes to the engine's :class:`~marlin_tpu_torch.utils.tracing.EventLog`
(or the process default, resolved per emit so a log installed mid-run is
picked up) under the single kind ``"serve"`` with an ``ev`` discriminator:

=============  ===========================================================
``ev``         fields
=============  ===========================================================
``enqueue``    ``rid``, ``bucket``, ``depth`` (queue depth after admit)
``reject``     ``rid``, ``reason``
``prefill``    one per prefill dispatch: ``rid``, ``bucket``, ``seconds``
               (wall time), ``new_tokens`` (1 on the completing dispatch —
               the row's first token lands there — else 0); paged chunked
               prefill additionally carries ``chunk`` = [start, tokens]
               (a long prompt emits one record per chunk, resumable across
               worker iterations)
``step``       one per DECODE STEP over a bucket's rows: ``bucket``,
               ``rows`` (live this step), ``occupancy``, ``new_tokens``
               (= live rows), ``seconds`` (wall decode-step latency),
               ``tok_s`` — the per-step occupancy stream is how slot
               refill is asserted (a finished row's slot shows occupied
               again on the next step's record)
``page``       paged KV pool accounting: ``action`` (``alloc`` at row
               admission / ``free`` at retirement / ``cow`` on a
               copy-on-write split / ``lost`` when a failed donated call
               consumed the slab), ``rid``, ``pages`` (moved by this
               action), ``shared`` (of them, prefix-cache shares), and
               the pool ``used``/``total`` after it — the stream
               ``obs.report`` turns into the prefix-hit-rate /
               page-occupancy line
``retry``      ``rid``, ``attempt`` (the attempt about to run),
               ``max_attempts``, ``reason`` — one failed attempt re-queued
``result``     ``rid``, ``status``, ``bucket``, ``queue_s``, ``ttft_s``,
               ``total_s``; retried requests add ``attempt`` (the final,
               serving attempt — latency is attributed to it); paged rows
               add ``pages``/``shared_pages``
``swap``       one atomic model hot-update on a resident BucketProgram:
               ``program``
=============  ===========================================================

Non-LM BucketProgram traffic (serving/programs/) threads a ``program``
field through its ``enqueue``/``step``/``reject``/``result`` records (LM
records stay byte-identical — readers default a missing field to ``lm``),
and aggregates into three labelled families:
``marlin_serve_program_requests_total{program,status}`` (terminal outcomes
per serving program), ``marlin_serve_program_rows_total{program}`` (rows
executed by one-shot program steps), and
``marlin_serve_program_swaps_total{program}`` (atomic model hot-updates).

The engine activates each request's span context around the rid-carrying
emits, so one request's ``enqueue``/``prefill``/``result`` records share a
``trace_id`` in the JSONL (obs/trace.py; the analyzer joins them).

In parallel, everything aggregates into the process registry
(:mod:`marlin_tpu_torch.obs.metrics`) so a ``/metrics`` scrape sees live serving
state: ``marlin_serve_submitted_total``,
``marlin_serve_requests_total{status=...}``, ``marlin_serve_tokens_total``,
``marlin_serve_dispatches_total{kind=step|prefill}``,
``marlin_serve_busy_seconds_total``, gauges ``marlin_serve_queue_depth`` /
``marlin_serve_slot_occupancy`` / ``marlin_serve_kv_inflight_bytes`` /
``marlin_serve_kv_pages_total`` / ``marlin_serve_kv_pages_used`` /
``marlin_serve_kv_pages_shared`` (paged pool state), the
``marlin_serve_prefix_cache_total{result=hit|miss}`` counter, and
histograms ``marlin_serve_ttft_seconds`` / ``marlin_serve_total_seconds`` /
``marlin_serve_step_seconds``.

Latencies are measured on the engine's *injected* clock (deterministic
tests), throughput (``tok_s``) on the real wall clock (it is a measurement,
not a policy input). The first token lands with the row's (final) prefill
dispatch, so ``ttft_s`` is genuinely earlier than ``total_s`` — the
headline latency row-level scheduling buys, and what paged chunked prefill
bounds under long-prompt load.

:meth:`ServeMetrics.snapshot` aggregates everything for tests and the bench
without re-reading the log file. Its percentiles run
over *uniform reservoir samples* (:class:`Reservoir`, Algorithm R with an
injectable RNG) — the previous first-``keep_latencies``-then-drop scheme
silently stopped sampling after warmup, biasing every long-run percentile
toward the coldest requests the engine ever served.
"""

from __future__ import annotations

import random
import threading

from ..obs.metrics import get_registry, percentile  # noqa: F401  (re-export)
from ..obs.perf import get_program_costs
from ..utils.tracing import get_default_event_log

__all__ = ["ServeMetrics", "Reservoir", "percentile"]


class Reservoir:
    """Uniform reservoir sampling (Algorithm R): after ``n`` adds, each of
    the ``n`` values had probability ``k/n`` of being retained — percentiles
    over the sample estimate the whole stream, not its first ``k`` entries.
    The RNG is injectable (tests pin it; callers share one across
    reservoirs). NOT thread-safe on its own — :class:`ServeMetrics` adds
    under its lock."""

    __slots__ = ("k", "n", "items", "_rng")

    def __init__(self, k: int, rng: random.Random):
        self.k = int(k)
        self.n = 0
        self.items: list[float] = []
        self._rng = rng

    def add(self, value: float) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(value)
        else:
            j = self._rng.randrange(self.n)
            if j < self.k:
                self.items[j] = value

    def values(self) -> list[float]:
        return list(self.items)


class ServeMetrics:
    """Thread-safe counter/latency sink for one engine. All record_* methods
    are called by the engine (submit path + worker thread) — never raise out
    of them into the serving path."""

    def __init__(self, log=None, keep_latencies: int = 4096, rng=None):
        self._log = log
        self._lock = threading.Lock()
        rng = rng if rng is not None else random.Random(0)
        self.submitted = 0
        self.rejected = 0
        self.expired = 0
        self.completed = 0
        self.errors = 0
        self.shut_down = 0
        self.retries = 0
        self.batches = 0  # legacy (gang scheduler): always 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.pages_total = 0
        self.pages_used = 0
        self.pages_shared = 0
        self.steps = 0
        self.new_tokens = 0
        self.busy_s = 0.0
        self.migrated_out = 0   # rows exported into a migration blob
        self.migrated_in = 0    # rows adopted mid-stream from a peer
        self.migrate_fallback = 0  # rows that fell back to the retry path
        self.program_steps = 0  # one-shot program batch dispatches
        self.program_rows = 0   # rows those dispatches served
        self.swaps = 0          # atomic model hot-updates (record_swap)
        self._occupancy_sum = 0.0
        self._step_occupancy_sum = 0.0
        self._total_s = Reservoir(keep_latencies, rng)
        self._queue_s = Reservoir(keep_latencies, rng)
        self._ttft_s = Reservoir(keep_latencies, rng)
        self._step_s = Reservoir(keep_latencies, rng)
        self._ts = None  # optional TimeSeriesStore (attach_timeseries)
        reg = get_registry()
        self._m_submitted = reg.counter(
            "marlin_serve_submitted_total", "Requests admitted by submit()")
        self._m_requests = reg.counter(
            "marlin_serve_requests_total",
            "Terminal request outcomes by status",
            labelnames=("status",))
        self._m_tokens = reg.counter(
            "marlin_serve_tokens_total", "Generated tokens (all requests)")
        self._m_dispatch = reg.counter(
            "marlin_serve_dispatches_total",
            "Engine dispatches by kind (decode step / prefill — one "
            "prefill dispatch per chunk under paged chunked prefill)",
            labelnames=("kind",))
        self._m_busy = reg.counter(
            "marlin_serve_busy_seconds_total",
            "Wall seconds the engine spent inside compiled programs")
        self._m_queue_depth = reg.gauge(
            "marlin_serve_queue_depth",
            "Requests admitted but not yet retired (queued + in flight)")
        self._m_occupancy = reg.gauge(
            "marlin_serve_slot_occupancy",
            "Live rows / max_batch of the most recent dispatch")
        self._m_kv_bytes = reg.gauge(
            "marlin_serve_kv_inflight_bytes",
            "Admitted-but-unretired KV-cache bytes against the planner's "
            "HBM budget")
        self._m_ttft = reg.histogram(
            "marlin_serve_ttft_seconds", "Time to first generated token")
        self._m_total = reg.histogram(
            "marlin_serve_total_seconds", "Submit-to-result latency")
        self._m_step = reg.histogram(
            "marlin_serve_step_seconds", "Row-level decode-step wall time")
        self._m_retries = reg.counter(
            "marlin_serve_retries_total",
            "Failed attempts transparently re-queued (decode/prefill fault "
            "or worker crash) within the request's max_attempts budget")
        self._m_pages_total = reg.gauge(
            "marlin_serve_kv_pages_total",
            "Allocatable pages in the paged KV pool (serve_num_pages minus "
            "the dummy page)")
        self._m_pages_used = reg.gauge(
            "marlin_serve_kv_pages_used",
            "Pages held by live rows and/or the prefix cache")
        self._m_pages_shared = reg.gauge(
            "marlin_serve_kv_pages_shared",
            "Pages with more than one referent (copy-on-write prefix "
            "sharing: cache + row, or row + row)")
        self._m_prefix = reg.counter(
            "marlin_serve_prefix_cache_total",
            "Prefix-cache lookups at row admission by result (hit = at "
            "least one full prompt page reused)", labelnames=("result",))
        self._m_prog_requests = reg.counter(
            "marlin_serve_program_requests_total",
            "Terminal request outcomes by serving program (BucketProgram "
            "name: lm, als, pagerank, classify, ...) and status",
            labelnames=("program", "status"))
        self._m_prog_rows = reg.counter(
            "marlin_serve_program_rows_total",
            "Rows executed by one-shot (non-LM) BucketProgram step "
            "dispatches, by program",
            labelnames=("program",))
        self._m_prog_swaps = reg.counter(
            "marlin_serve_program_swaps_total",
            "Atomic model hot-updates (swap_model) on resident "
            "BucketPrograms, by program",
            labelnames=("program",))
        self._m_migrate = reg.counter(
            "marlin_serve_migrations_total",
            "Cross-replica row migrations by leg (export = rows serialized "
            "off a frozen engine, adopt = rows resumed mid-stream on this "
            "engine, fallback = rows degraded to the retry path)",
            labelnames=("leg",))

    def attach_timeseries(self, store) -> None:
        """Feed raw latency samples into a
        :class:`~marlin_tpu_torch.obs.timeseries.TimeSeriesStore` so windowed
        percentiles (the SLO engine's ``p99:...`` objectives) see every
        observation, not just the cumulative histogram the registry pump
        carries. Series are named after the histogram families
        (``marlin_serve_ttft_seconds`` etc. — the pump's derived cum
        series use ``_count``/``_sum`` suffixes, so the names never
        collide). Pass ``None`` to detach."""
        with self._lock:
            self._ts = store

    def _ts_observe(self, name: str, value: float) -> None:
        ts = getattr(self, "_ts", None)
        if ts is not None:
            try:
                ts.observe(name, value)
            except Exception:
                pass  # observability stays passive on the serving path

    def _emit(self, **fields) -> None:
        log = self._log or get_default_event_log()
        if log is not None:
            log.event("serve", **fields)

    def record_queue(self, depth: int, kv_bytes: int) -> None:
        """Live admission-gate state (the engine calls this on every admit
        and retirement) — gauges only, no EventLog record."""
        self._m_queue_depth.set(depth)
        self._m_kv_bytes.set(kv_bytes)

    def record_enqueue(self, rid: int, bucket, depth: int,
                       program: str | None = None) -> None:
        with self._lock:
            self.submitted += 1
        self._m_submitted.inc()
        # queue-depth gauge: record_queue is the single writer (the engine
        # calls it right after, with the admission gate's own count)
        fields = {"ev": "enqueue", "rid": rid, "bucket": list(bucket),
                  "depth": depth}
        if program is not None and program != "lm":
            fields["program"] = program
        self._emit(**fields)

    def record_reject(self, rid: int, reason: str,
                      program: str | None = None) -> None:
        with self._lock:
            self.rejected += 1
        self._m_requests.labels(status="rejected").inc()
        self._m_prog_requests.labels(program=program or "lm",
                                     status="rejected").inc()
        fields = {"ev": "reject", "rid": rid, "reason": reason}
        if program is not None and program != "lm":
            fields["program"] = program
        self._emit(**fields)

    def record_prefill(self, bucket, seconds: float,
                       rid: int | None = None,
                       program_key: str | None = None,
                       program: str = "lm_prefill_slot",
                       chunk=None, final: bool = True) -> None:
        """One prefill dispatch. The row's FIRST token is emitted by the
        COMPLETING dispatch (real TTFT), so that one counts toward
        ``new_tokens`` — without it, steps=1 traffic would report zero
        tokens; paged chunked prefill additionally records one
        zero-new-token event per earlier chunk (``chunk`` = [start,
        tokens], ``final=False``). ``program_key`` joins the wall time onto
        the bucket's captured cost model for ``program`` (obs/perf.py)
        — the roofline side of the same record."""
        emitted = 1 if final else 0
        with self._lock:
            self.new_tokens += emitted
            self.busy_s += seconds
        if program_key is not None:
            get_program_costs().observe(program, program_key, seconds)
        self._m_dispatch.labels(kind="prefill").inc()
        if emitted:
            self._m_tokens.inc()
        self._m_busy.inc(seconds)
        fields = {"ev": "prefill", "bucket": list(bucket),
                  "new_tokens": emitted, "seconds": seconds}
        if chunk is not None:
            fields["chunk"] = list(chunk)
        if rid is not None:
            fields["rid"] = rid
        self._emit(**fields)

    def record_step(self, bucket, rows: int, max_batch: int,
                    seconds: float,
                    program_key: str | None = None,
                    program: str = "lm_decode_rows",
                    label: str | None = None) -> None:
        """One decode step over a bucket's rows: ``rows`` live slots each
        emitted one token (``new_tokens`` == ``rows``). ``program_key``
        joins the step's wall time onto ``program``'s cost model, feeding
        ``marlin_program_roofline_frac``. ``label`` marks a non-LM
        BucketProgram batch (the serving-program name, distinct from
        ``program`` — the ProgramCosts family): its rows are program rows,
        not generated tokens, so they count into
        ``marlin_serve_program_rows_total{program}`` instead of the token
        counters and never touch LM's tok/s arithmetic."""
        with self._lock:
            self.steps += 1
            self.busy_s += seconds
            self._step_occupancy_sum += rows / max_batch
            self._step_s.add(seconds)
            if label is None:
                self.new_tokens += rows
            else:
                self.program_steps += 1
                self.program_rows += rows
        if program_key is not None:
            get_program_costs().observe(program, program_key, seconds)
        self._m_dispatch.labels(kind="step").inc()
        self._m_busy.inc(seconds)
        self._m_occupancy.set(rows / max_batch)
        self._m_step.observe(seconds)
        self._ts_observe("marlin_serve_step_seconds", seconds)
        fields = {"ev": "step", "bucket": list(bucket), "rows": rows,
                  "occupancy": round(rows / max_batch, 4),
                  "seconds": seconds}
        if label is None:
            self._m_tokens.inc(rows)
            fields["new_tokens"] = rows
            fields["tok_s"] = round(rows / max(seconds, 1e-9), 2)
        else:
            self._m_prog_rows.labels(program=label).inc(rows)
            fields["new_tokens"] = 0
            fields["program"] = label
        self._emit(**fields)

    def record_swap(self, program: str) -> None:
        """One atomic model hot-update (``swap_model``) installed on a
        resident BucketProgram."""
        with self._lock:
            self.swaps += 1
        self._m_prog_swaps.labels(program=program).inc()
        self._emit(ev="swap", program=program)

    def record_retry(self, rid: int, attempt: int, max_attempts: int,
                     reason: str) -> None:
        """One failed attempt re-queued for another try. The request stays
        admitted (no terminal counter moves); latency/TTFT land only with
        the final attempt's result — a retried request is attributed to the
        attempt that actually served it."""
        with self._lock:
            self.retries += 1
        self._m_retries.inc()
        self._emit(ev="retry", rid=rid, attempt=attempt,
                   max_attempts=max_attempts, reason=reason)

    def record_migration(self, leg: str, rows: int) -> None:
        """One cross-replica migration leg over ``rows`` rows: ``export``
        (frozen rows serialized off this engine), ``adopt`` (rows resumed
        mid-stream here), or ``fallback`` (rows degraded to the retry
        path). Counter + one ``ev="migrate"`` EventLog record."""
        if rows <= 0:
            return
        with self._lock:
            if leg == "export":
                self.migrated_out += rows
            elif leg == "adopt":
                self.migrated_in += rows
            elif leg == "fallback":
                self.migrate_fallback += rows
        self._m_migrate.labels(leg=leg).inc(rows)
        self._emit(ev="migrate", leg=leg, rows=rows)

    def record_pages(self, total: int, used: int, shared: int) -> None:
        """Live paged-pool state (the engine calls this after admissions,
        retirements, and pool drops) — gauges only, no EventLog record."""
        with self._lock:
            self.pages_total = total
            self.pages_used = used
            self.pages_shared = shared
        self._m_pages_total.set(total)
        self._m_pages_used.set(used)
        self._m_pages_shared.set(shared)

    def record_prefix(self, hit: bool) -> None:
        """One prefix-cache lookup at row admission (hit = at least one
        full prompt page reused instead of re-prefilled)."""
        with self._lock:
            if hit:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1
        self._m_prefix.labels(result="hit" if hit else "miss").inc()

    def record_page_event(self, action: str, rid: int | None = None,
                          pages: int | None = None,
                          shared: int | None = None,
                          used: int | None = None,
                          total: int | None = None) -> None:
        """One ``ev="page"`` EventLog record (see the module table); the
        stream obs.report aggregates into the paging line."""
        fields = {"ev": "page", "action": action}
        for name, v in (("rid", rid), ("pages", pages), ("shared", shared),
                        ("used", used), ("total", total)):
            if v is not None:
                fields[name] = v
        self._emit(**fields)

    def record_result(self, rid: int, status: str, bucket=None,
                      queue_s: float | None = None,
                      total_s: float | None = None,
                      ttft_s: float | None = None,
                      attempt: int = 1,
                      pages: int | None = None,
                      shared_pages: int | None = None,
                      program: str | None = None) -> None:
        with self._lock:
            if status == "ok":
                self.completed += 1
            elif status == "expired":
                self.expired += 1
            elif status == "error":
                self.errors += 1
            elif status == "shutting_down":
                self.shut_down += 1
            if total_s is not None:
                self._total_s.add(total_s)
            if queue_s is not None:
                self._queue_s.add(queue_s)
            # ttft falls back to total_s ONLY for completed results with no
            # measured first-token time (legacy streams; every current
            # scheduler stamps ttft at the final prefill dispatch);
            # expired/error requests never produced a token, and counting
            # their wait as time-to-first-token would corrupt the headline
            # percentile the serving A/Bs measure
            if ttft_s is None and status == "ok":
                ttft_s = total_s
            if ttft_s is not None:
                self._ttft_s.add(ttft_s)
        self._m_requests.labels(status=status).inc()
        self._m_prog_requests.labels(program=program or "lm",
                                     status=status).inc()
        if total_s is not None:
            self._m_total.observe(total_s)
            self._ts_observe("marlin_serve_total_seconds", total_s)
        if ttft_s is not None:
            self._m_ttft.observe(ttft_s)
            self._ts_observe("marlin_serve_ttft_seconds", ttft_s)
        if queue_s is not None:
            self._ts_observe("marlin_serve_queue_seconds", queue_s)
        fields = {"ev": "result", "rid": rid, "status": status}
        if program is not None and program != "lm":
            fields["program"] = program
        if attempt > 1:
            fields["attempt"] = attempt
        if bucket is not None:
            fields["bucket"] = list(bucket)
        if queue_s is not None:
            fields["queue_s"] = queue_s
        if ttft_s is not None:
            fields["ttft_s"] = ttft_s
        if total_s is not None:
            fields["total_s"] = total_s
        if pages is not None:
            fields["pages"] = pages
        if shared_pages is not None:
            fields["shared_pages"] = shared_pages
        self._emit(**fields)

    def snapshot(self) -> dict:
        """One aggregate dict: counters (paging hit/page fields included)
        plus decode-step occupancy mean, tokens/s over engine busy time,
        and p50/p99 total / ttft latency (None until data; percentiles
        over the uniform reservoirs)."""
        with self._lock:
            lat = self._total_s.values()
            qs = self._queue_s.values()
            tt = self._ttft_s.values()
            ss = self._step_s.values()
            dispatches = self.batches + self.steps
            occ = self._occupancy_sum + self._step_occupancy_sum
            out = {
                "submitted": self.submitted, "rejected": self.rejected,
                "expired": self.expired, "completed": self.completed,
                "errors": self.errors, "shut_down": self.shut_down,
                "retries": self.retries,
                "batches": self.batches, "steps": self.steps,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "pages_total": self.pages_total,
                "pages_used": self.pages_used,
                "pages_shared": self.pages_shared,
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "migrate_fallback": self.migrate_fallback,
                "program_steps": self.program_steps,
                "program_rows": self.program_rows,
                "swaps": self.swaps,
                "new_tokens": self.new_tokens,
                "busy_s": round(self.busy_s, 6),
                "occupancy_mean": (round(occ / dispatches, 4)
                                   if dispatches else None),
                "tok_s": (round(self.new_tokens / self.busy_s, 2)
                          if self.busy_s > 0 else None),
            }
        out["p50_total_s"] = percentile(lat, 50) if lat else None
        out["p99_total_s"] = percentile(lat, 99) if lat else None
        out["p50_queue_s"] = percentile(qs, 50) if qs else None
        out["p50_ttft_s"] = percentile(tt, 50) if tt else None
        out["p99_ttft_s"] = percentile(tt, 99) if tt else None
        out["p50_step_s"] = percentile(ss, 50) if ss else None
        return out
