"""The continuous-batching serving engine: one worker thread over the paged
KV pool, or over dense per-bucket slabs.

Counterpart of ``marlin_tpu/serving/engine.py``. :class:`ServeEngine` is the
front half of an inference stack over the LM's paged programs
(:func:`~marlin_tpu_torch.models.transformer.lm_prefill_paged` and
:func:`~marlin_tpu_torch.models.transformer.lm_decode_paged`) or, with
``paged=False``, its dense-slab control
(:func:`~marlin_tpu_torch.models.transformer.lm_prefill_slot` and
:func:`~marlin_tpu_torch.models.transformer.lm_decode_rows` over one
:class:`~.batcher.SlotPool` a bucket: whole-prompt prefill on admission, the
bucket's worst case charged at admission). A mixture-of-experts model serves
through either with ``moe=(top_k, capacity_factor, group)``: concurrent
callers ``submit`` requests; an admission gate (queue depth + in-flight
KV-cache byte budget, request.py) rejects overload with a reason; a batch
former (batcher.py) buckets prompts onto a small static shape set; and a
single worker thread keeps the device fed. Scheduling is row-level (the unit
is the slot-step, not the batch).

ONE device-resident page slab (:mod:`.kvpool` over
:func:`~marlin_tpu_torch.models.transformer.init_kv_pages`) is shared by
every bucket; each row holds a host-side block table of pages. Admission
charges the request's ACTUAL pages
(:func:`~marlin_tpu_torch.models.planner.request_pages`), completed full
prompt pages are prefix-shared copy-on-write across requests
(:class:`~.kvpool.PagedKVPool`), and long prompts prefill in bounded
``serve_prefill_chunk``-token chunks. Every worker iteration:

    refill freed rows from the queue (page allocation + prefix match —
    host-side, cheap)  →  prefill at most ``serve_prefill_chunk`` prompt
    TOKENS, oldest row first, in page-aligned chunks (a row's final chunk
    emits its first token — real TTFT)  →  retire rows that emitted
    ``eos``, hit their step budget, or expired  →  run ONE decode step per
    bucket over its live rows  →  repeat

so one long prompt can never monopolize an iteration. Exactly one Result
per request; per-row greedy output equals
:func:`~marlin_tpu_torch.models.transformer.lm_generate` on the unpadded
prompt; sampled rows draw from composition-independent
``fold_in(key(seed), step)`` streams, so a sampled row's tokens do not depend
on which rows it shared a step with.

What differs from the JAX package, and why:

- **Host reads.** The decode step's emitted tokens come to the host once
  per step (``.cpu()`` in :meth:`ServeEngine._step_paged`, after every
  bucket's step was dispatched); the final prefill chunk's first token is read
  once per row (``int(first)``). Nothing else on the path reads the card:
  block tables, positions and sampling knobs are host numpy, as in the
  reference, and the programs keep the greedy/sampled test on the host.
- **No donation.** The programs update the slab in place and an injected
  fault fires before any write, so a failed call never consumes the pool
  (:meth:`ServeEngine._paged_pool_lost` is False by design). A CUDA
  out-of-memory error drops and rebuilds the pool
  (:meth:`ServeEngine._drop_paged_pool`), as a consumed slab does in the
  reference.
- **Threads.** The worker sets its CUDA device explicitly. Every program it
  calls runs under ``torch.no_grad`` (thread-local, so each entry point
  enters it) and with TF32 off through ``ops.local.precision_scope``,
  whose gate keeps another thread's TF32 products from interleaving with a
  decode step: the engine's tokens do not depend on what other threads set.
- **No fallback.** ``decode_kernel="auto"`` is the CUDA kernel on the card;
  a failed launch fails (or retries) that bucket's rows, and never reruns
  them through ``gather``.

Cross-engine migration (:meth:`ServeEngine.freeze_rows` /
:meth:`~ServeEngine.adopt_rows` / :meth:`~ServeEngine.adopt_entries` /
:meth:`~ServeEngine.export_prefixes` / :meth:`~ServeEngine.import_prefixes`)
moves live rows between engines mid-stream through the JAX package's MGRT
blob (:mod:`.kvpool`), byte-compatible both ways; the export runs on the
freezing caller's thread after the worker has parked, every import on the
target's worker through its mailbox. Declared SLOs (``serve_slo``) build a
per-engine :class:`~marlin_tpu_torch.obs.slo.SloEngine` over a
:class:`~marlin_tpu_torch.obs.timeseries.TimeSeriesStore`, whose breaches
arm admission shedding. :class:`~.supervisor.Supervisor`,
:class:`~.router.Router` and :class:`~.fleet.FleetController` drive these
hooks; a slab engine does not migrate (``freeze_rows`` returns None,
``adopt_rows`` raises :class:`MigrationError`), as in the JAX package.

Lifecycle: ``drain()`` stops admission and completes everything already
accepted; ``close()`` stops admission, finishes the work in flight (live
and mid-prefill rows), and retires everything still queued with a clean
``shutting_down`` Result. Both are terminal and idempotent; the worker
thread (named ``marlin-serve-*``) is joined before either returns. Chaos
hooks (the port's own utils/faults.py registry): ``serve.enqueue`` fires in
``submit``; ``serve.prefill`` before each paged prefill CHUNK (a fault
fails/retries that one request and the pool stays consistent);
``serve.step`` before each slab prefill (the row being admitted);
``serve.decode_step`` before each decode step (a fault fails/retries only
that step's live rows); ``serve.program_step`` before each one-shot program
batch; ``serve.worker_crash`` once per worker iteration, outside those
envelopes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
import weakref

import numpy as np
import torch

from ..config import get_config
from ..obs import memledger, perf, trace as obs_trace
from ..obs.collectors import compile_count as _compile_count
from ..obs.exposition import (register_health_provider,
                              register_kvpool_provider,
                              register_slo_provider,
                              unregister_health_provider,
                              unregister_kvpool_provider,
                              unregister_slo_provider)
from ..obs.metrics import get_registry
from ..utils import faults
from .batcher import (BatchFormer, SlotPool, bucket_program_key,
                      capture_bucket_costs, normalize_buckets, warmup_buckets)
from .kvpool import (PagedGroup, PagedKVPool, PagePoolExhausted,
                     auto_num_pages, capture_paged_costs, paged_program_key,
                     warmup_paged)
from .metrics import ServeMetrics
from .programs import PagedLMProgram, ProgramRowSet
from .request import (SHED_REASON_PREFIX, STATUS_ERROR, STATUS_EXPIRED,
                      STATUS_OK, STATUS_REJECTED, STATUS_SHUTTING_DOWN,
                      AdmissionQueue, Request, Result, ResultHandle)

__all__ = ["ServeEngine", "MigrationError"]

class MigrationError(RuntimeError):
    """A freeze/adopt handoff could not run (lifecycle, timeout, or a
    failure on the target's worker) — the caller degrades those rows to the
    retry path."""


_engine_ids = itertools.count()
_mig_tokens = itertools.count()  # distinct migration-blob ledger names

# real-seconds cap on one condition wait under an INJECTED clock: bounds how
# stale the worker's view of a fake clock can get (tests advance it between
# polls). Real-clock engines never poll — they wait on the condition until
# notified.
_POLL_CAP_S = 0.02


class _Entry:
    """One admitted request riding through the former to a row.
    ``queue_s`` is stamped when the scheduler claims the entry. ``trace``
    is the request's span context (obs/trace.py), captured at submit and
    re-activated by the worker thread around every record the request
    produces — that cross-thread handoff is what joins one request's
    enqueue/prefill/result records into one trace in the JSONL.

    ``attempt`` counts executions of this request (1-based); a retry
    re-queues a FRESH entry via :meth:`retry` — same request, handle,
    admission cost (the reservation is carried, never re-charged), and
    original ``enq_t`` (latency is honest: it includes the failed
    attempts) — and marks this one ``superseded`` so a stale worker
    generation that still holds it can never retire it. The exactly-once
    Result is enforced twice over: superseded entries no-op in ``_retire``,
    and the admission budget is released only by whoever wins the handle's
    single ``_set``."""

    __slots__ = ("request", "handle", "bucket", "cost", "enq_t", "queue_s",
                 "trace", "attempt", "superseded")

    def __init__(self, request, handle, bucket, cost, enq_t, trace=None,
                 attempt=1):
        self.request = request
        self.handle = handle
        self.bucket = bucket
        self.cost = cost
        self.enq_t = enq_t
        self.queue_s = None
        self.trace = trace
        self.attempt = attempt
        self.superseded = False

    def retry(self) -> "_Entry":
        """The next-attempt twin (this entry becomes superseded)."""
        self.superseded = True
        return _Entry(self.request, self.handle, self.bucket, self.cost,
                      self.enq_t, trace=self.trace, attempt=self.attempt + 1)

    def attempts_left(self) -> bool:
        return self.attempt < self.request.max_attempts


def _is_cuda_oom(exc: BaseException) -> bool:
    return isinstance(exc, torch.cuda.OutOfMemoryError)


class ServeEngine:
    """Continuous-batching inference engine over a trained LM.

    ``params``/``heads``/``compute_dtype`` describe the model exactly as
    :func:`~marlin_tpu_torch.models.transformer.lm_generate` takes them (the
    port's param dict, e.g. from ``interop.lm_params_from_numpy``); the
    engine serves on the params' device. Knobs default from the global
    config: ``buckets`` (``serve_buckets``), ``max_batch``
    (``serve_max_batch``), ``queue_depth`` (``serve_queue_depth``),
    ``page_len``/``num_pages``/``prefill_chunk``/``prefix_cache``/
    ``decode_kernel`` (the ``serve_*`` knobs of the same names) and
    ``max_wait_ms`` (``serve_max_wait_ms``), which reaches the batcher as
    in the JAX engine, is refused there when negative, and is ignored:
    row-level scheduling claims work as soon as a row frees, so nothing
    waits to ripen. ``hbm_budget_bytes`` defaults to the card's
    own :func:`~marlin_tpu_torch.models.planner.usable_hbm_bytes`; on the
    CPU it defaults to 0, which disables the byte gate (there is no device
    memory to guard). ``clock`` is the engine's *policy* clock (deadlines,
    latency metrics) — injectable for deterministic tests. ``log``
    overrides the default EventLog for ``serve`` records.

    ``paged`` (``serve_paged``) picks the KV backend: the paged pool, or
    with False the dense-slab control. ``moe`` is the mixture-of-experts
    layers' ``(top_k, capacity_factor, group)``, passed to every program
    call. ``programs`` registers additional
    :class:`~.programs.BucketProgram` instances served next to LM traffic —
    requests route by ``Request.program``.

    Usable as a context manager (``close()`` on exit); ``start=False`` defers
    the worker thread so tests can stage a queue before any dispatch."""

    def __init__(self, params: dict, heads: int, *, buckets=None,
                 max_batch: int | None = None,
                 max_wait_ms: float | None = None,
                 queue_depth: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 compute_dtype: str | None = None, moe: tuple | None = None,
                 paged: bool | None = None,
                 page_len: int | None = None, num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool | None = None,
                 decode_kernel: str | None = None,
                 programs=None,
                 clock=time.monotonic, log=None, start: bool = True):
        cfg = get_config()
        self.params = params
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.moe = moe
        self.paged = bool(cfg.serve_paged if paged is None else paged)
        self.device = params["emb"].device
        self.buckets = normalize_buckets(
            cfg.serve_buckets if buckets is None else buckets)
        self.max_batch = int(cfg.serve_max_batch if max_batch is None
                             else max_batch)
        wait_ms = cfg.serve_max_wait_ms if max_wait_ms is None else max_wait_ms
        depth = int(cfg.serve_queue_depth if queue_depth is None
                    else queue_depth)
        # --- paged-pool geometry (serving/kvpool.py) -----------------------
        # decode-attention backend, resolved once ('auto' → the CUDA kernel
        # on the card, gather on the CPU) so every program key / warmup /
        # dispatch in this engine agrees on it
        from ..models.transformer import resolve_decode_kernel

        self._decode_kernel = resolve_decode_kernel(
            cfg.serve_decode_kernel if decode_kernel is None
            else decode_kernel, self.device)
        self._page_len = int(cfg.serve_page_len if page_len is None
                             else page_len)
        if self.paged and self._decode_kernel == "pallas":
            from ..ops.paged_attention import align_page_len

            self._page_len = align_page_len(self._page_len)
        self._prefill_chunk = int(cfg.serve_prefill_chunk
                                  if prefill_chunk is None else prefill_chunk)
        self._prefix_cache = bool(cfg.serve_prefix_cache
                                  if prefix_cache is None else prefix_cache)
        npages = int(cfg.serve_num_pages if num_pages is None else num_pages)
        if npages <= 0:
            npages = auto_num_pages(self.buckets, self.max_batch,
                                    self._page_len)
        self._num_pages = npages
        self._kvpool: PagedKVPool | None = None  # built lazily / on warmup
        if self.paged:
            from ..models.planner import kv_page_bytes

            self._page_bytes = kv_page_bytes(params, heads, self._page_len,
                                             compute_dtype)
        if hbm_budget_bytes is None:
            if self.device.type == "cuda":
                from ..models.planner import usable_hbm_bytes

                hbm_budget_bytes = usable_hbm_bytes(self.device)
            else:
                hbm_budget_bytes = 0
        self._clock = clock
        self._real_clock = clock is time.monotonic
        self.metrics = ServeMetrics(log=log)
        self._queue = AdmissionQueue(depth, hbm_budget_bytes)
        self._cond = threading.Condition()
        self._former = BatchFormer(self.buckets, self.max_batch,
                                   max_wait=float(wait_ms) / 1e3)
        # Request.program routing table: LM (this engine's paged path,
        # wrapped as the first BucketProgram) plus whatever the caller
        # registered. Former/pool keys for non-LM buckets are namespaced
        # (name, *bucket) tuples — a str head can never collide with LM's
        # (prompt, steps) int pairs
        self._programs: dict[str, object] = {"lm": PagedLMProgram(self)}
        for p in (programs or ()):
            if not getattr(p, "name", ""):
                raise ValueError(f"program {p!r} must set a non-empty .name")
            if p.name in self._programs:
                raise ValueError(f"duplicate program name {p.name!r}")
            self._programs[p.name] = p
        # running | draining | freezing | frozen | closing | closed —
        # freezing/frozen are the migration pause (freeze_rows): the worker
        # parks leaving its pools intact and the freezing thread takes over
        self._state = "running"
        #: worker mailbox for cross-engine migration ops (adopt_rows /
        #: export_prefixes / import_prefixes): (kind, payload, event, box)
        #: tuples serviced once per worker iteration — the pool stays
        #: single-threaded, the requester waits on the event
        self._mig_inbox: collections.deque = collections.deque()
        self._started = False
        #: True while warmup() runs the bucket programs (and builds the
        #: CUDA kernels) on the caller's thread — the supervisor's watchdog
        #: skips the stuck check meanwhile (crash detection stays on)
        self._warming = False
        eid = next(_engine_ids)
        self._name = f"marlin-serve-{eid}"
        # --- recovery ------------------------------------------------------
        # the worker generation: a recovery bumps it, spawns a fresh thread,
        # and any stale worker still unwinding exits at its next gen check
        # without touching shared state (its entries are superseded)
        self._gen = 0
        self._pools: dict[tuple, object] = {}   # current worker's groups
        self._claimed: list = []                # claimed-but-unslotted rows
        self._crash: tuple | None = None        # (exc, undone entries)
        self._on_crash = None                   # supervisor's prompt-wake cb
        self._abandoned = None                  # superseded wedged thread:
        # never joined (close() must not block on a thread that may never
        # return from its device call)
        self._idle = False                      # worker parked in cond.wait
        # EWMA of per-request service seconds (ok results, engine clock) —
        # the deadline-admission estimate's only input
        self._service_ewma = 0.0
        self._thread = self._make_thread(0)
        # --- performance introspection (obs/perf.py) -----------------------
        # the step-time black box: per-iteration records from the worker
        # loop, dumped on worker faults, on close, and via GET /debug/flight
        self.flight = perf.FlightRecorder(name=self._name)
        self._heartbeat: float | None = None  # real clock; worker stamps it
        self._live_rows = 0                   # worker-written, healthz-read
        self._prog_keys: dict[tuple, str] = {}
        # per-bucket measured-peak admission ratio (obs/memledger.py),
        # resolved once on first admission to that bucket
        self._calib_ratios: dict[tuple, float] = {}
        self._finalized = False
        # readiness: /healthz reports this engine's lifecycle and 503s once
        # it leaves "accepting" (weakref — the provider must never pin a
        # dead engine; terminal close/drain unregister explicitly)
        ref = weakref.ref(self)
        name = self._name

        def _health():
            eng = ref()
            if eng is None:
                unregister_health_provider(name)
                return None
            return eng._health_info()

        def _kvpool_report():
            eng = ref()
            if eng is None:
                unregister_kvpool_provider(name)
                return None
            return eng.kvpool_audit()

        register_health_provider(name, _health)
        if self.paged:
            register_kvpool_provider(name, _kvpool_report)
        # --- serving SLOs (obs/slo.py + obs/timeseries.py) -----------------
        # built only when objectives are configured (serve_slo) — otherwise
        # the hot path carries one None check per worker iteration. The
        # store and the SLO engine run on THIS engine's injected clock;
        # evaluation is scrape- and worker-driven (tick is rate-limited),
        # never a new thread.
        self._slo = None
        self._ts = None
        self._ts_collector = None
        if cfg.serve_slo:
            from ..obs.slo import SloEngine, objectives_from_config
            from ..obs.timeseries import TimeSeriesStore, install_collector

            self._ts = TimeSeriesStore(
                window_s=float(cfg.serve_ts_window_s),
                bucket_s=float(cfg.serve_ts_bucket_s), clock=clock)
            self.metrics.attach_timeseries(self._ts)
            self._slo = SloEngine(objectives_from_config(cfg), self._ts,
                                  scope=self._name, log=log, clock=clock)
            # scrape-driven pump, restricted to the objectives' families
            # (the registry is process-global, the store a bounded
            # per-engine ring)
            self._ts_collector = install_collector(
                self._ts, only=self._slo.pump_families)
            if cfg.serve_slo_shed:
                # graceful degradation: a breach arms admission shedding at
                # level = number of breached objectives; clear disarms.
                # In-flight work is never touched.
                slack = float(cfg.serve_slo_shed_slack_s)

                def _on_breach(ev, _q=self._queue, _slack=slack):
                    breached = ev.get("breached") or ()
                    if breached:
                        _q.set_shed(len(breached),
                                    reason=",".join(breached),
                                    protect_slack_s=_slack)
                    else:
                        _q.clear_shed()

                self._slo.add_breach_hook(_on_breach)

            def _slo_report():
                eng = ref()
                if eng is None:
                    unregister_slo_provider(name)
                    return None
                return eng._slo_payload()

            register_slo_provider(name, _slo_report)
        if start:
            self.start()

    # ------------------------------------------------------------- lifecycle

    def _make_thread(self, gen: int) -> threading.Thread:
        """A worker thread for one generation. Restarted generations keep
        the ``marlin-serve`` prefix (thread-leak checks and the flight
        recorder key on it) with a ``-r<gen>`` suffix."""
        name = self._name if gen == 0 else f"{self._name}-r{gen}"
        return threading.Thread(target=self._run, args=(gen,), daemon=True,
                                name=name)

    def start(self) -> None:
        """Start the worker thread (idempotent; no-op once shutting down)."""
        with self._cond:
            if self._started or self._state != "running":
                return
            self._started = True
        self._thread.start()

    def warmup(self) -> int:
        """Run every bucket's programs once before traffic: the chunked
        prefill + decode pair per bucket plus the page copy, against THIS
        engine's pool (kvpool.warmup_paged), or in slab mode the slot
        prefill + decode pair over a throwaway slab
        (batcher.warmup_buckets). Builds the CUDA kernels and warms the
        allocator, and records each bucket's cost models. Call before the
        first submit — warmup drives the live pool. Returns the buckets
        warmed."""
        self._warming = True
        try:
            if self.paged:
                with self._cond:  # never race a worker's lazy pool creation
                    pool = self._ensure_kvpool()
                n = warmup_paged(self.params, self.heads, self.buckets,
                                 self.max_batch, pool, self._prefill_chunk,
                                 self.compute_dtype, self.moe,
                                 kernel=self._decode_kernel)
            else:
                n = warmup_buckets(self.params, self.heads, self.buckets,
                                   self.max_batch, self.compute_dtype,
                                   self.moe)
            for name, prog in self._programs.items():
                if name != "lm":  # LM ran above against the live pool
                    n += prog.warmup()
            return n
        finally:
            self._warming = False

    def swap_model(self, program: str, model) -> None:
        """Atomically install new weights on a resident BucketProgram.
        Raises for an unknown program or one without a ``swap_model`` hook;
        on success records one ``ev="swap"`` event +
        ``marlin_serve_program_swaps_total{program}``."""
        prog = self._programs.get(program)
        if prog is None:
            raise ValueError(
                f"unknown program {program!r} (this engine serves "
                f"{sorted(self._programs)})")
        hook = getattr(prog, "swap_model", None)
        if hook is None:
            raise ValueError(
                f"program {program!r} has no swap_model hook")
        hook(model)
        self.metrics.record_swap(program)

    def pending(self) -> int:
        """Requests admitted but not yet retired (queued + in flight)."""
        return self._queue.count

    # ------------------------------------------------------- introspection

    def _health_info(self) -> dict:
        """The /healthz readiness payload for this engine: lifecycle state
        (``accepting`` while running), live slot rows, queue depth, and the
        worker heartbeat age (None until the worker's first iteration).
        Lock-free reads of GIL-atomic fields — the probe must never contend
        with the worker."""
        state = {"running": "accepting", "draining": "draining",
                 "freezing": "draining", "frozen": "draining",
                 "closing": "closed", "closed": "closed"}[self._state]
        hb = self._heartbeat
        return {
            "state": state,
            "live_slots": self._live_rows,
            "queue_depth": self._queue.count,
            "worker_started": self._started,
            "heartbeat_age_s": (round(time.monotonic() - hb, 3)
                                if hb is not None else None),
        }

    def _slo_payload(self) -> dict | None:
        """The ``GET /debug/slo`` scope payload for this engine: the SLO
        engine's evaluation (ticked on the probe, so a scrape always sees
        a fresh-enough verdict without any poller thread) plus the health
        block and paged-pool gauges the ops console renders as topology.
        None when no objectives are configured (the provider prunes)."""
        slo = self._slo
        if slo is None:
            return None
        try:
            slo.tick(self._clock())
            p = slo.payload()
        except Exception:  # the probe must never 500
            return None
        p["health"] = self._health_info()
        m = self.metrics
        p["pages"] = {"total": m.pages_total, "used": m.pages_used,
                      "shared": m.pages_shared}
        p["shed_level"] = self._queue.shed_level
        p["shed_count"] = self._queue.shed_count
        return p

    def _prog_key(self, bucket) -> str:
        """The roofline-accounting key for this engine's programs at one
        bucket (cached — it sits on the per-step path)."""
        key = self._prog_keys.get(bucket)
        if key is None:
            if self.paged:
                key = paged_program_key(self.params, bucket, self.max_batch,
                                        self._page_len, self.compute_dtype,
                                        self._decode_kernel)
            else:
                key = bucket_program_key(self.params, bucket, self.max_batch,
                                         self.compute_dtype)
            self._prog_keys[bucket] = key
        return key

    def _calibrate_cost(self, request, pbucket, cost: int) -> int:
        """Measured-peak admission calibration (obs/memledger.py): scale
        the planner's per-bucket charge by the measured peak/planner ratio
        for this bucket's program key — 1.0 unless a peak was measured in
        this process for exactly this program. LM only; the ratio resolves
        once per bucket and is cached."""
        if request.program != "lm":
            return cost
        ratio = self._calib_ratios.get(pbucket)
        if ratio is None:
            from .batcher import bucket_kv_bytes

            planner = bucket_kv_bytes(self.params, self.heads, pbucket,
                                      self.compute_dtype,
                                      batch=self.max_batch)
            programs = (("lm_prefill_paged", "lm_decode_paged")
                        if self.paged
                        else ("lm_prefill_slot", "lm_decode_rows"))
            ratio = memledger.admission_ratio(planner, programs,
                                              self._prog_key(pbucket))
            self._calib_ratios[pbucket] = ratio
        return int(cost * ratio) if ratio != 1.0 else cost

    def _ensure_kvpool(self) -> PagedKVPool:
        """The engine's one paged pool, built lazily (warmup or the first
        admission) and rebuilt zeroed after a recovery or a dropped pool."""
        pool = self._kvpool
        if pool is None:
            # single-writer — the pool pointer belongs to the live scheduler
            # generation; _recover/close swap it only after the worker they
            # superseded has stopped dispatching
            pool = self._kvpool = PagedKVPool(
                self.params, self.heads, self._num_pages, self._page_len,
                self.compute_dtype, self._prefix_cache)
            self.metrics.record_pages(pool.capacity, 0, 0)
            # account the slab in the process memory ledger: the free rides
            # every drop path (recovery, pool drop, terminal close), so a
            # rebuild re-registers the same name without double-counting
            led = memledger.get_ledger()
            led.free(f"kvpool:{self._name}", strict=False)
            led.register(f"kvpool:{self._name}",
                         self._num_pages * self._page_bytes, "kvpool",
                         owner=self._name)
        return pool

    def _record_pages(self, pool) -> None:
        st = pool.stats()
        self.metrics.record_pages(st["total"], st["used"], st["shared"])

    def _flight_dump(self, reason: str) -> None:
        """Dump the flight ring (never raises — rides failure paths)."""
        try:
            self.flight.dump(reason=reason)
        except Exception:
            pass

    def _finalize_obs(self) -> None:
        """Terminal observability flush (close/drain, idempotent): dump the
        flight ring and land the program-utilization snapshots
        (``kind="program"``/``ev="util"``) in the EventLog, sweep the
        memory ledger, then drop out of the /healthz and /debug/kvpool
        registries — a terminated engine must not hold the process at
        503."""
        if self._finalized:
            return
        self._finalized = True
        self._flight_dump("close")
        try:
            families = ["lm_decode_paged", "lm_prefill_paged",
                        "lm_decode_rows", "lm_prefill_slot"]
            families += [p.cost_program for n, p in self._programs.items()
                         if n != "lm" and p.cost_program]
            for prog in dict.fromkeys(families):
                perf.get_program_costs().emit(prog)
        except Exception:
            pass
        try:
            memledger.get_ledger().free_owner(self._name)
            memledger.emit_snapshot()
        except Exception:
            pass
        unregister_health_provider(self._name)
        unregister_kvpool_provider(self._name)
        unregister_slo_provider(self._name)
        if self._ts_collector is not None:
            get_registry().remove_collector(self._ts_collector)
            self._ts_collector = None
        self.metrics.attach_timeseries(None)

    def _join_worker(self) -> None:
        """Join until no worker generation will run again — a supervisor
        may swap in a fresh generation mid-join (crash during drain), or be
        a poll interval away from consuming a crash stash. Terminates
        because recovery is bounded: without a supervisor a crash never
        respawns."""
        if not self._started:
            return
        waited = 0.0
        while True:
            t = self._thread
            if t is self._abandoned:
                return  # a wedged generation given up on: joining would
                # hang shutdown, and everything it held was already retired
            try:
                t.join()
            except RuntimeError:
                # a recovery publishes the fresh generation's thread under
                # the lock but starts it only after releasing it; joining
                # inside that window raises "cannot join thread before it
                # is started" — yield and re-join once the starter runs
                time.sleep(0.001)
                continue
            with self._cond:
                if self._thread is not t:
                    waited = 0.0
                    continue  # a recovery swapped in a new generation
                if (self._on_crash is not None and self._crash is not None
                        and self._state in ("running", "draining")):
                    recovery_pending = True  # stashed, not yet respawned
                else:
                    return
            if recovery_pending:
                if waited >= 5.0:
                    # an attached supervisor that never consumed the stash:
                    # return and let the caller's _fail_crash_stash resolve
                    # everything the dead worker held
                    return
                time.sleep(0.005)
                waited += 0.005

    def _fail_crash_stash(self, reason: str) -> None:
        """Retire whatever a crashed, never-recovered worker was holding
        (drain/close before a supervisor recovered it) — the shutdown path
        must strand nothing."""
        with self._cond:
            crash = self._crash
            self._crash = None
        if crash is None:
            return
        for e in crash[1]:
            if not e.handle.done():
                self._retire(e, Result(e.request.rid, STATUS_ERROR,
                                       reason=reason))

    def drain(self) -> None:
        """Graceful stop: no new admissions (post-drain submits resolve
        ``shutting_down``), but everything already accepted — queued and in
        flight — completes. Terminal: the worker exits and is joined before
        this returns."""
        self._queue.close("engine draining (no new admissions)")
        self.start()  # a never-started engine still owes queued results
        with self._cond:
            if self._state == "running":
                self._state = "draining"
            self._cond.notify_all()
        self._join_worker()
        self._fail_mig_inbox("engine drained before servicing migration")
        self._fail_crash_stash("serving worker died while draining")
        with self._cond:
            self._state = "closed"
            leftovers = self._former.take_all()
        for e in leftovers:
            # only reachable when the last worker generation died with no
            # supervisor left to respawn one — queued work still resolves
            self._retire(e, Result(e.request.rid, STATUS_ERROR,
                                   reason="serving worker lost while "
                                          "draining"))
        self._finalize_obs()

    def close(self) -> None:
        """Fast stop: no new admissions, the rows in flight complete, and
        every still-queued request is retired with a clean
        ``shutting_down`` Result (never silently dropped). Idempotent."""
        self._queue.close("engine shutting down")
        with self._cond:
            if self._state == "closed":
                return
            self._state = "closing"
            leftovers = self._former.take_all()
            self._cond.notify_all()
        for e in leftovers:
            self._retire(e, Result(
                e.request.rid, STATUS_SHUTTING_DOWN,
                reason="engine closed before this request was scheduled"))
        self._join_worker()
        self._fail_mig_inbox("engine closed before servicing migration")
        self._fail_crash_stash("serving worker died; engine closed before "
                               "recovery")
        with self._cond:
            self._state = "closed"
        self._finalize_obs()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- admission

    def submit(self, request: Request) -> ResultHandle:
        """Admit one request. Always returns a handle that will carry exactly
        one Result; overload / no-bucket / past-deadline submissions resolve
        immediately with ``rejected`` / ``expired`` status and a reason.

        Opens the request's span (a child of the caller's active span when
        there is one, else a fresh trace root), so every record the request
        ever produces — here and on the worker thread — shares one
        ``trace_id``."""
        ctx = obs_trace.child_of_current(f"serve.request.{request.rid}")
        with obs_trace.use(ctx):
            return self._submit(request, ctx)

    def _submit(self, request: Request, ctx) -> ResultHandle:
        faults.fire("serve.enqueue", path=str(request.rid))
        handle = ResultHandle(request)
        now = self._clock()
        prog = self._programs.get(request.program)
        if prog is None:
            return self._refuse(handle, STATUS_REJECTED, (
                f"unknown program {request.program!r} (this engine serves "
                f"{sorted(self._programs)})"))
        why = prog.validate(request)
        if why is not None:
            return self._refuse(handle, STATUS_REJECTED, why)
        pbucket = prog.pick_bucket(request)
        if pbucket is None:
            return self._refuse(handle, STATUS_REJECTED,
                                prog.refuse_no_bucket(request))
        # former/pool key: LM keeps its bare (prompt, steps) tuple; other
        # programs namespace theirs under their name
        bucket = (pbucket if request.program == "lm"
                  else (prog.name,) + tuple(pbucket))
        # resolve the relative/default deadline to an absolute engine-clock
        # one, ONCE — a worker restart must not hand the request a fresh
        # budget
        if request.deadline is None:
            rel = request.deadline_s
            if rel is None:
                rel = get_config().serve_default_deadline_s
            if rel is not None:
                request.deadline = now + float(rel)
                request.deadline_s = None
        if request.deadline is not None and request.deadline <= now:
            return self._refuse(handle, STATUS_EXPIRED, (
                f"deadline {request.deadline} already passed at submission "
                f"(now {now})"))
        # deadline-aware admission: with service history (EWMA of ok
        # per-request seconds), a request whose projected completion behind
        # the current queue already overshoots its deadline is refused NOW
        if request.deadline is not None and self._service_ewma > 0.0:
            projected = now + self._service_ewma * (
                1.0 + self._queue.count / self.max_batch)
            if projected > request.deadline:
                return self._refuse(handle, STATUS_REJECTED, (
                    f"deadline unmeetable: projected completion {projected:.3f}"
                    f" > deadline {request.deadline:.3f} at queue depth "
                    f"{self._queue.count} (service est "
                    f"{self._service_ewma:.3f}s)"))
        # the program prices its own resource units (LM: actual KV pages)
        # against the one shared admission budget; a capacity refusal (e.g.
        # more pages than the pool holds) raises the reason
        try:
            cost = prog.admission_cost(request, pbucket)
        except ValueError as exc:
            return self._refuse(handle, STATUS_REJECTED, str(exc))
        if get_config().serve_admission_calibration:
            cost = self._calibrate_cost(request, pbucket, cost)
        reason = self._queue.try_admit(
            cost, priority=request.priority,
            deadline_slack_s=(request.deadline - now
                              if request.deadline is not None else None))
        if reason is not None:
            # a drain/close-shut gate is a deterministic shutting_down
            # Result; overload stays a rejection with the backpressure
            # reason. Matching the RETURNED reason keeps a "queue full"
            # verdict that raced a concurrent drain labeled as what it was
            if reason == self._queue.closed_reason:
                return self._refuse(handle, STATUS_SHUTTING_DOWN, reason)
            if (self._slo is not None
                    and reason.startswith(SHED_REASON_PREFIX)):
                self._slo.record_shed()
            return self._refuse(handle, STATUS_REJECTED, reason)
        entry = _Entry(request, handle, bucket, cost, now, trace=ctx)
        with self._cond:
            if self._state != "running":
                admitted = False
            else:
                self._former.add(entry)
                if self._idle:
                    # an IDLE worker's heartbeat is legitimately old (it
                    # blocks in cond.wait): restart the window at admission
                    self._heartbeat = time.monotonic()
                self._cond.notify_all()
                admitted = True
        if not admitted:  # raced with drain()/close(): resolve, don't strand
            self._queue.release(cost)
            return self._refuse(handle, STATUS_SHUTTING_DOWN,
                                "engine is shutting down")
        self.metrics.record_enqueue(request.rid, bucket, self._queue.count,
                                    program=request.program)
        self.metrics.record_queue(self._queue.count,
                                  self._queue.bytes_in_flight)
        return handle

    def submit_many(self, requests) -> list[ResultHandle]:
        return [self.submit(r) for r in requests]

    def _refuse(self, handle, status: str, reason: str) -> ResultHandle:
        handle._set(Result(handle.request.rid, status, reason=reason))
        if status == STATUS_REJECTED:
            self.metrics.record_reject(handle.request.rid, reason,
                                       program=handle.request.program)
        else:
            self.metrics.record_result(handle.request.rid, status,
                                       program=handle.request.program)
        return handle

    # ----------------------------------------------------------- worker loop

    def _run(self, gen: int = 0) -> None:
        if self.device.type == "cuda":
            # the current device is per thread: the worker's launches and
            # allocations must land on the params' card whatever the
            # process default is
            torch.cuda.set_device(self.device)
        if self.paged:
            self._run_paged(gen)
        else:
            self._run_rowlevel(gen)

    def _crash_handler(self, exc: BaseException, held: list,
                       gen: int) -> bool:
        """A worker generation is dying with ``held`` entries in hand.
        Supervised (``_on_crash`` installed, engine still serving): stash
        the undone entries for :meth:`_recover`, kick the supervisor, and
        return True — the worker exits quietly and the engine KEEPS
        accepting. Unsupervised: fail everything held plus the queued
        backlog with ``error`` Results so no submitter is ever stranded,
        and return False so the thread log still sees the exception. A
        SUPERSEDED generation dying late exits quietly without stashing —
        its entries were already requeued or failed by the recovery that
        superseded it."""
        cb = leftovers = None
        with self._cond:
            if self._gen != gen:
                return True  # stale straggler: recovery already ran
            undone = []
            seen = set()
            for e in held:
                if id(e) in seen or e.handle.done() or e.superseded:
                    continue
                seen.add(id(e))
                undone.append(e)
            # "freezing" counts as supervised: freeze_rows() itself consumes
            # the stash (the crashed rows ride the migration fallback) — a
            # fail-everything here would break exactly-once for rows the
            # freeze is about to hand to another replica
            supervised = ((self._on_crash is not None
                           and self._state in ("running", "draining"))
                          or self._state == "freezing")
            if supervised:
                self._crash = (exc, undone)
                cb = self._on_crash
            else:
                leftovers = self._former.take_all()
                self._state = "closing"
            self._claimed = []
        self._flight_dump("worker-died")
        if supervised:
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass
            return True
        for e in leftovers + undone:
            if not e.handle.done():
                self._retire(e, Result(e.request.rid, STATUS_ERROR,
                                       reason="serving worker died"))
        return False

    def _retire(self, entry: _Entry, result: Result) -> None:
        if entry.superseded:
            return  # a retried twin owns this request (and its budget) now
        if entry.attempt > 1:
            result.metrics.setdefault("attempt", entry.attempt)
        try:
            entry.handle._set(result)
        except RuntimeError:
            # lost the exactly-once race to a stale worker generation's
            # twin — the winner released the budget and recorded the result
            return
        self._queue.release(entry.cost)
        if result.status == STATUS_OK:
            total = result.metrics.get("total_s")
            if total is not None:
                # EWMA of per-request SERVICE time — total minus queue wait
                # (the deadline projection multiplies this by the queue
                # depth, so feeding total_s would count queueing twice)
                svc = max(total - (result.metrics.get("queue_s") or 0.0),
                          0.0)
                self._service_ewma = (svc if self._service_ewma == 0.0
                                      else 0.8 * self._service_ewma
                                      + 0.2 * svc)
        # re-activate the request's span on whichever thread retires it, so
        # the result record joins the request's trace
        with obs_trace.use(entry.trace):
            self.metrics.record_result(
                result.rid, result.status,
                bucket=result.metrics.get("bucket"),
                queue_s=result.metrics.get("queue_s"),
                total_s=result.metrics.get("total_s"),
                ttft_s=result.metrics.get("ttft_s"),
                attempt=entry.attempt,
                pages=result.metrics.get("pages"),
                shared_pages=result.metrics.get("shared_pages"),
                program=entry.request.program)
        self.metrics.record_queue(self._queue.count,
                                  self._queue.bytes_in_flight)

    # --------------------------------------------------- the program lane

    @staticmethod
    def _is_program_bucket(bucket) -> bool:
        """True for a namespaced (name, *bucket) program key — the one
        type test that routes a former bucket to the program lane (LM
        buckets are bare (prompt, steps) int tuples)."""
        return (isinstance(bucket, tuple) and bool(bucket)
                and isinstance(bucket[0], str))

    def _claim_rowlevel(self, pools) -> list[_Entry]:
        """Claim queued entries for free rows, per bucket (called under the
        engine lock; prefill happens outside it). Program buckets claim up
        to their program's padded width instead of the LM max_batch."""
        claimed = []
        for bucket in self._former.pending_buckets():
            pool = pools.get(bucket)
            if pool is not None:
                free = len(pool.free_slots())
            elif self._is_program_bucket(bucket):
                prog = self._programs.get(bucket[0])
                free = prog.width if prog is not None else self.max_batch
            else:
                free = self.max_batch
            if free:
                claimed.extend(self._former.take_for_bucket(bucket, free))
        return claimed

    def _admit_program_rows(self, pools, claimed) -> None:
        """Bind claimed program entries to :class:`ProgramRowSet` slots —
        host-side only; a one-shot program's device work happens in
        :meth:`_step_program_rows`. Dispatch order matches the paged
        admit: priority first, then arrival."""
        if not claimed:
            return
        claimed = sorted(claimed,
                         key=lambda e: (-e.request.priority, e.request.rid))
        for e in claimed:
            with obs_trace.use(e.trace):
                now = self._clock()
                r = e.request
                prog = self._programs.get(e.bucket[0])
                if prog is None:
                    self._retire(e, Result(
                        r.rid, STATUS_ERROR,
                        reason=f"program {e.bucket[0]!r} is not registered "
                               f"on this engine",
                        metrics={"bucket": e.bucket,
                                 "queue_s": now - e.enq_t,
                                 "total_s": now - e.enq_t}))
                    continue
                if r.deadline is not None and r.deadline <= now:
                    self._retire(e, Result(
                        r.rid, STATUS_EXPIRED,
                        reason=f"deadline {r.deadline} passed before "
                               f"dispatch (dispatched at {now})",
                        metrics={"bucket": e.bucket,
                                 "queue_s": now - e.enq_t,
                                 "total_s": now - e.enq_t}))
                    continue
                e.queue_s = now - e.enq_t
                rows = pools.get(e.bucket)
                if rows is None:
                    rows = pools[e.bucket] = ProgramRowSet(e.bucket,
                                                           prog.width)
                rows.assign(rows.free_slots()[0], e)
        self._live_rows = sum(len(g.live_slots()) for g in pools.values())

    def _step_program_rows(self, pools) -> None:
        """One batched call per program bucket with live rows: expire stale
        rows, pad the rest to the program's smallest fitting width,
        execute, retire everything with its value — the one-shot analog of
        a decode step, interleaved with LM prefill chunks and decode steps
        in the same worker iteration."""
        for bucket, rows in list(pools.items()):
            if not isinstance(rows, ProgramRowSet):
                continue
            prog = self._programs[bucket[0]]
            now = self._clock()
            for i in rows.occupied_slots():
                dl = rows.entries[i].request.deadline
                if dl is not None and dl <= now:
                    self._retire_program_row(
                        rows, i, STATUS_EXPIRED, now,
                        reason=f"deadline {dl} passed before the program "
                               f"step (now {now})")
            live = rows.occupied_slots()
            if not live:
                continue
            entries = [rows.entries[i] for i in live]
            pkey = prog.program_key(bucket[1:],
                                    prog.step_width(len(entries)))
            try:
                faults.fire("serve.program_step",
                            path=f"{bucket[0]}-{len(entries)}")
                t0 = time.perf_counter()
                values = prog.step(bucket[1:],
                                   [e.request for e in entries])
            except Exception as exc:
                self._fail_program_rows(rows, exc)
                continue
            wall = time.perf_counter() - t0
            self.metrics.record_step(
                bucket, len(live), rows.width, wall, program_key=pkey,
                program=prog.cost_program, label=bucket[0])
            self.flight.record(
                "step", bucket=list(bucket), rows=len(live), seconds=wall,
                queue_depth=self._queue.count, compiles=_compile_count())
            now = self._clock()
            for i, val in zip(live, values):
                self._retire_program_row(rows, i, STATUS_OK, now, value=val)
        self._live_rows = sum(len(g.live_slots()) for g in pools.values())

    def _retire_program_row(self, rows, slot: int, status: str, now: float,
                            value=None, reason: str = "") -> None:
        """Retire one program row and free its slot (the exactly-once
        release runs in :meth:`_retire` as for every other row). A one-shot
        answer IS the first output, so ``ttft_s`` equals ``total_s``."""
        e = rows.entries[slot]
        metrics = {"bucket": rows.bucket, "slot": slot, "queue_s": e.queue_s,
                   "ttft_s": now - e.enq_t, "total_s": now - e.enq_t}
        if status == STATUS_OK:
            result = Result(e.request.rid, STATUS_OK, value=value,
                            metrics=metrics)
        else:
            result = Result(e.request.rid, status, reason=reason,
                            metrics=metrics)
        rows.release(slot)
        self._retire(e, result)

    def _fail_program_rows(self, rows, exc: Exception) -> None:
        """A program step died: rows with attempt budget left requeue for
        a transparent retry; the rest fail with error Results — only this
        bucket's rows are touched."""
        reason = f"program step failed: {type(exc).__name__}: {exc}"
        self.flight.record("program_fault", bucket=list(rows.bucket),
                           rows=len(rows.occupied_slots()), error=reason,
                           queue_depth=self._queue.count,
                           compiles=_compile_count())
        now = self._clock()
        for i in rows.occupied_slots():
            e = rows.entries[i]
            if e.attempts_left():
                rows.release(i)
                self._requeue(e, reason)
            else:
                self._retire_program_row(rows, i, STATUS_ERROR, now,
                                         reason=reason)
        self._flight_dump("program-step-failed")

    def _requeue(self, entry: _Entry, reason: str) -> None:
        """Park a failed attempt back in the former for its next attempt
        (the caller checked ``attempts_left``). The admission reservation
        is CARRIED — never released, never re-charged. On a shutting-down
        engine the retry would never be claimed, so it retires with the
        failure instead of stranding."""
        twin = entry.retry()
        with self._cond:
            requeued = self._state in ("running", "draining")
            if requeued:
                self._former.add(twin)
                self._cond.notify_all()
        if not requeued:
            self._retire(twin, Result(
                twin.request.rid, STATUS_ERROR,
                reason=f"{reason} (engine shutting down before retry)"))
            return
        with obs_trace.use(entry.trace):
            self.metrics.record_retry(entry.request.rid, twin.attempt,
                                      entry.request.max_attempts, reason)

    # ------------------------------------------------- supervised recovery

    def attach_supervisor(self, on_crash) -> None:
        """Install a supervisor's crash kick: while set, a dying worker
        stashes its undone entries for :meth:`_recover` instead of failing
        them, and calls ``on_crash()`` so recovery starts promptly."""
        self._on_crash = on_crash

    def detach_supervisor(self) -> None:
        self._on_crash = None

    def _recover(self, reason: str, respawn: bool = True) -> dict:
        """Recover from a dead or stuck worker generation: supersede it
        (``_gen`` bump — a stale thread exits at its next check and can
        never retire a superseded entry), requeue every undone in-flight
        entry within its attempt budget (the rest fail with ``error``),
        drop the page pool — its block tables and prefix cache died with
        the worker; it rebuilds zeroed on the next admission — or the slot
        pools of a slab engine, likewise, and spawn a fresh worker thread. Queued (former) entries are untouched.
        ``respawn=False`` is the terminal path: supersede and fail
        everything held, mark the old thread abandoned, and spawn nothing.
        Returns counts for the caller's record."""
        failed, twins = [], []
        with self._cond:
            self._gen += 1
            gen = self._gen
            alive = respawn and self._state in ("running", "draining")
            if self._crash is not None:
                stash = list(self._crash[1])
                self._crash = None
            else:
                # stuck path: steal what the stale (still-alive) worker
                # holds — its pools/claimed mirrors, snapshotting each list
                # (the straggler mutates entries WITHOUT this lock)
                stash = [e for p in self._pools.values()
                         for e in list(p.entries) if e is not None]
                stash += list(self._claimed)
            # the slab state died with the worker: the slot pools rebuild
            # zeroed on the fresh generation's first admissions
            for bucket, p in self._pools.items():
                if isinstance(p, SlotPool):
                    memledger.get_ledger().free(self._slab_name(bucket),
                                                strict=False)
            self._pools = {}
            self._claimed = []
            if self._kvpool is not None:
                memledger.get_ledger().free(f"kvpool:{self._name}",
                                            strict=False)
            self._kvpool = None
            seen = set()
            for e in stash:
                if id(e) in seen or e.handle.done() or e.superseded:
                    continue
                seen.add(id(e))
                if alive and e.attempts_left():
                    twin = e.retry()
                    self._former.add(twin)
                    twins.append(twin)
                else:
                    failed.append(e)
            if alive:
                self._thread = self._make_thread(gen)
            elif not respawn:
                self._abandoned = self._thread
            started = self._started
            self._heartbeat = time.monotonic()
            self._cond.notify_all()
        for e in failed:
            self._retire(e, Result(
                e.request.rid, STATUS_ERROR,
                reason=f"worker lost and attempt budget exhausted: "
                       f"{reason}"))
        for t in twins:
            with obs_trace.use(t.trace):
                self.metrics.record_retry(t.request.rid, t.attempt,
                                          t.request.max_attempts, reason)
        self._live_rows = 0
        if alive and started:
            self._thread.start()
        return {"gen": gen, "requeued": len(twins), "failed": len(failed)}

    # ------------------------------------------------ cross-engine migration

    def _device_scope(self):
        """The engine's CUDA device as the calling thread's current one (a
        no-op on the CPU): the freezing caller's export reads the slab from
        its own thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def freeze_rows(self) -> dict | None:
        """Pause this engine at a step boundary and take ownership of every
        resident row for migration: admission closes, the worker parks at
        its next iteration top (state ``freezing`` — pools left intact),
        and the caller thread exports each row's KV pages + cursors into a
        CRC-framed host blob (:meth:`PagedKVPool.export_rows`).

        Returns ``{"engine", "blob", "entries", "queued", "fallback",
        "ledger_token"}``: ``entries`` maps rid → the live in-process
        ``_Entry`` (handle + admission reservation — both travel with the
        row, the blob only carries device/cursor state); ``queued`` is the
        former backlog (never started — moved wholesale, no retry twin);
        ``fallback`` is rows that could not export (a ``serve.migrate``
        export fault, or a worker crash mid-freeze — the pool is not
        trusted after one) and must ride the retry path. Returns None when
        the engine is already terminal — the caller falls back to a plain
        drain; so does a slab engine, which has no blob to export. Terminal
        either way once it returns a dict: the worker has exited and the
        router closes the engine next."""
        if not self.paged:
            return None
        self._queue.close("engine freezing for migration")
        with self._cond:
            if self._state not in ("running", "draining"):
                return None
            self._state = "freezing"
            self._cond.notify_all()
        self._join_worker()
        self._fail_mig_inbox("engine froze for migration")
        with self._cond:
            crash = self._crash
            self._crash = None
            pools = dict(self._pools)
            pool = self._kvpool
            queued = self._former.take_all()
        entries: dict = {}
        rows: list[dict] = []
        fallback: list = []
        seen: set[int] = set()

        def _viable(e) -> bool:
            if (e is None or id(e) in seen or e.superseded
                    or e.handle.done()):
                return False
            seen.add(id(e))
            return True

        if crash is not None:
            # the worker died mid-freeze: the pool is not trusted — export
            # nothing, every stashed row rides the retry fallback
            for e in crash[1]:
                if _viable(e):
                    fallback.append(e)
        else:
            for bucket, group in pools.items():
                if isinstance(group, ProgramRowSet):
                    # one-shot program rows have no KV state to export: the
                    # program's freeze hook may veto, otherwise they ride
                    # the fallback lane and re-execute on the target
                    # (exactly-once is the handle's, not the row's)
                    prog = self._programs.get(bucket[0])
                    for slot in group.occupied_slots():
                        e = group.entries[slot]
                        if not _viable(e):
                            continue
                        if prog is not None:
                            prog.freeze(e)
                        fallback.append(e)
                    continue
                for slot in group.occupied_slots():
                    e = group.entries[slot]
                    if not _viable(e):
                        continue
                    try:
                        faults.fire(
                            "serve.migrate",
                            path=f"export:{e.request.rid}@{self._name}")
                        rows.append(self._export_row(group, bucket, slot))
                        entries[e.request.rid] = e
                    except Exception:
                        fallback.append(e)
        blob = None
        if rows and pool is not None:
            try:
                with self._device_scope():
                    blob = pool.export_rows(rows)
                self.metrics.record_migration("export", len(rows))
            except Exception:
                # the blob never materialized: every exported row falls
                # back to the retry path
                fallback.extend(entries.values())
                entries = {}
        token = None
        if blob is not None:
            # the frozen blob is migration bytes in flight: credit it to
            # this engine until the adopt side consumes it (adopt_rows
            # transfers ownership to the target, then debits exactly once;
            # a never-adopted blob is swept by _finalize_obs's free_owner)
            token = f"migration:{self._name}:{next(_mig_tokens)}"
            memledger.get_ledger().register(token, len(blob), "migration",
                                            owner=self._name)
        with self._cond:
            self._state = "frozen"
        self._flight_dump("freeze")
        return {"engine": self, "blob": blob, "entries": entries,
                "queued": list(queued), "fallback": fallback,
                "ledger_token": token}

    def _export_row(self, group, bucket, slot: int) -> dict:
        """One row's migration manifest: block table (position order),
        cursors, host token stream, and sampling state — everything
        :meth:`PagedGroup.restore` needs for a bit-identical resume. The
        keys, their order and their int/float types are the JAX package's
        (the meta chunk is this dict's ``json.dumps``)."""
        e = group.entries[slot]
        return {
            "rid": e.request.rid,
            "bucket": [int(b) for b in bucket],
            "prompt": np.asarray(e.request.prompt, np.int32).tolist(),
            "pages": [int(p) for p in (group.row_pages[slot] or [])],
            "length": int(group.lengths[slot]),
            "position": int(group.positions[slot]),
            "steps_done": int(group.steps_done[slot]),
            "cur_tok": int(group.cur_tok[slot]),
            "pf_next": int(group.pf_next[slot]),
            "n_shared": int(group.shared_pages[slot]),
            "emitted": [int(t) for t in (group.emitted[slot] or [])],
            "seed": int(e.request.seed),
            "temperature": float(group.temperature[slot]),
            "top_p": float(group.top_p[slot]),
            "top_k": int(group.top_k[slot]),
            "ttft_s": group.ttft_s[slot],
            # the request's span context rides the manifest so an adopting
            # engine — even in another process — continues the SAME trace
            "trace": (None if e.trace is None else {
                "trace_id": e.trace.trace_id, "span_id": e.trace.span_id,
                "parent_id": e.trace.parent_id, "name": e.trace.name}),
        }

    def adopt_rows(self, frozen: dict, timeout: float | None = None) -> dict:
        """Adopt a peer's frozen row set: import the blob's KV pages into
        this engine's pool (re-deduplicating through the prefix cache) and
        resume each row mid-stream. Runs on THIS engine's worker thread via
        the migration mailbox — the pool stays single-threaded. Each row
        binds under the engine lock: its admission reservation is adopted
        (:meth:`AdmissionQueue.adopt`) at bind time and released by the
        normal retirement path, so the reservation is carried exactly once
        end to end (the caller releases the source's charge for adopted
        rids). Rows whose entry was superseded or resolved while frozen
        are dropped with their pages released. Returns ``{"adopted":
        [rids], "fallback": [entries]}``; on a worker timeout the rows
        bound so far count as adopted and the rest fall back — never
        both."""
        entries = dict(frozen["entries"])
        blob = frozen.get("blob")
        if blob is None or not entries:
            return {"adopted": [], "fallback": list(entries.values())}
        if not self.paged:
            raise MigrationError(
                f"adopt target {self._name} is not a paged engine")
        if timeout is None:
            timeout = get_config().serve_migrate_timeout_s
        box: dict = {"bound": [], "cancelled": False}
        ev = threading.Event()
        with self._cond:
            if self._state != "running" or not self._started:
                raise MigrationError(
                    f"adopt target {self._name} not accepting "
                    f"({self._state})")
            self._mig_inbox.append(
                ("adopt", {"blob": blob, "entries": entries}, ev, box))
            if self._idle:
                self._heartbeat = time.monotonic()
            self._cond.notify_all()
        # the handoff is committed: the blob's ledger entry moves to this
        # engine and is debited exactly once below, whichever way the adopt
        # resolves (the not-accepting raise above leaves it with the
        # source, so a retry against another replica still finds it)
        token = frozen.get("ledger_token")
        led = memledger.get_ledger()
        if token:
            led.transfer(token, owner=self._name)
        try:
            if not ev.wait(timeout):
                # cancel under the lock: rows not yet bound will be released
                # by the worker when it gets there; rows already bound are
                # this engine's responsibility now
                with self._cond:
                    box["cancelled"] = True
                    bound = set(box["bound"])
                return {"adopted": sorted(bound),
                        "fallback": [e for rid, e in entries.items()
                                     if rid not in bound]}
            err = box.get("error")
            if err is not None:
                if isinstance(err, MigrationError):
                    raise err
                raise MigrationError(
                    f"adopt failed on {self._name}: {type(err).__name__}: "
                    f"{err}") from err
            return box["result"]
        finally:
            if token:
                led.free(token, strict=False)

    def adopt_entries(self, entries) -> bool:
        """Queue-only handoff for migrated work WITHOUT device state — the
        frozen backlog and retry-fallback twins. Each entry's reservation
        is force-admitted (the fleet already admitted this work; the gate
        bounds new admissions only) and the entry queues normally. Returns
        False when this engine is not accepting — the caller tries the
        next replica."""
        entries = list(entries)
        if not entries:
            return True
        with self._cond:
            if self._state != "running":
                return False
            for e in entries:
                self._queue.adopt(e.cost)
                self._former.add(e)
            if self._idle:
                self._heartbeat = time.monotonic()
            self._cond.notify_all()
        self.metrics.record_queue(self._queue.count,
                                  self._queue.bytes_in_flight)
        return True

    def export_prefixes(self, n: int,
                        timeout: float | None = None) -> bytes | None:
        """The pool's N hottest prefix-cache chains as a migration blob
        (worker-mediated; best-effort — returns None instead of raising:
        cache warming must never fail a restart)."""
        if not self.paged or n <= 0:
            return None
        if timeout is None:
            timeout = get_config().serve_migrate_timeout_s
        try:
            return self._mig_post("export_prefixes", int(n), timeout)
        except MigrationError:
            return None

    def import_prefixes(self, blob: bytes | None,
                        timeout: float | None = None) -> int:
        """Warm this pool's prefix cache from a peer's exported chains
        (worker-mediated; best-effort). Returns entries inserted."""
        if not self.paged or not blob:
            return 0
        if timeout is None:
            timeout = get_config().serve_migrate_timeout_s
        try:
            return int(self._mig_post("import_prefixes", blob, timeout) or 0)
        except MigrationError:
            return 0

    def _mig_post(self, kind: str, payload, timeout: float):
        """Post one op to the worker's migration mailbox and wait."""
        box: dict = {"bound": [], "cancelled": False}
        ev = threading.Event()
        with self._cond:
            if self._state != "running" or not self._started:
                raise MigrationError(
                    f"{self._name} not accepting ({self._state})")
            self._mig_inbox.append((kind, payload, ev, box))
            if self._idle:
                self._heartbeat = time.monotonic()
            self._cond.notify_all()
        if not ev.wait(timeout):
            with self._cond:
                box["cancelled"] = True
            raise MigrationError(
                f"{kind} timed out after {timeout}s on {self._name}")
        err = box.get("error")
        if err is not None:
            raise MigrationError(
                f"{kind} failed on {self._name}: {type(err).__name__}: "
                f"{err}") from err
        return box.get("result")

    def _service_migrations(self, pool, pools, pf_queue) -> None:
        """Drain the migration mailbox on the worker thread (called once
        per iteration). Any failure lands in the requester's box — the
        worker survives every migration fault; mid-migration failure must
        degrade to the retry path, never kill the adoptive engine."""
        while True:
            with self._cond:
                if not self._mig_inbox:
                    return
                kind, payload, ev, box = self._mig_inbox.popleft()
                if box.get("cancelled"):
                    box["error"] = MigrationError("cancelled by requester")
                    ev.set()
                    continue
            try:
                if kind == "adopt":
                    box["result"] = self._mig_adopt(pool, pools, pf_queue,
                                                    payload, box)
                elif kind == "export_prefixes":
                    box["result"] = pool.export_prefixes(payload)
                elif kind == "import_prefixes":
                    faults.fire("serve.migrate", path=f"warm@{self._name}")
                    n = pool.import_prefixes(payload)
                    self._record_pages(pool)
                    box["result"] = n
                else:
                    box["error"] = MigrationError(
                        f"unknown migration op {kind!r}")
            except BaseException as exc:
                box["error"] = exc
            ev.set()

    def _mig_adopt(self, pool, pools, pf_queue, payload, box) -> dict:
        """Worker-side adopt: import the blob, then bind each row under
        the engine lock (atomic against the requester's timeout-cancel —
        a row is either bound here exactly once or reported back for the
        fallback path, never both)."""
        faults.fire("serve.migrate", path=f"import@{self._name}")
        entries = payload["entries"]
        rows = pool.import_rows(payload["blob"])
        adopted: list = []
        fallback: list = []
        for row in rows:
            rid = row["rid"]
            e = entries.get(rid)
            pages = row["pages"]
            bucket = tuple(row["bucket"])
            group = pools.get(bucket)
            if group is None and bucket in self.buckets:
                group = pools[bucket] = PagedGroup(
                    bucket, self.max_batch, self._page_len,
                    self._prefill_chunk)
                capture_paged_costs(
                    self.params, self.heads, bucket, self.max_batch,
                    pool, self._prefill_chunk, self.compute_dtype,
                    self.moe, key=self._prog_key(bucket),
                    kernel=self._decode_kernel)
            bound = False
            try:
                faults.fire("serve.migrate",
                            path=f"adopt:{rid}@{self._name}")
                with self._cond:
                    viable = (e is not None and not e.superseded
                              and not e.handle.done()
                              and not box.get("cancelled")
                              and self._state == "running")
                    free = group.free_slots() if group is not None else []
                    if viable and free:
                        slot = free[0]
                        self._queue.adopt(e.cost)
                        group.restore(slot, e, row, pages)
                        if int(row["pf_next"]) >= 0:
                            pf_queue.append((bucket, slot, rid))
                        box["bound"].append(rid)
                        bound = True
            except Exception:
                bound = False
            if bound:
                adopted.append(rid)
                # re-activate the request's trace across the hop: a cross-
                # process adopt has no live entry span, so rebuild it from
                # the manifest; either way the migration itself becomes a
                # child span, so freeze -> adopt -> result joins into one
                # trace_id
                base = e.trace
                t = row.get("trace")
                if base is None and t:
                    base = obs_trace.SpanContext(
                        t.get("trace_id"), t.get("span_id"),
                        t.get("parent_id"),
                        t.get("name") or f"serve.request.{rid}")
                if base is not None:
                    e.trace = base.child(f"serve.migrate.{rid}")
                with obs_trace.use(e.trace):
                    self.metrics.record_page_event(
                        "adopt", rid=rid, pages=len(pages),
                        shared=int(row["n_shared"]),
                        used=pool.used_count(), total=pool.capacity)
            else:
                pool.release(pages)
                if (e is not None and not e.superseded
                        and not e.handle.done()):
                    fallback.append(e)
        if adopted:
            self.metrics.record_migration("adopt", len(adopted))
        self._record_pages(pool)
        self._live_rows = sum(len(g.live_slots())
                              for g in pools.values())
        return {"adopted": adopted, "fallback": fallback}

    def _fail_mig_inbox(self, reason: str) -> None:
        """Resolve every pending mailbox op with an error (the worker is
        gone — a requester blocked on its event must not wait out the
        full timeout)."""
        while True:
            with self._cond:
                if not self._mig_inbox:
                    return
                kind, payload, ev, box = self._mig_inbox.popleft()
            box["error"] = MigrationError(reason)
            ev.set()

    def kvpool_audit(self) -> dict:
        """The pool invariant report (:meth:`PagedKVPool.audit`) over this
        engine's live groups — exact on a quiesced engine (closed,
        drained, frozen); advisory under a running worker (the probe snapshot races
        row transitions). Never raises — rides ``GET /debug/kvpool``."""
        if not self.paged:
            return {"ok": True, "errors": [], "note": "engine is not paged"}
        with self._cond:
            pool = self._kvpool
            groups = [g for g in self._pools.values()
                      if not isinstance(g, ProgramRowSet)]
        if pool is None:
            return {"ok": True, "errors": [], "note": "no pool built"}
        try:
            return pool.audit(groups)
        except Exception as exc:  # racing a live worker's row transition
            return {"ok": False,
                    "errors": [f"audit crashed: {type(exc).__name__}: "
                               f"{exc}"]}

    # ------------------------------------------------ dense-slab scheduler

    def _run_rowlevel(self, gen: int) -> None:
        """The slab slot-step loop: each iteration refills freed slots from
        the queue (whole-prompt prefill on admission), retires finished or
        expired rows, and runs one decode step per bucket with live rows.
        ``pools`` maps bucket -> :class:`~.batcher.SlotPool` (or a program
        bucket's row set) and persists across iterations; ``self._pools``/
        ``self._claimed`` mirror the worker's hands so a recovery of a STUCK
        generation can still find every in-flight entry."""
        pools: dict[tuple, object] = {}
        with self._cond:
            if self._gen != gen:
                return  # superseded before the first iteration
            self._pools = pools
        claimed: list[_Entry] = []
        try:
            while True:
                if self._gen == gen:  # a superseded straggler must never
                    self._heartbeat = time.monotonic()  # fake a live pulse
                if self._slo is not None:
                    self._slo.tick(self._clock())
                faults.fire("serve.worker_crash",
                            path=threading.current_thread().name)
                claimed = []
                with self._cond:
                    while True:
                        if self._gen != gen:
                            return  # superseded by a recovery
                        if self._state == "closing":
                            # the live slots are the work in flight: finish
                            # them (close() already emptied the former)
                            if not any(p.live_slots()
                                       for p in pools.values()):
                                return
                            break
                        draining = self._state == "draining"
                        claimed = self._claim_rowlevel(pools)
                        if claimed or any(p.live_slots()
                                          for p in pools.values()):
                            break
                        if draining:
                            return  # nothing queued, nothing live
                        self._idle = True
                        self._cond.wait(None if self._real_clock
                                        else _POLL_CAP_S)
                        self._idle = False
                        if self._gen == gen:
                            self._heartbeat = time.monotonic()
                    self._claimed = claimed
                prog_claimed = [e for e in claimed
                                if self._is_program_bucket(e.bucket)]
                lm_claimed = [e for e in claimed
                              if not self._is_program_bucket(e.bucket)]
                self._admit_rowlevel(pools, lm_claimed)
                self._admit_program_rows(pools, prog_claimed)
                claimed = []
                with self._cond:
                    if self._gen == gen:  # never clobber a successor's
                        self._claimed = []  # claimed mirror
                self._step_rowlevel(pools)
                self._step_program_rows(pools)
        except BaseException as exc:  # worker death: recover or fail held
            live = [p.entries[i] for p in pools.values()
                    for i in p.live_slots()]
            if self._crash_handler(exc, claimed + live, gen):
                return
            raise

    def _slab_name(self, bucket) -> str:
        """The memory-ledger name of one bucket's slab."""
        return f"slab:{self._name}:{bucket[0]}x{bucket[1]}"

    def _drop_slab(self, pools, bucket) -> None:
        """Forget a bucket's slab (its ledger entry with it); the next
        admission to the bucket builds a zeroed one."""
        pools.pop(bucket, None)
        memledger.get_ledger().free(self._slab_name(bucket), strict=False)

    def _admit_rowlevel(self, pools, claimed) -> None:
        """Prefill each claimed entry into a free slot of its bucket's slab
        (built lazily and registered in the memory ledger). The first token
        lands here — the row's TTFT."""
        from ..models.transformer import lm_prefill_slot

        for e in claimed:
            with obs_trace.use(e.trace):
                now = self._clock()
                r = e.request
                dl = r.deadline
                p, s = e.bucket
                if dl is not None and dl <= now:
                    self._retire(e, Result(
                        r.rid, STATUS_EXPIRED,
                        reason=f"deadline {dl} passed before dispatch "
                               f"(dispatched at {now})",
                        metrics={"bucket": e.bucket,
                                 "queue_s": now - e.enq_t,
                                 "total_s": now - e.enq_t}))
                    continue
                e.queue_s = now - e.enq_t
                try:
                    faults.fire("serve.step", path=f"bucket-{p}x{s}")
                    pool = pools.get(e.bucket)
                    if pool is None:
                        pool = pools[e.bucket] = SlotPool(
                            self.params, self.heads, e.bucket,
                            self.max_batch, self.compute_dtype)
                        led = memledger.get_ledger()
                        name = self._slab_name(e.bucket)
                        led.free(name, strict=False)
                        led.register(name, pool.nbytes(), "kvpool",
                                     owner=self._name)
                        # no-warmup path: the bucket's cost model still lands
                        capture_bucket_costs(
                            self.params, self.heads, e.bucket,
                            self.max_batch, self.compute_dtype, self.moe,
                            key=self._prog_key(e.bucket))
                    slot = pool.free_slots()[0]
                    prompt = np.zeros((p,), np.int32)
                    n = r.prompt.shape[0]
                    prompt[:n] = r.prompt
                    t0 = time.perf_counter()
                    caches, tokens, first = lm_prefill_slot(
                        self.params, pool.caches, pool.tokens, slot, prompt,
                        n, heads=self.heads, max_len=p + s, seed=r.seed,
                        temperature=r.temperature, top_p=r.top_p,
                        top_k=r.top_k, compute_dtype=self.compute_dtype,
                        moe=self.moe)
                    first = int(first)  # the row's one prefill read
                    wall = time.perf_counter() - t0
                except Exception as exc:
                    self._admit_failure(pools, e, exc)
                    continue
                pool.caches, pool.tokens = caches, tokens
                pool.assign(slot, e)
                pool.ttft_s[slot] = self._clock() - e.enq_t
                self.metrics.record_prefill(
                    e.bucket, wall, rid=r.rid,
                    program_key=self._prog_key(e.bucket),
                    program="lm_prefill_slot")
                self.flight.record(
                    "prefill", bucket=[p, s], slot=slot, rid=r.rid,
                    seconds=wall, queue_depth=self._queue.count,
                    compiles=_compile_count())
                if r.steps == 1 or (r.eos is not None and first == r.eos):
                    self._retire_row(pool, slot, STATUS_OK, self._clock())
        self._live_rows = sum(len(p.live_slots()) for p in pools.values())

    def _step_rowlevel(self, pools) -> None:
        """Retire expired live rows, then run ONE decode step per bucket
        with live rows and retire rows that finished on it. Every bucket's
        step is dispatched before any result is read (the card runs them
        back to back)."""
        from ..models.transformer import lm_decode_rows

        launched = []
        for bucket, pool in list(pools.items()):
            if isinstance(pool, ProgramRowSet):
                continue  # the program lane steps in _step_program_rows
            now = self._clock()
            for i in pool.live_slots():
                dl = pool.entries[i].request.deadline
                if dl is not None and dl <= now:
                    self._retire_row(
                        pool, i, STATUS_EXPIRED, now,
                        reason=f"deadline {dl} passed mid-decode "
                               f"(now {now})")
            live = pool.live_slots()
            if not live:
                continue
            p, s = bucket
            try:
                faults.fire("serve.decode_step", path=f"bucket-{p}x{s}")
                t0 = time.perf_counter()
                caches, tokens, nxt = lm_decode_rows(
                    self.params, pool.caches, pool.tokens, pool.positions,
                    pool.steps_done, pool.seeds, pool.temperature,
                    pool.top_p, pool.top_k, heads=self.heads,
                    max_len=pool.max_len, compute_dtype=self.compute_dtype,
                    moe=self.moe)
            except Exception as exc:
                self._fail_pool(pools, bucket, exc)
                continue
            pool.caches, pool.tokens = caches, tokens
            launched.append((bucket, pool, live, t0, nxt))
        for bucket, pool, live, t0, nxt in launched:
            try:
                # THE one read of the card per decode step: the host must
                # see the emitted tokens to retire rows
                nxt = nxt.cpu().numpy()
            except Exception as exc:
                self._fail_pool(pools, bucket, exc)
                continue
            wall = time.perf_counter() - t0
            self.metrics.record_step(bucket, len(live), self.max_batch, wall,
                                     program_key=self._prog_key(bucket),
                                     program="lm_decode_rows")
            self.flight.record(
                "step", bucket=list(bucket), rows=len(live),
                seconds=wall, queue_depth=self._queue.count,
                compiles=_compile_count())
            now = self._clock()
            host_tokens = None  # one slab read shared by this step's retirees
            for i in live:
                if pool.entries[i] is None:
                    continue
                pool.positions[i] += 1
                pool.steps_done[i] += 1
                r = pool.entries[i].request
                if ((r.eos is not None and int(nxt[i]) == r.eos)
                        or int(pool.steps_done[i]) >= r.steps):
                    if host_tokens is None:
                        host_tokens = pool.tokens.cpu().numpy()
                    self._retire_row(pool, i, STATUS_OK, now,
                                     host_tokens=host_tokens)
        self._live_rows = sum(len(p.live_slots()) for p in pools.values())

    def _retire_row(self, pool, slot: int, status: str, now: float,
                    reason: str = "", host_tokens=None) -> None:
        """Retire one slot's row and free the slot — the ONLY path a live
        slot leaves the pool by, so every terminal status releases the
        admission budget exactly once. ``host_tokens`` lets a step that
        retires several rows share one read of the slab's token rows."""
        e = pool.entries[slot]
        metrics = {"bucket": pool.bucket, "slot": slot,
                   "queue_s": e.queue_s, "ttft_s": pool.ttft_s[slot],
                   "total_s": now - e.enq_t}
        if status == STATUS_OK:
            n = int(pool.lengths[slot])
            emitted = int(pool.steps_done[slot])
            if host_tokens is None:
                host_tokens = pool.tokens.cpu().numpy()
            toks = host_tokens[slot, :n + emitted].astype(np.int32)
            result = Result(e.request.rid, STATUS_OK, tokens=toks,
                            metrics=metrics)
        else:
            result = Result(e.request.rid, status, reason=reason,
                            metrics=metrics)
        pool.release(slot)
        self._retire(e, result)

    def _fail_pool(self, pools, bucket, exc: Exception) -> None:
        """A slab decode step died: rows with attempt budget left requeue
        for a transparent retry; the rest fail with error Results — only
        that step's live rows are touched and the slot pool stays
        consistent. The port updates the slab in place and never consumes
        it; a CUDA out-of-memory error still drops the bucket's slab (it
        rebuilds zeroed on the next admission), as a consumed slab is
        dropped in the JAX package."""
        pool = pools[bucket]
        reason = f"decode step failed: {type(exc).__name__}: {exc}"
        if memledger.is_oom_error(exc):
            memledger.dump_oom_forensics(reason)
        self.flight.record("decode_fault", bucket=list(bucket),
                           rows=len(pool.live_slots()), error=reason,
                           queue_depth=self._queue.count,
                           compiles=_compile_count())
        now = self._clock()
        for i in pool.live_slots():
            e = pool.entries[i]
            if e.attempts_left():
                pool.release(i)
                self._requeue(e, reason)
            else:
                self._retire_row(pool, i, STATUS_ERROR, now, reason=reason)
        if _is_cuda_oom(exc):
            self._drop_slab(pools, bucket)
        self._flight_dump("decode-step-failed")

    def _admit_failure(self, pools, entry: _Entry, exc: Exception) -> None:
        """A slab prefill died: the entry being admitted retries within its
        attempt budget, else gets an error Result; co-resident live rows
        survive unless a CUDA out-of-memory error drops the bucket's slab,
        in which case they fail/retry too."""
        now = self._clock()
        reason = f"prefill failed: {type(exc).__name__}: {exc}"
        if memledger.is_oom_error(exc):
            memledger.dump_oom_forensics(reason)
        if entry.attempts_left():
            self._requeue(entry, reason)
        else:
            self._retire(entry, Result(
                entry.request.rid, STATUS_ERROR, reason=reason,
                metrics={"bucket": entry.bucket, "queue_s": entry.queue_s,
                         "total_s": now - entry.enq_t}))
        self.flight.record("prefill_fault", bucket=list(entry.bucket),
                           rid=entry.request.rid, error=reason,
                           queue_depth=self._queue.count,
                           compiles=_compile_count())
        pool = pools.get(entry.bucket)
        if pool is not None and _is_cuda_oom(exc):
            lost = f"slab lost to a failed prefill: {reason}"
            for i in pool.live_slots():
                e = pool.entries[i]
                if e.attempts_left():
                    pool.release(i)
                    self._requeue(e, lost)
                else:
                    self._retire_row(pool, i, STATUS_ERROR, now, reason=lost)
            self._drop_slab(pools, entry.bucket)
        self._flight_dump("prefill-failed")

    # --------------------------------------------------- paged scheduler

    def _run_paged(self, gen: int) -> None:
        """The paged slot-step loop: each iteration refills freed rows from
        the queue (page allocation + prefix match — host-side), runs
        prefill chunks up to the ``serve_prefill_chunk`` TOKEN budget
        (oldest rows first), then one decode step per bucket over its live
        rows. ``pools`` maps bucket -> PagedGroup over the engine's one
        shared :class:`PagedKVPool`; ``pf_queue`` is the FIFO of rows
        mid-prefill ((bucket, slot, rid) — rid guards against a retired
        slot's re-occupant inheriting a stale cursor). ``self._pools``/
        ``self._claimed`` mirror the worker's hands so a recovery of a
        STUCK generation can still find every in-flight entry."""
        pools: dict[tuple, PagedGroup] = {}
        with self._cond:
            if self._gen != gen:
                return  # superseded before the first iteration
            self._pools = pools
            # the GENERATION-LOCAL pool binding: every helper below takes
            # this pool, never self._kvpool — a stuck-but-alive superseded
            # worker resuming mid-iteration must mutate only its own dead
            # pool, not the replacement generation's. Bound UNDER the lock
            # with the generation re-checked.
            pool = self._ensure_kvpool()
        pf_queue: collections.deque = collections.deque()
        claimed: list[_Entry] = []
        try:
            while True:
                if self._gen == gen:  # a superseded straggler must never
                    self._heartbeat = time.monotonic()  # fake a live pulse
                if self._slo is not None:
                    # rate-limited internally (serve_slo_eval_interval_s):
                    # per-iteration cost is one float compare
                    self._slo.tick(self._clock())
                faults.fire("serve.worker_crash",
                            path=threading.current_thread().name)
                claimed = []
                with self._cond:
                    while True:
                        if self._gen != gen:
                            return  # superseded by a recovery
                        if self._state == "freezing":
                            # migration pause: park WITHOUT touching the
                            # pools — freeze_rows() joins this thread and
                            # takes over every resident row
                            return
                        busy = any(p.occupied_slots()
                                   for p in pools.values())
                        if self._mig_inbox:
                            break  # service the mailbox outside the lock
                        if self._state == "closing":
                            # resident rows (live AND mid-prefill) are the
                            # work in flight: finish them (close() already
                            # emptied the former)
                            if not busy:
                                return
                            break
                        draining = self._state == "draining"
                        claimed = self._claim_rowlevel(pools)
                        if claimed or busy:
                            break
                        if draining:
                            return  # nothing queued, nothing resident
                        self._idle = True
                        self._cond.wait(None if self._real_clock
                                        else _POLL_CAP_S)
                        self._idle = False
                        if self._gen == gen:
                            self._heartbeat = time.monotonic()
                    self._claimed = claimed
                with self._cond:
                    if self._gen == gen and pool is not self._kvpool:
                        # this generation dropped its pool (a CUDA OOM):
                        # rebind to the rebuilt one, under the lock + gen
                        # check so a stale generation never builds the live
                        # generation's pool
                        pool = self._ensure_kvpool()
                self._service_migrations(pool, pools, pf_queue)
                prog_claimed = [e for e in claimed
                                if self._is_program_bucket(e.bucket)]
                lm_claimed = [e for e in claimed
                              if not self._is_program_bucket(e.bucket)]
                self._admit_paged(pool, pools, lm_claimed, pf_queue)
                self._admit_program_rows(pools, prog_claimed)
                claimed = []
                with self._cond:
                    if self._gen == gen:  # never clobber a successor's
                        self._claimed = []  # claimed mirror
                self._prefill_paged_chunk(pool, pools, pf_queue)
                self._step_paged(pool, pools)
                self._step_program_rows(pools)
        except BaseException as exc:  # worker death: recover or fail held
            held = [p.entries[i] for p in pools.values()
                    for i in p.occupied_slots()]
            if self._crash_handler(exc, claimed + held, gen):
                return
            raise

    def _admit_paged(self, pool, pools, claimed, pf_queue) -> None:
        """Bind each claimed entry to a free row of its bucket's group:
        prefix-cache match, page allocation (the admission charge was
        taken in page units at submit, so the alloc cannot fail under
        engine traffic — still guarded), block table build. Host-side
        only; the device work happens chunk by chunk in
        :meth:`_prefill_paged_chunk`."""
        if not claimed:
            return
        from ..models.planner import request_pages

        # dispatch order ACROSS buckets: the prefill queue is the TTFT
        # ledger — higher priority first, then arrival (rid is monotonic
        # per process)
        claimed = sorted(claimed,
                         key=lambda e: (-e.request.priority, e.request.rid))
        for e in claimed:
            with obs_trace.use(e.trace):
                now = self._clock()
                r = e.request
                if r.deadline is not None and r.deadline <= now:
                    self._retire(e, Result(
                        r.rid, STATUS_EXPIRED,
                        reason=f"deadline {r.deadline} passed before "
                               f"dispatch (dispatched at {now})",
                        metrics={"bucket": e.bucket,
                                 "queue_s": now - e.enq_t,
                                 "total_s": now - e.enq_t}))
                    continue
                e.queue_s = now - e.enq_t
                group = pools.get(e.bucket)
                if group is None:
                    group = pools[e.bucket] = PagedGroup(
                        e.bucket, self.max_batch, self._page_len,
                        self._prefill_chunk)
                    # no-warmup path: the bucket's cost model still lands
                    capture_paged_costs(
                        self.params, self.heads, e.bucket, self.max_batch,
                        pool, self._prefill_chunk, self.compute_dtype,
                        self.moe, key=self._prog_key(e.bucket),
                        kernel=self._decode_kernel)
                slot = group.free_slots()[0]
                n = r.prompt.shape[0]
                shared_len, spages = pool.match_prefix(r.prompt)
                need = request_pages(n, r.steps, self._page_len)
                try:
                    owned = pool.alloc(need - len(spages))
                except PagePoolExhausted as exc:
                    pool.release(spages)  # drop the refs the match took
                    # the OOM post-mortem lands BEFORE the retry path runs
                    memledger.dump_oom_forensics(
                        f"page allocation failed for rid {r.rid}: {exc}")
                    reason = f"page allocation failed: {exc}"
                    if e.attempts_left():
                        self._requeue(e, reason)
                    else:
                        self._retire(e, Result(
                            r.rid, STATUS_ERROR, reason=reason,
                            metrics={"bucket": e.bucket,
                                     "queue_s": e.queue_s,
                                     "total_s": now - e.enq_t}))
                    continue
                group.assign(slot, e, spages + owned, shared_len,
                             len(spages))
                pf_queue.append((e.bucket, slot, r.rid))
                self.metrics.record_prefix(hit=bool(spages))
                self.metrics.record_page_event(
                    "alloc", rid=r.rid, pages=len(spages) + len(owned),
                    shared=len(spages), used=pool.used_count(),
                    total=pool.capacity)
        self._record_pages(pool)

    def _prefill_paged_chunk(self, pool, pools, pf_queue) -> None:
        """Run bounded prefill for this iteration: at most
        ``serve_prefill_chunk`` prompt TOKENS per worker iteration (several
        short prompts may share the budget; one long prompt consumes it in
        a single chunk and resumes next iteration), decode steps
        interleaving in between. Rows prefill oldest first. A row's final
        chunk emits its first token — real TTFT — caches the completed
        prompt pages for prefix sharing, and flips the row decode-ready."""
        budget = self._prefill_chunk
        while budget > 0 and pf_queue:
            budget -= self._prefill_one_chunk(pool, pools, pf_queue)
        self._live_rows = sum(len(g.live_slots()) for g in pools.values())

    def _prefill_one_chunk(self, pool, pools, pf_queue) -> int:
        """One chunk for the head of the prefill queue; returns the real
        prompt tokens it consumed (0 ends the caller's budget loop —
        nothing left to prefill, or the head row just failed)."""
        while pf_queue:
            bucket, slot, rid = pf_queue[0]
            group = pools.get(bucket)
            e = group.entries[slot] if group is not None else None
            if (e is None or e.request.rid != rid
                    or group.pf_next[slot] < 0):
                pf_queue.popleft()  # stale: retired/expired/re-occupied
                continue
            break
        else:
            return 0
        with obs_trace.use(e.trace):
            r = e.request
            p, s = bucket
            cs = int(group.pf_next[slot])  # host numpy bookkeeping
            n = int(group.lengths[slot])   # host numpy bookkeeping
            C = group.chunk
            tokens = min(C, n - cs)
            final = cs + C >= n
            chunk = group.prompts[slot][cs:cs + C]
            if chunk.shape[0] < C:
                # a prefix hit whose shared_len is page- but not CHUNK-
                # aligned leaves a short tail slice; pad it back to the
                # bucket's chunk width
                chunk = np.concatenate(
                    [chunk, np.zeros(C - chunk.shape[0], np.int32)])
            try:
                # copy-on-write gate on every page the chunk will scatter
                # into (a no-op in steady state: writes target owned pages
                # by construction — kvpool.PagedKVPool.ensure_writable)
                for j in range(cs // self._page_len,
                               min((cs + C) // self._page_len,
                                   group.pages_per_row)):
                    self._cow(pool, group, slot, j, rid=r.rid)
                from ..models.transformer import lm_prefill_paged

                faults.fire("serve.prefill", path=f"bucket-{p}x{s}")
                t0 = time.perf_counter()
                pages, first = lm_prefill_paged(
                    self.params, pool.pages, group.tables[slot], chunk, cs,
                    n, heads=self.heads, page_len=self._page_len,
                    seed=r.seed, temperature=r.temperature, top_p=r.top_p,
                    top_k=r.top_k, compute_dtype=self.compute_dtype,
                    moe=self.moe)
                if final:
                    # the row's one prefill read of the card: its first
                    # token (an earlier chunk is not waited for — its
                    # time is the dispatch time)
                    first = int(first)
                wall = time.perf_counter() - t0
            except Exception as exc:
                pf_queue.popleft()
                self._paged_prefill_failure(pool, pools, bucket, slot, exc)
                return 0  # end this iteration's budget loop
            pool.pages = pages
            group.pf_next[slot] = cs + C
            self.metrics.record_prefill(
                e.bucket, wall, rid=r.rid,
                program_key=self._prog_key(e.bucket),
                program="lm_prefill_paged", chunk=[cs, tokens], final=final)
            self.flight.record(
                "prefill", bucket=[p, s], slot=slot, rid=r.rid,
                seconds=wall, chunk=[cs, tokens],
                queue_depth=self._queue.count, compiles=_compile_count(),
                pages_used=pool.used_count())
            if final:
                pf_queue.popleft()
                group.finish_prefill(slot, first)
                group.ttft_s[slot] = self._clock() - e.enq_t
                # the prompt's full pages are final now — publish them for
                # copy-on-write reuse by later identical prefixes
                pool.insert_prefix(r.prompt, group.row_pages[slot])
                self._record_pages(pool)
                if r.steps == 1 or (r.eos is not None and first == r.eos):
                    self._retire_row_paged(pool, pools, bucket, slot,
                                           STATUS_OK, self._clock())
        return tokens

    def _cow(self, pool, group, slot: int, table_idx: int,
             rid: int | None = None) -> None:
        """Engine-side copy-on-write: splits the page and keeps the group's
        release bookkeeping in step with the table (kvpool owns the device
        copy)."""
        old = int(group.tables[slot, table_idx])
        if pool.ensure_writable(group.tables[slot], table_idx):
            rp = group.row_pages[slot]
            rp[table_idx] = int(group.tables[slot, table_idx])
            if group.shared_pages[slot] > 0:
                group.shared_pages[slot] -= 1
            self.metrics.record_page_event(
                "cow", rid=rid, pages=1, used=pool.used_count(),
                total=pool.capacity)
            self.flight.record("cow", slot=slot, page=old,
                               fresh=rp[table_idx],
                               pages_used=pool.used_count())

    def _step_paged(self, pool, pools) -> None:
        """Retire expired resident rows, then run ONE decode step per
        bucket over its live rows. Every bucket's step is dispatched before any
        result is read (the card runs them back to back); non-live rows run
        the masked-harmless dummy against page 0 so a prefilling
        neighbor's pages are never scribbled."""
        from ..models.transformer import lm_decode_paged

        launched = []
        for bucket, group in list(pools.items()):
            if isinstance(group, ProgramRowSet):
                continue  # the program lane steps in _step_program_rows
            now = self._clock()
            for i in group.occupied_slots():
                dl = group.entries[i].request.deadline
                if dl is not None and dl <= now:
                    self._retire_row_paged(
                        pool, pools, bucket, i, STATUS_EXPIRED, now,
                        reason=f"deadline {dl} passed mid-decode "
                               f"(now {now})")
            live = group.live_slots()
            if not live:
                continue
            p, s = bucket
            try:
                for i in live:  # COW gate on each row's write page
                    self._cow(pool, group, slot=i,
                              table_idx=int(group.positions[i])
                              // self._page_len,
                              rid=group.entries[i].request.rid)
                faults.fire("serve.decode_step", path=f"bucket-{p}x{s}")
                t0 = time.perf_counter()
                tables, positions, cur = group.decode_inputs()
                pages, nxt = lm_decode_paged(
                    self.params, pool.pages, tables, positions, cur,
                    group.steps_done, group.seeds, group.temperature,
                    group.top_p, group.top_k, heads=self.heads,
                    page_len=self._page_len,
                    compute_dtype=self.compute_dtype, moe=self.moe,
                    kernel=self._decode_kernel)
            except Exception as exc:
                self._fail_paged_bucket(pool, pools, bucket, exc)
                continue
            pool.pages = pages
            launched.append((bucket, group, live, t0, nxt))
        for bucket, group, live, t0, nxt in launched:
            try:
                # THE one read of the card per decode step: the host must
                # see the emitted tokens to retire rows (every bucket's
                # step was dispatched above first)
                nxt = nxt.cpu().numpy()
            except Exception as exc:
                self._fail_paged_bucket(pool, pools, bucket, exc)
                continue
            wall = time.perf_counter() - t0
            self.metrics.record_step(bucket, len(live), self.max_batch,
                                     wall, program_key=self._prog_key(bucket),
                                     program="lm_decode_paged")
            self.flight.record(
                "step", bucket=list(bucket), rows=len(live),
                seconds=wall, queue_depth=self._queue.count,
                compiles=_compile_count(), pages_used=pool.used_count())
            now = self._clock()
            for i in live:
                if group.entries[i] is None:
                    continue  # expired between dispatch and landing
                group.positions[i] += 1
                group.steps_done[i] += 1
                tok = int(nxt[i])
                group.cur_tok[i] = tok
                group.emitted[i].append(tok)
                r = group.entries[i].request
                if ((r.eos is not None and tok == r.eos)
                        or int(group.steps_done[i]) >= r.steps):
                    self._retire_row_paged(pool, pools, bucket, i,
                                           STATUS_OK, now)
        self._live_rows = sum(len(g.live_slots()) for g in pools.values())

    def _retire_row_paged(self, pool, pools, bucket, slot: int,
                          status: str, now: float, reason: str = "") -> None:
        """Retire one paged row and free its slot — the ONLY path a
        resident row leaves a group by, so every terminal status releases
        the row's pages AND its page-unit admission reservation exactly
        once (pages here via the pool refcount, the reservation in
        :meth:`_retire` by whoever wins the handle)."""
        group = pools[bucket]
        e = group.entries[slot]
        n_pages = len(group.row_pages[slot] or [])
        metrics = {"bucket": bucket, "slot": slot, "queue_s": e.queue_s,
                   "ttft_s": group.ttft_s[slot],
                   "total_s": now - e.enq_t, "pages": n_pages,
                   "shared_pages": int(group.shared_pages[slot])}
        if status == STATUS_OK:
            toks = np.concatenate([
                np.asarray(e.request.prompt, np.int32),
                np.asarray(group.emitted[slot], np.int32)])
            result = Result(e.request.rid, STATUS_OK, tokens=toks,
                            metrics=metrics)
        else:
            result = Result(e.request.rid, status, reason=reason,
                            metrics=metrics)
        pages = group.release(slot)
        if pool is not None:
            pool.release(pages)
            # inside the request's span: the free record must join the
            # request's trace whichever step retires it
            with obs_trace.use(e.trace):
                self.metrics.record_page_event(
                    "free", rid=e.request.rid, pages=len(pages),
                    used=pool.used_count(), total=pool.capacity)
            self._record_pages(pool)
        self._retire(e, result)

    def _paged_pool_lost(self, pool) -> bool:
        """Whether a failed call consumed the page slab — the JAX package's
        donation check (``is_deleted``). Always False here, by design: the
        port's programs update the slab in place and never consume it (no
        donation), and an injected fault fires before any write, so a
        failed call leaves the pool and every other row's pages usable. A
        CUDA out-of-memory error still drops the pool
        (:meth:`_drop_paged_pool`), for the allocator's sake."""
        return False

    def _drop_paged_pool(self, pool, pools, reason: str) -> None:
        """Drop the calling generation's pool after a CUDA out-of-memory
        error: every resident row in EVERY bucket loses its cache — requeue
        each within its attempt budget (the page-unit reservation is
        carried), fail the rest, and drop the pool so its slab is freed; the
        live worker rebinds a zeroed rebuild at its next iteration (the
        same contract as worker-crash recovery). A STALE generation
        reaching here clears only its own map — the engine-level pool
        reference is cleared only when it still names this pool."""
        now = self._clock()
        for bucket, group in list(pools.items()):
            if isinstance(group, ProgramRowSet):
                continue  # program rows hold no pages
            for i in group.occupied_slots():
                e = group.entries[i]
                group.release(i)  # page bookkeeping dies with the pool
                if e.attempts_left():
                    self._requeue(e, reason)
                else:
                    self._retire(e, Result(
                        e.request.rid, STATUS_ERROR, reason=reason,
                        metrics={"bucket": bucket, "queue_s": e.queue_s,
                                 "total_s": now - e.enq_t}))
            pools.pop(bucket)
        if self._kvpool is pool:
            memledger.get_ledger().free(f"kvpool:{self._name}",
                                        strict=False)
            self._kvpool = None
            self.metrics.record_page_event("lost", used=0,
                                           total=self._num_pages - 1)
            self.metrics.record_pages(self._num_pages - 1, 0, 0)

    def _fail_paged_bucket(self, pool, pools, bucket,
                           exc: Exception) -> None:
        """A paged decode step died (an injected fault, a failed launch):
        only that step's live rows fail/retry and their pages free; a CUDA
        out-of-memory error escalates to :meth:`_drop_paged_pool`. Never a
        rerun through another backend."""
        group = pools.get(bucket)
        if group is None or pool is not self._kvpool:
            # an earlier bucket's failure in this same landing loop already
            # escalated to _drop_paged_pool: every resident row was
            # requeued/failed there
            return
        reason = f"decode step failed: {type(exc).__name__}: {exc}"
        if memledger.is_oom_error(exc):
            memledger.dump_oom_forensics(reason)
        self.flight.record("decode_fault", bucket=list(bucket),
                           rows=len(group.live_slots()), error=reason,
                           queue_depth=self._queue.count,
                           compiles=_compile_count(),
                           pages_used=pool.used_count() if pool else 0)
        if self._paged_pool_lost(pool) or _is_cuda_oom(exc):
            self._drop_paged_pool(pool, pools, reason)
        else:
            now = self._clock()
            for i in group.live_slots():
                e = group.entries[i]
                if e.attempts_left():
                    pool.release(group.release(i))
                    self._requeue(e, reason)
                else:
                    self._retire_row_paged(pool, pools, bucket, i,
                                           STATUS_ERROR, now, reason=reason)
            self._record_pages(pool)
        self._flight_dump("decode-step-failed")

    def _paged_prefill_failure(self, pool, pools, bucket, slot: int,
                               exc: Exception) -> None:
        """A prefill chunk died: the row being prefilled retries within
        its attempt budget (the chunk cursor restarts from its shared
        prefix on the retry — resumability is host state) or errors;
        co-resident rows survive unless a CUDA out-of-memory error drops
        the pool."""
        group = pools[bucket]
        e = group.entries[slot]
        reason = f"prefill failed: {type(exc).__name__}: {exc}"
        if memledger.is_oom_error(exc):
            memledger.dump_oom_forensics(reason)
        self.flight.record("prefill_fault", bucket=list(bucket),
                           rid=e.request.rid, error=reason,
                           queue_depth=self._queue.count,
                           compiles=_compile_count(),
                           pages_used=pool.used_count() if pool else 0)
        if self._paged_pool_lost(pool) or _is_cuda_oom(exc):
            self._drop_paged_pool(pool, pools,
                                  f"pool lost to a failed prefill: {reason}")
        else:
            now = self._clock()
            pool.release(group.release(slot))
            if e.attempts_left():
                self._requeue(e, reason)
            else:
                self._retire(e, Result(
                    e.request.rid, STATUS_ERROR, reason=reason,
                    metrics={"bucket": bucket, "queue_s": e.queue_s,
                             "total_s": now - e.enq_t}))
            self.metrics.record_page_event(
                "free", rid=e.request.rid, used=pool.used_count(),
                total=pool.capacity)
            self._record_pages(pool)
        self._flight_dump("prefill-failed")
