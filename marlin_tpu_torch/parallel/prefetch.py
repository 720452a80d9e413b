"""Asynchronous host→device prefetch for the out-of-core streaming layer.

Counterpart of ``marlin_tpu/parallel/prefetch.py``. A streamed op (the
tall-skinny Gramian or multiply of BASELINE.md config 4) leaves the card idle
while the caller's thread reads a chunk, converts it and copies it over, one
chunk at a time. :class:`ChunkPrefetcher` moves that production to background
threads, so the copy of chunk i+1 rides under the card's compute on chunk i.

Where the JAX package calls ``jax.device_put``, a producer here

- copies the chunk into a **pinned** staging buffer, taken from a pool of
  ``depth + workers`` buffers allocated once per pipeline and reused
  (pinning a fresh gigabyte per chunk would cost more than the copy);
- issues ``copy_(..., non_blocking=True)`` into a device tensor on a **side
  CUDA stream** of the pipeline's own, and records an event after it;
- gives the staging buffer back to the pool only once that event has
  completed.

The consumer's stream waits on the event (no host wait) and the device tensor
is marked with ``record_stream`` for the consumer's stream, so the caching
allocator does not hand its memory out again while the consumer still reads
it. With ``device_put=False``, or a CPU device, the pipeline yields host
chunks as the JAX package's does.

Guarantees, as in the JAX package:

- **Ordering** — chunks come out in source order regardless of worker count
  (reads are serialized; a reorder buffer absorbs out-of-order completion).
- **Backpressure** — at most ``depth`` chunks in flight (read but not yet
  consumed), plus an in-flight device byte budget
  (``config.prefetch_hbm_budget_bytes``); at least one chunk always
  proceeds, so no budget deadlock.
- **Exception propagation** — a producer-side error (source, transform or
  copy) surfaces at the consumer as the original exception, at its position
  in the stream; it never hangs the caller.
- **Clean shutdown** — :meth:`close` (idempotent, also called on exhaustion
  and by ``with``) stops and joins every worker.
- **Chaos hooks** — each read passes the ``prefetch.produce`` fault point.
- **Instrumentation** — per-stage seconds (``produce``/``transfer``/
  ``stall``) in a :class:`~marlin_tpu_torch.utils.profiling.StageTimes`, one
  summary event in the default EventLog on close, the shared flight
  recorder, the ``prefetch`` memory-ledger entry and the
  ``marlin_prefetch_*`` metric families. :meth:`copy_seconds` reads the
  host-to-device copies' own time on the card from their CUDA events.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..config import get_config, resolve_device
from ..obs import perf, trace as obs_trace
from ..obs.metrics import get_registry
from ..utils import faults
from ..utils.profiling import StageTimes

__all__ = ["ChunkPrefetcher", "prefetch_chunks", "staging_counts",
           "reset_staging_counts"]

_ids = itertools.count()

_families = None  # lazy singleton: one set of registry families, all pipelines

_flight = None  # lazy shared flight recorder: all pipelines, one black box
_flight_lock = threading.Lock()

# host-to-device copies issued by every pipeline: by whether their source
# buffer was pinned (the staging contract says it always is), and the bytes
# and card seconds of those of closed pipelines
_STAGING_ZERO = {"pinned": 0, "unpinned": 0, "bytes": 0, "copy_s": 0.0}
_staging = dict(_STAGING_ZERO)
_staging_lock = threading.Lock()


def staging_counts() -> dict:
    """Host-to-device copies the pipelines issued since the last reset: how
    many came from pinned and from pageable buffers, and the bytes and the
    seconds on the card (CUDA events) of those whose pipeline has closed."""
    with _staging_lock:
        return dict(_staging)


def reset_staging_counts() -> None:
    with _staging_lock:
        _staging.update(_STAGING_ZERO)


def _ledger_add(delta: int) -> None:
    """Mirror an in-flight-bytes gauge delta into the process MemoryLedger
    (component ``prefetch``, one shared flow entry). Never raises."""
    try:
        from ..obs.memledger import get_ledger

        get_ledger().add("prefetch:inflight", delta, "prefetch")
    except Exception:
        pass


def _flight_ring() -> "perf.FlightRecorder":
    """The prefetch flight recorder (obs/perf.py): per-chunk production
    records from every pipeline's producer threads, dumped to JSONL when a
    producer dies. Shared process-wide (a per-pipeline ring would vanish with
    the object that just crashed)."""
    global _flight
    with _flight_lock:
        if _flight is None:
            _flight = perf.FlightRecorder(name="prefetch")
        return _flight


def _metric_families():
    """(chunks counter, stall-seconds counter, ready-depth gauge,
    in-flight-bytes gauge) — shared by every pipeline in the process.
    obs.collectors touches this at endpoint start so the series exist even
    before the first streamed op."""
    global _families
    if _families is None:
        reg = get_registry()
        _families = (
            reg.counter("marlin_prefetch_chunks_total",
                        "Chunks delivered to consumers by prefetch "
                        "pipelines"),
            reg.counter("marlin_prefetch_stall_seconds_total",
                        "Seconds consumers waited on the prefetch queue "
                        "(un-overlapped producer latency)"),
            reg.gauge("marlin_prefetch_ready_depth",
                      "Produced-but-unconsumed chunks buffered right now"),
            reg.gauge("marlin_prefetch_inflight_bytes",
                      "Bytes of prefetched-but-unconsumed chunks counted "
                      "against the device budget"),
        )
    return _families


def _nbytes(chunk) -> int:
    if isinstance(chunk, torch.Tensor):
        return chunk.numel() * chunk.element_size()
    return int(getattr(chunk, "nbytes", 0))


class _PinnedPool:
    """``size`` pinned host buffers, allocated at first use at the first
    chunk's byte size (grown, once, if a later chunk is larger) and reused.
    A buffer is free again once the event of the copy that read it has
    completed."""

    def __init__(self, size: int):
        self._cv = threading.Condition()
        self._free: list[torch.Tensor] = []
        self._busy: list[tuple[torch.Tensor, torch.cuda.Event]] = []
        self._left = size  # buffers not allocated yet

    def take(self, nbytes: int, stop: threading.Event) -> torch.Tensor | None:
        with self._cv:
            while True:
                # reclaim buffers whose copies have finished
                done = [b for b, ev in self._busy if ev.query()]
                if done:
                    self._busy = [(b, ev) for b, ev in self._busy
                                  if not any(b is d for d in done)]
                    self._free.extend(done)
                for i, b in enumerate(self._free):
                    if b.numel() >= nbytes:
                        return self._free.pop(i)
                if self._free or self._left:
                    if self._free:  # too small: replace it
                        self._free.pop()
                    else:
                        self._left -= 1
                    return torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True)
                if stop.is_set():
                    return None
                if self._busy:
                    oldest = self._busy[0][1]
                    self._cv.release()
                    try:
                        oldest.synchronize()
                    finally:
                        self._cv.acquire()
                else:  # every buffer is with a producer: wait for one
                    self._cv.wait(0.1)

    def give(self, buf: torch.Tensor, event: torch.cuda.Event | None) -> None:
        with self._cv:
            if event is None:
                self._free.append(buf)
            else:
                self._busy.append((buf, event))
            self._cv.notify_all()


def _staged_view(buf: torch.Tensor, chunk) -> torch.Tensor:
    """Copy a host chunk (numpy array or CPU tensor) into the front of a
    pinned byte buffer; returns the pinned view of the chunk's shape and
    dtype."""
    if isinstance(chunk, torch.Tensor):
        view = buf[:_nbytes(chunk)].view(chunk.dtype).view(chunk.shape)
        view.copy_(chunk)
        return view
    arr = np.asarray(chunk)
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    view = buf[:arr.nbytes].view(dtype).view(arr.shape)
    np.copyto(view.numpy(), arr, casting="no")
    return view


class ChunkPrefetcher:
    """Iterate ``source``'s chunks with production moved to background threads.

    ``source``: any iterable of host chunks (numpy arrays, memmap views, CPU
    tensors). ``transform``: optional host-side per-chunk function (dtype
    conversion, compression) run on a worker thread. ``device_put=True``
    additionally stages each chunk through a pinned buffer and copies it to
    ``device`` (default: the configured one) on a side stream, so consumers
    receive device tensors; ``device_put=False`` yields host chunks.
    ``depth``/``workers``/``hbm_budget_bytes`` default from
    :mod:`marlin_tpu_torch.config`.

    Use as an iterator (``for x in ChunkPrefetcher(src): ...``); wrap in
    ``with`` or call :meth:`close` when abandoning it mid-stream.
    """

    def __init__(self, source: Iterable, transform: Callable[[Any], Any] | None = None,
                 *, depth: int | None = None, workers: int | None = None,
                 device_put: bool = True, hbm_budget_bytes: int | None = None,
                 stats: StageTimes | None = None, device=None):
        cfg = get_config()
        self._depth = cfg.prefetch_depth if depth is None else depth
        n_workers = cfg.prefetch_workers if workers is None else workers
        self._budget = (cfg.prefetch_hbm_budget_bytes
                        if hbm_budget_bytes is None else hbm_budget_bytes)
        if self._depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {self._depth}")
        if n_workers < 1:
            raise ValueError(f"prefetch workers must be >= 1, got {n_workers}")
        self._it = iter(source)
        self._transform = transform
        self._device_put = device_put
        self._device = resolve_device(device) if device_put else None
        self._cuda = self._device is not None and self._device.type == "cuda"
        if self._cuda:
            self._side = torch.cuda.Stream(device=self._device)
            self._pool = _PinnedPool(self._depth + n_workers)
        self._copies: list[tuple] = []  # (start event, end event, bytes)
        self.stats = stats if stats is not None else StageTimes()
        self._metrics = _metric_families()
        # producer threads inherit the creating thread's span context, so
        # chunk-pipeline records join the streamed op's trace
        self._span = obs_trace.capture()

        self._src_lock = threading.Lock()  # serializes next(it) + index assignment
        self._cv = threading.Condition()
        self._slots = threading.Semaphore(self._depth)
        self._stop = threading.Event()
        self._ready: dict[int, tuple] = {}   # idx -> ("ok", chunk, nbytes, event) | ("err", exc, 0, None)
        self._next_read = 0
        self._next_yield = 0
        self._next_admit = 0  # budget admission cursor (stream order)
        self._end: int | None = None         # first index past the stream
        self._inflight_bytes = 0
        self._closed = False
        self._emitted = False

        pid = next(_ids)
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"marlin-prefetch-{pid}-{w}")
            for w in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------------- producer
    def _work(self) -> None:
        with obs_trace.use(self._span):
            if self._cuda:
                with torch.cuda.device(self._device):
                    self._work_loop()
            else:
                self._work_loop()

    def _work_loop(self) -> None:
        while not self._stop.is_set():
            # bounded queue: one slot per chunk in flight; timed acquire so a
            # close() while blocked here is noticed (close also over-releases)
            if not self._slots.acquire(timeout=0.1):
                continue
            if self._stop.is_set():
                return
            t0 = time.perf_counter()
            with self._src_lock:
                if self._end is not None:
                    return  # stream already over (EOF or source error)
                i = self._next_read
                try:
                    faults.fire("prefetch.produce", path=f"chunk-{i}", index=i)
                    chunk = next(self._it)
                except StopIteration:
                    self._finish(i)
                    return
                except BaseException as e:  # source failure ends the stream
                    self._flight_fault(i, "source", e)
                    self._post(i, ("err", e, 0, None))
                    self._finish(i + 1)
                    return
                self._next_read = i + 1
            # off the source lock: convert + stage + copy (the parallel part)
            admitted = 0
            try:
                if self._transform is not None:
                    chunk = self._transform(chunk)
                nbytes = _nbytes(chunk)
                produce_s = time.perf_counter() - t0
                self.stats.add("produce", produce_s)
                _flight_ring().record("chunk", i=i, nbytes=nbytes,
                                      seconds=produce_s,
                                      ready=len(self._ready))
                if not self._wait_for_budget(i, nbytes):
                    return  # closed while waiting
                admitted = nbytes
                event = None
                if self._device_put:
                    with self.stats.timed("transfer"):
                        chunk, event = self._to_device(chunk, nbytes)
                    if chunk is None:
                        return  # closed while waiting for a buffer
                self._post(i, ("ok", chunk, nbytes, event))
            except BaseException as e:  # transform/copy failure: positional
                with self._cv:
                    # refund admitted budget and, on a pre-admission failure,
                    # advance the admission cursor past i — successors must
                    # not stall against a chunk that will never be admitted
                    self._inflight_bytes -= admitted
                    self._metrics[3].dec(admitted)
                    _ledger_add(-admitted)
                    if self._next_admit == i:
                        self._next_admit = i + 1
                    self._cv.notify_all()
                self._flight_fault(i, "transform/upload", e)
                self._post(i, ("err", e, 0, None))

    def _to_device(self, chunk, nbytes: int):
        """(device tensor, event after its copy or None). On a CUDA device:
        stage through a pooled pinned buffer, copy on the side stream."""
        if not self._cuda:
            if not isinstance(chunk, torch.Tensor):
                chunk = torch.from_numpy(np.array(chunk, copy=True))
            return chunk.to(self._device), None
        buf = self._pool.take(nbytes, self._stop)
        if buf is None:
            return None, None
        try:
            host = _staged_view(buf, chunk)
            pinned = host.is_pinned()
            with _staging_lock:
                _staging["pinned" if pinned else "unpinned"] += 1
            with torch.cuda.stream(self._side):
                dev = torch.empty(host.shape, dtype=host.dtype,
                                  device=self._device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(self._side)
                dev.copy_(host, non_blocking=True)
                end.record(self._side)
        except BaseException:
            self._pool.give(buf, None)
            raise
        self._pool.give(buf, end)
        with self._cv:
            self._copies.append((start, end, nbytes))
        return dev, end

    @staticmethod
    def _flight_fault(i: int, stage: str, exc: BaseException) -> None:
        """A producer died: put the failure in the ring, then dump it.
        Never raises."""
        try:
            ring = _flight_ring()
            ring.record("produce_error", i=i, stage=stage,
                        error=f"{type(exc).__name__}: {exc}")
            ring.dump(reason="producer-died")
        except Exception:
            pass

    def _wait_for_budget(self, i: int, nbytes: int) -> bool:
        """Block until chunk ``i`` may occupy the in-flight device budget.

        Admission is in STREAM ORDER (``_next_admit`` cursor), not
        first-come: if chunk i+1's worker could claim the budget while chunk
        i's worker still waits for it, the consumer — which needs i before
        i+1 — would deadlock. A lone chunk always fits (``inflight == 0``),
        so an undersized budget serializes instead of deadlocking. Returns
        False if closed while waiting."""
        with self._cv:
            if self._stop.is_set():
                return False  # closed: don't touch the (shared) gauges
            if self._budget > 0:
                while not self._stop.is_set() and (
                        self._next_admit != i
                        or (self._inflight_bytes > 0
                            and self._inflight_bytes + nbytes > self._budget)):
                    self._cv.wait(0.1)
                if self._stop.is_set():
                    return False
                self._next_admit = i + 1
            self._inflight_bytes += nbytes
            # gauges move by deltas: several pipelines may run concurrently
            self._metrics[3].inc(nbytes)
            _ledger_add(nbytes)
            self._cv.notify_all()
            return True

    def _post(self, i: int, item: tuple) -> None:
        with self._cv:
            if not self._stop.is_set():
                self._ready[i] = item
                self._metrics[2].inc()
            self._cv.notify_all()

    def _finish(self, end: int) -> None:
        with self._cv:
            if self._end is None or end < self._end:
                self._end = end
            self._cv.notify_all()

    # ---------------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        j = self._next_yield
        t0 = time.perf_counter()
        with self._cv:
            while j not in self._ready:
                if self._end is not None and j >= self._end:
                    break
                # timed wait: a wedged producer must never hang the caller
                self._cv.wait(0.1)
            item = self._ready.pop(j, None)
            if item is not None:
                self._metrics[2].dec()
        stall = time.perf_counter() - t0
        self.stats.add("stall", stall)
        self._metrics[1].inc(stall)
        if item is None:  # clean exhaustion
            self.close()
            raise StopIteration
        self._next_yield = j + 1
        kind, payload, nbytes, event = item
        if kind == "err":
            self.close()
            raise payload
        if event is not None:
            # the consumer's stream waits for the copy on the card, and the
            # allocator keeps the tensor's memory until that stream is past
            # its last use
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            payload.record_stream(consumer)
        with self._cv:
            self._inflight_bytes -= nbytes
            self._metrics[3].dec(nbytes)
            _ledger_add(-nbytes)
            self._cv.notify_all()
        self._slots.release()
        self._metrics[0].inc()
        return payload

    def copy_seconds(self) -> tuple[int, float]:
        """(bytes, seconds) of the host-to-device copies issued so far, the
        seconds read from their CUDA events on the side stream (waits for
        them). (0, 0.0) off the card. A closed pipeline adds its own to
        :func:`staging_counts`."""
        with self._cv:
            copies = list(self._copies)
        if not copies:
            return 0, 0.0
        self._side.synchronize()
        return (sum(c[2] for c in copies),
                sum(s.elapsed_time(e) for s, e, _ in copies) / 1e3)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop and join every worker; safe to call repeatedly. Buffered
        chunks are dropped (their device memory frees with the references).

        Never raises: close() runs on the streamed ops' finally-path, where
        an exception would mask the caller's real one. A worker that outlives
        the join window (parked in a slow source read it will finish on its
        own — it is a daemon and observes the stop flag at its next check) is
        reported as a warning instead."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop.set()
            # release only THIS pipeline's contribution to the shared gauges
            self._metrics[2].dec(len(self._ready))
            self._metrics[3].dec(self._inflight_bytes)
            _ledger_add(-self._inflight_bytes)
            self._ready.clear()
            self._inflight_bytes = 0
            self._cv.notify_all()
        for _ in self._threads:  # unblock any worker stuck on a full queue
            self._slots.release()
        for t in self._threads:
            t.join(timeout=10.0)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            import warnings

            warnings.warn(f"prefetch worker(s) still running after close() "
                          f"(blocked in a slow source read?): {alive}",
                          RuntimeWarning, stacklevel=2)
        if self._copies:
            nbytes, seconds = self.copy_seconds()
            with _staging_lock:
                _staging["bytes"] += nbytes
                _staging["copy_s"] += seconds
        if not self._emitted:
            self._emitted = True
            self.stats.emit(kind="prefetch", chunks=self._next_yield,
                            depth=self._depth, workers=len(self._threads))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_chunks(source: Iterable, transform: Callable[[Any], Any] | None = None,
                    **kwargs) -> ChunkPrefetcher:
    """Functional spelling of :class:`ChunkPrefetcher` (same signature)."""
    return ChunkPrefetcher(source, transform, **kwargs)
