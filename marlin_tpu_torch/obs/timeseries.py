"""Bounded in-process windowed time-series store for the SLO engine.

Counterpart of ``marlin_tpu/obs/timeseries.py``, copied (the module is
stdlib-only).

The registry (obs/metrics.py) holds *current* values — cumulative counters,
last-write gauges, all-time histograms — which answers "how much so far" but
not "what is the p99 over the last minute" or "how fast is the error counter
moving right now". This module adds the missing time axis without a
background poller or an external TSDB: a :class:`TimeSeriesStore` keeps a
fixed-size ring of wall-aligned time buckets per series, so rate / delta /
percentile queries over arbitrary trailing windows are O(ring length) and
memory is bounded by construction (``max_series`` series x ring length x
``samples_per_bucket``).

Three series kinds, created lazily on first write:

- **counter** — per-bucket accumulated increments; fed directly (:meth:`add`)
  or from a cumulative registry counter (:meth:`record_cum`, which diffs
  consecutive observations and tolerates resets). Queried with
  :meth:`delta` / :meth:`rate`.
- **gauge** — last value written in each bucket (:meth:`set`); queried with
  :meth:`last`.
- **sample** — bounded list of raw observations per bucket (:meth:`observe`);
  queried with :meth:`values` / :meth:`pct` / :meth:`mean`. Buckets cap at
  ``samples_per_bucket`` values; overflow is counted, not stored (percentiles
  over a saturated bucket are front-biased — size the cap to the per-bucket
  event rate).

Feeding is hot-path-cheap (one lock, one ring-slot write) and *pull-based*
from the registry: :func:`pump_registry` snapshots every registered family
into the store (labeled children flatten to ``name{label=value,...}`` series
plus a summed ``name`` family total), and :func:`install_collector` hangs
that pump on the registry's render hook, so every ``/metrics`` scrape also
advances the store — no new threads on the hot path (the SLO engine's
``tick()`` pumps too, so evaluation works without a scraper).

The clock is injectable (and every method takes an optional ``now``) so SLO
tests drive windows deterministically — no sleeps.
"""

from __future__ import annotations

import math
import threading
import time

from .metrics import MetricsRegistry, get_registry, percentile

__all__ = ["TimeSeriesStore", "pump_registry", "install_collector"]


class _Series:
    """One named series: a ring of ``n`` aligned buckets. ``epochs[i]``
    stamps which absolute bucket index slot ``i`` currently holds — a slot
    whose epoch is stale is implicitly empty (lazily recycled on write), so
    advancing time never needs a sweep."""

    __slots__ = ("kind", "n", "epochs", "vals", "last_cum", "overflow")

    def __init__(self, kind: str, n: int):
        self.kind = kind
        self.n = n
        self.epochs = [-1] * n
        # counter: float accumulator; gauge: last value; sample: list
        self.vals: list = [None] * n
        self.last_cum: float | None = None  # record_cum's previous reading
        self.overflow = 0  # sample observations dropped at the bucket cap


class TimeSeriesStore:
    """Fixed-memory ring of aligned time buckets per metric series.

    ``window_s`` is the maximum trailing window any query can span (the ring
    holds ``ceil(window_s / bucket_s)`` buckets); ``bucket_s`` the alignment
    granularity (queries quantize to whole buckets). Writers and readers
    share one lock — every operation is a few list writes, never I/O."""

    def __init__(self, window_s: float = 600.0, bucket_s: float = 5.0,
                 *, clock=time.monotonic, max_series: int = 256,
                 samples_per_bucket: int = 256):
        if bucket_s <= 0 or window_s < bucket_s:
            raise ValueError(
                f"need window_s >= bucket_s > 0, got window_s={window_s} "
                f"bucket_s={bucket_s}")
        self.bucket_s = float(bucket_s)
        self.window_s = float(window_s)
        self.n_buckets = int(math.ceil(window_s / bucket_s))
        self.max_series = int(max_series)
        self.samples_per_bucket = int(samples_per_bucket)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self.dropped_series = 0  # writes refused at the max_series cap

    # ------------------------------------------------------------- writing

    def _slot(self, s: _Series, now: float) -> int:
        """The ring slot for ``now``'s bucket, recycled if stale (under the
        caller's lock)."""
        epoch = int(now // self.bucket_s)
        i = epoch % s.n
        if s.epochs[i] != epoch:
            s.epochs[i] = epoch
            s.vals[i] = None
        return i

    def _get(self, name: str, kind: str) -> _Series | None:
        s = self._series.get(name)
        if s is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                return None
            s = self._series[name] = _Series(kind, self.n_buckets)
        elif s.kind != kind:
            return None  # kind conflict: refuse silently (store stays sane)
        return s

    def add(self, name: str, amount: float = 1.0,
            now: float | None = None) -> None:
        """Accumulate ``amount`` into the counter series' current bucket."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._get(name, "counter")
            if s is None:
                return
            i = self._slot(s, now)
            s.vals[i] = (s.vals[i] or 0.0) + amount

    def record_cum(self, name: str, value: float,
                   now: float | None = None, *,
                   first_counts: bool = False) -> None:
        """Feed a *cumulative* counter reading (a registry counter's current
        value): the positive delta from the previous reading lands in the
        current bucket. The first reading only sets the baseline (pre-watch
        history must not spike the window) — unless ``first_counts``, where
        it counts in full from zero: the pump passes that for a labeled
        child that appears while its family was already being watched, so
        a ratio of child/family-total never reads 0/N for the cycle the
        child first shows up in. A reading below the previous one is a
        counter reset — the new value counts from zero."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._get(name, "counter")
            if s is None:
                return
            prev, s.last_cum = s.last_cum, float(value)
            if prev is None:
                if not first_counts:
                    return
                prev = 0.0
            delta = value - prev if value >= prev else value
            if delta <= 0:
                return
            i = self._slot(s, now)
            s.vals[i] = (s.vals[i] or 0.0) + delta

    def watched(self, name: str) -> bool:
        """True when the series already exists (has at least a baseline)."""
        with self._lock:
            return name in self._series

    def set(self, name: str, value: float, now: float | None = None) -> None:
        """Set the gauge series' current-bucket value (last write wins)."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._get(name, "gauge")
            if s is None:
                return
            s.vals[self._slot(s, now)] = float(value)

    def observe(self, name: str, value: float,
                now: float | None = None) -> None:
        """Append one raw observation to the sample series' current bucket
        (dropped, counted, past ``samples_per_bucket``)."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._get(name, "sample")
            if s is None:
                return
            i = self._slot(s, now)
            if s.vals[i] is None:
                s.vals[i] = []
            if len(s.vals[i]) < self.samples_per_bucket:
                s.vals[i].append(float(value))
            else:
                s.overflow += 1

    # ------------------------------------------------------------- queries

    def _window_cells(self, s: _Series, window_s: float, now: float):
        """The (epoch-valid) cell values covering the trailing window,
        newest-last (under the caller's lock)."""
        k = max(1, min(s.n, int(math.ceil(window_s / self.bucket_s))))
        top = int(now // self.bucket_s)
        out = []
        for epoch in range(top - k + 1, top + 1):
            i = epoch % s.n
            if s.epochs[i] == epoch and s.vals[i] is not None:
                out.append(s.vals[i])
        return out

    def delta(self, name: str, window_s: float,
              now: float | None = None) -> float:
        """Sum of a counter series' increments over the trailing window
        (0.0 for an unknown series)."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "counter":
                return 0.0
            return float(sum(self._window_cells(s, window_s, now)))

    def rate(self, name: str, window_s: float,
             now: float | None = None) -> float:
        """Per-second rate of a counter series over the trailing window."""
        return self.delta(name, window_s, now) / max(window_s, 1e-9)

    def values(self, name: str, window_s: float,
               now: float | None = None) -> list[float]:
        """Every sample observed in the trailing window (oldest bucket
        first; [] for an unknown series)."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "sample":
                return []
            out: list[float] = []
            for cell in self._window_cells(s, window_s, now):
                out.extend(cell)
            return out

    def pct(self, name: str, q: float, window_s: float,
            now: float | None = None) -> float | None:
        """Nearest-rank percentile of the window's samples (None when
        empty)."""
        vals = self.values(name, window_s, now)
        return percentile(vals, q) if vals else None

    def mean(self, name: str, window_s: float,
             now: float | None = None) -> float | None:
        vals = self.values(name, window_s, now)
        return sum(vals) / len(vals) if vals else None

    def last(self, name: str, window_s: float | None = None,
             now: float | None = None) -> float | None:
        """A gauge series' most recent value inside the window (defaults to
        the full ring span); None when it never reported there."""
        now = self._clock() if now is None else now
        window_s = self.window_s if window_s is None else window_s
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "gauge":
                return None
            cells = self._window_cells(s, window_s, now)
            return float(cells[-1]) if cells else None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self, window_s: float | None = None,
                 now: float | None = None) -> dict:
        """One dict per series over the trailing window — the /debug/slo
        payload's raw-series section and the store's test surface."""
        now = self._clock() if now is None else now
        window_s = self.window_s if window_s is None else window_s
        with self._lock:
            items = list(self._series.items())
        out = {}
        for name, s in items:
            if s.kind == "counter":
                d = self.delta(name, window_s, now)
                out[name] = {"kind": "counter", "delta": d,
                             "rate": d / max(window_s, 1e-9)}
            elif s.kind == "gauge":
                out[name] = {"kind": "gauge",
                             "last": self.last(name, window_s, now)}
            else:
                vals = self.values(name, window_s, now)
                out[name] = {
                    "kind": "sample", "count": len(vals),
                    "p50": percentile(vals, 50) if vals else None,
                    "p99": percentile(vals, 99) if vals else None,
                }
        return out


def _flat(name: str, labelnames, labelvalues) -> str:
    if not labelnames:
        return name
    pairs = ",".join(f"{k}={v}" for k, v in zip(labelnames, labelvalues))
    return f"{name}{{{pairs}}}"


def pump_registry(store: TimeSeriesStore,
                  registry: MetricsRegistry | None = None,
                  now: float | None = None,
                  only: "set[str] | None" = None) -> None:
    """Snapshot registry families into the store: counters feed
    cumulative-counter series (per labeled child, plus the summed family
    total under the bare name so ratio objectives can divide a labeled
    child by its family), gauges feed gauge series, histograms feed their
    ``_count``/``_sum`` as cumulative counters. Never raises — it rides
    the render hook and the SLO tick.

    ``only`` restricts the pump to the named families (bare family names,
    no label suffix). The SLO engine passes the families its objectives
    actually read: the registry is process-global and grows a labeled
    child per engine/scope ever created, while each store is a bounded
    per-engine ring — pumping everything would crowd a long-lived
    process's store past ``max_series`` and starve the latency-sample
    feed the percentile objectives depend on."""
    reg = registry if registry is not None else get_registry()
    try:
        fams = reg.families()
    except Exception:
        return
    for fam in fams:
        if only is not None and fam.name not in only:
            continue
        try:
            children = fam.children()
            if fam.kind == "counter":
                # a child born while the family was already watched accrued
                # its whole value under observation — count it from zero,
                # keeping child and family-total series consistent
                was_watched = store.watched(fam.name)
                total = 0.0
                for values, child in children.items():
                    v = child.value
                    total += v
                    if fam.labelnames:
                        store.record_cum(
                            _flat(fam.name, fam.labelnames, values), v, now,
                            first_counts=was_watched)
                store.record_cum(fam.name, total, now)
            elif fam.kind == "gauge":
                for values, child in children.items():
                    store.set(_flat(fam.name, fam.labelnames, values),
                              child.value, now)
            else:  # histogram
                csum = 0.0
                ccount = 0
                for values, child in children.items():
                    _, hsum, hcount = child.snapshot()
                    csum += hsum
                    ccount += hcount
                store.record_cum(fam.name + "_count", ccount, now)
                store.record_cum(fam.name + "_sum", csum, now)
        except Exception:
            continue


def install_collector(store: TimeSeriesStore,
                      registry: MetricsRegistry | None = None,
                      only: "set[str] | None" = None):
    """Hang :func:`pump_registry` on the registry's render hook so every
    ``/metrics`` scrape advances the store (``only`` as in the pump).
    Returns the collector callable — hand it to
    ``registry.remove_collector`` at teardown."""
    reg = registry if registry is not None else get_registry()

    def _collect():
        pump_registry(store, reg, only=only)

    reg.add_collector(_collect)
    return _collect
