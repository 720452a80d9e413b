"""Thread-safe process-global metrics registry with Prometheus exposition.

Counterpart of ``marlin_tpu/obs/metrics.py``, copied (the module is stdlib-only).

The reference's only observability was wall-clock prints (SURVEY §5.1/§5.5);
the repo until now kept four disconnected fragments (EventLog JSONL,
ServeMetrics counters, StageTimes, a test-only compile tally). This module
is the one sink they all record through: ``Counter`` / ``Gauge`` /
``Histogram`` families with label sets, registered by name in a
:class:`MetricsRegistry`, rendered in the Prometheus text exposition format
(version 0.0.4) so any scraper — or the bundled stdlib endpoint,
:mod:`marlin_tpu_torch.obs.exposition` — can read live state.

Design points:

- **Registration is idempotent** — ``registry.counter("x", ...)`` returns
  the existing family when the name is already registered with the same
  kind and label names (subsystems re-instantiate freely: every
  ``ServeEngine`` or ``ChunkPrefetcher`` grabs its families in its
  constructor); a *conflicting* re-registration raises.
- **Hot-path cost is two dict lookups and one small lock** — metrics sit on
  per-chunk / per-decode-step / per-request paths, never per-token, and
  must stay passive (the serve-bench A/B bound is 2%).
- **Collectors** — callables run at render time (device-memory gauges,
  planner budget) so scrape-time state is live without a background poller.

:func:`percentile` lives here too (nearest-rank, dependency-free) — it
predates the registry in ``serving.metrics`` and is shared by the serving
snapshot, the bench, and the trace analyzer.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "percentile", "DEFAULT_BUCKETS"]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list — tiny and
    dependency-free so the bench, tests, serving snapshot, and the trace
    analyzer share one definition."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of empty list")
    i = max(0, min(len(xs) - 1, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[i]


#: default histogram bucket bounds (seconds): spans sub-ms decode steps to
#: multi-second compiles; +Inf is implicit in exposition
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _format_value(v: float) -> str:
    """Prometheus sample value: integral floats render without the trailing
    .0 (counters read naturally), everything else as repr (full precision,
    scientific accepted by the format)."""
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: tuple[str, str] | None = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs) + "}"


class Counter:
    """Monotonically increasing value (one labeled child of a family)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Settable value (one labeled child of a family)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Cumulative-bucket histogram (one labeled child of a family)."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self._lock = threading.Lock()
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)  # per-bound (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.counts[i] += 1
                    break

    def snapshot(self) -> tuple[list[int], float, int]:
        """(cumulative bucket counts, sum, count) under the lock."""
        with self._lock:
            cum, running = [], 0
            for c in self.counts:
                running += c
                cum.append(running)
            return cum, self.sum, self.count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: kind + help + label names + labeled
    children. Label-free families proxy ``inc``/``set``/``observe``/…
    straight to their single anonymous child, so ``reg.counter("x").inc()``
    reads like a plain counter."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str], buckets: Sequence[float] | None):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or DEFAULT_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, *values, **kv):
        """The child for one label-value combination (created on first
        use). Accepts positional values in ``labelnames`` order or the
        same set as keywords."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(str(kv.pop(n)) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} "
                    f"(labels are {self.labelnames})") from None
            if kv:
                raise ValueError(f"{self.name}: unknown label(s) "
                                 f"{sorted(kv)} (labels are "
                                 f"{self.labelnames})")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label value(s) "
                f"{self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; address a child "
                f"via .labels(...)")
        return self.labels()

    # label-free proxies
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    @property
    def value(self) -> float:
        return self._default_child().value

    def children(self) -> dict[tuple, object]:
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Named families + render-time collectors. One process-global instance
    (:func:`get_registry`) serves the whole library; tests may build private
    instances for isolation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._collectors: list[Callable[[], None]] = []

    # ------------------------------------------------------------ registration

    def _register(self, name: str, help: str, kind: str,
                  labelnames: Iterable[str],
                  buckets: Sequence[float] | None = None) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}; cannot re-register "
                        f"as {kind} with labels {labelnames}")
                return fam
            fam = _Family(name, help, kind, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._register(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._register(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] | None = None) -> _Family:
        return self._register(name, help, "histogram", labelnames, buckets)

    def families(self) -> list[_Family]:
        """Every registered family, name-sorted — the iteration surface the
        time-series pump (obs/timeseries.py) reads; values are live objects,
        snapshot each family's ``children()`` to read consistently."""
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    # -------------------------------------------------------------- collectors

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callable run before every render (live gauges:
        device memory, queue depths read off an engine). Idempotent per
        callable object."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # ---------------------------------------------------------------- render

    def render(self) -> str:
        """The Prometheus text exposition (format version 0.0.4) of every
        family, collectors run first. A collector that raises is skipped —
        a broken probe must never fail the scrape (observability stays
        passive)."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        out: list[str] = []
        for fam in families:
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in sorted(fam.children().items()):
                if fam.kind == "histogram":
                    cum, total, count = child.snapshot()
                    for bound, c in zip(child.bounds, cum):
                        ls = _label_str(fam.labelnames, values,
                                        ("le", _format_value(bound)))
                        out.append(f"{fam.name}_bucket{ls} {c}")
                    ls = _label_str(fam.labelnames, values, ("le", "+Inf"))
                    out.append(f"{fam.name}_bucket{ls} {count}")
                    base = _label_str(fam.labelnames, values)
                    out.append(f"{fam.name}_sum{base} {_format_value(total)}")
                    out.append(f"{fam.name}_count{base} {count}")
                else:
                    ls = _label_str(fam.labelnames, values)
                    out.append(
                        f"{fam.name}{ls} {_format_value(child.value)}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Drop every family's children (values), keeping registrations and
        collectors. Test isolation only — production counters are
        cumulative by contract."""
        with self._lock:
            for fam in self._families.values():
                with fam._lock:
                    fam._children.clear()


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every library subsystem records into."""
    return _registry
