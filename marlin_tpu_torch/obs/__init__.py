"""Unified observability: metrics registry, exposition, traces, analysis.

Counterpart of ``marlin_tpu/obs/``. Copied (stdlib-only in the JAX package
too): :mod:`~marlin_tpu_torch.obs.metrics`,
:mod:`~marlin_tpu_torch.obs.report`, :mod:`~marlin_tpu_torch.obs.exposition`
and :mod:`~marlin_tpu_torch.obs.console`. Rewritten on their device side:
:mod:`~marlin_tpu_torch.obs.trace` (a span is also a ``torch.profiler``
range while a capture is on), :mod:`~marlin_tpu_torch.obs.perf` (a per-GPU
peak table, analytic program costs, ``torch.profiler`` captures),
:mod:`~marlin_tpu_torch.obs.memledger` (``torch.cuda.memory_allocated`` as
the live view, no TPU calibration table) and
:mod:`~marlin_tpu_torch.obs.collectors` (kernel builds as the compile
tally, ``torch.cuda.memory_stats`` gauges).

- :mod:`~marlin_tpu_torch.obs.metrics` — thread-safe process-global registry
  of labeled ``Counter``/``Gauge``/``Histogram`` families with Prometheus
  text exposition.
- :mod:`~marlin_tpu_torch.obs.exposition` — stdlib ``http.server``
  ``/metrics`` endpoint; :func:`start_from_config` starts it from
  ``obs_http_port``.
- :mod:`~marlin_tpu_torch.obs.trace` — spans: contextvars propagation so
  every EventLog record carries ``trace_id``/``span_id``/``parent_id``, and
  under a ``torch.profiler`` capture a ``"marlin." + name`` range on the
  clock of the device's events.
- :mod:`~marlin_tpu_torch.obs.report` — the post-hoc analyzer
  (``python -m marlin_tpu_torch.obs.report events.jsonl``).
- :mod:`~marlin_tpu_torch.obs.timeseries` — bounded in-process windowed
  store (a ring of aligned time buckets per series) fed from the registry
  by a render-time collector (copied, stdlib-only).
- :mod:`~marlin_tpu_torch.obs.slo` — declarative serving SLOs
  (``serve_slo``) evaluated over the store: multi-window error-budget burn
  rates with hysteresis, ``marlin_slo_*`` gauges, breach hooks that drive
  admission shedding, ``GET /debug/slo`` (copied, stdlib-only).
- :mod:`~marlin_tpu_torch.obs.console` — live terminal ops console
  (``python -m marlin_tpu_torch.obs.console``) polling ``/metrics`` +
  ``/debug/slo`` (copied, stdlib-only).
- :mod:`~marlin_tpu_torch.obs.memledger` — per-component device-memory
  attribution, the reconciler, admission calibration, leak detection and
  OOM forensics.
- :mod:`~marlin_tpu_torch.obs.perf` — roofline accounting, profiler capture
  and the step-time flight recorder.
"""

from . import trace  # noqa: F401  (stdlib-only; must import first)
from . import memledger  # noqa: F401  (stdlib-only at import; torch lazy)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    percentile,
)
from .exposition import MetricsServer, start_from_config  # noqa: F401
from . import collectors  # noqa: F401  (imports utils.tracing lazily)
from . import perf  # noqa: F401  (imports torch lazily)
from .timeseries import TimeSeriesStore, install_collector  # noqa: F401
from .slo import SloEngine, fleet_merge, objectives_from_config  # noqa: F401

from .memledger import (  # noqa: F401
    MemoryLedger,
    get_leak_detector,
    get_ledger,
)

__all__ = ["trace", "collectors", "memledger", "perf", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "get_registry", "percentile",
           "MetricsServer", "start_from_config", "TimeSeriesStore",
           "install_collector", "SloEngine", "fleet_merge",
           "objectives_from_config", "MemoryLedger", "get_ledger",
           "get_leak_detector"]
