"""Runtime collectors: compiles and device memory on the metrics registry.

Counterpart of ``marlin_tpu/obs/collectors.py``, with the device side
rewritten for PyTorch:

- **Compiles** — the JAX package bridges ``jax.monitoring``'s XLA compile
  events. The port compiles no programs: its only compiler is ``nvcc``,
  which builds the kernel library once per checkout on first use
  (``ops/_build.py`` calls :func:`record_compile` when it does). The serving
  path compiles nothing per bucket or per request, so :func:`compile_count`
  stays 0 over a serve on the CPU, and moves at most once on the card, when
  the first kernel launch of a fresh checkout builds the library.
  :func:`install_compile_metrics` registers ``marlin_compile_total`` /
  ``marlin_compile_seconds`` so a scrape shows them (at zero until a build).
- **Device memory** — :func:`install_device_memory_gauges` registers a
  render-time collector publishing ``torch.cuda.memory_stats`` of every
  visible card (``allocated_bytes.all.current`` as bytes in use, the card's
  total memory as the limit, labeled ``cuda:<i>``) next to the planner's
  budget (``marlin_hbm_planner_budget_bytes``,
  :func:`~marlin_tpu_torch.models.planner.usable_hbm_bytes`). Nothing on
  the CPU. :func:`log_device_memory` emits the same numbers as an EventLog
  record for the analyzer's memory timeline.
- :func:`install_default_collectors` installs both (idempotent per
  registry); :class:`~marlin_tpu_torch.obs.exposition.MetricsServer` calls
  it on start so every scrape endpoint carries them."""

from __future__ import annotations

import threading

from .metrics import MetricsRegistry, get_registry

__all__ = ["install_compile_metrics", "compile_count", "record_compile",
           "install_device_memory_gauges", "log_device_memory",
           "install_default_collectors"]

_lock = threading.Lock()
_compile_count = 0
_compile_families = None  # (total counter, seconds histogram) once installed
_memory_installed: set[int] = set()  # id(registry) -> collector installed


def install_compile_metrics(registry: MetricsRegistry | None = None) -> None:
    """Register the compile families (idempotent; the first caller's registry
    wins — there is one process-wide tally)."""
    global _compile_families
    reg = registry if registry is not None else get_registry()
    with _lock:
        if _compile_families is not None:
            return
        _compile_families = (
            reg.counter("marlin_compile_total",
                        "Kernel library builds (nvcc) in this process"),
            reg.histogram("marlin_compile_seconds",
                          "Kernel library build durations (seconds)"))


def record_compile(seconds: float) -> None:
    """One kernel library build of ``seconds``: counts it, observes it on
    the compile families when installed, and lands a ``kind="compile"``
    record in the default EventLog when one is installed. Never raises."""
    global _compile_count
    with _lock:
        _compile_count += 1
        fams = _compile_families
    try:
        if fams is not None:
            fams[0].inc()
            fams[1].observe(seconds)
        from ..utils.tracing import get_default_event_log

        log = get_default_event_log()
        if log is not None:
            log.event("compile", seconds=seconds)
    except Exception:
        pass  # a metrics failure must never fail the build


def compile_count() -> int:
    """Kernel library builds in this process (see the module docstring: the
    serving path compiles nothing, so this stays 0 across a serve on the
    CPU). Consumers take deltas around a block."""
    return _compile_count


def _device_memory() -> dict:
    """``{"cuda:<i>": (bytes in use, total bytes)}`` over the visible cards;
    empty without CUDA."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = (
                int(stats.get("allocated_bytes.all.current", 0)),
                int(torch.cuda.get_device_properties(i).total_memory))
        except Exception:
            pass
    return out


def _collect_device_memory(reg: MetricsRegistry) -> None:
    in_use = reg.gauge(
        "marlin_device_memory_bytes_in_use",
        "Per-card torch.cuda.memory_stats()['allocated_bytes.all.current']",
        labelnames=("device",))
    limit = reg.gauge(
        "marlin_device_memory_bytes_limit",
        "Per-card total memory (torch.cuda.get_device_properties)",
        labelnames=("device",))
    budget = reg.gauge(
        "marlin_hbm_planner_budget_bytes",
        "The planner's usable device-memory budget "
        "(models.planner.usable_hbm_bytes) — what serving admission gates "
        "KV-cache bytes against")
    mem = _device_memory()
    for key, (used, total) in mem.items():
        in_use.labels(device=key).set(used)
        limit.labels(device=key).set(total)
    if mem:
        try:
            from ..models.planner import usable_hbm_bytes

            budget.set(usable_hbm_bytes("cuda"))
        except Exception:
            pass


def install_device_memory_gauges(registry: MetricsRegistry | None = None,
                                 ) -> None:
    """Attach the device-memory/planner-budget collector to ``registry``
    (idempotent per registry): gauges refresh at every render, so a scrape
    reads live device state with no background poller."""
    reg = registry if registry is not None else get_registry()
    with _lock:
        if id(reg) in _memory_installed:
            return
        _memory_installed.add(id(reg))
    reg.add_collector(lambda: _collect_device_memory(reg))


def log_device_memory(log=None, **fields) -> None:
    """Emit one ``kind="memory"`` EventLog record with per-card bytes in use
    (the analyzer's memory-timeline sample). Uses the default log when none
    is given; no-ops without one."""
    if log is None:
        from ..utils.tracing import get_default_event_log

        log = get_default_event_log()
    if log is None:
        return
    devices = {k: used for k, (used, _) in _device_memory().items()}
    log.event("memory", devices=devices, **fields)


def install_default_collectors(registry: MetricsRegistry | None = None,
                               ) -> None:
    """Everything a scrape endpoint should carry: the compile families, the
    device-memory/planner gauges, the program-cost/roofline collector
    (obs/perf.py — ``marlin_program_*``), the memory-ledger reconciler
    (obs/memledger.py — ``marlin_mem_*``, each scrape doubling as one
    leak-detection window), and the prefetch family pre-registration (so a
    serving-only process still exposes the prefetch series at zero instead
    of omitting them)."""
    reg = registry if registry is not None else get_registry()
    install_compile_metrics(reg)
    install_device_memory_gauges(reg)
    from .memledger import install_memledger_gauges
    from .perf import install_program_costs

    install_program_costs(reg)
    install_memledger_gauges(reg)
    if reg is get_registry():
        # prefetch declares its families lazily on first pipeline; touch
        # them so the series exist (at zero) on processes that never stream
        from ..parallel import prefetch as _prefetch

        _prefetch._metric_families()
