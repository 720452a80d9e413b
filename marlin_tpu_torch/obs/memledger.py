"""MemoryLedger — device-memory attribution for the serving stack.

Counterpart of ``marlin_tpu/obs/memledger.py``; the ledger, the leak
detector and the OOM forensics are the JAX package's, and the device side
is rewritten for PyTorch: live bytes are ``torch.cuda.memory_allocated``
summed over the visible cards ("n/a" on the CPU, as the reference gives off
the TPU), an OOM is also a ``torch.cuda.OutOfMemoryError``, and admission
calibration reads only peaks measured in this process — never the JAX
package's TPU compile table (``AOT_MEMORY.json``). Three pieces:

- :class:`MemoryLedger` — a process-global, thread-safe account where every
  device-resident allocation registers a named, component-labeled footprint
  (KV page slabs under ``kvpool``, BucketProgram model buffers under
  ``program``, prefetch in-flight bytes under ``prefetch``, autotune
  scratch, checkpoint staging, migration blobs in flight) with exact debit
  on free, so ``sum(ledger) == what we think we hold`` at all times —
  :meth:`MemoryLedger.audit` cross-checks the running total against a full
  recomputation in the :meth:`~marlin_tpu_torch.serving.kvpool.PagedKVPool.audit`
  style and carries every accounting anomaly (double register, strict free
  of an unknown name, a flow entry driven negative) as an error.
- **The three-view reconciler** — :func:`reconcile` joins (a) the ledger's
  registered bytes, (b) live ``torch.cuda.memory_allocated`` where there is
  a card (graceful ``None`` → rendered "n/a" on CPU), and (c) the measured
  peaks ProgramCosts holds —
  exposed as the ``marlin_mem_{registered,live,unattributed}_bytes``
  gauge families (:func:`install_memledger_gauges`, a render-time
  collector like the device-memory gauges) and ``GET /debug/memory``
  (:func:`memory_payload`).
- **Measured-peak admission calibration** — :func:`admission_ratio`
  answers "how far above the planner's slab estimate does this bucket's
  program actually peak": a live ProgramCosts measurement for the exact
  program key, else 1.0. The serving engine multiplies its per-bucket
  admission cost by this ratio when ``serve_admission_calibration`` is on.

Plus two alarm paths: :class:`LeakDetector` (a component freed in the
ledger whose live bytes do not drop across N observation windows →
``kind="mem"`` / ``ev="leak"`` event + SLO-style hooks) and
:func:`dump_oom_forensics` (on RESOURCE_EXHAUSTED / allocation failure the
engine dumps the full ledger + per-bucket ratios + every flight-recorder
ring to ONE JSONL artifact *before* the retry path runs — the OOM
post-mortem that used to evaporate with the retry).

Import cost is stdlib-only; torch is imported lazily inside the live-bytes
probe. All mutators run under one lock.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["MemoryLedger", "LeakDetector", "KNOWN_COMPONENTS",
           "get_ledger", "get_leak_detector", "reset_ledger",
           "live_device_bytes", "reconcile", "measured_peak_bytes",
           "admission_ratio", "ratio_table", "memory_payload",
           "install_memledger_gauges", "emit_snapshot", "is_oom_error",
           "dump_oom_forensics"]

#: The canonical component vocabulary — every ledger registration must use
#: one of these (the JAX package's set, so ledgers of the two read alike).
KNOWN_COMPONENTS = ("autotune", "ckpt", "kvpool", "migration", "prefetch",
                    "program")

_MAX_ANOMALIES = 64   # bounded: an accounting bug must not grow a list forever
_MAX_ALERTS = 32      # leak alerts kept for /debug/memory
_MAX_OOM_DUMPS = 16   # forensics artifacts kept per capture dir (perf's cap)


class _Entry:
    __slots__ = ("name", "component", "nbytes", "owner")

    def __init__(self, name: str, component: str, nbytes: int, owner: str):
        self.name = name
        self.component = component
        self.nbytes = int(nbytes)
        self.owner = owner


class MemoryLedger:
    """The process memory account (see module docstring).

    Two entry shapes share one namespace: *slab* entries
    (:meth:`register` / :meth:`free` — a fixed-size allocation debited
    exactly once) and *flow* entries (:meth:`add` — a byte counter for
    in-flight traffic like prefetch, created on first credit and clamped
    at zero). :meth:`transfer` atomically reassigns an entry's owner (the
    migration freeze→adopt handoff: debit the source, credit the target,
    exactly once, with the process total invariant throughout)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: dict[str, _Entry] = {}
        self._total = 0
        self._anomalies: list[str] = []
        self._free_listeners: list = []

    # ------------------------------------------------------------- mutation

    def _anomaly(self, msg: str) -> None:
        if len(self._anomalies) < _MAX_ANOMALIES:
            self._anomalies.append(msg)

    def register(self, name: str, nbytes: int, component: str,
                 owner: str = "") -> None:
        """Credit one named allocation. A re-register of a live name is an
        accounting anomaly (the audit reports it) but replaces the entry —
        the total stays exact either way; free before re-registering."""
        nbytes = int(nbytes)
        with self._lock:
            if component not in KNOWN_COMPONENTS:
                self._anomaly(f"register({name!r}): unknown component "
                              f"{component!r}")
            if nbytes < 0:
                self._anomaly(f"register({name!r}): negative size {nbytes}")
                nbytes = 0
            old = self._entries.get(name)
            if old is not None:
                self._anomaly(f"register({name!r}): double register "
                              f"(replacing {old.nbytes} bytes)")
                self._total -= old.nbytes
            self._entries[name] = _Entry(name, component, nbytes, owner)
            self._total += nbytes

    def free(self, name: str, strict: bool = True) -> int:
        """Debit one named allocation exactly; returns the bytes freed.
        ``strict=False`` makes an unknown name a no-op (idempotent
        teardown paths — close after recover); strict frees of unknown
        names are anomalies."""
        with self._lock:
            e = self._entries.pop(name, None)
            if e is None:
                if strict:
                    self._anomaly(f"free({name!r}): not registered")
                return 0
            self._total -= e.nbytes
            freed = e.nbytes
            component = e.component
            listeners = list(self._free_listeners)
        for fn in listeners:
            try:
                fn(component, freed)
            except Exception:
                pass
        return freed

    def add(self, name: str, delta: int, component: str,
            owner: str = "") -> None:
        """Flow-entry credit/debit: ``delta`` bytes onto a counter entry,
        created at zero on first use. Driving a counter negative is an
        anomaly (clamped); a counter debited back to zero stays registered
        at zero — flows are long-lived series, not one-shot slabs."""
        delta = int(delta)
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(name, component, 0, owner)
            new = e.nbytes + delta
            if new < 0:
                self._anomaly(f"add({name!r}, {delta}): flow driven "
                              f"negative ({e.nbytes} held)")
                new = 0
            self._total += new - e.nbytes
            e.nbytes = new
            component = e.component
            listeners = list(self._free_listeners) if delta < 0 else ()
        for fn in listeners:
            try:
                fn(component, -delta)
            except Exception:
                pass

    def transfer(self, name: str, owner: str) -> bool:
        """Atomically reassign an entry's owner — the cross-engine
        migration handoff (source debited, target credited, exactly once;
        the process total never moves). False when the name is unknown
        (already consumed — a second transfer is not an anomaly, it is
        how at-most-once reads on the adopt side stay idempotent)."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return False
            e.owner = owner
            return True

    def free_owner(self, owner: str, strict: bool = False) -> int:
        """Debit every entry an owner still holds (terminal engine close —
        a closed engine must leave the ledger clean). Returns bytes freed."""
        with self._lock:
            names = [n for n, e in self._entries.items() if e.owner == owner]
        return sum(self.free(n, strict=strict) for n in names)

    def add_free_listener(self, fn) -> None:
        """``fn(component, nbytes)`` after every debit — the leak
        detector's feed. Idempotent per callable."""
        with self._lock:
            if fn not in self._free_listeners:
                self._free_listeners.append(fn)

    # -------------------------------------------------------------- queries

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def totals(self) -> dict:
        """Bytes by component (only components with a live entry)."""
        with self._lock:
            out: dict[str, int] = {}
            for e in self._entries.values():
                out[e.component] = out.get(e.component, 0) + e.nbytes
            return out

    def owner_bytes(self, owner: str) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.owner == owner)

    def entries(self) -> list[dict]:
        with self._lock:
            return [{"name": e.name, "component": e.component,
                     "bytes": e.nbytes, "owner": e.owner}
                    for e in sorted(self._entries.values(),
                                    key=lambda e: e.name)]

    def audit(self) -> dict:
        """Cross-check every ledger invariant (the PagedKVPool.audit
        contract: ``{"ok", "errors", **stats}``, read-only, never raises):
        the incrementally maintained total must equal a full recomputation,
        no entry may be negative, and every recorded accounting anomaly —
        double register, strict free of an unknown name, a flow driven
        negative — is an error. Exact at any quiesce point; advisory only
        against concurrent mutators (each op is atomic, the sum is a
        snapshot)."""
        with self._lock:
            errors = list(self._anomalies)
            recomputed = 0
            for e in self._entries.values():
                if e.nbytes < 0:
                    errors.append(f"entry {e.name!r} negative "
                                  f"({e.nbytes} bytes)")
                if e.component not in KNOWN_COMPONENTS:
                    errors.append(f"entry {e.name!r} has unknown component "
                                  f"{e.component!r}")
                recomputed += e.nbytes
            if recomputed != self._total:
                errors.append(f"running total {self._total} != recomputed "
                              f"{recomputed}")
            return {"ok": not errors, "errors": errors,
                    "registered_bytes": recomputed,
                    "entries": len(self._entries),
                    "components": self.totals()}

    def reset(self) -> None:
        """Drop every entry and anomaly (tests)."""
        with self._lock:
            self._entries.clear()
            self._anomalies.clear()
            self._total = 0


class LeakDetector:
    """Freed-but-not-released watch: when the ledger debits a component by
    ``min_bytes`` or more, the backend's live byte count is expected to
    drop within ``windows`` observation samples (one per scrape of the
    memledger collector, or per explicit :meth:`observe`). A pending free
    that outlives its window with live bytes still within half the freed
    size of the free-time level raises ONE ``kind="mem"`` / ``ev="leak"``
    event and fires the SLO-style hooks. Without a card nothing calls
    :meth:`observe`, so the detector is a structural no-op on the CPU —
    pending frees age out silently."""

    def __init__(self, windows: int | None = None,
                 min_bytes: int = 32 * 1024 * 1024,
                 clock=time.monotonic):
        if windows is None:
            try:
                from ..config import get_config

                windows = int(get_config().obs_mem_leak_windows)
            except Exception:
                windows = 3
        self.windows = max(1, int(windows))
        self.min_bytes = int(min_bytes)
        self._clock = clock
        self._lock = threading.Lock()
        self._hooks: list = []
        self._pending: list[dict] = []   # {component, freed, live0, seen}
        self._last_live: int | None = None
        self.alerts: list[dict] = []

    def add_hook(self, fn) -> None:
        """``fn(alert_dict)`` on every leak verdict (idempotent per
        callable) — the same shape as SloEngine breach hooks: wire it to
        shedding, paging, or a log."""
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def note_free(self, component: str, nbytes: int) -> None:
        """The ledger's free listener: arm a watch for debits worth
        watching (≥ ``min_bytes``) when a live baseline exists."""
        if nbytes < self.min_bytes:
            return
        with self._lock:
            if self._last_live is None:
                return  # no live view (CPU): nothing to reconcile against
            self._pending.append({"component": component,
                                  "freed_bytes": int(nbytes),
                                  "live_at_free": self._last_live,
                                  "seen": 0, "t": self._clock()})

    def observe(self, live_bytes: int) -> list[dict]:
        """One reconciliation sample; returns the alerts this sample
        raised (also kept on ``.alerts`` and emitted as events)."""
        fired: list[dict] = []
        with self._lock:
            self._last_live = int(live_bytes)
            keep: list[dict] = []
            for p in self._pending:
                p["seen"] += 1
                dropped = p["live_at_free"] - live_bytes
                if dropped >= p["freed_bytes"] // 2:
                    continue  # the free showed up live: watch resolved
                if p["seen"] < self.windows:
                    keep.append(p)
                    continue
                alert = {"component": p["component"],
                         "freed_bytes": p["freed_bytes"],
                         "live_drop_bytes": int(dropped),
                         "windows": self.windows, "t": p["t"]}
                fired.append(alert)
                self.alerts.append(alert)
                del self.alerts[:-_MAX_ALERTS]
            self._pending = keep
            hooks = list(self._hooks)
        for alert in fired:
            _emit_event(ev="leak", **{k: v for k, v in alert.items()
                                      if k != "t"})
            for fn in hooks:
                try:
                    fn(dict(alert))
                except Exception:
                    pass
        return fired

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def reset(self) -> None:
        with self._lock:
            self._pending.clear()
            self.alerts.clear()
            self._last_live = None


# ------------------------------------------------------- process singletons

_LEDGER = MemoryLedger()
_DETECTOR: LeakDetector | None = None
_singleton_lock = threading.Lock()


def get_ledger() -> MemoryLedger:
    """The process-global ledger every registration site writes to."""
    return _LEDGER


def get_leak_detector() -> LeakDetector:
    """The process leak detector, wired to the global ledger's free feed
    on first use."""
    global _DETECTOR
    with _singleton_lock:
        if _DETECTOR is None:
            _DETECTOR = LeakDetector()
            _LEDGER.add_free_listener(_DETECTOR.note_free)
        return _DETECTOR


def reset_ledger() -> None:
    """Test hook: clear the ledger, the leak detector, and the cached
    admission ratios."""
    _LEDGER.reset()
    if _DETECTOR is not None:
        _DETECTOR.reset()
    with _ratio_lock:
        _ratio_cache.clear()
    global _last_oom_dump
    _last_oom_dump = 0.0


def _emit_event(**fields) -> None:
    """One ``kind="mem"`` record in the default EventLog (the lazy-binding
    idiom every obs emitter uses; swallows everything — accounting must
    never fail the path it observes)."""
    try:
        from ..utils.tracing import get_default_event_log

        log = get_default_event_log()
        if log is not None:
            log.event("mem", **fields)
    except Exception:
        pass


def emit_snapshot(log=None) -> None:
    """Land one ``ev="snapshot"`` memory-attribution record (per-component
    bytes + total) — engines call this at terminal close so the post-hoc
    report's memory section has data even without a scrape."""
    led = get_ledger()
    fields = {"ev": "snapshot", "components": led.totals(),
              "total_bytes": led.total_bytes()}
    try:
        if log is not None:
            log.event("mem", **fields)
        else:
            _emit_event(**fields)
    except Exception:
        pass


# --------------------------------------------------------------- reconciler

def live_device_bytes() -> int | None:
    """Bytes PyTorch's allocator holds in live tensors
    (``torch.cuda.memory_allocated``) summed over the visible cards, or None
    without CUDA — callers render "n/a", never zero (a zero would read as
    "nothing resident", the opposite of "unknown")."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return sum(int(torch.cuda.memory_allocated(i))
                   for i in range(torch.cuda.device_count()))
    except Exception:
        return None


def reconcile(ledger: MemoryLedger | None = None) -> dict:
    """The three-view join: ledger-registered bytes (by component), live
    backend bytes (None → "n/a"), and the unattributed remainder
    ``live - registered`` (only when live is known; negative means the
    ledger over-counts — reported, not clamped, because that asymmetry is
    the finding)."""
    led = ledger if ledger is not None else get_ledger()
    registered = led.total_bytes()
    live = live_device_bytes()
    out = {"registered_bytes": registered, "components": led.totals(),
           "live_bytes": live,
           "unattributed_bytes": None if live is None
           else live - registered}
    if live:
        out["unattributed_frac"] = round(
            max(live - registered, 0) / live, 4)
    else:
        out["unattributed_frac"] = None
    return out


# ----------------------------------------------- measured-peak calibration

_ratio_lock = threading.Lock()
_ratio_cache: dict[tuple, float] = {}

_RATIO_FLOOR = 1.0   # calibration only ever tightens admission
_RATIO_CAP = 32.0    # a corrupt table must not brick admission entirely


def measured_peak_bytes(programs, key: str) -> int | None:
    """The compiler-measured peak for one program key: the max
    ``peak_bytes`` over the given ProgramCosts families at ``key`` (the
    prefill/decode pair peak together — the slab is shared), or None when
    nothing measured (the analytic serving costs carry no peak)."""
    try:
        from . import perf

        peak = 0
        for row in perf.get_program_costs().rows():
            if row.get("program") in programs and row.get("key") == key:
                peak = max(peak, int(row.get("peak_bytes") or 0))
        return peak or None
    except Exception:
        return None


def admission_ratio(planner_bytes: int, programs, key: str) -> float:
    """measured peak / planner estimate for one bucket's program key,
    clamped to ``[1, 32]`` and cached per key (admission-path hot): a live
    ProgramCosts measurement for the EXACT key (model dims, page geometry,
    and kernel all key in), else 1.0 — uncalibrated admission. The JAX
    package's second source, the ``AOT_MEMORY.json`` table, holds TPU
    compile figures and is not read here."""
    ck = (tuple(programs), key)
    with _ratio_lock:
        cached = _ratio_cache.get(ck)
    if cached is not None:
        return cached
    ratio = 1.0
    if planner_bytes > 0:
        peak = measured_peak_bytes(programs, key)
        if peak:
            ratio = min(max(peak / float(planner_bytes), _RATIO_FLOOR),
                        _RATIO_CAP)
    with _ratio_lock:
        _ratio_cache[ck] = ratio
    return ratio


def ratio_table() -> list[dict]:
    """The planner-ratio table for /debug/memory: one row per program and
    key whose peak was measured in this process (ProgramCosts
    ``peak_bytes``). Empty until something measures a peak."""
    try:
        from . import perf

        return [{"program": r["program"], "key": r["key"],
                 "measured_peak_bytes": r["peak_bytes"]}
                for r in perf.get_program_costs().rows()
                if r.get("peak_bytes")]
    except Exception:
        return []


# ----------------------------------------------------- exposition / gauges

_gauges_installed: set[int] = set()


def _collect_mem(reg) -> None:
    led = get_ledger()
    registered = reg.gauge(
        "marlin_mem_registered_bytes",
        "MemoryLedger-registered device bytes by component "
        "(component='total' = whole ledger)", labelnames=("component",))
    live_g = reg.gauge(
        "marlin_mem_live_bytes",
        "torch.cuda.memory_allocated summed over the visible cards "
        "(absent without CUDA — CPU renders n/a, never zero)",
        labelnames=("component",))
    unatt = reg.gauge(
        "marlin_mem_unattributed_bytes",
        "live_bytes minus ledger-registered bytes — HBM nobody claims "
        "(absent without a live view)", labelnames=("component",))
    totals = led.totals()
    for comp in KNOWN_COMPONENTS:
        registered.labels(component=comp).set(totals.get(comp, 0))
    registered.labels(component="total").set(led.total_bytes())
    live = live_device_bytes()
    if live is not None:
        live_g.labels(component="total").set(live)
        unatt.labels(component="total").set(live - led.total_bytes())
        get_leak_detector().observe(live)


def install_memledger_gauges(registry=None) -> None:
    """Attach the ledger/reconciler collector to ``registry`` (idempotent
    per registry, refreshes at every render like the device-memory
    gauges). Each scrape is also one leak-detector observation window."""
    from .metrics import get_registry

    reg = registry if registry is not None else get_registry()
    with _singleton_lock:
        if id(reg) in _gauges_installed:
            return
        _gauges_installed.add(id(reg))
    reg.add_collector(lambda: _collect_mem(reg))


def memory_payload() -> tuple[int, dict]:
    """(status_code, body) for ``GET /debug/memory``: the full ledger
    snapshot, the self-audit, the three-view reconciliation (live/
    unattributed render "n/a" on CPU), the per-bucket planner-ratio
    table, and recent leak alerts. 503 when the audit reports a
    violation (an inconsistent account is as out-of-rotation as an
    inconsistent pool); never raises."""
    try:
        led = get_ledger()
        audit = led.audit()
        rec = reconcile(led)
        body = {
            "status": "ok" if audit["ok"] else "violated",
            "audit": audit,
            "entries": led.entries(),
            "registered_bytes": rec["registered_bytes"],
            "components": rec["components"],
            "live_bytes": ("n/a" if rec["live_bytes"] is None
                           else rec["live_bytes"]),
            "unattributed_bytes": ("n/a" if rec["unattributed_bytes"] is None
                                   else rec["unattributed_bytes"]),
            "unattributed_frac": ("n/a" if rec["unattributed_frac"] is None
                                  else rec["unattributed_frac"]),
            "planner_ratios": ratio_table(),
            "leak_alerts": list(get_leak_detector().alerts),
        }
        return (200 if audit["ok"] else 503), body
    except Exception as e:  # pragma: no cover - probe must never 500
        return 200, {"status": "error",
                     "error": f"{type(e).__name__}: {e}"}


# ------------------------------------------------------------ OOM forensics

_last_oom_dump = 0.0


def is_oom_error(exc: BaseException) -> bool:
    """Heuristic allocation-failure classifier over backend exceptions
    (``torch.cuda.OutOfMemoryError`` by type, the rest by message) and the
    engine's own :class:`PagePoolExhausted` (matched by name — no serving
    import from obs)."""
    if type(exc).__name__ in ("PagePoolExhausted", "OutOfMemoryError"):
        return True
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    msg = str(exc)
    return ("RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
            or "out of memory" in msg or "OOM" in msg)


def dump_oom_forensics(reason: str, extra: dict | None = None,
                       min_interval_s: float = 5.0) -> str | None:
    """Dump the full memory post-mortem to ONE JSONL artifact — the
    ledger (entries + audit + reconciliation), the per-bucket planner
    ratios, and every live flight-recorder ring — and land a
    ``kind="mem"`` / ``ev="oom_dump"`` event pointing at it. Called by
    the engine's allocation-failure paths BEFORE the retry runs (the
    retry rebuilds pools and destroys the evidence). Rate-limited
    (``min_interval_s``; pass 0 to force), pruned to the newest
    {max} artifacts, never raises. Returns the path, or None when
    skipped/failed.""".format(max=_MAX_OOM_DUMPS)
    global _last_oom_dump
    now = time.monotonic()
    if min_interval_s > 0 and now - _last_oom_dump < min_interval_s:
        return None
    _last_oom_dump = now
    try:
        from . import perf

        led = get_ledger()
        head = {"kind": "mem", "ev": "oom", "t": time.time(),
                "reason": reason, "audit": led.audit(),
                "reconcile": {k: v for k, v in reconcile(led).items()
                              if k != "components"}}
        if extra:
            head.update(extra)
        lines = [json.dumps(head, default=str)]
        for e in led.entries():
            lines.append(json.dumps({"kind": "mem", "ev": "entry", **e}))
        for row in ratio_table():
            lines.append(json.dumps({"kind": "mem", "ev": "ratio", **row},
                                    default=str))
        for rec in perf.flight_records():
            lines.append(json.dumps(rec, default=str))
        cap_dir = perf._capture_dir()
        path = os.path.join(
            cap_dir, f"marlin_oom_{os.getpid()}_{next(perf._dump_ids)}.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        try:  # prune oldest artifacts beyond the cap
            mine = sorted(
                (os.path.join(cap_dir, n) for n in os.listdir(cap_dir)
                 if n.startswith("marlin_oom_") and n.endswith(".jsonl")),
                key=os.path.getmtime)
            for stale in mine[:-_MAX_OOM_DUMPS]:
                os.unlink(stale)
        except OSError:
            pass
        _emit_event(ev="oom_dump", path=path, reason=reason,
                    registered_bytes=led.total_bytes())
        return path
    except Exception:
        return None
