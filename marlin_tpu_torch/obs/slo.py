"""Declarative SLOs with multi-window error-budget burn rates.

Counterpart of ``marlin_tpu/obs/slo.py``, copied (stdlib-only).

The fleet (serving/router.py) had no live answer to "are we meeting our
latency/availability targets *right now*, and which replica is burning the
budget". This module closes the loop: objectives are declared in config
(``serve_slo`` — a tuple of dicts, see :func:`parse_objective`), evaluated
against a :class:`~marlin_tpu_torch.obs.timeseries.TimeSeriesStore` over two
trailing windows (a *fast* window that reacts inside one evaluation
interval, and the objective's own *slow* window that smooths the headline
compliance number), and summarized as error-budget **burn rates** — the
SRE framing: ``burn = error_rate / (1 - target_fraction)``, so burn 1.0
exactly consumes the budget over the window and burn >> 1 is an incident.

Objective metric grammar (the ``metric`` field):

=====================  ====================================================
``p99:<series>``       nearest-rank percentile of the window's samples vs
                       ``target`` (``p50``/``p90``/``p95``/``p999`` too);
                       the good-fraction defaults to the percentile itself
                       (p99 <= X  ==  "99% of requests under X"), so the
                       error budget is ``1 - 0.99``
``mean:<series>``      window sample mean vs ``target``
``ratio:<g>/<t>``      counter-delta ratio (e.g. ok results / all results)
                       vs a minimum ``target`` fraction; budget is
                       ``1 - target``
``rate:<series>``      per-second counter rate vs a minimum ``target``
``gauge:<series>``     the gauge's latest value vs ``target``
=====================  ====================================================

``op`` (``"<="``/``">="``) overrides the default direction; ``budget``
overrides the allowed error fraction where no natural one exists
(mean/rate/gauge default 0.01). Series names are the store's — registry
families land there verbatim (labeled children as ``name{label=value}``)
via the pump, latency samples via the ServeMetrics feed.

State machine per objective (hysteresis so a flapping burn does not strobe
the degradation hook): ``ok -> breach`` when the fast-window burn crosses
``serve_slo_burn_fast``; ``breach -> ok`` only after the fast burn has
stayed under half the threshold for ``serve_slo_hysteresis`` consecutive
evaluations. Transitions fire every registered ``on_breach`` hook (the
engine subscribes its AdmissionQueue for graceful shedding) and land as
``kind="slo"`` EventLog records; every evaluation refreshes the
``marlin_slo_{compliance,budget_remaining,burn_rate,breached}`` gauges
(labels ``slo``/``scope``) plus the ``marlin_slo_shed_total`` counter the
admission path increments per shed.

Everything is clock-injected and thread-safe; :meth:`SloEngine.tick` is
rate-limited internally (``serve_slo_eval_interval_s``) and driven from the
serving worker loop and the ``/debug/slo`` provider — no new threads.
"""

from __future__ import annotations

import re
import threading
import time

from ..config import get_config
from .metrics import get_registry, percentile
from .timeseries import TimeSeriesStore, pump_registry

__all__ = ["Objective", "SloEngine", "parse_objective",
           "objectives_from_config", "fleet_merge", "pump_families"]

_PCT_RE = re.compile(r"^p(\d{2,3})$")

#: aggregations whose violation is binary (no per-event good fraction) —
#: their error budget defaults to 1% unless the spec overrides it
_BINARY_BUDGET = 0.01


class Objective:
    """One parsed objective (immutable; :func:`parse_objective` builds it).

    ``agg`` is the aggregation ("p99", "mean", "ratio", "rate", "gauge");
    ``series`` the store series it reads (``good``/``total`` for ratio);
    ``op`` the compliance direction; ``budget`` the allowed error fraction
    the burn rate is normalized by."""

    __slots__ = ("name", "metric", "agg", "q", "series", "good", "total",
                 "target", "window_s", "op", "budget")

    def __init__(self, name, metric, agg, q, series, good, total, target,
                 window_s, op, budget):
        self.name = name
        self.metric = metric
        self.agg = agg
        self.q = q
        self.series = series
        self.good = good
        self.total = total
        self.target = float(target)
        self.window_s = float(window_s)
        self.op = op
        self.budget = float(budget)

    def __repr__(self):
        return (f"Objective({self.name!r}, {self.metric!r} {self.op} "
                f"{self.target} over {self.window_s}s)")


def parse_objective(spec: dict) -> Objective:
    """Build an :class:`Objective` from one ``serve_slo`` entry. Raises
    ``ValueError`` on a malformed spec — config errors must fail loudly at
    engine construction, not silently skip an objective."""
    try:
        name = str(spec["name"])
        metric = str(spec["metric"])
        target = float(spec["target"])
        window_s = float(spec["window_s"])
    except (KeyError, TypeError, ValueError) as exc:
        raise ValueError(f"serve_slo entry needs name/metric/target/"
                         f"window_s: {spec!r} ({exc})") from None
    if window_s <= 0:
        raise ValueError(f"serve_slo {name!r}: window_s must be > 0")
    agg, sep, series = metric.partition(":")
    if not sep or not series:
        raise ValueError(
            f"serve_slo {name!r}: metric must be '<agg>:<series>', got "
            f"{metric!r}")
    q = None
    good = total = None
    m = _PCT_RE.match(agg)
    if m:
        q = float(m.group(1)) / (10.0 if len(m.group(1)) == 3 else 1.0)
        if not 0 < q < 100:
            raise ValueError(f"serve_slo {name!r}: bad percentile {agg!r}")
        default_op, budget = "<=", max(1.0 - q / 100.0, 1e-6)
        agg = "pct"
    elif agg == "mean":
        default_op, budget = "<=", _BINARY_BUDGET
    elif agg == "ratio":
        good, sep, total = series.partition("/")
        if not sep or not good or not total:
            raise ValueError(
                f"serve_slo {name!r}: ratio metric must be "
                f"'ratio:<good>/<total>', got {metric!r}")
        if not 0 < target <= 1:
            raise ValueError(
                f"serve_slo {name!r}: ratio target must be in (0, 1]")
        default_op, budget = ">=", max(1.0 - target, 1e-6)
    elif agg == "rate":
        default_op, budget = ">=", _BINARY_BUDGET
    elif agg == "gauge":
        default_op, budget = "<=", _BINARY_BUDGET
    else:
        raise ValueError(
            f"serve_slo {name!r}: unknown aggregation {agg!r} (want "
            f"pNN/mean/ratio/rate/gauge)")
    op = str(spec.get("op", default_op))
    if op not in ("<=", ">="):
        raise ValueError(f"serve_slo {name!r}: op must be '<=' or '>='")
    budget = float(spec.get("budget", budget))
    if not 0 < budget <= 1:
        raise ValueError(f"serve_slo {name!r}: budget must be in (0, 1]")
    return Objective(name, metric, agg, q, series, good, total, target,
                     window_s, op, budget)


def objectives_from_config(cfg=None) -> list[Objective]:
    """Parse ``config.serve_slo`` (a tuple of spec dicts) into objectives."""
    cfg = cfg if cfg is not None else get_config()
    return [parse_objective(dict(s)) for s in (cfg.serve_slo or ())]


def pump_families(objectives) -> set[str]:
    """The registry family names a set of objectives reads — what the
    rate-limited tick passes to ``pump_registry(only=...)``. The global
    registry accretes a labeled child per engine ever created in the
    process; each store is a bounded per-engine ring, so the pump must
    carry only what evaluation will query. A store series name maps back
    to its family by stripping the ``{label=value}`` suffix; histogram
    derivatives (``X_count``/``X_sum``) map back to family ``X``."""
    names: set[str] = set()
    for o in objectives:
        for s in (o.series, o.good, o.total):
            if not s:
                continue
            base = s.split("{", 1)[0]
            names.add(base)
            for suffix in ("_count", "_sum"):
                if base.endswith(suffix):
                    names.add(base[:-len(suffix)])
    return names


class SloEngine:
    """Evaluate a set of objectives against one time-series store.

    ``scope`` labels every gauge/event this instance emits (the engine name
    for per-replica evaluation, ``"fleet"`` for the router merge). Knobs
    default from config: ``serve_slo_eval_interval_s`` (tick rate limit),
    ``serve_slo_fast_window_s`` (the reactive burn window),
    ``serve_slo_burn_fast`` (the fast-burn alert threshold) and
    ``serve_slo_hysteresis`` (consecutive clear evaluations to release)."""

    def __init__(self, objectives, store: TimeSeriesStore, *,
                 scope: str = "engine", registry=None, log=None,
                 clock=time.monotonic,
                 eval_interval_s: float | None = None,
                 fast_window_s: float | None = None,
                 burn_threshold: float | None = None,
                 hysteresis: int | None = None):
        cfg = get_config()
        self.objectives = [o if isinstance(o, Objective)
                           else parse_objective(dict(o))
                           for o in objectives]
        self.store = store
        self.scope = scope
        self._registry = registry
        self._log = log
        self._clock = clock
        self.pump_families = pump_families(self.objectives)
        self.eval_interval_s = float(
            cfg.serve_slo_eval_interval_s if eval_interval_s is None
            else eval_interval_s)
        self.fast_window_s = float(
            cfg.serve_slo_fast_window_s if fast_window_s is None
            else fast_window_s)
        self.burn_threshold = float(
            cfg.serve_slo_burn_fast if burn_threshold is None
            else burn_threshold)
        self.hysteresis = int(
            cfg.serve_slo_hysteresis if hysteresis is None else hysteresis)
        self._lock = threading.Lock()
        self._last_tick: float | None = None
        self._state: dict[str, dict] = {
            o.name: {"breached": False, "clear_streak": 0}
            for o in self.objectives}
        self._last_eval: list[dict] = []
        self._events: list[dict] = []  # recent transitions (bounded tail)
        self._hooks: list = []
        reg = registry if registry is not None else get_registry()
        labels = ("slo", "scope")
        self._g_compliance = reg.gauge(
            "marlin_slo_compliance",
            "Good fraction over the objective's window (1.0 = fully "
            "compliant)", labelnames=labels)
        self._g_budget = reg.gauge(
            "marlin_slo_budget_remaining",
            "Error budget left over the objective's window (1 - "
            "error_rate/budget, floored at 0)", labelnames=labels)
        self._g_burn = reg.gauge(
            "marlin_slo_burn_rate",
            "Fast-window error-budget burn rate (1.0 consumes the budget "
            "exactly over the window)", labelnames=labels)
        self._g_breached = reg.gauge(
            "marlin_slo_breached",
            "1 while the objective is in the breached (fast-burn) state, "
            "else 0 (hysteresis applies on clear)", labelnames=labels)
        self._c_shed = reg.counter(
            "marlin_slo_shed_total",
            "Requests shed by admission while this objective's breach "
            "drove graceful degradation (clean reject-with-reason, never "
            "a drop)", labelnames=labels)

    # ------------------------------------------------------------- plumbing

    def add_breach_hook(self, fn) -> None:
        """Register ``fn(event_dict)`` to fire on every breach/clear
        transition. Idempotent per callable."""
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def remove_breach_hook(self, fn) -> None:
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    def record_shed(self, n: int = 1) -> None:
        """Count ``n`` shed requests against every currently-breached
        objective (admission calls this per clean shed reject)."""
        with self._lock:
            breached = [name for name, st in self._state.items()
                        if st["breached"]]
        for name in breached or ["(none)"]:
            self._c_shed.labels(slo=name, scope=self.scope).inc(n)

    def breached(self) -> list[str]:
        """Names of objectives currently in the breached state."""
        with self._lock:
            return sorted(name for name, st in self._state.items()
                          if st["breached"])

    def _emit(self, **fields) -> None:
        # utils.tracing imports obs.trace at its own init: resolve the
        # default log lazily so this module stays importable from
        # obs/__init__ (same dance as obs.collectors)
        from ..utils.tracing import get_default_event_log

        log = self._log or get_default_event_log()
        if log is not None:
            try:
                log.event("slo", scope=self.scope, **fields)
            except Exception:
                pass

    # ------------------------------------------------------------ evaluation

    def _measure(self, o: Objective, window_s: float, now: float):
        """(value, error_rate, n) for one objective over one window.
        ``error_rate`` is None when the window holds no data — an empty
        window is *unknown*, not compliant breach fodder."""
        st = self.store
        if o.agg in ("pct", "mean"):
            vals = st.values(o.series, window_s, now)
            if not vals:
                return None, None, 0
            value = (percentile(vals, o.q) if o.agg == "pct"
                     else sum(vals) / len(vals))
            bad = sum(1 for v in vals if not _ok(v, o.op, o.target))
            return value, bad / len(vals), len(vals)
        if o.agg == "ratio":
            total = st.delta(o.total, window_s, now)
            if total <= 0:
                return None, None, 0
            good = st.delta(o.good, window_s, now)
            value = good / total
            return value, max(0.0, 1.0 - value), int(total)
        if o.agg == "rate":
            value = st.rate(o.series, window_s, now)
            return value, (0.0 if _ok(value, o.op, o.target) else 1.0), 1
        # gauge
        value = st.last(o.series, window_s, now)
        if value is None:
            return None, None, 0
        return value, (0.0 if _ok(value, o.op, o.target) else 1.0), 1

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Evaluate every objective (no rate limit, no registry pump) and
        drive the breach state machine. Returns one dict per objective."""
        now = self._clock() if now is None else now
        out, transitions = [], []
        with self._lock:
            hooks = list(self._hooks)
        for o in self.objectives:
            try:
                fast_w = min(self.fast_window_s, o.window_s)
                value, err_slow, n = self._measure(o, o.window_s, now)
                _, err_fast, n_fast = self._measure(o, fast_w, now)
                burn_fast = ((err_fast / o.budget)
                             if err_fast is not None else 0.0)
                burn_slow = ((err_slow / o.budget)
                             if err_slow is not None else 0.0)
                compliance = (1.0 - err_slow
                              if err_slow is not None else 1.0)
                remaining = max(0.0, 1.0 - burn_slow)
                with self._lock:
                    st = self._state[o.name]
                    was = st["breached"]
                    if not was:
                        if burn_fast >= self.burn_threshold and n_fast > 0:
                            st["breached"] = True
                            st["clear_streak"] = 0
                    else:
                        if burn_fast < 0.5 * self.burn_threshold:
                            st["clear_streak"] += 1
                            if st["clear_streak"] >= self.hysteresis:
                                st["breached"] = False
                        else:
                            st["clear_streak"] = 0
                    breached = st["breached"]
                rec = {
                    "slo": o.name, "metric": o.metric, "op": o.op,
                    "target": o.target, "window_s": o.window_s,
                    "value": value, "n": n, "compliance": compliance,
                    "burn_rate": burn_fast, "burn_slow": burn_slow,
                    "budget_remaining": remaining, "breached": breached,
                }
                out.append(rec)
                lbl = {"slo": o.name, "scope": self.scope}
                self._g_compliance.labels(**lbl).set(compliance)
                self._g_budget.labels(**lbl).set(remaining)
                self._g_burn.labels(**lbl).set(burn_fast)
                self._g_breached.labels(**lbl).set(1.0 if breached else 0.0)
                if breached != was:
                    ev = {"slo": o.name, "state": ("breach" if breached
                                                  else "clear"),
                          "burn_rate": round(burn_fast, 4),
                          "value": value, "target": o.target,
                          "window_s": o.window_s}
                    transitions.append(ev)
            except Exception:
                # one broken objective must never take down evaluation of
                # the rest (or the serving worker driving the tick)
                continue
        with self._lock:
            self._last_eval = out
            self._events.extend(transitions)
            del self._events[:-64]
        for ev in transitions:
            self._emit(**ev)
            for fn in hooks:
                try:
                    fn(dict(ev, breached=self.breached()))
                except Exception:
                    pass
        return out

    def tick(self, now: float | None = None) -> list[dict] | None:
        """Rate-limited evaluation driven from the serving worker loop and
        the /debug/slo provider: pumps the registry into the store, then
        :meth:`evaluate` — at most once per ``eval_interval_s``. Returns
        None when skipped. Never raises."""
        now = self._clock() if now is None else now
        with self._lock:
            if (self._last_tick is not None
                    and now - self._last_tick < self.eval_interval_s):
                return None
            self._last_tick = now
        try:
            pump_registry(self.store, self._registry, now,
                          only=self.pump_families)
        except Exception:
            pass
        return self.evaluate(now)

    def payload(self) -> dict:
        """The /debug/slo JSON for this scope: last evaluation per
        objective plus the recent transition tail."""
        with self._lock:
            return {"scope": self.scope,
                    "eval_interval_s": self.eval_interval_s,
                    "fast_window_s": self.fast_window_s,
                    "burn_threshold": self.burn_threshold,
                    "objectives": [dict(r) for r in self._last_eval],
                    "events": [dict(e) for e in self._events[-16:]]}


def _ok(value: float, op: str, target: float) -> bool:
    return value <= target if op == "<=" else value >= target


def fleet_merge(payloads: list[dict]) -> dict:
    """Merge per-replica SLO payloads into one fleet view: worst-case per
    objective name (min compliance / budget, max burn, breached if any
    replica is), with the contributing replica named — the router's
    /debug/slo scope and the console's headline."""
    merged: dict[str, dict] = {}
    events: list[dict] = []
    for p in payloads:
        scope = p.get("scope", "?")
        for rec in p.get("objectives", ()):
            name = rec.get("slo")
            cur = merged.get(name)
            if cur is None:
                merged[name] = cur = dict(rec, replicas=0, worst=scope)
                cur["breached"] = False
                cur["compliance"] = 1.0
                cur["budget_remaining"] = 1.0
                cur["burn_rate"] = 0.0
            cur["replicas"] += 1
            if rec.get("compliance", 1.0) < cur["compliance"]:
                cur["compliance"] = rec.get("compliance", 1.0)
                cur["worst"] = scope
                cur["value"] = rec.get("value")
            cur["budget_remaining"] = min(cur["budget_remaining"],
                                          rec.get("budget_remaining", 1.0))
            cur["burn_rate"] = max(cur["burn_rate"],
                                   rec.get("burn_rate", 0.0))
            cur["breached"] = cur["breached"] or bool(rec.get("breached"))
        for ev in p.get("events", ()):
            events.append(dict(ev, scope=scope))
    return {"scope": "fleet",
            "objectives": [merged[k] for k in sorted(merged)],
            "events": events[-16:]}
