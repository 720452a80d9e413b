"""Live terminal ops console over ``/metrics`` + ``/debug/slo``.

Counterpart of ``marlin_tpu/obs/console.py``, copied (the module is
stdlib-only and imports nothing of the package).
``python -m marlin_tpu_torch.obs.console --url http://host:port`` attaches to
any running server started by :mod:`marlin_tpu_torch.obs.exposition` (an
engine's, a bench's) and renders, at a poll interval:

- **fleet topology** — one row per registered SLO scope (router →
  replicas): lifecycle state, queue depth, live rows, paged-pool occupancy
  — read from the scope's ``/debug/slo`` health block and the process
  gauges in ``/metrics``;
- **SLO compliance** — per objective: current value vs target, a
  compliance bar, the fast-window burn rate with a client-side sparkline
  (history accumulates across polls), budget remaining, breach state;
- **elastic fleet** — when a fleet controller is registered
  (``/debug/fleet``): replica count vs bounds, the live burn streaks, the
  in-flight action, and the recent scale-out/in/rebalance history with
  outcomes;
- **memory** — when the server carries ``/debug/memory`` (the
  MemoryLedger, obs/memledger.py): per-component stacked occupancy of
  the registered bytes, the live vs unattributed reconciliation ("n/a"
  where the device reports no live bytes), and the per-bucket
  planner-ratio/calibration table;
- **event tail** — the recent SLO breach/clear transitions plus the
  migration/restart counters' movement.

An engine built with ``serve_slo`` registers its SLO scope, a
:class:`~marlin_tpu_torch.serving.router.Router` the fleet-merged one, and a
:class:`~marlin_tpu_torch.serving.fleet.FleetController` its
``/debug/fleet`` payload; without them the topology, SLO and fleet panels
render their empty rows.

Everything is stdlib (``urllib`` + ANSI), read-only, and split into pure
functions over captured payloads — :func:`render` takes the parsed
``/metrics`` dict and ``/debug/slo`` JSON and returns a string, so tests
snapshot frames without a live server (``--once`` prints a single frame
and exits).
"""

from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request

__all__ = ["parse_metrics", "metric_value", "sparkline", "bar", "render",
           "fetch", "fetch_fleet", "fetch_memory", "main"]

_SPARK = "▁▂▃▄▅▆▇█"


# ----------------------------------------------------------------- parsing

def parse_metrics(text: str) -> dict:
    """Parse a Prometheus text exposition into
    ``{family: {((label, value), ...): float}}`` (unlabeled samples key on
    the empty tuple). Tolerant: unparseable lines are skipped — a torn or
    foreign exposition must not kill the console."""
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, _, value = line.rpartition(" ")
            if not head:
                continue
            if "{" in head:
                name, _, rest = head.partition("{")
                rest = rest.rstrip("}")
                labels = []
                for part in rest.split(","):
                    if not part:
                        continue
                    k, _, v = part.partition("=")
                    labels.append((k.strip(), v.strip().strip('"')))
                key = tuple(sorted(labels))
            else:
                name, key = head, ()
            out.setdefault(name, {})[key] = float(value)
        except ValueError:
            continue
    return out


def metric_value(metrics: dict, name: str, default: float = 0.0,
                 **labels) -> float:
    """The first sample of ``name`` whose labels include every given
    ``label=value`` pair (sums over matches for counters split by extra
    labels)."""
    fam = metrics.get(name)
    if not fam:
        return default
    want = set(labels.items())
    total, hit = 0.0, False
    for key, v in sorted(fam.items()):
        if want <= set(key):
            total += v
            hit = True
    return total if hit else default


# ---------------------------------------------------------------- widgets

def sparkline(values, width: int = 24) -> str:
    """The last ``width`` values as a unicode sparkline (scaled to the
    window's own max; flat-zero renders as a floor line)."""
    vals = [max(0.0, float(v)) for v in list(values)[-width:]]
    if not vals:
        return ""
    top = max(vals)
    if top <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int(v / top * (len(_SPARK) - 1) + 0.5))]
        for v in vals)


def bar(frac: float, width: int = 20) -> str:
    """A ``[####----]`` compliance bar over ``frac`` in [0, 1]."""
    frac = min(1.0, max(0.0, float(frac)))
    n = int(round(frac * width))
    return "[" + "#" * n + "-" * (width - n) + "]"


def _fmt(v, digits: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


# ----------------------------------------------------------------- render

def render(metrics: dict, slo: dict, history: dict | None = None,
           width: int = 78, *, fleet: dict | None = None,
           memory: dict | None = None) -> str:
    """One console frame from a parsed ``/metrics`` dict and a
    ``/debug/slo`` payload. ``history`` maps ``scope/slo`` to the burn-rate
    samples this console has seen (the sparkline source); pass None for a
    single captured frame. ``fleet`` is the optional ``/debug/fleet``
    payload — when present (a FleetController is registered) an elastic
    fleet panel renders between the SLO table and the event tail; old
    servers without the endpoint render identically to before. ``memory``
    is the optional ``/debug/memory`` payload (the MemoryLedger) — same
    degradation contract. Pure — the snapshot test renders captured
    payloads byte-for-byte."""
    lines: list[str] = []
    rule = "─" * width
    scopes = list(slo.get("scopes", ()))
    merge = next((s for s in scopes if s.get("scope") == "fleet"), None)
    replicas = [s for s in scopes if s.get("scope") != "fleet"]
    lines.append(f"marlin ops console · {len(replicas)} replica(s)"
                 + (" · fleet merge" if merge else ""))
    lines.append(rule)

    # topology: router -> replicas, live state off each scope's health block
    lines.append("  scope                    state      queue  rows   "
                 "pages        breached")
    for s in replicas or [{}]:
        if not s:
            lines.append("  (no SLO scopes registered)")
            break
        h = s.get("health") or {}
        pages = s.get("pages") or {}
        ptxt = (f"{int(pages.get('used', 0))}/{int(pages.get('total', 0))}"
                if pages else "-")
        breached = sorted(o["slo"] for o in s.get("objectives", ())
                          if o.get("breached"))
        lines.append(
            f"  {str(s.get('scope', '?'))[:24]:<24} "
            f"{str(h.get('state', '?')):<10} "
            f"{int(h.get('queue_depth', 0)):>5}  "
            f"{int(h.get('live_slots', 0)):>4}   "
            f"{ptxt:<12} {','.join(breached) or '-'}")
    q = metric_value(metrics, "marlin_serve_queue_depth")
    occ = metric_value(metrics, "marlin_serve_slot_occupancy")
    used = metric_value(metrics, "marlin_serve_kv_pages_used")
    tot = metric_value(metrics, "marlin_serve_kv_pages_total")
    lines.append(f"  process gauges: queue={int(q)} occupancy={occ:.2f} "
                 f"pages={int(used)}/{int(tot)}")
    lines.append(rule)

    # SLO table: the fleet merge when present, else every per-replica scope
    show = [merge] if merge else scopes
    lines.append("  slo              value/target      compliance"
                 "             burn    budget  state")
    any_obj = False
    for s in show:
        if s is None:
            continue
        for o in s.get("objectives", ()):
            any_obj = True
            comp = o.get("compliance", 1.0) or 0.0
            burn = o.get("burn_rate", 0.0) or 0.0
            key = f"{s.get('scope', '?')}/{o.get('slo', '?')}"
            hist = (history or {}).get(key, [burn])
            state = "BREACH" if o.get("breached") else "ok"
            lines.append(
                f"  {str(o.get('slo', '?'))[:16]:<16} "
                f"{_fmt(o.get('value')):>7}/{_fmt(o.get('target')):<7} "
                f"{bar(comp)} {comp * 100:5.1f}%  "
                f"{burn:5.2f}  {(o.get('budget_remaining') or 0) * 100:5.1f}%"
                f"  {state}")
            spark = sparkline(hist)
            if spark:
                lines.append(f"    burn {spark}")
    if not any_obj:
        lines.append("  (no objectives configured — set serve_slo)")
    lines.append(rule)

    # elastic fleet: controller bounds/streaks + recent scale actions
    for ctl in (fleet or {}).get("fleets", ()):
        b = ctl.get("bounds") or {}
        st = ctl.get("streaks") or {}
        act = ctl.get("action")
        lines.append(
            f"  fleet {str(ctl.get('router', '?'))[:20]:<20} "
            f"replicas={int(ctl.get('replicas', 0))} "
            f"[{int(b.get('min', 0))}..{int(b.get('max', 0))}] "
            f"burn={_fmt(ctl.get('burn'))} "
            f"streaks hot={int(st.get('hot', 0))} "
            f"slack={int(st.get('slack', 0))} "
            f"imb={int(st.get('imbalance', 0))}")
        if act:
            lines.append(f"    action in flight: {act.get('action', '?')}"
                         + (" (TIMED OUT)" if act.get("timed_out") else ""))
        for rec in list(ctl.get("history", ()))[-3:]:
            extra = f" replica={rec['replica']}" if "replica" in rec else ""
            lines.append(f"    {rec.get('action', '?'):<10} "
                         f"-> {rec.get('outcome', '?')}{extra}")
        hrs = ctl.get("replica_seconds")
        if hrs is not None:
            lines.append(f"    replica-hours {hrs / 3600.0:.3f}")
    if (fleet or {}).get("fleets"):
        lines.append(rule)

    # memory: per-component stacked occupancy + reconciliation + ratios
    if memory is not None:
        comps = memory.get("components") or {}
        total = memory.get("registered_bytes") or 0
        live = memory.get("live_bytes", "n/a")
        unatt = memory.get("unattributed_frac", "n/a")
        audit_ok = (memory.get("audit") or {}).get("ok", True)
        lines.append(
            f"  memory: registered={int(total)} live={live} "
            f"unattributed={unatt if isinstance(unatt, str) else f'{unatt * 100:.1f}%'}"
            f"{'' if audit_ok else '  LEDGER AUDIT VIOLATED'}")
        for comp, b in sorted(comps.items(), key=lambda kv: -kv[1]):
            frac = b / total if total else 0.0
            lines.append(f"    {comp:<12}{bar(frac)} {b:>14}")
        ratios = memory.get("planner_ratios") or ()
        if ratios:
            lines.append("    bucket       planner B      measured B  "
                         "ratio  calib")
            for r in ratios:
                lines.append(
                    f"    {str(r.get('bucket', '?')):<10}"
                    f"{_fmt(r.get('planner_bytes')):>12} "
                    f"{_fmt(r.get('measured_peak_bytes')):>15}  "
                    f"{_fmt(r.get('planner_ratio')):>5}  "
                    f"{_fmt(r.get('calibration')):>5}")
        for a in list(memory.get("leak_alerts") or ())[-3:]:
            lines.append(f"    LEAK {a.get('component', '?')}: freed "
                         f"{a.get('freed_bytes', '?')} B, live held over "
                         f"{a.get('windows', '?')} window(s)")
        lines.append(rule)

    # event tail: SLO transitions + migration/restart counter movement
    shed = metric_value(metrics, "marlin_slo_shed_total")
    mig_out = metric_value(metrics, "marlin_serve_migrations_total",
                           leg="export")
    mig_in = metric_value(metrics, "marlin_serve_migrations_total",
                          leg="adopt")
    lines.append(f"  shed={int(shed)} migrations: export={int(mig_out)} "
                 f"adopt={int(mig_in)}")
    events: list[tuple[str, dict]] = []
    for s in scopes:
        for ev in s.get("events", ()):
            events.append((str(s.get("scope", "?")), ev))
    for scope, ev in events[-8:]:
        lines.append(
            f"  [{scope}] {ev.get('slo', '?')} -> {ev.get('state', '?')} "
            f"(burn {_fmt(ev.get('burn_rate'))}, value "
            f"{_fmt(ev.get('value'))} vs {_fmt(ev.get('target'))})")
    if not events:
        lines.append("  (no SLO transitions yet)")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ live

def fetch(base_url: str, timeout: float = 3.0) -> tuple[dict, dict]:
    """(parsed /metrics, /debug/slo JSON) off one server. Raises on an
    unreachable server — the caller decides how to degrade."""
    base = base_url.rstrip("/")
    with urllib.request.urlopen(base + "/metrics", timeout=timeout) as r:
        metrics = parse_metrics(r.read().decode("utf-8", "replace"))
    with urllib.request.urlopen(base + "/debug/slo", timeout=timeout) as r:
        slo = json.loads(r.read().decode("utf-8", "replace"))
    return metrics, slo


def fetch_fleet(base_url: str, timeout: float = 3.0) -> dict | None:
    """The ``/debug/fleet`` payload, or None when the server predates the
    endpoint / no controller is registered — the console degrades to the
    fleet-less layout either way."""
    base = base_url.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/debug/fleet",
                                    timeout=timeout) as r:
            payload = json.loads(r.read().decode("utf-8", "replace"))
    except Exception:
        return None
    return payload if payload.get("fleets") else None


def fetch_memory(base_url: str, timeout: float = 3.0) -> dict | None:
    """The ``/debug/memory`` payload, or None when the server predates
    the endpoint — the console degrades to the memory-less layout. A 503
    (ledger audit violation) still renders: that frame is the one an
    operator most needs to see."""
    base = base_url.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/debug/memory",
                                    timeout=timeout) as r:
            return json.loads(r.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        if e.code == 503:  # audit violation: payload rides the error body
            try:
                return json.loads(e.read().decode("utf-8", "replace"))
            except Exception:
                return None
        return None
    except Exception:
        return None


def main(argv=None) -> int:
    """``python -m marlin_tpu_torch.obs.console [--url U] [--interval S]
    [--once] [--no-clear]`` — poll and render until interrupted."""
    argv = list(sys.argv[1:] if argv is None else argv)
    url, interval, once, clear = "http://127.0.0.1:9100", 2.0, False, True
    it = iter(argv)
    for a in it:
        if a == "--url":
            url = next(it, None) or url
        elif a == "--interval":
            try:
                interval = float(next(it, "") or interval)
            except ValueError:
                pass
        elif a == "--once":
            once = True
        elif a == "--no-clear":
            clear = False
        else:
            print("usage: python -m marlin_tpu_torch.obs.console [--url URL] "
                  "[--interval S] [--once] [--no-clear]", file=sys.stderr)
            return 2
    history: dict[str, list] = {}
    while True:
        try:
            metrics, slo = fetch(url)
        except Exception as e:
            frame = (f"marlin ops console · {url} unreachable: "
                     f"{type(e).__name__}: {e}\n")
        else:
            for s in slo.get("scopes", ()):
                for o in s.get("objectives", ()):
                    key = f"{s.get('scope', '?')}/{o.get('slo', '?')}"
                    history.setdefault(key, []).append(
                        o.get("burn_rate", 0.0) or 0.0)
                    del history[key][:-64]
            frame = render(metrics, slo, history, fleet=fetch_fleet(url),
                           memory=fetch_memory(url))
        if clear and not once:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(frame)
        sys.stdout.flush()
        if once:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":  # pragma: no cover - exercised via --once in CLI
    sys.exit(main())
