"""Post-hoc EventLog analyzer: ``python -m marlin_tpu_torch.obs.report <events.jsonl>``.

Counterpart of ``marlin_tpu/obs/report.py``, copied (the module is stdlib-only).

Reconstructs what a run did from its JSONL post-mortem stream alone — no
profiler UI, no live process:

- **per-kind latency** — every record kind carrying ``seconds`` (serving
  steps, prefills, checkpoint saves, compiles, timers …) gets count and
  p50/p95/p99/max.
- **traces** — records join on ``trace_id`` (the span context EventLog
  stamps, :mod:`marlin_tpu_torch.obs.trace`); the report shows how many records
  joined and the slowest traces end-to-end.
- **serving TTFT breakdown** — per-request ``queue_s``/``ttft_s``/``total_s``
  from ``serve``/``result`` records decomposed into queue vs prefill vs
  decode time, the serving latency question ("where did the ms go?") in
  three lines; streams carrying ``ev="page"`` records (the paged KV pool)
  additionally get a paging line — prefix-cache hit rate, peak page
  occupancy, copy-on-write splits.
- **program utilization** — ``kind="program"`` records (obs/perf.py): analytic
  cost models (``ev="cost"``) and measured-utilization snapshots
  (``ev="util"``, emitted by engine close / streamed ops / the autotuner)
  rendered as a roofline table — calls, achieved GFLOP/s, and the
  fraction of the attainable rate, per compiled program and configuration.
- **compile / memory timelines** — ``kind="compile"`` records (from a
  compile bridge; the port compiles nothing on its serving path) and ``kind="memory"`` samples
  (:func:`~marlin_tpu_torch.obs.collectors.log_device_memory`) as time-offset
  listings, so a recompile storm or an HBM creep is visible at a glance.

Reading is torn-line tolerant (the same skip-and-flag contract as
``EventLog.read``): a crash mid-write costs one partial line, never the
analysis. Output is deterministic for a given file (fixed formats, sorted
orders) — the test suite goldens it.
"""

from __future__ import annotations

import datetime
import json
import re
import sys
import time

from .metrics import percentile

__all__ = ["load_events", "parse_when", "trace_join", "analyze", "main",
           "KNOWN_KINDS", "KNOWN_SERVE_EVS"]

#: every EventLog record kind the package emits — the post-mortem
#: vocabulary this analyzer understands. Kinds without a dedicated section
#: still render through the generic per-kind latency table, but they must
#: be declared here: an undeclared kind is a black-box stream, and the
#: static analyzer (tools/analyze, doc-sync check) fails the gate on any
#: emission site this set does not cover.
KNOWN_KINDS = frozenset({
    "ckpt", "compile", "fleet", "flight", "mem", "memory", "prefetch",
    "profile", "program", "resume", "resume_skip", "retry",
    "retry_deadline", "retry_exhausted", "serve", "slo", "stage_times",
    "step_failure", "timer",
})

#: the ``ev=`` discriminators of ``kind="serve"`` records (the
#: serving/metrics.py table plus the supervisor/router resilience events).
#: Same contract: emitting a serve ev missing here fails the doc-sync gate.
KNOWN_SERVE_EVS = frozenset({
    "breaker", "enqueue", "migrate", "page", "prefill", "rebalance",
    "reject", "replica_add", "replica_retire", "replica_rotate", "restart",
    "result", "retry", "route_failover", "step", "swap",
})


def parse_when(text: str, now: float | None = None) -> float:
    """One ``--since``/``--until`` value as an epoch timestamp. Accepts a
    relative ``<N>s/m/h/d ago`` (measured back from ``now``, default the
    real clock), a bare epoch number, or an ISO-8601 datetime (a naive one
    is taken as UTC — EventLog stamps ``time.time()``)."""
    text = text.strip()
    m = re.match(r"^(\d+(?:\.\d+)?)\s*([smhd])\s+ago$", text)
    if m:
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}[m.group(2)]
        base = time.time() if now is None else now
        return base - float(m.group(1)) * mult
    try:
        return float(text)
    except ValueError:
        pass
    try:
        dt = datetime.datetime.fromisoformat(text)
    except ValueError:
        raise ValueError(
            f"cannot parse time {text!r} (want ISO-8601, an epoch number, "
            f"or '<N>s/m/h/d ago')") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


def load_events(path: str, since: float | None = None,
                until: float | None = None) -> tuple[list[dict], int]:
    """(records, skipped torn/partial lines) from one JSONL file — the one
    torn-line-tolerant parse (``EventLog.read`` delegates here).
    ``since``/``until`` (epoch seconds) window the stream on each record's
    ``t`` stamp at load time, so every downstream section — and the CLI's
    ``--since "5m ago"`` — analyzes only the window; records with no ``t``
    are kept (they cannot be placed, and dropping them would hide them)."""
    records, skipped = [], 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            t = rec.get("t")
            if isinstance(t, (int, float)):
                if since is not None and t < since:
                    continue
                if until is not None and t > until:
                    continue
            records.append(rec)
    return records, skipped


def trace_join(records) -> tuple[int, int]:
    """(requests whose serve records all share one non-None ``trace_id``,
    total rid-carrying requests). One definition of "trace-joined" shared by
    this analyzer and the bench's ``serve_obs`` acceptance record."""
    rid_traces: dict = {}
    for r in records:
        if r.get("kind") == "serve" and "rid" in r:
            rid_traces.setdefault(r["rid"], set()).add(r.get("trace_id"))
    joined = sum(1 for tids in rid_traces.values()
                 if len(tids) == 1 and None not in tids)
    return joined, len(rid_traces)


def _ms(v: float) -> str:
    return f"{v * 1e3:.1f}"


def _kind_key(rec: dict) -> str:
    ev = rec.get("ev")
    return f"{rec['kind']}/{ev}" if ev else rec["kind"]


def _latency_section(events: list[dict]) -> list[str]:
    by_kind: dict[str, list[float]] = {}
    for rec in events:
        if isinstance(rec.get("seconds"), (int, float)):
            by_kind.setdefault(_kind_key(rec), []).append(rec["seconds"])
    out = ["== per-kind latency (records carrying `seconds`) =="]
    if not by_kind:
        out.append("(none)")
        return out
    out.append(f"{'kind':<18}{'count':>6}{'p50 ms':>10}{'p95 ms':>10}"
               f"{'p99 ms':>10}{'max ms':>10}{'total s':>10}")
    for kind in sorted(by_kind):
        xs = by_kind[kind]
        out.append(
            f"{kind:<18}{len(xs):>6}{_ms(percentile(xs, 50)):>10}"
            f"{_ms(percentile(xs, 95)):>10}{_ms(percentile(xs, 99)):>10}"
            f"{_ms(max(xs)):>10}{sum(xs):>10.3f}")
    return out


def _trace_section(events: list[dict]) -> list[str]:
    traces: dict[str, list[dict]] = {}
    for rec in events:
        tid = rec.get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(rec)
    in_traces = sum(len(v) for v in traces.values())
    out = ["== traces =="]
    if not traces:
        out.append("(no trace_id-carrying records)")
        return out
    spans = {rec.get("span_id") for recs in traces.values() for rec in recs}
    out.append(f"traces: {len(traces)}   spans: {len(spans)}   "
               f"records in traces: {in_traces}/{len(events)}")
    ranked = sorted(
        traces.items(),
        key=lambda kv: (-(max(r.get("t", 0.0) for r in kv[1])
                          - min(r.get("t", 0.0) for r in kv[1])), kv[0]))
    out.append("slowest traces:")
    for tid, recs in ranked[:5]:
        dur = (max(r.get("t", 0.0) for r in recs)
               - min(r.get("t", 0.0) for r in recs))
        kinds = ",".join(sorted({_kind_key(r) for r in recs}))
        out.append(f"  {tid}  records={len(recs)}  span={dur:.3f}s  "
                   f"kinds={kinds}")
    return out


def _serving_section(events: list[dict]) -> list[str]:
    serve = [r for r in events if r.get("kind") == "serve"]
    out = ["== serving =="]
    if not serve:
        out.append("(no serve records)")
        return out
    results = [r for r in serve if r.get("ev") == "result"]
    by_status: dict[str, int] = {}
    for r in results:
        by_status[r.get("status", "?")] = by_status.get(
            r.get("status", "?"), 0) + 1
    submitted = sum(1 for r in serve if r.get("ev") == "enqueue")
    status_str = ", ".join(f"{k} {v}" for k, v in sorted(by_status.items()))
    out.append(f"requests: submitted {submitted}; results: {status_str}")
    # per-program ride-along (only when the stream carries program-labelled
    # serve records — serving/programs/ BucketPrograms — so pure-LM logs
    # render unchanged): terminal outcomes, completed-result p50 latency,
    # and hot model swaps per serving program. Records with no program
    # field are LM's (its events stay byte-identical to pre-program logs).
    if any("program" in r for r in serve
           if r.get("ev") in ("enqueue", "result", "step", "swap")):
        by_prog: dict[str, dict] = {}
        for r in results:
            p = r.get("program", "lm")
            d = by_prog.setdefault(p, {"status": {}, "total": []})
            d["status"][r.get("status", "?")] = \
                d["status"].get(r.get("status", "?"), 0) + 1
            if r.get("status") == "ok" and \
                    isinstance(r.get("total_s"), (int, float)):
                d["total"].append(r["total_s"])
        swaps: dict[str, int] = {}
        for r in serve:
            if r.get("ev") == "swap":
                p = r.get("program", "?")
                swaps[p] = swaps.get(p, 0) + 1
                by_prog.setdefault(p, {"status": {}, "total": []})
        out.append("per-program results:")
        out.append(f"  {'program':<12}{'results':>8}{'ok':>6}{'other':>7}"
                   f"{'p50 ms':>9}{'swaps':>7}")
        for p in sorted(by_prog):
            d = by_prog[p]
            n = sum(d["status"].values())
            n_ok = d["status"].get("ok", 0)
            p50 = (_ms(percentile(d["total"], 50)) if d["total"] else "-")
            out.append(f"  {p:<12}{n:>8}{n_ok:>6}{n - n_ok:>7}"
                       f"{p50:>9}{swaps.get(p, 0):>7}")
    # resilience ride-along (only when the stream carries it, so logs from
    # pre-retry engines render unchanged): transparent re-queues, worker
    # restarts, breaker transitions. A retried request's queue/ttft/total
    # below comes from its RESULT record — i.e. the final, successful
    # attempt; the failed attempts only widen its queue_s.
    retries = sum(1 for r in serve if r.get("ev") == "retry")
    restarts = sum(1 for r in serve if r.get("ev") == "restart")
    breakers = [r for r in serve if r.get("ev") == "breaker"]
    retried_ok = sum(1 for r in results
                     if r.get("status") == "ok" and r.get("attempt", 1) > 1)
    if retries or restarts or breakers:
        line = (f"resilience: {retries} attempt(s) re-queued, "
                f"{restarts} worker restart(s)")
        if retried_ok:
            line += (f"; {retried_ok} ok result(s) served by a retry "
                     f"(latency attributed to the final attempt)")
        if breakers:
            line += f"; breaker: {breakers[-1].get('state', '?')}"
        out.append(line)
    # paged KV pool ride-along (only when the stream carries ev="page"
    # records, so pre-paging logs render unchanged): prefix-cache hit rate
    # over alloc records and page occupancy over every pool snapshot
    pages = [r for r in serve if r.get("ev") == "page"]
    if pages:
        allocs = [r for r in pages if r.get("action") == "alloc"]
        hits = sum(1 for r in allocs if r.get("shared", 0) > 0)
        shared = sum(r.get("shared", 0) for r in allocs)
        snaps = [(r["used"], r["total"]) for r in pages
                 if isinstance(r.get("used"), int)
                 and isinstance(r.get("total"), int) and r["total"] > 0]
        line = "paging:"
        if allocs:
            line += (f" prefix cache {hits}/{len(allocs)} admissions hit "
                     f"({hits / len(allocs) * 100:.1f}% — {shared} page(s) "
                     f"reused instead of re-prefilled);")
        if snaps:
            pk_used, pk_total = max(snaps, key=lambda s: s[0] / s[1])
            line += (f" page occupancy peak "
                     f"{pk_used / pk_total * 100:.1f}% "
                     f"({pk_used}/{pk_total} pages)")
        cows = sum(1 for r in pages if r.get("action") == "cow")
        if cows:
            line += f"; {cows} copy-on-write split(s)"
        out.append(line.rstrip(";"))
    ok = [r for r in results if r.get("status") == "ok"
          and isinstance(r.get("total_s"), (int, float))]
    if ok:
        queue = [r.get("queue_s", 0.0) or 0.0 for r in ok]
        ttft = [r.get("ttft_s") if r.get("ttft_s") is not None
                else r["total_s"] for r in ok]
        prefill = [max(t - q, 0.0) for t, q in zip(ttft, queue)]
        decode = [max(r["total_s"] - t, 0.0) for r, t in zip(ok, ttft)]
        total = [r["total_s"] for r in ok]
        out.append("TTFT breakdown over ok results (p50 / p99 ms):")
        for name, xs in (("queue", queue), ("prefill", prefill),
                         ("decode", decode), ("total", total)):
            out.append(f"  {name:<8}{_ms(percentile(xs, 50)):>9} / "
                       f"{_ms(percentile(xs, 99))}")
    # the trace-join check: every record a request produced under ONE id
    joined, total = trace_join(serve)
    if total:
        out.append(f"trace join: {joined}/{total} requests have "
                   f"all their records under one trace_id")
    return out


def _program_section(events: list[dict]) -> list[str]:
    """The roofline table: the LAST ``ev="util"`` snapshot per
    (program, key) — snapshots are cumulative, so the last one is the
    run's total — plus a count of cost-only programs that never got a
    timing joined."""
    utils: dict[tuple, dict] = {}
    cost_only: set = set()
    for r in events:
        if r.get("kind") != "program":
            continue
        pk = (r.get("program"), r.get("key"))
        if r.get("ev") == "util":
            utils[pk] = r
        elif r.get("ev") == "cost":
            cost_only.add(pk)
    out = ["== program utilization =="]
    if not utils and not cost_only:
        out.append("(no program records — obs.perf cost capture never ran)")
        return out
    if utils:
        out.append(f"{'program':<20}{'key':<36}{'calls':>7}{'GFLOP/s':>10}"
                   f"{'roofline':>10}")
        for (prog, key), r in sorted(utils.items()):
            ach = r.get("achieved_flops_per_s")
            frac = r.get("roofline_frac")
            out.append(
                f"{str(prog):<20}{str(key):<36}{r.get('calls', 0):>7}"
                f"{(f'{ach / 1e9:.2f}' if ach else '-'):>10}"
                f"{(f'{frac * 100:.2f}%' if frac is not None else '-'):>10}")
    unmeasured = cost_only - set(utils)
    if unmeasured:
        out.append(f"({len(unmeasured)} program(s) with a captured cost "
                   f"model but no joined timing)")
    return out


def _timeline_section(events: list[dict], t0: float) -> list[str]:
    out = []
    compiles = [r for r in events if r.get("kind") == "compile"
                and isinstance(r.get("seconds"), (int, float))]
    out.append("== compile ==")
    if compiles:
        out.append(f"compiles: {len(compiles)}, total "
                   f"{sum(r['seconds'] for r in compiles):.3f}s")
        for r in compiles[:20]:
            out.append(f"  t+{r['t'] - t0:.3f}s  {r['seconds']:.3f}s")
        if len(compiles) > 20:
            out.append(f"  ... {len(compiles) - 20} more")
    else:
        out.append("(no compile records)")
    mem = [r for r in events if r.get("kind") == "memory"
           and isinstance(r.get("devices"), dict)]
    out.append("")
    out.append("== memory ==")
    if mem:
        peak, peak_dev = 0, "?"
        for r in mem:
            for dev, b in r["devices"].items():
                if b >= peak:
                    peak, peak_dev = b, dev
        out.append(f"samples: {len(mem)}, peak bytes_in_use: {peak} "
                   f"({peak_dev})")
        for r in mem[:20]:
            devs = " ".join(f"{d}={b}" for d, b in sorted(
                r["devices"].items()))
            out.append(f"  t+{r['t'] - t0:.3f}s  {devs}")
        if len(mem) > 20:
            out.append(f"  ... {len(mem) - 20} more")
    else:
        out.append("(no memory samples — collectors.log_device_memory "
                   "never ran, or the backend exposes no memory_stats)")
    return out


def _memory_attribution_section(events: list[dict]) -> list[str]:
    """The MemoryLedger's post-hoc view over ``kind="mem"`` records
    (obs/memledger.py): the LAST per-component attribution snapshot
    (engines emit one at terminal close), every leak verdict, and every
    OOM forensics artifact the run dumped. Renders only when the stream
    carries mem records, so pre-ledger logs golden byte-identical."""
    mem = [r for r in events if r.get("kind") == "mem"]
    if not mem:
        return []
    out = ["== memory attribution =="]
    snaps = [r for r in mem if r.get("ev") == "snapshot"
             and isinstance(r.get("components"), dict)]
    if snaps:
        last = snaps[-1]
        total = last.get("total_bytes", 0)
        out.append(f"ledger snapshots: {len(snaps)}; last attribution "
                   f"({total} bytes registered):")
        for comp, b in sorted(last["components"].items()):
            frac = f" ({b / total * 100:.1f}%)" if total else ""
            out.append(f"  {comp:<12}{b:>14}{frac}")
        if not last["components"]:
            out.append("  (ledger empty at snapshot)")
    leaks = [r for r in mem if r.get("ev") == "leak"]
    if leaks:
        out.append(f"leak alerts: {len(leaks)}")
        for r in leaks[:10]:
            out.append(f"  {r.get('component', '?')}: freed "
                       f"{r.get('freed_bytes', '?')} B, live dropped "
                       f"{r.get('live_drop_bytes', '?')} B over "
                       f"{r.get('windows', '?')} window(s)")
    dumps = [r for r in mem if r.get("ev") == "oom_dump"]
    if dumps:
        out.append(f"OOM forensics dumps: {len(dumps)}")
        for r in dumps[:10]:
            out.append(f"  {r.get('reason', '?')} -> {r.get('path', '?')}")
    if len(out) == 1:
        out.append(f"({len(mem)} mem record(s), no snapshot/leak/oom)")
    return out


def analyze(events: list[dict], skipped: int = 0) -> str:
    """The full deterministic report for one event stream."""
    out = ["== marlin_tpu_torch.obs.report =="]
    if not events:
        out.append("events: 0")
        return "\n".join(out) + "\n"
    events = sorted(events, key=lambda r: r.get("t", 0.0))
    t0 = events[0].get("t", 0.0)
    span = events[-1].get("t", 0.0) - t0
    torn = f"  ({skipped} torn line(s) skipped)" if skipped else ""
    out.append(f"events: {len(events)}  span: {span:.3f}s{torn}")
    out.append("")
    out.extend(_latency_section(events))
    out.append("")
    out.extend(_trace_section(events))
    out.append("")
    out.extend(_serving_section(events))
    out.append("")
    out.extend(_program_section(events))
    mem_sec = _memory_attribution_section(events)
    if mem_sec:
        out.append("")
        out.extend(mem_sec)
    out.append("")
    out.extend(_timeline_section(events, t0))
    return "\n".join(out) + "\n"


_USAGE = ("usage: python -m marlin_tpu_torch.obs.report <events.jsonl> "
          "[--since WHEN] [--until WHEN]\n"
          "  WHEN: ISO-8601, an epoch number, or '<N>s/m/h/d ago'")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path, since, until = None, None, None
    it = iter(argv)
    for a in it:
        if a in ("-h", "--help"):
            print(_USAGE, file=sys.stderr)
            return 2
        if a in ("--since", "--until"):
            raw = next(it, None)
            if raw is None:
                print(f"{a} needs a value\n{_USAGE}", file=sys.stderr)
                return 2
            try:
                when = parse_when(raw)
            except ValueError as e:
                print(f"{a}: {e}", file=sys.stderr)
                return 2
            if a == "--since":
                since = when
            else:
                until = when
        elif path is None:
            path = a
        else:
            print(_USAGE, file=sys.stderr)
            return 2
    if path is None:
        print(_USAGE, file=sys.stderr)
        return 2
    try:
        events, skipped = load_events(path, since=since, until=until)
    except OSError as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(analyze(events, skipped))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
