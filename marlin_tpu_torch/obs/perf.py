"""Performance introspection: roofline accounting, profiler capture, flight
recorder.

Counterpart of ``marlin_tpu/obs/perf.py``; its device side is rewritten for
PyTorch on an NVIDIA GPU. Three instruments, all passive (a broken probe must
never fail the program it watches):

- **Program cost accounting** — :class:`ProgramCosts` is a process-global
  registry of per-program cost models. The JAX package reads them from
  XLA's ``cost_analysis()``; the port has no compiler to ask, so its cost
  models are analytic (FLOPs and bytes counted from the shapes: the serving
  ``capture_bucket_costs``/``capture_paged_costs``), passed as ``cost=``
  dicts of the same shape. They are *joined* with measured wall times
  (:meth:`ProgramCosts.observe` from the serving worker) and rendered as
  roofline numbers on ``/metrics`` (``marlin_program_flops`` / ``_bytes`` /
  ``_achieved_flops_per_s`` / ``_roofline_frac``), in the EventLog
  (``kind="program"``), and in the analyzer's program-utilization table
  (``python -m marlin_tpu_torch.obs.report``). Peaks come from a per-GPU
  table of datasheet rates (:func:`peak_rates`, detected from
  ``torch.cuda.get_device_name``) or the ``obs_peak_flops``/``obs_peak_bw``
  config overrides; the CPU gets none, so its fractions stay unreported.
- **On-demand profiler capture** — :func:`capture_profile`: a single-flight
  ``torch.profiler`` trace into a size-capped rotating capture directory
  (``obs_profile_dir`` / ``obs_profile_cap_bytes``), landing a
  ``kind="profile"`` EventLog record with the artifact path. Exposed as
  ``POST /debug/profile?seconds=N`` on the obs HTTP server (second
  concurrent request gets 409) and as a SIGUSR2 hook
  (:func:`install_profile_signal`).
- **Step-time flight recorder** — :class:`FlightRecorder`, a small locked
  ring buffer of per-iteration records (bucket, live slots, queue depth,
  step wall-times, compile tallies) written from the serving worker loop
  and prefetch producers, dumped to JSONL on unhandled worker exceptions,
  on ``engine.close()``, and on demand via ``GET /debug/flight`` — the
  black box for post-mortems where the EventLog tail alone cannot
  reconstruct the final iterations. Dumps are plain event records
  (``kind="flight"``), so ``obs.report`` parses them unchanged.

torch imports stay inside functions: ``obs`` must import on hosts where the
backend is broken (observability is how you debug exactly those hosts).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import shutil
import signal
import tempfile
import threading
import time
import weakref
from typing import Any

from .metrics import MetricsRegistry, get_registry

__all__ = ["peak_rates", "roofline", "program_key", "ProgramCosts",
           "get_program_costs", "install_program_costs", "FlightRecorder",
           "flight_records", "capture_profile", "ProfileBusy",
           "install_profile_signal"]


# --------------------------------------------------------------------- peaks

#: Per-GPU peak rates keyed by a ``torch.cuda.get_device_name`` substring
#: (lower case, first hit wins): FLOP/s by operand type, and HBM bytes/s.
#: NVIDIA's H100 SXM5 datasheet, dense (no sparsity). The port's serving
#: products run in IEEE f32 (TF32 off), so ``float32`` is the default row.
_GPU_PEAKS: tuple[tuple[str, dict, float], ...] = (
    ("h100", {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12},
     3.35e12),
)


def peak_rates(device=None, dtype: str = "float32",
               ) -> tuple[float | None, float | None]:
    """(peak FLOP/s for ``dtype``, peak HBM bytes/s) of ``device`` (default:
    CUDA device 0 when there is one). The ``obs_peak_flops``/``obs_peak_bw``
    config overrides win over detection; the CPU, a GPU missing from the
    table, or an unknown ``dtype`` gives None for what it cannot say —
    roofline fractions then stay unreported rather than lying."""
    from ..config import get_config

    cfg = get_config()
    flops, bw = cfg.obs_peak_flops, cfg.obs_peak_bw
    if flops is not None and bw is not None:
        return float(flops), float(bw)
    det_flops = det_bw = None
    try:
        import torch

        dev = torch.device(device) if device is not None else (
            torch.device("cuda", 0) if torch.cuda.is_available() else None)
        if dev is not None and dev.type == "cuda":
            name = torch.cuda.get_device_name(dev).lower()
            for sub, by_type, b in _GPU_PEAKS:
                if sub in name:
                    det_flops, det_bw = by_type.get(dtype), b
                    break
    except Exception:
        pass
    return (float(flops) if flops is not None else det_flops,
            float(bw) if bw is not None else det_bw)


def roofline(flops, bytes_accessed, seconds,
             peak_flops=None, peak_bw=None) -> dict:
    """The roofline arithmetic for one program: ``flops``/``bytes_accessed``
    per call (either may be 0/None), ``seconds`` the measured wall per call.
    Returns achieved rates, arithmetic intensity, the attainable rate under
    ``min(peak_flops, peak_bw * intensity)``, and ``roofline_frac`` =
    achieved / attainable.

    Edge cases are results, not errors: zero/None ``seconds`` means no
    measurement (all rates None); a zero-FLOP program (e.g. a pure H2D
    transfer) degrades to the bandwidth roofline (``frac`` = achieved
    bytes/s over ``peak_bw``); missing peaks leave ``frac`` None. The
    fraction is deliberately *not* clamped to 1.0 — frac > 1 means the
    peak table (or the cost model) is wrong for this part, which is worth
    seeing."""
    flops = float(flops) if flops else 0.0
    bytes_accessed = float(bytes_accessed) if bytes_accessed else 0.0
    out = {"flops": flops, "bytes": bytes_accessed,
           "achieved_flops_per_s": None, "achieved_bytes_per_s": None,
           "intensity": None, "attainable_flops_per_s": None,
           "roofline_frac": None}
    if bytes_accessed > 0:
        out["intensity"] = flops / bytes_accessed
    if not seconds or seconds <= 0:
        return out
    if flops > 0:
        out["achieved_flops_per_s"] = flops / seconds
    if bytes_accessed > 0:
        out["achieved_bytes_per_s"] = bytes_accessed / seconds
    if flops > 0:
        attainable = peak_flops
        if peak_bw and out["intensity"] is not None:
            bw_bound = peak_bw * out["intensity"]
            attainable = bw_bound if attainable is None \
                else min(attainable, bw_bound)
        if attainable:
            out["attainable_flops_per_s"] = attainable
            out["roofline_frac"] = out["achieved_flops_per_s"] / attainable
    elif bytes_accessed > 0 and peak_bw:
        # zero-FLOP program: the bandwidth roofline is the only one there is
        out["attainable_flops_per_s"] = None
        out["roofline_frac"] = out["achieved_bytes_per_s"] / peak_bw
    return out


# ------------------------------------------------------------- program costs


def program_key(**parts: Any) -> str:
    """Canonical key string for one compiled-program configuration —
    ``program_key(bucket="8x4", rows=4, dtype="float32")`` →
    ``"bucket=8x4 rows=4 dtype=float32"``. Capture sites and measurement
    sites must build the key through here (insertion order preserved) so
    the cost/timing join never misses on formatting."""
    return " ".join(f"{k}={v}" for k, v in parts.items())


def _log_event(kind: str, log=None, **fields) -> None:
    """Land one record in ``log`` (default: the process EventLog, resolved
    per emit), swallowing every failure — the one emission idiom shared by
    cost records, flight dumps, and profile captures: observability must
    never fail the path it observes."""
    try:
        if log is None:
            from ..utils.tracing import get_default_event_log

            log = get_default_event_log()
        if log is not None:
            log.event(kind, **fields)
    except Exception:
        pass


def _cost_dict(obj) -> dict | None:
    """Normalize a ``cost_analysis()`` result: ``Compiled`` returns a
    one-element list on some backends, ``Lowered`` a plain dict, either may
    be None or raise on backends without the analysis."""
    if obj is None:
        return None
    if isinstance(obj, (list, tuple)):
        obj = obj[0] if obj else None
    return obj if isinstance(obj, dict) else None


def _peak_memory_bytes(ma) -> int | None:
    """Peak device bytes from ``memory_analysis()`` — the documented
    temp+argument+output lower bound where the stats object lacks
    ``peak_memory_in_bytes`` (the stats objects differ between
    backends)."""
    if ma is None:
        return None
    peak = getattr(ma, "peak_memory_in_bytes", None)
    if peak:
        return int(peak)
    try:
        return int(ma.temp_size_in_bytes + ma.argument_size_in_bytes
                   + ma.output_size_in_bytes)
    except Exception:
        return None


class ProgramCosts:
    """Per-program cost models joined with measured wall time.

    One entry per ``(program, key)``: the cost model (flops, bytes accessed
    per call; peak memory where one was measured) plus
    the measured ``(calls, seconds)`` accumulation. :meth:`rows` derives
    achieved rates and roofline fractions against :func:`peak_rates`;
    :meth:`collect` publishes them as gauges at scrape time; :meth:`emit`
    lands ``kind="program"`` / ``ev="util"`` snapshots in the EventLog so
    the analyzer reconstructs the utilization table from the JSONL alone.

    Thread-safe; every capture path swallows its own exceptions (cost
    accounting rides compile and serving hot paths — it must never fail
    them)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], dict] = {}
        self._tried: set[tuple[str, str]] = set()

    def has(self, program: str, key: str) -> bool:
        """True when a cost model is already captured (two dict lookups)."""
        with self._lock:
            e = self._entries.get((program, key))
            return bool(e and e.get("captured"))

    def tried(self, program: str, key: str) -> bool:
        """True once ANY capture was attempted for (program, key) — success
        or not. Hot-path capture sites gate on this, not :meth:`has`: on a
        backend whose ``cost_analysis()`` is unavailable, gating on success
        would re-pay a full trace+lower on every dispatch, forever."""
        with self._lock:
            return (program, key) in self._tried

    def capture(self, program: str, key: str, *, lowered=None, compiled=None,
                cost: dict | None = None, memory=None,
                log=None) -> dict | None:
        """Record one program's cost model. ``cost`` is a
        ``cost_analysis()``-shaped dict (``{"flops", "bytes accessed"}``:
        the port's analytic counts); ``compiled``/``lowered`` keep the JAX
        package's signature for objects that carry such an analysis. The first
        successful capture per (program, key) lands a ``kind="program"`` /
        ``ev="cost"`` EventLog record. Never raises."""
        with self._lock:
            self._tried.add((program, key))
        try:
            if cost is None and compiled is not None:
                try:
                    cost = _cost_dict(compiled.cost_analysis())
                except Exception:
                    cost = None
            if cost is None and lowered is not None:
                try:
                    cost = _cost_dict(lowered.cost_analysis())
                except Exception:
                    cost = None
            else:
                cost = _cost_dict(cost)
            if memory is None and compiled is not None:
                try:
                    memory = compiled.memory_analysis()
                except Exception:
                    memory = None
            flops = bytes_accessed = None
            if cost:
                f = cost.get("flops")
                b = cost.get("bytes accessed")
                flops = float(f) if isinstance(f, (int, float)) and f >= 0 \
                    else None
                bytes_accessed = float(b) \
                    if isinstance(b, (int, float)) and b >= 0 else None
            peak_bytes = _peak_memory_bytes(memory)
            if flops is None and bytes_accessed is None and peak_bytes is None:
                return None
            with self._lock:
                e = self._entries.setdefault(
                    (program, key),
                    {"program": program, "key": key, "flops": None,
                     "bytes": None, "peak_bytes": None, "calls": 0,
                     "seconds": 0.0, "captured": False})
                first = not e["captured"]
                # richer info updates, None never clobbers a known value
                if flops is not None:
                    e["flops"] = flops
                if bytes_accessed is not None:
                    e["bytes"] = bytes_accessed
                if peak_bytes is not None:
                    e["peak_bytes"] = peak_bytes
                e["captured"] = True
                snap = dict(e)
            if first:
                self._emit_event(log, ev="cost", program=program, key=key,
                                 flops=snap["flops"], bytes=snap["bytes"],
                                 peak_bytes=snap["peak_bytes"])
            return snap
        except Exception:
            return None

    def observe(self, program: str, key: str, seconds: float,
                calls: int = 1) -> None:
        """Join measured wall time onto a program: ``seconds`` total for
        ``calls`` executions (a streamed op reports its whole pass at once).
        Hot-path cheap: one lock, no events."""
        if seconds is None or seconds < 0:
            return
        with self._lock:
            e = self._entries.setdefault(
                (program, key),
                {"program": program, "key": key, "flops": None,
                 "bytes": None, "peak_bytes": None, "calls": 0,
                 "seconds": 0.0, "captured": False})
            e["calls"] += int(calls)
            e["seconds"] += float(seconds)

    def rows(self) -> list[dict]:
        """Derived snapshot: every entry with achieved rates and roofline
        fraction filled in (None where uncomputable), sorted by
        (program, key)."""
        peak_flops, peak_bw = peak_rates()
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
        out = []
        for e in sorted(entries, key=lambda d: (d["program"], d["key"])):
            sec_per_call = e["seconds"] / e["calls"] if e["calls"] else None
            rl = roofline(e["flops"], e["bytes"], sec_per_call,
                          peak_flops, peak_bw)
            e.pop("captured", None)
            e.update(seconds_per_call=sec_per_call,
                     achieved_flops_per_s=rl["achieved_flops_per_s"],
                     achieved_bytes_per_s=rl["achieved_bytes_per_s"],
                     roofline_frac=rl["roofline_frac"],
                     peak_flops=peak_flops, peak_bw=peak_bw)
            out.append(e)
        return out

    def collect(self, registry: MetricsRegistry | None = None) -> None:
        """Publish the derived rows as gauges (render-time collector):
        ``marlin_program_flops`` / ``_bytes`` / ``_peak_bytes`` /
        ``_achieved_flops_per_s`` / ``_roofline_frac``, labeled
        (program, key)."""
        fams = _program_families(registry)
        for r in self.rows():
            labels = {"program": r["program"], "key": r["key"]}
            if r["flops"] is not None:
                fams["flops"].labels(**labels).set(r["flops"])
            if r["bytes"] is not None:
                fams["bytes"].labels(**labels).set(r["bytes"])
            if r["peak_bytes"] is not None:
                fams["peak_bytes"].labels(**labels).set(r["peak_bytes"])
            if r["achieved_flops_per_s"] is not None:
                fams["achieved"].labels(**labels).set(
                    r["achieved_flops_per_s"])
            if r["roofline_frac"] is not None:
                fams["frac"].labels(**labels).set(r["roofline_frac"])

    def emit(self, program: str | None = None, log=None) -> int:
        """Write one ``kind="program"`` / ``ev="util"`` EventLog record per
        measured row (``calls > 0``; all programs, or just ``program``).
        Returns the record count. Callers: engine close, streamed-op end —
        the snapshots the post-hoc analyzer joins into its utilization
        table."""
        n = 0
        for r in self.rows():
            if program is not None and r["program"] != program:
                continue
            if not r["calls"]:
                continue
            # NOTE the cumulative wall rides as total_s, NOT seconds: the
            # analyzer's per-kind latency table treats any `seconds` field
            # as one latency sample, and a run's accumulated total
            # masquerading as a latency would mislead exactly the diagnosis
            # the report exists for
            self._emit_event(
                log, ev="util", program=r["program"], key=r["key"],
                flops=r["flops"], bytes=r["bytes"],
                peak_bytes=r["peak_bytes"], calls=r["calls"],
                total_s=r["seconds"],
                seconds_per_call=r["seconds_per_call"],
                achieved_flops_per_s=r["achieved_flops_per_s"],
                roofline_frac=r["roofline_frac"],
                peak_flops=r["peak_flops"], peak_bw=r["peak_bw"])
            n += 1
        return n

    @staticmethod
    def _emit_event(log, **fields) -> None:
        _log_event("program", log=log, **fields)

    def reset(self) -> None:
        """Drop every entry (test isolation only)."""
        with self._lock:
            self._entries.clear()
            self._tried.clear()


_program_costs = ProgramCosts()

_fam_lock = threading.Lock()
# keyed by the registry OBJECT (weakly): an id()-keyed dict would both leak
# one family set per registry ever seen and, worse, hand a NEW registry that
# reuses a dead one's address the dead registry's family objects
_fams_by_registry: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _program_families(registry: MetricsRegistry | None = None) -> dict:
    reg = registry if registry is not None else get_registry()
    with _fam_lock:
        fams = _fams_by_registry.get(reg)
        if fams is None:
            label = ("program", "key")
            fams = _fams_by_registry[reg] = {
                "flops": reg.gauge(
                    "marlin_program_flops",
                    "Cost-model FLOPs per call of a program",
                    labelnames=label),
                "bytes": reg.gauge(
                    "marlin_program_bytes",
                    "Cost-model bytes accessed per call",
                    labelnames=label),
                "peak_bytes": reg.gauge(
                    "marlin_program_peak_bytes",
                    "Measured peak device bytes of a program",
                    labelnames=label),
                "achieved": reg.gauge(
                    "marlin_program_achieved_flops_per_s",
                    "Measured FLOP/s (cost-model FLOPs over measured wall "
                    "time)", labelnames=label),
                "frac": reg.gauge(
                    "marlin_program_roofline_frac",
                    "Achieved over attainable rate: min(peak FLOP/s, "
                    "peak BW x intensity); bandwidth roofline for zero-FLOP "
                    "programs", labelnames=label),
            }
    return fams


def get_program_costs() -> ProgramCosts:
    """The process-global cost registry every capture/observe site uses."""
    return _program_costs


_collector_installed: "weakref.WeakSet" = weakref.WeakSet()


def install_program_costs(registry: MetricsRegistry | None = None) -> None:
    """Attach the program-cost collector to ``registry`` (idempotent per
    registry, weakly tracked) and pre-register the ``marlin_program_*``
    families so they appear (empty) on scrapes before the first capture."""
    reg = registry if registry is not None else get_registry()
    _program_families(reg)
    with _fam_lock:
        if reg in _collector_installed:
            return
        _collector_installed.add(reg)
    reg.add_collector(lambda: _program_costs.collect(reg))


# ------------------------------------------------------------ flight recorder

_flights: "weakref.WeakSet" = weakref.WeakSet()


def _capture_dir() -> str:
    from ..config import get_config

    d = get_config().obs_profile_dir
    if not d:
        d = os.path.join(tempfile.gettempdir(), "marlin_tpu_torch_captures")
    os.makedirs(d, exist_ok=True)
    return d


_dump_ids = itertools.count()  # distinct dump/capture paths within a second


class FlightRecorder:
    """Bounded in-memory ring of per-iteration records — the black box.

    ``record(ev, **fields)`` appends one dict (stamped ``t`` +
    ``kind="flight"`` + ``src``) under a single small lock (the writers are
    per-engine-iteration / per-chunk, never per-token, and snapshot readers
    must not race a mutating ``deque``). ``maxlen`` defaults from
    ``config.obs_flight_len``. Instances self-register in a process-wide
    weak set so ``GET /debug/flight`` sees every live recorder.

    :meth:`dump` writes the ring to a JSONL file under the capture
    directory (pruned to the newest :data:`_FLIGHT_KEEP` dumps) and lands a
    ``kind="flight"`` / ``ev="dump"`` record with the artifact path in the
    default EventLog. It never raises — dumps ride worker failure paths."""

    _FLIGHT_KEEP = 16  # dump files kept in the capture dir, newest first

    def __init__(self, maxlen: int | None = None, name: str = ""):
        from ..config import get_config

        if maxlen is None:
            maxlen = get_config().obs_flight_len
        self.name = name
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(maxlen=max(1, maxlen))
        _flights.add(self)

    def record(self, ev: str, **fields: Any) -> None:
        rec = {"t": time.time(), "kind": "flight", "src": self.name,
               "ev": ev, **fields}
        with self._lock:
            self._buf.append(rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def dump(self, path: str | None = None, reason: str = "",
             log=None) -> str | None:
        """Write the ring (oldest first) to ``path`` (default: a fresh
        ``flight-<name>-<reason>-<stamp>.jsonl`` under the capture dir) as
        EventLog-shaped JSONL. Returns the path, or None when the ring is
        empty or the write failed (never raises)."""
        recs = self.records()
        if not recs:
            return None
        try:
            if path is None:
                # the counter keeps a fault dump and the close dump of the
                # same recorder in the same second from clobbering each
                # other; the reason slug rides in the name so pruning can
                # tell a post-mortem from a routine close
                slug = "".join(c if c.isalnum() else "-"
                               for c in (reason or "manual"))[:24]
                stamp = time.strftime("%Y%m%d-%H%M%S")
                path = os.path.join(
                    _capture_dir(),
                    f"flight-{self.name or 'ring'}-{slug}-{stamp}-"
                    f"{os.getpid()}-{next(_dump_ids)}.jsonl")
            with open(path, "w") as f:
                for r in recs:
                    if reason:
                        r = {**r, "reason": reason}
                    f.write(json.dumps(r) + "\n")
            self._prune_dumps(os.path.dirname(path))
        except Exception:
            return None
        _log_event("flight", log=log, ev="dump", src=self.name, path=path,
                   records=len(recs), reason=reason)
        return path

    @classmethod
    def _prune_dumps(cls, d: str) -> None:
        """Bound the dump dir, reason-aware: routine ``close`` dumps and
        fault post-mortems prune as SEPARATE pools (newest ``_FLIGHT_KEEP``
        each), so a process that churns engines cannot evict the one dump
        whose failure reason is the whole point of the black box."""
        try:
            dumps = sorted(
                (f for f in os.listdir(d)
                 if f.startswith("flight-") and f.endswith(".jsonl")),
                key=lambda f: os.path.getmtime(os.path.join(d, f)))
            routine = [f for f in dumps if "-close-" in f]
            faults_ = [f for f in dumps if "-close-" not in f]
            for pool in (routine, faults_):
                for f in pool[:-cls._FLIGHT_KEEP]:
                    os.remove(os.path.join(d, f))
        except OSError:
            pass


def flight_records() -> list[dict]:
    """Every live recorder's ring, merged oldest-first — the
    ``GET /debug/flight`` payload."""
    recs: list[dict] = []
    for fr in list(_flights):
        recs.extend(fr.records())
    recs.sort(key=lambda r: r.get("t", 0.0))
    return recs


# ------------------------------------------------------------ profile capture


class ProfileBusy(RuntimeError):
    """A capture is already in flight (captures are single-flight: two
    concurrent profiler traces would corrupt each other)."""


_profile_lock = threading.Lock()


def capture_profile(seconds: float = 2.0, logdir: str | None = None,
                    log=None) -> str:
    """Run one ``torch.profiler`` trace (CPU activity, plus CUDA where there
    is a card) for ``seconds`` into a fresh subdirectory of the capture dir
    (``config.obs_profile_dir``) as a Chrome trace (``trace.json``), prune
    the dir to ``config.obs_profile_cap_bytes``, land a ``kind="profile"``
    EventLog record with the artifact path, and return that path.

    Single-flight: a second caller while one capture runs gets
    :class:`ProfileBusy` immediately (the HTTP endpoint maps it to 409).
    The profiler is stopped even when the timed sleep is interrupted."""
    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusy("a profiler capture is already in flight")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        seconds = max(0.0, float(seconds))
        base = logdir if logdir is not None else _capture_dir()
        os.makedirs(base, exist_ok=True)
        # counter suffix: back-to-back captures in one second must not
        # commingle their artifacts in one directory (single-flight only
        # serializes them, it does not space them out)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(
            base, f"profile-{stamp}-{os.getpid()}-{next(_dump_ids)}")
        os.makedirs(path, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            time.sleep(seconds)
        wall = time.perf_counter() - t0
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
        _prune_captures(base)
        _log_event("profile", log=log, path=path, seconds=wall,
                   requested_s=seconds)
        return path
    finally:
        _profile_lock.release()


def _tree_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _prune_captures(base: str) -> None:
    """Rotate the capture directory: drop the oldest ``profile-*`` capture
    trees until the total is under ``obs_profile_cap_bytes`` (the newest
    capture always survives, even oversized — deleting what the caller was
    just promised would be worse)."""
    from ..config import get_config

    cap = get_config().obs_profile_cap_bytes
    if not cap:
        return
    try:
        captures = sorted(
            (os.path.join(base, f) for f in os.listdir(base)
             if f.startswith("profile-")
             and os.path.isdir(os.path.join(base, f))),
            key=os.path.getmtime)
        sizes = {c: _tree_bytes(c) for c in captures}
        while len(captures) > 1 and sum(sizes[c] for c in captures) > cap:
            victim = captures.pop(0)
            shutil.rmtree(victim, ignore_errors=True)
    except OSError:
        pass


def install_profile_signal(seconds: float = 5.0) -> bool:
    """Install a SIGUSR2 handler that fires :func:`capture_profile` on a
    background thread (an in-flight capture makes the signal a no-op).
    Returns False where installation is impossible (non-main thread,
    platforms without SIGUSR2) — long-running entrypoints call this
    unconditionally."""
    if not hasattr(signal, "SIGUSR2"):
        return False

    def _on_signal(signum, frame):
        def _go():
            try:
                capture_profile(seconds)
            except ProfileBusy:
                pass
            except Exception:
                pass

        threading.Thread(target=_go, daemon=True,
                         name="marlin-profile-capture").start()

    try:
        signal.signal(signal.SIGUSR2, _on_signal)
        return True
    except ValueError:  # not the main thread
        return False
