"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

A cell names a configuration (``configs/<config>.json``: the deployment's
shapes and dtype), a traffic mix (``traffic/<traffic>.json``: the operation,
its parameters and the rank mesh) and a number of cards. The operation's
module (``ops/<op>.py``) draws the inputs on the card from the seed, makes
the port's objects, issues one call, counts a call's useful FLOPs and
bytes, and compares what a call produced with the plain reference
(``reference/``) by the numbers in ``limits/<cell>.json``. Each metric of
``BENCHMARK.json`` is read by ``metrics/<metric>.py``. So a configuration,
a traffic mix, a cell or a metric is added by new files and new entries.

An op file holds ``counts(cfg, traffic) -> (flops, bytes)`` of one call
and ``Case(ctx, cfg, traffic)`` (``ctx``: ``seed``, ``device``, ``mesh``,
``rank``, ``world``) with ``flops``, ``bytes``, ``call()``, ``keep(out)``
(what of a call's output the check needs), ``control()`` (the control's
output, kept alike), ``release()`` (drops the program's objects) and
``check(kept) -> {number: [gap, scale]}``, each number ``gap / scale``
after the largest of each over the ranks. A metric file holds
``read(run)``, ``run`` having ``calls``, ``window_s``, ``setup_s``,
``flops``, ``bytes`` (a call's), ``chips``, ``peak`` (``peaks.json``'s
entry for the card, or None) and ``trace`` (each rank's
:func:`summarize`, or None untraced). A traced rank's ``device`` and
``host`` hold its profiler events as ``(start_s, end_s, name)``, seconds
from the window's start, clipped to the window: every kernel, copy and
collective, and every host operation and span (the harness's
``portbench.call`` and whatever spans the program records), so a metric
reads what it needs from them itself.

One run: set-up (imports, the inputs, one warm-up call), then a closed
loop of calls for ``--seconds``. A call counts as done when its result is
on the card (a synchronise after it); the window runs from a barrier
before the first call to the synchronise and barrier after the first call
that completes past ``--seconds``. On several cards every rank issues the
calls in lockstep and rank 0's clock and decision rule the window. With
``--trace 1`` the window is traced by ``torch.profiler`` and the per-layer
metrics are read from it. After the window the output of one call drawn
from the seed and of the last call are compared with the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
from types import SimpleNamespace

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "marlin_tpu")
# a world's ranks are killed past this: set-up, the window, the trace's
# reading and the check together stay well inside a run's 360 s
DEADLINE_S = 300.0
# ns of the trace's clock a second
_NS = 1e9


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, root: str = ROOT) -> SimpleNamespace:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json`` with its
    configuration, traffic mix, limits and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(one of {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    pkg = os.path.join(root, "portbench")
    traffic = load_json(os.path.join(pkg, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(pkg, "limits", workload + ".json"))

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return SimpleNamespace(
        name=workload, chips=int(cell["chips"]), cfg=cfg, traffic=traffic,
        limits=limits, end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]), pkg=pkg)


def read_metrics(entries, run, pkg: str) -> dict:
    """Each metric's reader (``metrics/<name>.py``: ``read(run)``) on
    ``run``; a reader that finds nothing to read returns ``None`` and the
    metric is left out."""
    out = {}
    for m in entries:
        reader = _module(os.path.join(pkg, "metrics", m["name"] + ".py"),
                         "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def load_op(pkg: str, op: str):
    """The operation's module, ``ops/<op>.py`` under ``pkg``."""
    return _module(os.path.join(pkg, "ops", op + ".py"), "portbench_op_" + op)


def forbidden_modules() -> list[str]:
    """Modules of ``FORBIDDEN`` loaded in this process, compared by whole
    top-level names (``marlin_tpu_torch`` is not ``marlin_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ trace
def _union(intervals):
    """Disjoint, sorted union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_at(host, points):
    """For each point (sorted), the name of the innermost host event
    spanning it (the one that started last), or ``"host"``."""
    import heapq

    host = sorted(host)
    names, heap, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, e, name = host[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "host")
    return names


def summarize(device, host, window, top: int = 10) -> dict:
    """A rank's traced window from its events: ``device`` and ``host`` lists
    of ``(start_ns, end_ns, name)``, ``window`` the window's ``(start_ns,
    end_ns)``. Returns seconds: ``window_s``, ``busy_s`` (the union of
    device events), ``kernel_s`` (their sum), ``ops`` (the ``top`` names by
    device time), ``gaps`` (idle time by the host event spanning each gap's
    middle, the ``top`` names), and ``device`` and ``host``: the events
    that overlap the window, clipped to it, as ``(start_s, end_s, name)``
    from its start."""
    w0, w1 = window

    def clip(events):
        return [(max(s, w0), min(e, w1), n) for s, e, n in events
                if e > w0 and s < w1]

    dev, hst = clip(device), clip(host)
    by_name: dict[str, float] = {}
    kernel = 0.0
    for s, e, n in dev:
        d = (e - s) / _NS
        kernel += d
        by_name[n] = by_name.get(n, 0.0) + d
    busy = _union([(s, e) for s, e, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] + g[1])
    names = _host_at(hst, [(s + e) / 2 for s, e in gaps])
    idle: dict[str, float] = {}
    for (s, e), n in zip(gaps, names):
        idle[n] = idle.get(n, 0.0) + (e - s) / _NS

    def ranked(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    def rel(events):
        return [((s - w0) / _NS, (e - w0) / _NS, n) for s, e, n in events]

    return {"window_s": (w1 - w0) / _NS,
            "busy_s": sum(e - s for s, e in busy) / _NS,
            "kernel_s": kernel, "ops": ranked(by_name), "gaps": ranked(idle),
            "device": rel(dev), "host": rel(hst)}


def _packed(trace: dict) -> dict:
    """``trace`` with its event names listed once (``names``) and each event
    as ``[start_s, end_s, index]``: a rank's record crosses a file."""
    names: dict[str, int] = {}
    out = dict(trace)
    for key in ("device", "host"):
        out[key] = [[s, e, names.setdefault(n, len(names))]
                    for s, e, n in trace[key]]
    out["names"] = list(names)
    return out


def _unpacked(trace: dict) -> dict:
    names = trace.pop("names")
    for key in ("device", "host"):
        trace[key] = [(s, e, names[i]) for s, e, i in trace[key]]
    return trace


def _trace_summary(prof) -> dict:
    """:func:`summarize` of a finished ``torch.profiler.profile`` (its raw
    Kineto events: building the profiler's own event tree would take a
    traced run past its time)."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CPU:
            if item[2] == "portbench.window":
                window = item[:2]
            else:
                host.append(item)
        else:
            device.append(item)
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    # a span on the host (record_function) is mirrored on the device's
    # timeline under its name; it is no operation of the device
    spans = {n for _, _, n in host} | {"portbench.window"}
    return summarize([d for d in device if d[2] not in spans], host, window)


# ------------------------------------------------------------------- rank
@contextlib.contextmanager
def join_world(rank: int, world: int, job: dict):
    """This rank's ``(device, mesh, ctl)``: on several ranks the port's
    world (``job['out']`` holds its store) with its (p, 1) mesh and a gloo
    group ``ctl`` for the harness's own agreements, left on exit; on one,
    the card (or the CPU) and a mesh of one."""
    import torch
    import torch.distributed as dist

    from marlin_tpu_torch import mesh as mm

    cuda = job["device"] == "cuda"
    if world == 1:
        device = torch.device("cuda", 0) if cuda else torch.device("cpu")
        yield device, mm.Mesh(device), None
        return
    mm.initialize_distributed(f"file://{job['out']}/store", world, rank,
                              device=job["device"])
    try:
        ctl = dist.new_group(backend="gloo")
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        yield device, mm.create_mesh(tuple(job["traffic"]["mesh"])), ctl
    finally:
        mm.shutdown_distributed()


def run_rank(rank: int, world: int, job: dict, log=print) -> dict:
    """Join the world (of ``world`` ranks), then set up, run the window and
    check on this rank; the record the result line is made from, also
    written to ``{job['out']}/rank{r}.json`` when ``job['out']`` is set."""
    import marlin_tpu_torch  # noqa: F401  (its import is timed apart)

    stamps = {"imported": time.time()}
    with join_world(rank, world, job) as (device, mesh, ctl):
        stamps["world joined"] = time.time()
        rec = _window(rank, world, job, device, mesh, ctl, log, stamps)
    if job.get("out"):
        if rec["trace"] is not None:
            rec["trace"] = _packed(rec["trace"])
        with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    return rec


def _window(rank, world, job, device, mesh, ctl, log, stamps) -> dict:
    import torch
    import torch.distributed as dist

    cuda = device.type == "cuda"
    traffic = job["traffic"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def barrier():
        sync()
        if ctl is not None:
            dist.barrier(group=ctl)

    op = load_op(job["pkg"], traffic["op"])
    ctx = SimpleNamespace(seed=int(job["seed"]), device=device, mesh=mesh,
                          rank=rank, world=world)
    case = op.Case(ctx, job["cfg"], traffic)
    sync()
    stamps["inputs drawn"] = time.time()
    case.keep(case.call())  # warm-up: every shape the window uses
    sync()
    stamps["warmed up"] = time.time()
    log(f"rank {rank}: set-up " + ", ".join(
        f"{k} {v - job['t0']:.3f}" for k, v in stamps.items())
        + " s from the start")

    prof = None
    if job["trace"]:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    from torch.profiler import record_function

    rng = random.Random(int(job["seed"]))
    sampled = last = None
    calls, agree_at = 0, 1
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    barrier()
    t_first = time.time()
    t0 = time.perf_counter()
    with record_function("portbench.window"):
        while True:
            with record_function("portbench.call"):
                kept = case.keep(case.call())
                sync()
            calls += 1
            if rng.randrange(calls) == 0:
                sampled = kept
            last = kept
            elapsed = time.perf_counter() - t0
            stop = elapsed >= job["seconds"]
            if ctl is not None and calls < agree_at:
                stop = False
            elif ctl is not None:
                # rank 0's clock rules: it says whether to stop and after
                # which call the ranks agree next, a little before the end
                # it foresees, then after every call
                ahead = int(0.9 * (job["seconds"] - elapsed) * calls / elapsed)
                flag = torch.tensor([int(stop), calls + max(1, ahead)])
                dist.broadcast(flag, 0, group=ctl)
                stop, agree_at = bool(flag[0]), int(flag[1])
            if stop:
                break
        barrier()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = _trace_summary(prof)
        del prof
    log(f"rank {rank}: {calls} calls in {window_s:.3f} s")

    case.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = case.check([sampled, last])
    del sampled, last, kept
    if ctl is not None:  # the largest reading of every rank
        for name in sorted(numbers):
            t = torch.tensor(numbers[name], dtype=torch.float64)
            dist.all_reduce(t, dist.ReduceOp.MAX, group=ctl)
            numbers[name] = t.tolist()
    return {"rank": rank, "calls": calls, "window_s": window_s,
            "t_first": t_first, "flops": case.flops, "bytes": case.bytes,
            "numbers": numbers, "memory_peak_bytes": int(peak),
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "trace": trace, "forbidden": forbidden_modules()}


# ------------------------------------------------------------------- main
def _cards(chips: int) -> str | None:
    """Why this host cannot run a cell of ``chips`` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards; torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run there builds and compiles."""
    base = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run_cell(cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", entry=run_rank) -> dict:
    """One run of ``cell`` (:func:`resolve`), each rank in ``entry``
    (:func:`run_rank`, or a test's wrapper of it); returns the result
    line's object, ``compared`` (each number compared with its limit) last.
    On several ranks a failed world raises
    :class:`~portbench.ranks_world.WorldFailed` after printing its ranks'
    logs."""
    world = 1
    for d in cell.traffic["mesh"]:
        world *= int(d)
    if world != cell.chips:
        raise SystemExit(f"{cell.name}: the mesh {cell.traffic['mesh']} is "
                         f"not {cell.chips} ranks")
    job = {"cfg": cell.cfg, "traffic": cell.traffic, "pkg": cell.pkg,
           "seed": seed,
           "seconds": seconds, "trace": bool(trace), "t0": t0,
           "device": device, "out": None}
    if world == 1:
        recs = [entry(0, 1, job, lambda m: print(m, file=sys.stderr))]
    else:
        from portbench.ranks_world import WorldFailed, run_world

        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            job["out"] = tmp
            try:
                run_world(entry, world, job, tmp, DEADLINE_S)
            except WorldFailed as e:
                for r in range(world):
                    _print_log(tmp, r, r in e.ranks)
                raise
            for r in range(world):
                _print_log(tmp, r, False)
            recs = [load_json(os.path.join(tmp, f"rank{r}.json"))
                    for r in range(world)]
            for r in recs:
                if r["trace"] is not None:
                    _unpacked(r["trace"])
    return _result(cell, recs, t0, trace)


def _print_log(tmp: str, rank: int, failed: bool) -> None:
    path = os.path.join(tmp, f"rank{rank}.log")
    text = open(path).read() if os.path.exists(path) else "(no log)\n"
    head = f"--- rank {rank} {'FAILED' if failed else 'log'} ---"
    print(head + "\n" + text, end="", file=sys.stderr, flush=True)


def _result(cell, recs, t0, trace) -> dict:
    first = recs[0]
    peaks = load_json(os.path.join(cell.pkg, "peaks.json"))
    run = SimpleNamespace(
        calls=first["calls"], window_s=first["window_s"],
        setup_s=first["t_first"] - t0, flops=first["flops"],
        bytes=first["bytes"], chips=len(recs), peak=peaks.get(first["kind"]),
        trace=[r["trace"] for r in recs] if trace else None)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run,
                           cell.pkg)
    compared = {}
    for name, limit in cell.limits.items():
        num, den = first["numbers"].get(name, (float("inf"), 1.0))
        value = num / den if den else float("inf")
        compared[name] = {"value": value, "limit": float(limit)}
    correct = bool(compared) and all(
        c["value"] <= c["limit"] for c in compared.values())
    device = {"platform": "gpu" if first["kind"] != "cpu" else "cpu",
              "kind": first["kind"], "count": len(recs),
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in recs)}
    out = {"correct": correct, "attempted": first["calls"], "failed": 0,
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = sum(t["busy_s"] for t in run.trace) / len(recs)
        device["window_s"] = run.trace[0]["window_s"]
        out["breakdown"] = {"device_ops": run.trace[0]["ops"],
                            "idle_gaps": run.trace[0]["gaps"]}
    out["forbidden"] = sorted({m for r in recs for m in r["forbidden"]})
    out["compared"] = compared
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(args.workload)
    _cache_dirs()
    why = _cards(cell.chips)
    if why is not None:
        print(f"portbench: {why}; no result", file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0)
    except Exception as e:  # a failed world: its logs are printed above
        from portbench.ranks_world import WorldFailed

        if not isinstance(e, WorldFailed):
            raise
        print(json.dumps({"correct": False, "attempted": 0,
                          "failed": len(e.ranks), "metrics": {},
                          "device": {"platform": "gpu", "count": cell.chips},
                          "compared": {}}))
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    found = sorted(set(out.pop("forbidden")) | set(forbidden_modules()))
    if found:
        print(f"portbench: loaded {found} (compared by top-level name); "
              f"no result", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
