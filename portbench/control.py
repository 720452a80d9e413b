#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... [--control-seeds 7 8 9]

For each seed, in one process (one world on several cards), the inputs are
drawn, the program makes one call of the timed path, and its output is
compared with the reference by the cell's numbers; for each control seed
the control (the op's ``control()``: the computation put in the program's
place one precision below the configuration's) is compared alike. Prints
one JSON line a reading: ``{"seed", "side": "program"|"control",
"numbers": {name: value}}``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def readings(rank, world, job, log=print) -> dict:
    """One rank's readings: it joins the world as a run does
    (:func:`harness.join_world`) and draws, calls and checks each seed."""
    with harness.join_world(rank, world, job) as (device, mesh, ctl):
        return _readings(rank, world, job, device, mesh, ctl, log)


def _readings(rank, world, job, device, mesh, ctl, log) -> dict:
    import torch
    import torch.distributed as dist

    op = harness.load_op(job["pkg"], job["traffic"]["op"])
    out = []
    for seed in job["seeds"]:
        for side in ("program", "control"):
            if side == "control" and seed not in job["control_seeds"]:
                continue
            ctx = SimpleNamespace(seed=seed, device=device, mesh=mesh,
                                  rank=rank, world=world)
            case = op.Case(ctx, job["cfg"], job["traffic"])
            t = time.perf_counter()
            kept = case.keep(case.call()) if side == "program" \
                else case.control()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            secs = time.perf_counter() - t
            case.release()
            numbers = case.check([kept])
            del kept, case
            if device.type == "cuda":
                torch.cuda.empty_cache()
            line = {"seed": seed, "side": side, "call_s": secs}
            for name, pair in sorted(numbers.items()):
                t = torch.tensor(pair, dtype=torch.float64)
                if ctl is not None:
                    dist.all_reduce(t, dist.ReduceOp.MAX, group=ctl)
                num, den = t.tolist()
                line[name] = num / den if den else float("inf")
            out.append(line)
            if rank == 0:
                log(json.dumps(line))
    return {"readings": out}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    harness._cache_dirs()
    if args.device == "cuda":
        why = harness._cards(cell.chips)
        if why is not None:
            print(f"portbench: {why}", file=sys.stderr)
            return 2
    job = {"cfg": cell.cfg, "traffic": cell.traffic, "pkg": cell.pkg,
           "device": args.device,
           "seeds": args.seeds, "control_seeds": args.control_seeds,
           "out": None}
    if cell.chips == 1:
        readings(0, 1, job)
        return 0
    from portbench.ranks_world import WorldFailed, run_world

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        job["out"] = tmp
        try:
            run_world(readings, cell.chips, job, tmp, 3000.0)
        except WorldFailed:
            for r in range(cell.chips):
                harness._print_log(tmp, r, True)
            raise
        harness._print_log(tmp, 0, False)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
