"""The plumbing of the tools that run the port's rank paths on several cards
(``tools/matrices_ranks.py``, ``tools/workloads_ranks.py``): one process a
card, one NCCL world.

- :func:`world_size` reads WORLD from the command line (default: every
  card) and refuses a WORLD larger than ``torch.cuda.device_count()``.
- :func:`run_world` spawns the ranks (rank r on card r), each running
  ``fn(rank, world, tmp, log)`` with ``log`` writing to
  ``{out}/rank{r}.log``; a rank's traceback goes to its log too. It waits
  at most ``DEADLINE_S`` seconds: a rank that fails stops the world
  (``torch.multiprocessing`` kills the others), and at the deadline every
  rank still running is killed. Either way it prints every rank's log and
  raises, so the tool exits non-zero. It prints the world's seconds.
- :func:`slowest`, :func:`per_rank` and :func:`events` are the figures'
  helpers inside a world: the largest of a number over the ranks, every
  rank's number on every rank, and the CUDA-event time of a call.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# how long a world may run before its ranks are killed. On four H100s
# tools/workloads_ranks.py's world of 2 ran 68 s, and its build with the
# worlds of 4 and 2 246 s, so a world of 4 takes under 180 s; the
# documented chip command (the build, then worlds of 4 and 2 under one
# 900 s limit) reaches a hung world's deadline before its own
DEADLINE_S = 300.0


def world_size(argv) -> int:
    """WORLD from ``argv`` (default: every card); raises ``SystemExit``
    with a message when the host lacks CUDA or has fewer cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda is not available")
    cards = torch.cuda.device_count()
    world = int(argv[0]) if argv else cards
    if not 1 <= world <= cards:
        raise SystemExit(f"WORLD {world} needs as many cards; this host has "
                         f"{cards}")
    return world


def _rank_entry(rank, fn, world, tmp, out):
    sys.path.insert(0, ROOT)
    with open(os.path.join(out, f"rank{rank}.log"), "w") as f:
        def log(msg):
            f.write(msg + "\n")
            f.flush()
        try:
            fn(rank, world, tmp, log)
        except BaseException:
            log(traceback.format_exc())
            raise


def run_world(fn, world: int, tmp: str, out: str) -> None:
    """Run ``fn(rank, world, tmp, log)`` on ``world`` spawned ranks
    (``fn`` a module-level function of the tool, so the ranks can import
    it); returns when every rank has ended well, raises otherwise."""
    import torch.multiprocessing as mp

    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_rank_entry, args=(fn, world, tmp, out),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    deadline = t0 + DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(30)
                raise TimeoutError(f"the {world}-rank world passed its "
                                   f"{DEADLINE_S:.0f} s deadline; killed")
    finally:
        for r in range(world):
            path = os.path.join(out, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    print(f.read(), end="", flush=True)
        print(f"the {world}-rank world ran {time.monotonic() - t0:.1f} s",
              flush=True)


def slowest(x: float) -> float:
    """The largest ``x`` over the world's ranks (a collective)."""
    return max(per_rank(x))


def per_rank(x: float) -> list[float]:
    """Every rank's ``x``, in rank order (a collective)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(x)], dtype=torch.float64,
                     device=torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [float(p) for p in parts]


def events(fn, reps: int):
    """(result, ms a call by CUDA events over ``reps`` calls after one
    warm-up call)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def smi() -> list[str]:
    """``nvidia-smi``'s name and power limit of every card."""
    return os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip().splitlines()
