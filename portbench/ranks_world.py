"""One process a card, one NCCL world: the benchmark's copy of the port's
rank tools' spawner (``tools/ranks_world.py``), kept here so that an edit
of the tools cannot move the yardstick.

:func:`run_world` spawns the ranks (rank r on card r), each running
``fn(rank, world, job, log)`` with ``log`` writing to ``{out}/rank{r}.log``;
a rank's traceback goes to its log too. It waits at most ``deadline_s``
seconds: a rank that fails stops the world (``torch.multiprocessing`` kills
the others), and at the deadline every rank still running is killed. Either
way it raises :class:`WorldFailed`, which names the ranks that failed or
passed the deadline, and the caller prints their logs.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class WorldFailed(RuntimeError):
    """The world did not end well: ``ranks`` failed or passed the
    deadline (``timed_out``)."""

    def __init__(self, msg: str, ranks: list[int], timed_out: bool):
        super().__init__(msg)
        self.ranks = ranks
        self.timed_out = timed_out


def _rank_entry(rank, fn, world, job, out):
    sys.path.insert(0, ROOT)
    with open(os.path.join(out, f"rank{rank}.log"), "w") as f:
        def log(msg):
            f.write(msg + "\n")
            f.flush()
        try:
            fn(rank, world, job, log)
        except BaseException:
            log(traceback.format_exc())
            raise


def run_world(fn, world: int, job, out: str, deadline_s: float) -> None:
    """Run ``fn(rank, world, job, log)`` on ``world`` spawned ranks (``fn``
    a module-level function, so the ranks can import it); returns when
    every rank has ended well, raises :class:`WorldFailed` otherwise."""
    import torch.multiprocessing as mp

    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_rank_entry, args=(fn, world, job, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                late = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                raise WorldFailed(f"the {world}-rank world passed its "
                                  f"{deadline_s:.0f} s deadline; ranks {late} "
                                  f"killed", late, True)
    except mp.ProcessRaisedException as e:
        raise WorldFailed(str(e).splitlines()[0], [e.error_index],
                          False) from None
    except mp.ProcessExitedException as e:
        raise WorldFailed(str(e).splitlines()[0], [e.error_index],
                          False) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(30)
