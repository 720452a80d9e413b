"""Shared CLI plumbing for the port's example programs.

Counterpart of ``examples/_common.py``. The reference's examples are
spark-submit ``main()``s that double as the benchmark harness, each printing
wall-clock millis (SURVEY.md §2.5). These CLIs keep the JAX package's
positional-argument contracts, usage and ``die`` messages, printed lines and
return values, and run on the configured device: ``cuda`` unless the caller
wraps ``main`` in ``config_context(device="cpu")``. Without a card they raise,
as :func:`marlin_tpu_torch.config.resolve_device` does.

Run as modules from the repo root, e.g.::

    python -m marlin_tpu_torch.examples.matrix_multiply 20000 20000 20000 1

Every timed window ends in :func:`marlin_tpu_torch.evaluate` (or a read of
the result on the host), after a warm-up where the JAX CLI has one.
"""

from __future__ import annotations

import sys
import time


def millis() -> float:
    return time.perf_counter() * 1000.0


def die(usage: str):
    print(usage, file=sys.stderr)
    raise SystemExit(1)
