"""Timing hooks.

Counterpart of ``marlin_tpu/utils/profiling.py`` (``evaluate`` and ``timer``).
PyTorch returns from a CUDA call before the card has finished it, so a host
clock around device work measures only the enqueue unless the work is forced
first: :func:`evaluate` is that barrier (the analog of ``MTUtils.evaluate``,
utils/MTUtils.scala:218-220).
"""

from __future__ import annotations

import contextlib
import time

import torch


def _tensors(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def evaluate(*xs):
    """Wait until the given tensors (or matrices, vectors, or containers of
    them) are computed; returns them. ``torch.cuda.synchronize`` on each CUDA
    device they live on; CPU tensors are already done."""
    devices = {t.device for x in xs for t in _tensors(x) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return xs[0] if len(xs) == 1 else xs


@contextlib.contextmanager
def timer(label: str = "", results: list | None = None, quiet: bool = False):
    """Wall-clock the body and print millis like the reference's examples do
    (e.g. examples/BLAS3.scala:34-56). Call :func:`evaluate` on the body's
    results inside it, or the time is the enqueue's."""
    t0 = time.perf_counter()
    yield
    dt_ms = (time.perf_counter() - t0) * 1000.0
    if results is not None:
        results.append(dt_ms)
    if not quiet:
        print(f"{label or 'elapsed'}: {dt_ms:.1f} ms")
