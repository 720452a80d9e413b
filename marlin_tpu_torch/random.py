"""Deterministic random matrix generation on the device.

Counterpart of ``marlin_tpu/random.py``. The reference draws per-partition
seeded streams (rdd/RandomRDD.scala:28-45) and the JAX package counter-based
threefry keys; here a seed becomes a ``torch.Generator`` on the target device
(Philox on CUDA), and the numbers are generated where they will live. The
streams differ from JAX's: the parity tests feed both packages the same numpy
arrays instead.
"""

from __future__ import annotations

from typing import Any

import torch

from .config import get_config, resolve_device


def ensure_key(seed_or_key, device=None) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed_or_key``; a generator is
    returned as it is."""
    if isinstance(seed_or_key, torch.Generator):
        return seed_or_key
    if not isinstance(seed_or_key, int):
        raise TypeError(f"expected an int seed or a torch.Generator, got "
                        f"{type(seed_or_key).__name__}")
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed_or_key)
    return gen


def random_array(
    seed_or_key,
    shape: tuple[int, ...],
    dist: str = "uniform",
    dtype: Any = None,
    device=None,
    minval: float = 0.0,
    maxval: float = 1.0,
    lam: float = 1.0,
) -> torch.Tensor:
    """An i.i.d. random tensor generated on ``device``.

    ``dist`` mirrors the reference's generator set
    (utils/RandomDataGenerator.scala:12-100): ``uniform`` on [minval, maxval),
    ``normal``, ``poisson`` (rate ``lam``), ``zeros``, ``ones``."""
    dtype = dtype or get_config().default_dtype
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if dist == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if dist == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    gen = ensure_key(seed_or_key, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} cannot fill a tensor "
                         f"on {dev}")
    if dist == "uniform":
        x = torch.rand(shape, generator=gen, dtype=dtype, device=dev)
        if (minval, maxval) != (0.0, 1.0):
            x.mul_(maxval - minval).add_(minval)
        return x
    if dist == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    if dist == "poisson":
        rates = torch.full(shape, float(lam), dtype=torch.float32, device=dev)
        return torch.poisson(rates, generator=gen).to(dtype)
    raise ValueError(f"unknown distribution: {dist}")
