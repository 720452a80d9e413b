"""Deterministic random matrix generation on the device.

Counterpart of ``marlin_tpu/random.py``. The reference draws per-partition
seeded streams (rdd/RandomRDD.scala:28-45) and the JAX package counter-based
threefry keys; here a seed becomes a ``torch.Generator`` on the target device
(Philox on CUDA), and the numbers are generated where they will live. The
streams differ from JAX's: the parity tests feed both packages the same numpy
arrays instead.

Over ``torch.distributed`` ranks a rank draws only its block, by counter
(:func:`random_block`): element ``i`` of the padded array is the JAX
package's threefry draw at counter ``i`` (``jax_threefry_partitionable``
layout), so the matrix is the JAX package's on a device mesh of the same
grid, and the same logical matrix on every grid.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from . import threefry
from .config import get_config, resolve_device

# elements a row chunk of random_block draws at once: the hash keeps about
# ten int64 temporaries of a chunk alive
BLOCK_CHUNK = 1 << 22


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


def random_block(seed_or_key, padded: tuple[int, ...], bounds, dist: str =
                 "uniform", dtype: Any = None, device=None, minval: float = 0.0,
                 maxval: float = 1.0, lam: float = 1.0) -> torch.Tensor:
    """The block ``bounds`` (``(start, stop)`` a dimension) of a ``padded``
    random array, drawn alone: element ``i`` of the flat array is the
    threefry draw at counter ``i`` under ``seed_or_key`` (an int seed or key
    words). ``uniform`` (float32) is ``jax.random.uniform``'s bits;
    ``normal`` is ``jax.random.normal``'s uniform values through PyTorch's
    ``erfinv``; ``poisson`` inverts the Poisson CDF at each element's own
    uniform (a counter-derived stream of one draw, not JAX's sampler). Other
    float dtypes are the float32 draw cast. Drawn in row chunks of about
    :data:`BLOCK_CHUNK` elements."""
    dtype = dtype or get_config().default_dtype
    dev = resolve_device(device)
    shape = tuple(b - a for a, b in bounds)
    if dist == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if dist == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if dist not in ("uniform", "normal", "poisson"):
        raise ValueError(f"unknown distribution: {dist}")
    if isinstance(seed_or_key, torch.Generator):
        raise TypeError("a draw over ranks is counter-based: pass an int "
                        "seed or threefry key words, not a torch.Generator")
    key = threefry.as_key(seed_or_key, dev)
    out = torch.empty(shape, dtype=dtype, device=dev)
    if not out.numel():
        return out
    strides = [1] * len(padded)
    for d in range(len(padded) - 2, -1, -1):
        strides[d] = strides[d + 1] * int(padded[d + 1])
    inner = 0
    inner_n = 1
    for d in range(1, len(shape)):
        idx = torch.arange(bounds[d][0], bounds[d][1], dtype=torch.int64,
                           device=dev) * strides[d]
        inner = (inner[..., None] if torch.is_tensor(inner) else inner) + idx
        inner_n *= shape[d]
    step = max(1, BLOCK_CHUNK // inner_n)
    for r in range(0, shape[0], step):
        rows = torch.arange(bounds[0][0] + r,
                            bounds[0][0] + min(r + step, shape[0]),
                            dtype=torch.int64, device=dev) * strides[0]
        ctr = rows.reshape((-1,) + (1,) * (len(shape) - 1)) + inner
        bits = threefry.bits_at(key, ctr)
        if dist == "normal":
            x = threefry.normal_from_bits(bits, torch.float32)
        else:
            x = threefry.uniform_from_bits(
                bits, *((minval, maxval) if dist == "uniform" else (0., 1.)))
            if dist == "poisson":
                x = _poisson_inverse(x, lam)
        out[r:r + step] = x.to(dtype)
    return out


def _poisson_inverse(u: torch.Tensor, lam: float) -> torch.Tensor:
    """The smallest ``k`` with ``P(X <= k) > u`` for X ~ Poisson(``lam``),
    element by element, in float64, up to ``lam + 12 sqrt(lam) + 20``."""
    u = u.double()
    p = torch.full_like(u, math.exp(-lam))
    cdf = p.clone()
    k = torch.zeros_like(u)
    for i in range(1, int(lam + 12 * math.sqrt(lam) + 20)):
        more = cdf <= u
        if not bool(more.any()):
            break
        p = p * (lam / i)
        k = torch.where(more, k + 1, k)
        cdf = torch.where(more, cdf + p, cdf)
    return k
