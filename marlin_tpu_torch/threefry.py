"""JAX's threefry2x32 PRNG in torch integer ops, for sampling that replays.

The JAX package samples tokens with ``jax.random``: a row's stream is
``fold_in(key(seed), step)`` (``transformer._row_key``), ``lm_generate``
splits its key once per step, and ``categorical`` is the Gumbel-max trick over
``uniform`` bits. Integer arithmetic is exact on every device, so porting the
hash gives the same bits, and the same sampled tokens wherever the logits
agree. The layout is that of ``jax_threefry_partitionable=True`` (the default
of the JAX the reference runs on): ``split``, ``fold_in`` and
``random_bits`` hash the 64-bit counter ``i`` as the pair ``(i >> 32, i)``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(``jax.random.key_data``); leading axes batch independent keys. Words live in
int64 so that sums and shifts never overflow, and are masked to 32 bits after
each step.
"""

from __future__ import annotations

import math
import numbers

import torch

__all__ = ["threefry2x32", "prng_key", "as_key", "fold_in", "split",
           "random_bits", "uniform", "normal", "randint", "gumbel",
           "categorical"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)`` under
    key words ``(k1, k2)``; all broadcastable int64 tensors of uint32 values.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as key words ``(seed >> 32, seed & 0xffffffff)``
    (a seed below 2**32 gives ``(0, seed)``)."""
    seed = int(seed)
    hi = (seed >> 32) & _M32 if seed >= 0 else 0
    return torch.tensor([hi, seed & _M32], dtype=torch.int64, device=device)


def as_key(key, device=None) -> torch.Tensor:
    """An int seed, or key words (numpy, list or tensor), as an int64 key
    tensor on ``device``."""
    if isinstance(key, numbers.Integral):
        return prng_key(int(key), device)
    t = torch.as_tensor(key, device=device)
    if t.shape[-1:] != (2,):
        raise ValueError(f"a key has two words, got shape {tuple(t.shape)}")
    return t.to(torch.int64) & _M32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``data`` (int or int tensor, broadcast
    against the key's leading axes) under ``key``."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, shape ``(num, 2)`` for one key
    (``(..., num, 2)`` for a batch)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32,
                        i & _M32)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of ``shape`` for each key: the counter runs
    over the flattened shape. Returns int64 values below 2**32, shaped
    ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    a, b = threefry2x32(k1, k2, i >> 32, i & _M32)
    return (a ^ b).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float32 or bfloat16:
    uniform values on (-1, 1) from the same bits, each step rounded to
    ``dtype`` as JAX rounds it, then ``sqrt(2) * erfinv``. float32 takes 23
    mantissa bits of a 32-bit word; bfloat16 7 bits of the word's low byte
    (JAX draws 8 bits for types of fewer than 8 mantissa bits). The bits and
    the uniform values are JAX's exactly; ``erfinv`` is PyTorch's, which may
    differ from XLA's in the last place."""
    if dtype == torch.float32:
        width, nmant, one, view = 32, 23, 0x3F800000, torch.int32
    elif dtype == torch.bfloat16:
        width, nmant, one, view = 8, 7, 0x3F80, torch.int16
    else:
        raise TypeError(f"normal: float32 or bfloat16, got {dtype}")
    bits = random_bits(key, shape) & ((1 << width) - 1)
    f = (((bits >> (width - nmant)) | one).to(view).view(dtype)
         - torch.ones((), dtype=dtype, device=key.device))
    # the largest value below -1 in dtype, and 1, as JAX's bounds
    lo = torch.full((), -(1.0 - 2.0 ** -(nmant + 1)), dtype=dtype,
                    device=key.device)
    hi = torch.ones((), dtype=dtype, device=key.device)
    u = torch.maximum(lo, f * (hi - lo) + lo)
    return torch.erfinv(u) * torch.full((), math.sqrt(2.0), dtype=dtype,
                                        device=key.device)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for uint32 values ``a`` held in int64 and a uint32
    ``b``, without the 64-bit product overflowing: ``b`` is split into
    16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=jnp.int32)``:
    two words of random bits per value (one from each half of
    ``split(key)``), folded into ``[minval, maxval)`` by uint32 remainders,
    with JAX's uint32 wrap-around. Returns int32 values of ``shape``."""
    i32 = torch.iinfo(torch.int32)
    minval, maxval = int(minval), int(maxval)
    if not (i32.min <= minval <= i32.max and i32.min <= maxval <= i32.max):
        raise OverflowError(f"randint bounds [{minval}, {maxval}) leave int32")
    k1, k2 = split(key, 2).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span  # a uint32 product: it wraps
    offset = ((_mul32(higher % span, mult) + lower % span) & _M32) % span
    # minval + offset as an int32 add that wraps, as lax does
    out = (minval + offset + 2 ** 31) % 2 ** 32 - 2 ** 31
    return out.to(torch.int32)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (its default "low" mode) in f32."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the Gumbel-max trick,
    ``argmax(gumbel + logits)`` with ties to the first index. One key per
    call, or one per row when ``key`` carries the logits' leading axes."""
    if key.dim() == 1:
        g = gumbel(key, logits.shape)
    else:
        g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits.float(), dim=-1)
