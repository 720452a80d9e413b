"""Ulysses attention: all-to-all head/sequence re-sharding, at world size 1.

Counterpart of ``marlin_tpu/parallel/ulysses.py``. There one ``all_to_all``
re-shards sequence-sharded Q/K/V over heads, each device runs full-sequence
flash attention for its heads, and a second ``all_to_all`` restores the
sequence sharding. On one device both all-to-alls are the identity, so what
remains is the local attention: :class:`~marlin_tpu_torch.ops.
flash_attention.FlashAttention` over all heads in one launch of each kernel
(the flash forward, and the dK/dV and dQ kernels in the backward; their
plain versions for CPU tensors). A mesh axis larger than 1 raises: the
all-to-alls over ``torch.distributed`` wait (ROADMAP queue 10).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..mesh import ROWS, pad_to_multiple
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope
from .ring_attention import _world_of_one

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, mesh=None, axis: str = ROWS,
                      causal: bool = False, scale: float | None = None,
                      precision: str = "high"):
    """Exact multi-head attention; ``q``/``k``/``v`` ``(heads, seq, d)`` or
    any leading batch dims folded into the head axis. The sequence is padded
    to the JAX package's rule (a 128-multiple slab, 1024 multiples past 1024
    tokens) and the pad masked by ``valid_len``; ``precision`` as in
    :func:`~marlin_tpu_torch.parallel.ring_attention.ring_attention`."""
    if q.ndim < 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ulysses needs (..., heads, seq, d) q/k/v of one shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.ndim > 3:
        lead = q.shape[:-2]
        q2, k2, v2 = (x.reshape(-1, *x.shape[-2:]) for x in (q, k, v))
        out = ulysses_attention(q2, k2, v2, mesh, axis, causal, scale,
                                precision)
        return out.reshape(*lead, *out.shape[-2:])
    if precision not in ("high", "default"):
        raise ValueError(f"unknown ulysses precision: {precision!r}")
    _world_of_one(mesh, axis, "ulysses attention")
    heads, seq, d = q.shape
    # the JAX package's slab rule at one device: 128 multiples, 1024
    # multiples past 1024 tokens (the flash panel's block contract)
    sp = pad_to_multiple(seq, 128)
    if sp > 1024:
        sp = pad_to_multiple(sp, 1024)
    if sp != seq:
        q, k, v = (F.pad(x, (0, 0, 0, sp - seq)) for x in (q, k, v))
    out_dtype = q.dtype
    if precision == "default":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale_val = float(scale if scale is not None else 1.0 / math.sqrt(d))
    with precision_scope("highest"):
        out = _flash.FlashAttention.apply(q, k, v, seq, causal, scale_val)
    out = out.to(out_dtype)
    return out[:, :seq, :] if sp != seq else out
