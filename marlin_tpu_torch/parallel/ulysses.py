"""Ulysses attention: all-to-all head/sequence re-sharding.

Counterpart of ``marlin_tpu/parallel/ulysses.py``. Across the ranks of a
mesh axis, one ``all_to_all_single`` re-shards the sequence-sharded Q/K/V
over heads, so each rank holds the full sequence for ``heads/p`` heads and
runs local attention; a second ``all_to_all_single`` restores the sequence
sharding. The local attention is :class:`~marlin_tpu_torch.ops.
flash_attention.FlashAttention` over the rank's heads in one launch of each
kernel (the flash forward, and the dK/dV and dQ kernels in the backward;
their plain versions for CPU tensors). Each all-to-all is an autograd
function whose backward is the inverse all-to-all, so the backward is the
pair of inverse all-to-alls around FlashAttention's backward, as the JAX
package's custom VJP. :func:`ulysses_attention_shard` works on this rank's
slab alone (the sequence-sharded trainer calls it); :func:`ulysses_attention`
keeps the logical in/out contract over it: every rank passes the whole
sequence, its slab is cut before the first all-to-all and the output slabs
gathered after the second. With no process group both all-to-alls are the
identity and only the local attention runs. On a CUDA device a head dim
above the flash kernels' 256 takes ring attention's tiled formulation
instead, by the rule of its ``"auto"`` backend
(:func:`~marlin_tpu_torch.parallel.ring_attention.resolve_attention_backend`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..mesh import (ROWS, default_mesh, distributed, over_ranks,
                    pad_to_multiple)
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope
from . import collectives as col
from .ring_attention import _xla_attention, resolve_attention_backend

__all__ = ["ulysses_attention", "ulysses_attention_shard",
           "ulysses_padded_len"]


def ulysses_padded_len(seq: int, p: int) -> int:
    """The padded length of a ``seq``-token sequence cut into ``p`` slabs,
    the JAX package's rule: 128-multiple slabs, and a total past 1024 a 1024
    multiple (the flash panel's block contract)."""
    slab = pad_to_multiple(pad_to_multiple(seq, p) // p, 128)
    if p * slab > 1024:
        slab = pad_to_multiple(slab, 1024 // math.gcd(p, 1024))
    return p * slab


def _check_heads(heads: int, p: int, axis: str) -> None:
    if heads % p:
        raise ValueError(
            f"heads ({heads}) must divide by the '{axis}' axis size ({p}) — "
            f"pad the head axis or use ring_attention")


def _local_attention(q, k, v, valid_len: int, causal: bool, scale: float):
    """All of the sequence for the heads at hand: the flash kernels, or the
    tiled formulation on the card above their head dim."""
    if q.device.type == "cuda" and resolve_attention_backend(
            "auto", q.device, q.shape[-1]) == "xla":
        return _xla_attention(q, k, v, valid_len, causal, scale)
    return _flash.FlashAttention.apply(q, k, v, valid_len, causal, scale)


def ulysses_attention_shard(q, k, v, mesh, valid_len: int, axis: str = ROWS,
                            causal: bool = False, scale: float | None = None,
                            precision: str = "high"):
    """Ulysses attention over this rank's ``(heads, slab, d)`` slab of a
    sequence cut in ``mesh.shape[axis]`` slabs in axis order, padded by the
    caller to :func:`ulysses_padded_len`; keys at or past ``valid_len`` are
    masked. One all-to-all gives this rank all of the sequence for
    ``heads/p`` heads, attention runs on them, and the inverse all-to-all
    returns this rank's output slab (q's dtype)."""
    if precision not in ("high", "default"):
        raise ValueError(f"unknown ulysses precision: {precision!r}")
    _check_heads(q.shape[0], mesh.shape[axis], axis)
    out_dtype = q.dtype
    if precision == "default":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale_val = float(scale if scale is not None
                      else 1.0 / math.sqrt(q.shape[-1]))
    with precision_scope("highest"):
        q, k, v = (_heads_from_slab(x, mesh, axis) for x in (q, k, v))
        out = _local_attention(q, k, v, valid_len, causal, scale_val)
        out = _slab_from_heads(out, mesh, axis)
    return out.to(out_dtype)


def ulysses_attention(q, k, v, mesh=None, axis: str = ROWS,
                      causal: bool = False, scale: float | None = None,
                      precision: str = "high"):
    """Exact multi-head attention; ``q``/``k``/``v`` ``(heads, seq, d)`` or
    any leading batch dims folded into the head axis. The sequence is padded
    to the JAX package's rule (:func:`ulysses_padded_len`) and the pad
    masked by ``valid_len``; ``precision`` as in
    :func:`~marlin_tpu_torch.parallel.ring_attention.ring_attention`. The
    flash kernels run where ring attention's ``"auto"`` would pick them (a
    CUDA device, head dim up to 256); the tiled formulation elsewhere on the
    card, and the kernels' plain versions for CPU tensors. Over ranks every
    rank passes the whole sequence: its slab is cut,
    :func:`ulysses_attention_shard` runs, and the output slabs are
    gathered."""
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
    if mesh is None and distributed():
        mesh = default_mesh()
    ranks = over_ranks(mesh, (axis,))
    p = mesh.shape[axis] if ranks else 1
    heads, seq, d = q.shape
    _check_heads(heads, p, axis)
    sp = ulysses_padded_len(seq, p)
    if sp != seq:
        q, k, v = (F.pad(x, (0, 0, 0, sp - seq)) for x in (q, k, v))
    if ranks:
        slabs = (col.Scatter.apply(x, mesh, axis, 1) for x in (q, k, v))
        out = col.Gather.apply(ulysses_attention_shard(
            *slabs, mesh, seq, axis, causal, scale, precision), mesh, axis, 1)
        return out[:, :seq, :] if sp != seq else out
    out_dtype = q.dtype
    if precision == "default":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale_val = float(scale if scale is not None else 1.0 / math.sqrt(d))
    with precision_scope("highest"):
        out = _local_attention(q, k, v, seq, causal, scale_val)
    out = out.to(out_dtype)
    return out[:, :seq, :] if sp != seq else out


def _heads_from_slab(x, mesh, axis: str):
    """This rank's (H, S/p, d) slab -> its (H/p, S, d) heads: one all-to-all
    sends head group j to rank j, and the slabs arrive in order."""
    p = mesh.shape[axis]
    h, s, d = x.shape
    got = col.AllToAll.apply(x.reshape(p, h // p, s, d), mesh, axis)
    return got.transpose(0, 1).reshape(h // p, p * s, d)


def _slab_from_heads(out, mesh, axis: str):
    """This rank's (H/p, S, d) heads -> its (H, S/p, d) slab: the inverse
    all-to-all."""
    p = mesh.shape[axis]
    hp, s, d = out.shape
    parts = out.reshape(hp, p, s // p, d).transpose(0, 1)
    back = col.AllToAll.apply(parts, mesh, axis)          # [j]: head group j
    return back.reshape(hp * p, s // p, d)
