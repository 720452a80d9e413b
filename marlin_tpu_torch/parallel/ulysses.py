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
package's custom VJP. Logical in/out: every rank passes the whole sequence;
this rank's slab is cut before the first all-to-all and the output slabs
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

from ..mesh import ROWS, default_mesh, distributed, pad_to_multiple
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope
from . import collectives as col
from .ring_attention import _xla_attention, resolve_attention_backend

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, mesh=None, axis: str = ROWS,
                      causal: bool = False, scale: float | None = None,
                      precision: str = "high"):
    """Exact multi-head attention; ``q``/``k``/``v`` ``(heads, seq, d)`` or
    any leading batch dims folded into the head axis. The sequence is padded
    to the JAX package's rule (a 128-multiple slab, 1024 multiples past 1024
    tokens) and the pad masked by ``valid_len``; ``precision`` as in
    :func:`~marlin_tpu_torch.parallel.ring_attention.ring_attention`. The
    flash kernels run where ring attention's ``"auto"`` would pick them (a
    CUDA device, head dim up to 256); the tiled formulation elsewhere on the
    card, and the kernels' plain versions for CPU tensors."""
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
    ranks = mesh is not None and getattr(mesh, "ranks", None) is not None
    p = mesh.shape[axis] if ranks else 1
    if not ranks and mesh is not None and mesh.shape[axis] != 1:
        raise ValueError(f"a '{axis}' axis of {mesh.shape[axis]} devices "
                         f"needs a mesh over torch.distributed ranks "
                         f"(initialize_distributed, then create_mesh)")
    heads, seq, d = q.shape
    if heads % p:
        raise ValueError(
            f"heads ({heads}) must divide by the '{axis}' axis size ({p}) — "
            f"pad the head axis or use ring_attention")
    # the JAX package's slab rule: 128-multiple slabs, and a total past 1024
    # a 1024 multiple (the flash panel's block contract)
    slab = pad_to_multiple(pad_to_multiple(seq, p) // p, 128)
    if p * slab > 1024:
        slab = pad_to_multiple(slab, 1024 // math.gcd(p, 1024))
    sp = p * slab
    if sp != seq:
        q, k, v = (F.pad(x, (0, 0, 0, sp - seq)) for x in (q, k, v))
    out_dtype = q.dtype
    if precision == "default":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale_val = float(scale if scale is not None else 1.0 / math.sqrt(d))
    tiled = (q.device.type == "cuda" and
             resolve_attention_backend("auto", q.device, d) == "xla")
    with precision_scope("highest"):
        if ranks:
            q, k, v = (_to_heads(x, mesh, axis) for x in (q, k, v))
        if tiled:
            out = _xla_attention(q, k, v, seq, causal, scale_val)
        else:
            out = _flash.FlashAttention.apply(q, k, v, seq, causal, scale_val)
        if ranks:
            out = _to_sequence(out, mesh, axis)
    out = out.to(out_dtype)
    return out[:, :seq, :] if sp != seq else out


def _to_heads(x, mesh, axis: str):
    """Logical (H, S, d) -> this rank's (H/p, S, d): cut the sequence slab,
    then one all-to-all sends head group j to rank j."""
    p = mesh.shape[axis]
    h, s, d = x.shape
    slab = col.Scatter.apply(x, mesh, axis, 1)            # (H, S/p, d)
    got = col.AllToAll.apply(slab.reshape(p, h // p, s // p, d), mesh, axis)
    return got.transpose(0, 1).reshape(h // p, s, d)      # slabs in order


def _to_sequence(out, mesh, axis: str):
    """This rank's (H/p, S, d) -> logical (H, S, d): the inverse all-to-all,
    then the slabs gathered."""
    p = mesh.shape[axis]
    hp, s, d = out.shape
    parts = out.reshape(hp, p, s // p, d).transpose(0, 1)
    back = col.AllToAll.apply(parts, mesh, axis)          # [j]: head group j
    return col.Gather.apply(back.reshape(hp * p, s // p, d), mesh, axis, 1)
