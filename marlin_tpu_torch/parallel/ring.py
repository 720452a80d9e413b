"""Ring matmul: B-panels rotating around a mesh axis.

Counterpart of ``marlin_tpu/parallel/ring.py``. Every rank keeps its rows of
A stationary while B's row panels rotate around the ring: at step ``i`` rank
``r`` holds the panel of rank ``(r - i) % p`` and multiplies it by the
matching columns of its A rows. The next panel's send and receive
(``torch.distributed.batch_isend_irecv`` to ``r + 1`` and from ``r - 1``)
are posted before the resident product, as the JAX package overlaps its
``ppermute`` with the dot. Logical in/out: every rank passes all of A and B
and gets all of C, gathered from the ranks' row blocks.

At one rank along the axis nothing rotates, just as ``ppermute`` over one
device is the identity: one ``torch.matmul`` with the JAX package's padding
and ``accum_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..mesh import ROWS, default_mesh, pad_to_multiple
from ..ops.local import local_matmul
from . import collectives as col

__all__ = ["ring_matmul"]


def ring_matmul(a: torch.Tensor, b: torch.Tensor, mesh=None,
                axis: str = ROWS, precision: str | None = None,
                accum_dtype=None) -> torch.Tensor:
    """``a @ b`` with B-panels rotating around the mesh ring. Logical
    in/out; m and k are zero-padded to multiples of the ring size and the
    result sliced back. Products at ``precision`` (default: the configured
    one), accumulated in ``accum_dtype`` (default ``a.dtype``)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    mesh = mesh or default_mesh()
    p = mesh.shape[axis]
    mp, kp = pad_to_multiple(m, p), pad_to_multiple(k, p)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k:
        b = F.pad(b, (0, 0, 0, kp - k))
    accum_dtype = accum_dtype or a.dtype
    if mesh.ranks is None:
        c = local_matmul(a, b, precision, accum_dtype)
        return c[:m] if mp != m else c
    r = mesh.index(axis)
    a_blk = col.block(a, mesh, axis, 0)            # (mp/p, kp) stationary
    b_cur = col.block(b, mesh, axis, 0).contiguous()  # (kp/p, n) rotating
    panel = kp // p
    acc = torch.zeros((a_blk.shape[0], n), dtype=accum_dtype, device=a.device)
    for i in range(p):
        owner = (r - i) % p  # whose B-panel this rank holds
        if i < p - 1:
            pending = col.ring_send_recv([b_cur], mesh, axis)
        a_chunk = a_blk[:, owner * panel:(owner + 1) * panel]
        acc = acc + local_matmul(a_chunk, b_cur, precision, accum_dtype)
        if i < p - 1:
            b_cur, = col.finish(*pending)
    c = col.all_gather_cat(acc, mesh, axis, 0)
    return c[:m] if mp != m else c
