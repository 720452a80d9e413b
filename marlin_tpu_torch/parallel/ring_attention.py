"""Ring attention: exact attention over a sequence sharded around a ring.

Counterpart of ``marlin_tpu/parallel/ring_attention.py``. The sequence is
split over a mesh axis; every rank keeps its Q rows while the K/V panels
rotate around the ring (``torch.distributed.batch_isend_irecv`` to the next
rank and from the previous one, the next panel posted before the resident
panel is folded in), and carries the softmax state ``(m, l, acc)`` across
the panels with masks at global positions. The backward
(:class:`_RingAttention`, the JAX package's custom VJP) runs the same
rotation with dK/dV accumulators riding the ring beside their panels, so
after ``p`` steps every panel's gradient sum is home; dQ accumulates
locally. Logical in/out: every rank passes the whole (padded) sequence, and
the output and the gradients are gathered back whole, so each rank holds the
whole tensors; :class:`_RingAttention` alone is the layer that works on this
rank's panels. With no process group
the ring is the home panel alone (the JAX package's ``p_size == 1``
branches).

Backends:

- ``"flash"``: each panel through :func:`~marlin_tpu_torch.ops.
  flash_attention.flash_attention_panel` at its global offsets, and its
  backward through :func:`~marlin_tpu_torch.ops.flash_attention.
  flash_attention_panel_bwd` — the CUDA forward, dK/dV and dQ kernels, over
  all heads in one launch each (the plain versions for CPU tensors). In a
  world of one the home panel is :class:`~marlin_tpu_torch.ops.
  flash_attention.FlashAttention`.
- ``"xla"``: the JAX package's tiled formulation in plain PyTorch — each
  panel in ``_KV_TILE``-key tiles folded by :func:`softmax_tile_update`. In
  a world of one autograd runs through the tiles, as JAX differentiates its
  XLA path; across ranks the backward rebuilds each panel's probabilities
  from the logsumexp rows, the plain recompute of the flash backward.
- ``"auto"``: ``"flash"`` for tensors on a CUDA device with a head dim of at
  most 256, ``"xla"`` above it and for CPU tensors
  (:func:`resolve_attention_backend`). The rule is the reach of the flash
  kernels: the forward and the backward pair are compiled up to d = 256
  (:data:`~marlin_tpu_torch.ops.flash_attention.FWD_MAX_D`,
  :data:`~marlin_tpu_torch.ops.flash_attention.BWD_MAX_D`), and training
  through ``"flash"`` needs both. The JAX package's ``auto`` picks flash on
  a TPU for ``d % 128 == 0``, the width of its matrix unit, so the two agree
  at d = 128 and 256 and differ at the other head dims up to 256 (64, 192,
  ...), where the TPU takes its tiled path and the card the kernels (d = 192
  pads to the d <= 256 instances with zero columns, as d = 96 pads to 128).
  Both paths compute the same function, the exact softmax attention of the
  panel. An explicit ``"flash"`` at d > 256 on the card raises; the JAX
  package's ``"flash"`` takes any head dim.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..mesh import ROWS, default_mesh, distributed, pad_to_multiple
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope
from . import collectives as col

__all__ = ["ring_attention", "attention_reference", "softmax_tile_update",
           "resolve_attention_backend"]

_NEG = -1e30
_KV_TILE = 2048  # inner tile bounding the (sq × tile) score buffer


def attention_reference(q, k, v, causal: bool = False,
                        scale: float | None = None):
    """Single-device oracle: softmax(q kᵀ · scale) v, in IEEE f32 (TF32
    off) whatever the inputs' dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    with precision_scope("highest"):
        s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
        if causal:
            qlen, klen = s.shape[-2], s.shape[-1]
            mask = (torch.arange(qlen, device=s.device)[:, None]
                    >= torch.arange(klen, device=s.device)[None, :])
            s = torch.where(mask, s, _NEG)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)


def softmax_tile_update(q_blk, k_t, v_t, m, l, acc, q_pos, k_pos, valid_len,
                        causal: bool, scale: float):
    """One blockwise-softmax step: fold the (q_blk × k_t) score tile into the
    running ``(m, l, acc)`` state. Leading (heads) axes broadcast. Scores are
    f32; ``p`` is cast to v's dtype before P·V, as the flash kernels do."""
    s = torch.matmul(q_blk.float(), k_t.float().transpose(-1, -2)) * scale
    keep = k_pos[None, :] < valid_len
    if causal:
        keep = keep & (q_pos[:, None] >= k_pos[None, :])
    s = torch.where(keep, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(v_t.dtype).float(),
                                                v_t.float())
    return m_new, l, acc


def resolve_attention_backend(backend: str, device, head_dim: int) -> str:
    """``backend`` as ``"flash"`` or ``"xla"`` for tensors on ``device`` with
    head dim ``head_dim`` (module docstring): ``"auto"`` is the CUDA kernels
    on a CUDA device up to the flash kernels' head dim (256), and the tiled
    plain path above it and elsewhere. ``"flash"`` on a CUDA device above
    that head dim raises: the kernels could not run."""
    if backend not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown ring attention backend: {backend!r}")
    on_card = torch.device(device).type == "cuda"
    reach = min(_flash.FWD_MAX_D, _flash.BWD_MAX_D)
    fits = head_dim <= reach
    if backend == "auto":
        return "flash" if on_card and fits else "xla"
    if backend == "flash" and on_card and not fits:
        raise ValueError(
            f"ring attention backend 'flash': head dim {head_dim} exceeds the "
            f"flash kernels' {reach} on {device}; 'auto' or 'xla' take the "
            f"tiled path")
    return backend


def _xla_attention(q, k, v, valid_len: int, causal: bool, scale: float):
    """The home panel in ``_KV_TILE`` tiles (the whole panel when it is not
    a tile multiple), autograd through every tile."""
    sq, skv = q.shape[-2], k.shape[-2]
    tile = _KV_TILE if skv % _KV_TILE == 0 else skv
    lead = q.shape[:-1]
    m = torch.full(lead, _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(lead, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)
    for off in range(0, skv, tile):
        k_pos = off + torch.arange(tile, device=q.device)
        m, l, acc = softmax_tile_update(
            q, k[..., off:off + tile, :], v[..., off:off + tile, :], m, l,
            acc, q_pos, k_pos, valid_len, causal, scale)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _xla_panel(q, k, v, m, l, acc, q_off: int, k_off: int, valid_len: int,
               causal: bool, scale: float):
    """Fold one K/V panel at global offsets into ``(m, l, acc)`` in
    ``_KV_TILE``-key tiles (the whole panel when it is not a tile
    multiple)."""
    sq, skv = q.shape[-2], k.shape[-2]
    tile = _KV_TILE if skv % _KV_TILE == 0 else skv
    q_pos = q_off + torch.arange(sq, device=q.device)
    for off in range(0, skv, tile):
        k_pos = k_off + off + torch.arange(tile, device=q.device)
        m, l, acc = softmax_tile_update(
            q, k[..., off:off + tile, :], v[..., off:off + tile, :], m, l,
            acc, q_pos, k_pos, valid_len, causal, scale)
    return m, l, acc


class _RingAttention(torch.autograd.Function):
    """Ring attention over this rank's ``(H, sq, d)`` panels, returning its
    output panel: ``_RingAttention.apply(q, k, v, mesh, axis, valid_len,
    causal, scale, flash)``. The forward saves the panels, the output and the
    logsumexp rows; the backward rotates K/V with their dK/dV accumulators
    (``parallel/ring_attention.py:160-210`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, valid_len, causal, scale, flash):
        p = mesh.shape[axis]
        r = mesh.index(axis)
        sq, skv = q.shape[-2], k.shape[-2]
        if flash:
            b = _flash.block_divisor(min(sq, skv))

            def panel(kc, vc, m, l, acc, owner):
                return _flash.flash_attention_panel(
                    q, kc, vc, m, l, acc, r * sq, owner * skv, valid_len,
                    causal=causal, scale=scale, bq=b, bkv=b)
        else:
            def panel(kc, vc, m, l, acc, owner):
                return _xla_panel(q, kc, vc, m, l, acc, r * sq, owner * skv,
                                  valid_len, causal, scale)
        m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for i in range(p):
            if i < p - 1:  # the next panel travels while this one folds in
                pending = col.ring_send_recv([k_cur, v_cur], mesh, axis)
            m, l, acc = panel(k_cur, v_cur, m, l, acc, (r - i) % p)
            if i < p - 1:
                k_cur, v_cur = col.finish(*pending)
        lf = torch.clamp(l, min=1e-30)
        out = (acc / lf[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(lf))
        ctx.meta = (mesh, axis, valid_len, causal, scale, flash)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, valid_len, causal, scale, flash = ctx.meta
        p = mesh.shape[axis]
        r = mesh.index(axis)
        sq, skv = q.shape[-2], k.shape[-2]
        do = dout.to(q.dtype).contiguous()
        delta = torch.sum(dout.float() * out.float(), dim=-1)
        if flash:
            b = _flash.block_divisor(min(sq, skv))
            panel_bwd, bq, bkv = _flash.flash_attention_panel_bwd, b, b
        else:
            tile = _KV_TILE if skv % _KV_TILE == 0 else skv
            panel_bwd = _flash.flash_attention_panel_bwd_plain
            bq, bkv = sq, tile
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for i in range(p):
            if i < p - 1:
                pending = col.ring_send_recv([k_cur, v_cur], mesh, axis)
            owner = (r - i) % p
            dq_p, dk_p, dv_p = panel_bwd(
                q, k_cur, v_cur, do, lse, delta, r * sq, owner * skv,
                valid_len, causal=causal, scale=scale, bq=bq, bkv=bkv)
            dq = dq + dq_p
            # the accumulators ride the ring with their panels: after p
            # hops every panel's gradient sum is home
            if p > 1:
                dk, dv = col.finish(*col.ring_send_recv(
                    [dk + dk_p, dv + dv_p], mesh, axis, tag0=2))
            else:
                dk, dv = dk + dk_p, dv + dv_p
            if i < p - 1:
                k_cur, v_cur = col.finish(*pending)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def _ring_ranks(q, k, v, mesh, axis: str, valid_len: int, causal: bool,
                scale: float, flash: bool):
    """Logical (H, sp, d) in and out: cut this rank's panels, run the ring,
    gather the output panels."""
    qb, kb, vb = (col.Scatter.apply(t, mesh, axis, 1) for t in (q, k, v))
    out = _RingAttention.apply(qb, kb, vb, mesh, axis, valid_len, causal,
                               scale, flash)
    return col.Gather.apply(out, mesh, axis, 1)


def ring_attention(q, k, v, mesh=None, axis: str = ROWS, causal: bool = False,
                   scale: float | None = None, backend: str = "auto",
                   precision: str = "high"):
    """Exact attention; ``q``/``k``/``v`` ``(seq, d)``, ``(heads, seq, d)``
    or any leading batch dims, one shape. Sequences longer than ``_KV_TILE``
    are padded to tile multiples, and on the flash path to 1024 multiples
    above 1024 tokens (else 128), the JAX package's contract; ``valid_len``
    masks the pad exactly. ``precision="default"`` casts q/k/v to bfloat16
    for the products (softmax statistics and the accumulator stay f32);
    ``"high"`` keeps their dtype, with f32 products in IEEE f32. The output
    has q's dtype and shape."""
    if q.ndim < 2 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.ndim > 3:
        lead = q.shape[:-2]
        q2, k2, v2 = (x.reshape(-1, *x.shape[-2:]) for x in (q, k, v))
        out = ring_attention(q2, k2, v2, mesh, axis, causal, scale, backend,
                             precision)
        return out.reshape(*lead, *out.shape[-2:])
    if precision not in ("high", "default"):
        raise ValueError(f"unknown ring attention precision: {precision!r}")
    seq, d = q.shape[-2], q.shape[-1]
    flash = resolve_attention_backend(backend, q.device, d) == "flash"
    if mesh is None and distributed():
        mesh = default_mesh()
    ranks = mesh is not None and getattr(mesh, "ranks", None) is not None
    p_size = mesh.shape[axis] if ranks else 1
    if not ranks and mesh is not None and mesh.shape[axis] != 1:
        raise ValueError(f"a '{axis}' axis of {mesh.shape[axis]} devices "
                         f"needs a mesh over torch.distributed ranks "
                         f"(initialize_distributed, then create_mesh)")
    sp = pad_to_multiple(seq, p_size)
    if sp // p_size > _KV_TILE:
        sp = p_size * pad_to_multiple(sp // p_size, _KV_TILE)
    if flash:
        panel = sp // p_size
        sp = p_size * pad_to_multiple(panel, 1024 if panel > 1024 else 128)
    if sp != seq:
        q, k, v = (F.pad(x, (0, 0, 0, sp - seq)) for x in (q, k, v))
    out_dtype = q.dtype
    if precision == "default":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale_val = float(scale if scale is not None else 1.0 / math.sqrt(d))
    with precision_scope("highest"):
        if ranks:
            single = q.ndim == 2
            if single:
                q, k, v = (x.unsqueeze(0) for x in (q, k, v))
            out = _ring_ranks(q, k, v, mesh, axis, seq, causal, scale_val,
                              flash)
            if single:
                out = out[0]
        elif flash:
            out = _flash.FlashAttention.apply(q, k, v, seq, causal, scale_val)
        else:
            out = _xla_attention(q, k, v, seq, causal, scale_val)
    out = out.to(out_dtype)
    return out[..., :seq, :] if sp != seq else out
