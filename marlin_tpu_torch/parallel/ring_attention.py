"""Ring attention: exact attention over a sequence, at world size 1.

Counterpart of ``marlin_tpu/parallel/ring_attention.py``. There the sequence
is sharded over a mesh axis and K/V panels rotate around the device ring;
every device keeps its Q rows, sees each panel once and carries the softmax
state ``(m, l, acc)`` across the panels. On one device the ring is the home
panel alone (the JAX package's ``p_size == 1`` branches), which is what this
module runs: a mesh axis larger than 1 raises, the rotation over
``torch.distributed`` waits (ROADMAP queue 1 item 12).

Backends:

- ``"flash"``: one flash panel through :class:`~marlin_tpu_torch.ops.
  flash_attention.FlashAttention` — the CUDA forward kernel, and the dK/dV
  and dQ kernels in the backward, over all heads in one launch each (the
  plain versions for CPU tensors).
- ``"xla"``: the JAX package's tiled formulation in plain PyTorch — the
  panel in ``_KV_TILE``-key tiles folded by :func:`softmax_tile_update`,
  with autograd through it, as JAX differentiates its XLA path.
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

from ..mesh import ROWS, pad_to_multiple
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope

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


def _world_of_one(mesh, axis: str, what: str) -> None:
    """Raise unless ``mesh`` (None: the default mesh, a world of one) has
    size 1 along ``axis``."""
    p_size = 1 if mesh is None else mesh.shape[axis]
    if p_size != 1:
        raise NotImplementedError(
            f"{what} over a '{axis}' axis of {p_size} devices needs "
            f"torch.distributed, which is not ported yet (ROADMAP queue 1 "
            f"item 12)")


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
    _world_of_one(mesh, axis, "ring attention")
    sp = seq
    if sp > _KV_TILE:
        sp = pad_to_multiple(sp, _KV_TILE)
    if flash:
        sp = pad_to_multiple(sp, 1024 if sp > 1024 else 128)
    if sp != seq:
        q, k, v = (F.pad(x, (0, 0, 0, sp - seq)) for x in (q, k, v))
    out_dtype = q.dtype
    if precision == "default":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale_val = float(scale if scale is not None else 1.0 / math.sqrt(d))
    with precision_scope("highest"):
        if flash:
            out = _flash.FlashAttention.apply(q, k, v, seq, causal, scale_val)
        else:
            out = _xla_attention(q, k, v, seq, causal, scale_val)
    out = out.to(out_dtype)
    return out[..., :seq, :] if sp != seq else out
