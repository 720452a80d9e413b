"""Flash attention forward: one online-softmax panel with carried state.

Counterpart of the forward half of ``marlin_tpu/ops/flash_attention.py``. Its
Pallas TPU panel kernel becomes the CUDA kernel ``csrc/flash_attention.cu``
(built and bound by ``ops/_build.py``): score tiles stay in shared memory and
registers, the running max ``m``, denominator ``l`` and f32 accumulator are
carried across the kv tiles, and tiles with no live entry (past
``valid_len``, or wholly above the causal diagonal) are never visited.

The panel contract is the JAX package's: ``q`` ``(sq, d)`` against a K/V panel
``(skv, d)``, state ``m``/``l`` ``(sq,)`` f32 and ``acc`` ``(sq, d)`` f32,
global offsets ``q_offset``/``k_offset`` of row and key 0, and ``valid_len``
(keys at or past it are masked); the caller divides ``acc / l`` after its
last panel. Here a leading heads axis is accepted as well — ``q`` ``(H, sq,
d)``, ``m`` ``(H, sq)`` — and one kernel launch covers all heads (the JAX
callers ``vmap`` over heads). ``m``/``l`` stay 1-D per head: the TPU's packed
``(sq//128, 128)`` form exists only for its (8, 128) tiling.

f32 inputs are multiplied in IEEE f32 on both versions (the TPU kernel pins
``Precision.HIGHEST``; TF32 is never used). The backward kernels wait for the
training slice.

:func:`flash_attention_panel` runs the kernel for CUDA tensors (raising on a
failed build or launch) and :func:`flash_attention_panel_plain` for CPU
tensors. ``flash_attention_panel.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .local import precision_scope

__all__ = ["flash_attention_panel", "flash_attention_panel_plain",
           "flash_attention_single_panel", "flash_attention_single_panel_plain",
           "block_divisor"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_divisor(n: int, cap: int | None = None) -> int:
    """The block policy of the JAX package, kept for its callers' padding
    contract: panels longer than 1024 are padded to 1024 multiples and use
    1024 blocks, shorter ones one whole-panel block; with ``cap``, the largest
    power-of-two divisor of ``n`` not above it.

    On Hopper the number has no meaning for the kernel, which tiles itself
    (64 × 64) and masks ragged edges; it sets the tiling of the plain version
    and thus where the plain version's online softmax rescales."""
    if cap is None:
        if n % 1024 == 0:
            return 1024
        if n % 128 == 0 and n <= 1024:
            return n
        cap = 1024
    b = 1
    while b < cap and n % (b * 2) == 0:
        b *= 2
    return b


def _as_heads(q, k, v, m, l, acc):
    """The panel's tensors with a leading heads axis, and whether the caller
    passed the single-head form."""
    single = q.ndim == 2
    if single:
        q, k, v, m, l, acc = (t.unsqueeze(0) for t in (q, k, v, m, l, acc))
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (H, sq, d) and k/v (H, skv, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H, sq, d = q.shape
    if k.shape[0] != H or k.shape[2] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if m.shape != (H, sq) or l.shape != (H, sq) or acc.shape != (H, sq, d):
        raise ValueError(f"state shapes m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}, acc {tuple(acc.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    return single, q, k, v, m, l, acc


def flash_attention_panel_plain(q, k, v, m, l, acc, q_offset, k_offset,
                                valid_len, *, causal: bool, scale: float,
                                bq: int = 1024, bkv: int = 1024):
    """The plain version: the TPU kernel's schedule in PyTorch, tiled over
    ``bq`` query rows and ``bkv`` keys (so a 16k panel never holds a whole
    score matrix), with the same block skip and masking."""
    single, q, k, v, m, l, acc = _as_heads(q, k, v, m, l, acc)
    H, sq, d = q.shape
    skv = k.shape[1]
    bq, bkv = max(1, min(bq, sq)), max(1, min(bkv, skv))
    q_offset, k_offset, valid_len = int(q_offset), int(k_offset), int(valid_len)
    m_out, l_out = m.float().clone(), l.float().clone()
    acc_out = acc.float().clone()
    dev = q.device
    with precision_scope("highest"):
        for i0 in range(0, sq, bq):
            qb = q[:, i0:i0 + bq].float()
            nq = qb.shape[1]
            q_start = q_offset + i0
            qpos = q_start + torch.arange(nq, device=dev)
            mb, lb = m_out[:, i0:i0 + nq], l_out[:, i0:i0 + nq]
            ab = acc_out[:, i0:i0 + nq]
            for j0 in range(0, skv, bkv):
                k_start = k_offset + j0
                if k_start >= valid_len or (causal and
                                            q_start + nq - 1 < k_start):
                    continue
                kb = k[:, j0:j0 + bkv].float()
                vb = v[:, j0:j0 + bkv]
                s = torch.matmul(qb, kb.transpose(1, 2)) * scale
                kpos = k_start + torch.arange(kb.shape[1], device=dev)
                keep = (kpos < valid_len)[None, :]
                if causal:
                    keep = keep & (qpos[:, None] >= kpos[None, :])
                s = torch.where(keep, s, _NEG)
                m_new = torch.maximum(mb, s.amax(dim=-1))
                alpha = torch.exp(mb - m_new)
                p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
                lb = lb * alpha + p.sum(dim=-1)
                pv = torch.matmul(p.to(v.dtype).float(), vb.float())
                ab = ab * alpha[..., None] + pv
                mb = m_new
            m_out[:, i0:i0 + nq], l_out[:, i0:i0 + nq] = mb, lb
            acc_out[:, i0:i0 + nq] = ab
    if single:
        return m_out[0], l_out[0], acc_out[0]
    return m_out, l_out, acc_out


def flash_attention_panel(q, k, v, m, l, acc, q_offset, k_offset, valid_len,
                          *, causal: bool, scale: float, bq: int = 1024,
                          bkv: int = 1024):
    """One flash pass of queries ``q`` against a K/V panel, updating the
    running state; returns the new ``(m, l, acc)`` (module docstring). CUDA
    tensors run the kernel, whose tiles are its own (``bq``/``bkv`` are read
    by the plain version only); CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attention_panel_plain(
            q, k, v, m, l, acc, q_offset, k_offset, valid_len, causal=causal,
            scale=scale, bq=bq, bkv=bkv)
    single, q, k, v, m, l, acc = _as_heads(q, k, v, m, l, acc)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_panel: unsupported device "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_panel: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    H, sq, d = q.shape
    skv = k.shape[1]
    if d > 128:
        raise ValueError(f"flash_attention_panel: head dim {d} exceeds the "
                         f"kernel's 128")
    for name, t in (("k", k), ("v", v), ("m", m), ("l", l), ("acc", acc)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_panel: {name} on {t.device}, "
                             f"q on {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    m, l, acc = (t.float().contiguous() for t in (m, l, acc))
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
            l_out.data_ptr(), acc_out.data_ptr(), H, sq, skv, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), int(q_offset), int(k_offset), int(valid_len),
            int(bool(causal)), float(scale), stream)
    _build.check(lib, err, f"flash_attention_panel q {tuple(q.shape)} "
                           f"kv {tuple(k.shape)}")
    flash_attention_panel.launches += 1
    if single:
        return m_out[0], l_out[0], acc_out[0]
    return m_out, l_out, acc_out


flash_attention_panel.launches = 0


def _single_panel(panel, q, k, v, valid_len, causal, scale):
    seq = q.shape[-2]
    b = block_divisor(seq)
    lead = q.shape[:-1]
    m = torch.full(lead, _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(lead, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m, l, acc = panel(q, k, v, m, l, acc, 0, 0, valid_len, causal=causal,
                      scale=scale, bq=b, bkv=b)
    lf = torch.clamp(l, min=1e-30)
    return acc / lf[..., None], m + torch.log(lf)


def flash_attention_single_panel(q, k, v, valid_len, *, causal: bool,
                                 scale: float):
    """Full-sequence attention as ONE panel: initialise ``(m, l, acc)``, one
    :func:`flash_attention_panel` pass over all keys, normalise with the
    1e-30 floor on ``l``. Returns ``(out, lse)``: ``out`` f32 in q's shape
    (``(seq, d)`` or ``(H, seq, d)``), ``lse = m + log l`` per row."""
    return _single_panel(flash_attention_panel, q, k, v, valid_len, causal,
                         scale)


def flash_attention_single_panel_plain(q, k, v, valid_len, *, causal: bool,
                                       scale: float):
    """:func:`flash_attention_single_panel` through the plain panel, on any
    device — the reference the card's runs are held against."""
    return _single_panel(flash_attention_panel_plain, q, k, v, valid_len,
                         causal, scale)
