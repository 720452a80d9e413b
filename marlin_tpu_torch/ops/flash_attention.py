"""Flash attention: one online-softmax panel with carried state, and its
two-pass recompute backward.

Counterpart of ``marlin_tpu/ops/flash_attention.py``. Its Pallas TPU panel
kernel becomes the CUDA kernel ``csrc/flash_attention.cu`` and its two
backward kernels ``csrc/flash_attention_bwd.cu`` (built and bound by
``ops/_build.py``). Forward: score tiles stay in shared memory and registers,
the running max ``m``, denominator ``l`` and f32 accumulator are carried
across the kv tiles, and tiles with no live entry (past ``valid_len``, or
wholly above the causal diagonal) are never visited. Backward
(:func:`flash_attention_panel_bwd`): probabilities are rebuilt per tile from
the forward's ``lse`` rows and ``delta = rowsum(dO·O)``, so no score matrix is
saved; one kernel gives f32 ``dk``/``dv`` with the kv tile outer, the other
f32 ``dq`` with the q tile outer. :class:`FlashAttention` is the autograd
function over :func:`flash_attention_single_panel` that ring and Ulysses
attention train through.

The panel contract is the JAX package's: ``q`` ``(sq, d)`` against a K/V panel
``(skv, d)``, state ``m``/``l`` ``(sq,)`` f32 and ``acc`` ``(sq, d)`` f32,
global offsets ``q_offset``/``k_offset`` of row and key 0, and ``valid_len``
(keys at or past it are masked); the caller divides ``acc / l`` after its
last panel. Here a leading heads axis is accepted as well — ``q`` ``(H, sq,
d)``, ``m`` ``(H, sq)`` — and one kernel launch covers all heads (the JAX
callers ``vmap`` over heads). ``m``/``l`` stay 1-D per head: the TPU's packed
``(sq//128, 128)`` form exists only for its (8, 128) tiling.

f32 inputs keep f32 accuracy everywhere (the TPU kernels pin
``Precision.HIGHEST``): the forward kernel and the plain versions multiply in
IEEE f32, the backward kernels on the tensor cores in three TF32 passes (a
single TF32 pass would be ~1e-3 off); bf16 inputs run bf16 products. ``p``
and ``ds`` are rounded to the input type before their products, as the TPU
kernels cast them down.

:func:`flash_attention_panel` runs the kernel for CUDA tensors (raising on a
failed build or launch) and :func:`flash_attention_panel_plain` for CPU
tensors; :func:`flash_attention_panel_bwd` likewise runs
:func:`flash_attention_bwd_dkv` and :func:`flash_attention_bwd_dq` or
:func:`flash_attention_panel_bwd_plain`. Each kernel wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import torch

from . import _build
from .local import precision_scope

__all__ = ["flash_attention_panel", "flash_attention_panel_plain",
           "flash_attention_single_panel", "flash_attention_single_panel_plain",
           "flash_attention_panel_bwd", "flash_attention_panel_bwd_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "FlashAttention", "block_divisor"]

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


def _as_heads(q, k, v, rows: dict, like_q: dict):
    """``q``, ``k``, ``v``, the per-row tensors ``rows`` (name: ``(sq,)``
    tensor — the state ``m``/``l``, or the backward's ``lse``/``delta``) and
    the q-shaped ``like_q`` (``acc``, or ``do``) with a leading heads axis,
    their shapes checked and q, k, v of one dtype; first, whether the caller
    passed the single-head form. Returns ``(single, q, k, v, *rows,
    *like_q)``."""
    rest = [*rows.values(), *like_q.values()]
    single = q.ndim == 2
    if single:
        q, k, v, *rest = (t.unsqueeze(0) for t in (q, k, v, *rest))
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (H, sq, d) and k/v (H, skv, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H, sq, d = q.shape
    if k.shape[0] != H or k.shape[2] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    want = [(H, sq)] * len(rows) + [q.shape] * len(like_q)
    for name, t, shape in zip([*rows, *like_q], rest, want):
        if t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}: want {tuple(shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    return (single, q, k, v, *rest)


def _check_kernel(name: str, q, **others) -> None:
    """Raise unless the kernel behind ``name`` takes ``q`` and ``others``:
    all on one CUDA device, q float32 or bfloat16, head dim at most 128."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] > 128:
        raise ValueError(f"{name}: head dim {q.shape[-1]} exceeds the "
                         f"kernel's 128")
    for other, t in others.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {other} on {t.device}, q on "
                             f"{q.device}")


def flash_attention_panel_plain(q, k, v, m, l, acc, q_offset, k_offset,
                                valid_len, *, causal: bool, scale: float,
                                bq: int = 1024, bkv: int = 1024):
    """The plain version: the TPU kernel's schedule in PyTorch, tiled over
    ``bq`` query rows and ``bkv`` keys (so a 16k panel never holds a whole
    score matrix), with the same block skip and masking."""
    single, q, k, v, m, l, acc = _as_heads(q, k, v, dict(m=m, l=l),
                                           dict(acc=acc))
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
    single, q, k, v, m, l, acc = _as_heads(q, k, v, dict(m=m, l=l),
                                           dict(acc=acc))
    _check_kernel("flash_attention_panel", q, k=k, v=v, m=m, l=l, acc=acc)
    H, sq, d = q.shape
    skv = k.shape[1]
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


# ------------------------------------------------------------------ backward


def _bwd_as_heads(q, k, v, do, lse, delta):
    """:func:`_as_heads` for the backward's tensors, with ``do`` of q's
    dtype. Returns ``(single, q, k, v, do, lse, delta)``."""
    single, q, k, v, lse, delta, do = _as_heads(
        q, k, v, dict(lse=lse, delta=delta), dict(do=do))
    if do.dtype != q.dtype:
        raise TypeError(f"do must have q's dtype {q.dtype}, got {do.dtype}")
    return single, q, k, v, do, lse, delta


def _bwd_plain(q, k, v, do, lse, delta, q_offset, k_offset, valid_len,
               causal, scale, bq, bkv):
    """The TPU backward's schedule in PyTorch over (H, ., d) tensors: the
    block skip of ``_bwd_block_live`` and the p/ds core of ``_bwd_p_ds``, with
    p and ds rounded to the input dtype before each product. Returns f32
    ``(dq, dk, dv)``."""
    H, sq, d = q.shape
    skv = k.shape[1]
    bq, bkv = max(1, min(bq, sq)), max(1, min(bkv, skv))
    q_offset, k_offset, valid_len = int(q_offset), int(k_offset), int(valid_len)
    dt, dev = q.dtype, q.device
    dq = torch.zeros((H, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((H, skv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    lse, delta = lse.float(), delta.float()
    with precision_scope("highest"):
        for i0 in range(0, sq, bq):
            qb = q[:, i0:i0 + bq].float()
            nq = qb.shape[1]
            dob = do[:, i0:i0 + nq].float()
            q_start = q_offset + i0
            qpos = q_start + torch.arange(nq, device=dev)
            lb = lse[:, i0:i0 + nq, None]
            db = delta[:, i0:i0 + nq, None]
            for j0 in range(0, skv, bkv):
                k_start = k_offset + j0
                if k_start >= valid_len or (causal and
                                            q_start + nq - 1 < k_start):
                    continue
                kb = k[:, j0:j0 + bkv].float()
                vb = v[:, j0:j0 + bkv].float()
                nk = kb.shape[1]
                s = torch.matmul(qb, kb.transpose(1, 2)) * scale
                kpos = k_start + torch.arange(nk, device=dev)
                keep = (kpos < valid_len)[None, :]
                if causal:
                    keep = keep & (qpos[:, None] >= kpos[None, :])
                p = torch.where(keep, torch.exp(s - lb), 0.0)
                ds = p * (torch.matmul(dob, vb.transpose(1, 2)) - db)
                ds_t = ds.to(dt).float()
                dv[:, j0:j0 + nk] += torch.matmul(
                    p.to(dt).float().transpose(1, 2), dob)
                dk[:, j0:j0 + nk] += torch.matmul(
                    ds_t.transpose(1, 2), qb) * scale
                dq[:, i0:i0 + nq] += torch.matmul(ds_t, kb) * scale
    return dq, dk, dv


def flash_attention_panel_bwd_plain(q, k, v, do, lse, delta, q_offset,
                                    k_offset, valid_len, *, causal: bool,
                                    scale: float, bq: int = 1024,
                                    bkv: int = 1024):
    """The plain version of :func:`flash_attention_panel_bwd`, tiled over
    ``bq`` query rows and ``bkv`` keys, on any device."""
    single, q, k, v, do, lse, delta = _bwd_as_heads(q, k, v, do, lse, delta)
    dq, dk, dv = _bwd_plain(q, k, v, do, lse, delta, q_offset, k_offset,
                            valid_len, causal, scale, bq, bkv)
    if single:
        return dq[0], dk[0], dv[0]
    return dq, dk, dv


def _bwd_launch(name, symbol, outs_like, q, k, v, do, lse, delta, q_offset,
                k_offset, valid_len, causal, scale):
    """Check the backward's inputs for the kernels (any device but CUDA
    raises), launch ``symbol`` and return its f32 outputs, one shaped like
    each input named in ``outs_like``; raises on a refused launch."""
    single, q, k, v, do, lse, delta = _bwd_as_heads(q, k, v, do, lse, delta)
    _check_kernel(name, q, k=k, v=v, do=do, lse=lse, delta=delta)
    H, sq, d = q.shape
    skv = k.shape[1]
    like = dict(q=q, k=k, v=v)
    outs = [torch.empty(like[n].shape, dtype=torch.float32, device=q.device)
            for n in outs_like]
    q, k, v, do = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v, do))
    lse, delta = (t.float().contiguous() for t in (lse, delta))
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(o.data_ptr() for o in outs), H, sq, skv, d, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1), int(q_offset), int(k_offset),
            int(valid_len), int(bool(causal)), float(scale), stream)
    _build.check(lib, err, f"{name} q {tuple(q.shape)} kv {tuple(k.shape)}")
    return [o[0] for o in outs] if single else outs


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, q_offset, k_offset,
                            valid_len, *, causal: bool, scale: float):
    """f32 ``(dk, dv)`` of one panel from the dK/dV kernel; CUDA tensors
    only (:func:`flash_attention_panel_bwd` runs the plain version for CPU
    ones)."""
    dk, dv = _bwd_launch("flash_attention_bwd_dkv", "marlin_flash_bwd_dkv",
                         "kv", q, k, v, do, lse, delta, q_offset, k_offset,
                         valid_len, causal, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, q_offset, k_offset,
                           valid_len, *, causal: bool, scale: float):
    """f32 ``dq`` of one panel from the dQ kernel; CUDA tensors only."""
    dq, = _bwd_launch("flash_attention_bwd_dq", "marlin_flash_bwd_dq", "q",
                      q, k, v, do, lse, delta, q_offset, k_offset, valid_len,
                      causal, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_panel_bwd(q, k, v, do, lse, delta, q_offset, k_offset,
                              valid_len, *, causal: bool, scale: float,
                              bq: int = 1024, bkv: int = 1024):
    """Backward of one flash panel, the two-pass recompute schedule: ``p`` is
    rebuilt per tile from ``lse`` (= m + log l of the forward) and ``delta``
    (= rowsum(dO·O)), both ``(sq,)`` — or ``(H, sq)`` with a leading heads
    axis on q, k, v and ``do``, covered by one launch of each kernel. Returns
    f32 ``(dq, dk, dv)`` for this panel. CUDA tensors run the dK/dV and dQ
    kernels (``bq``/``bkv`` are read by the plain version only; the TPU's
    halving of ``bkv`` at 1024 fits its 16 MB of VMEM and has no meaning
    here); CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attention_panel_bwd_plain(
            q, k, v, do, lse, delta, q_offset, k_offset, valid_len,
            causal=causal, scale=scale, bq=bq, bkv=bkv)
    kw = dict(causal=causal, scale=scale)
    args = (q, k, v, do, lse, delta, q_offset, k_offset, valid_len)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    return flash_attention_bwd_dq(*args, **kw), dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention over one whole panel through the flash forward, with the
    recompute backward: the custom VJP of the JAX package's ring and Ulysses
    attention at world size 1 (``parallel/ring_attention.py:296-311``,
    ``parallel/ulysses.py:50-78``).

    ``FlashAttention.apply(q, k, v, valid_len, causal, scale)`` takes ``(seq,
    d)`` or ``(H, seq, d)`` tensors and returns the output in q's dtype. The
    forward saves ``(q, k, v, out, lse)``; the backward forms ``delta =
    rowsum(dO·out)`` in f32, runs :func:`flash_attention_panel_bwd` and casts
    the f32 grads to the inputs' dtypes. Both kernels are looked up in this
    module at call time, so a check can swap in the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len, causal, scale):
        out, lse = flash_attention_single_panel(q, k, v, valid_len,
                                                causal=causal, scale=scale)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (int(valid_len), bool(causal), float(scale))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        valid_len, causal, scale = ctx.meta
        delta = torch.sum(dout.float() * out.float(), dim=-1)
        b = block_divisor(q.shape[-2])
        dq, dk, dv = flash_attention_panel_bwd(
            q, k, v, dout.to(q.dtype), lse, delta, 0, 0, valid_len,
            causal=causal, scale=scale, bq=b, bkv=b)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)
