"""Fused paged decode-attention: read the KV page slab in place.

Counterpart of ``marlin_tpu/ops/paged_attention.py``. Its Pallas TPU kernel
becomes the CUDA kernel ``csrc/paged_attention.cu`` (built and bound by
``ops/_build.py``): one block per (row, kv head) walks the row's pages through
the block table, so the context is never gathered into a copy.

Shapes follow the slab (:func:`~marlin_tpu_torch.models.transformer
.init_kv_pages`): K/V pages ``(num_pages, page_len, kv_heads, dh)``, queries
in the grouped decode form ``(B, kv_heads, group, dh)``. Numerics follow the
TPU kernel: f32 scores scaled by ``1/sqrt(dh)``, positions ``>= lengths[b]``
at −1e30, lengths clamped to ``[1, W·page_len]``, online softmax page by page,
``p`` cast to q's dtype before ``p·v``, an f32 accumulator, the output in q's
dtype. Dummy rows (all-zero tables) read page 0.

The page-length rule. On the TPU, ``page_len`` must be a multiple of the
8-row sublane tile, because a page is one VMEM block. The CUDA kernel reads a
page position by position (each position's ``dh`` elements are contiguous, so
the loads coalesce at any ``page_len``), stages it in shared memory and masks
by position, so on Hopper any ``page_len >= 1`` is legal: :data:`PAGE_MULTIPLE`
is 1, and :func:`align_page_len`, the one place that applies the rule, only
validates.

:func:`paged_decode_attention` runs the kernel for CUDA tensors (raising on a
failed build or launch) and :func:`paged_decode_attention_plain` for CPU
tensors. ``paged_decode_attention.launches`` counts kernel launches. A block
of the kernel holds ``group * dh <= 2048`` accumulators
(:data:`KERNEL_GROUP_DH`); a wider group is split into chunks of query heads
(:func:`group_chunks`), one launch each over the same pages. Every query head
attends on its own, so the chunks give exactly the whole group's result.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from .local import precision_scope

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "align_page_len", "paged_attention_cost", "group_chunks",
           "PAGE_MULTIPLE", "KERNEL_GROUP_DH"]

# pages are sized to a multiple of this many positions (module docstring)
PAGE_MULTIPLE = 1

# group * dh one block of the kernel holds (csrc/paged_attention.cu:
# kThreads * kMaxAcc)
KERNEL_GROUP_DH = 2048

_MASKED = -1e30  # the decode path's mask value; exp() of it underflows to 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def align_page_len(page_len: int) -> int:
    """Smallest page length ``>= page_len`` that is a multiple of
    :data:`PAGE_MULTIPLE` — the serving pool sizes its pages through here."""
    if page_len < 1:
        raise ValueError(f"page_len must be >= 1, got {page_len}")
    return -(-page_len // PAGE_MULTIPLE) * PAGE_MULTIPLE


def paged_attention_cost(batch: int, table_width: int, page_len: int,
                         kv_heads: int, group: int, dh: int,
                         itemsize: int = 4) -> dict:
    """Analytic cost of one call over full tables, in the keys of XLA's
    ``cost_analysis()``: FLOPs are the two (group·dh × page_len) contractions
    per (row, page, kv head); bytes one pass over each row's table extent of
    the slab plus q and the output."""
    t = batch * table_width * kv_heads
    flops = 2.0 * 2.0 * t * group * dh * page_len
    kv_bytes = 2.0 * t * page_len * dh * itemsize
    qo_bytes = 2.0 * batch * kv_heads * group * dh * itemsize
    return {"flops": flops, "bytes accessed": kv_bytes + qo_bytes}


def _check(q, k_pages, v_pages, tables) -> None:
    if q.ndim != 4:
        raise ValueError(f"q must be (B, kv_heads, group, dh), got "
                         f"{tuple(q.shape)}")
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError(f"k/v pages must share one (num_pages, page_len, "
                         f"kv_heads, dh) shape, got {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    if k_pages.shape[2] != q.shape[1] or k_pages.shape[3] != q.shape[3]:
        raise ValueError(f"page slab {tuple(k_pages.shape)} does not match "
                         f"query heads {tuple(q.shape)}")
    if tables.ndim != 2 or tables.shape[0] != q.shape[0]:
        raise ValueError(f"tables must be (B, W) with B={q.shape[0]}, got "
                         f"{tuple(tables.shape)}")
    if q.dtype != k_pages.dtype or q.dtype != v_pages.dtype:
        raise TypeError(f"q and the slab must share a dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")


def group_chunks(group: int, dh: int) -> list[slice]:
    """Slices of the group axis, each of at most ``KERNEL_GROUP_DH // dh``
    query heads: the kernel's launches for one call. Raises for ``dh``
    above :data:`KERNEL_GROUP_DH`, where not even one head fits."""
    if dh > KERNEL_GROUP_DH:
        raise ValueError(f"paged_decode_attention: dh = {dh} exceeds the "
                         f"kernel's {KERNEL_GROUP_DH}")
    step = KERNEL_GROUP_DH // dh
    return [slice(g0, min(g0 + step, group)) for g0 in range(0, group, step)]


def _score_div(dh: int) -> float:
    """``sqrt(dh)`` rounded to f32, the divisor the TPU kernel applies."""
    return float(np.float32(math.sqrt(dh)))


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths):
    """The plain version: the kernel's arithmetic in PyTorch, page by page
    (vectorised over rows, one gathered page per step)."""
    _check(q, k_pages, v_pages, tables)
    B, kvh, group, dh = q.shape
    page_len = k_pages.shape[1]
    W = tables.shape[1]
    tables = tables.to(device=q.device, dtype=torch.long)
    lengths = torch.as_tensor(lengths, device=q.device).long().clamp(
        1, W * page_len)
    div = _score_div(dh)
    qf = q.float()
    m = torch.full((B, kvh, group), _MASKED, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, kvh, group, dh), dtype=torch.float32,
                      device=q.device)
    t = torch.arange(page_len, device=q.device)
    with precision_scope("highest"):
        for w in range(W):
            k = k_pages[tables[:, w]].float()  # (B, page_len, kvh, dh)
            v = v_pages[tables[:, w]]
            s = torch.einsum("bkgd,btkd->bkgt", qf, k) / div
            live = (w * page_len + t)[None, :] < lengths[:, None]  # (B, T)
            s = torch.where(live[:, None, None, :], s, _MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(dim=-1)
            pv = torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype).float(),
                              v.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
    return (acc / l[..., None]).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths):
    """Decode attention for a batch of rows directly over the page slab.

    ``q`` is ``(B, kv_heads, group, dh)``, ``k_pages``/``v_pages`` the slab
    ``(num_pages, page_len, kv_heads, dh)``, ``tables`` ``(B, W)`` int block
    tables (dummy page 0 beyond a row's extent), ``lengths`` ``(B,)`` the live
    positions per row — ``pos + 1`` for a decode step whose K/V entry at
    ``pos`` is already written. Returns ``(B, kv_heads, group, dh)`` in q's
    dtype. CUDA tensors run the kernel (f32 or bf16), CPU tensors the plain
    version."""
    _check(q, k_pages, v_pages, tables)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, tables,
                                            lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
    B, kvh, group, dh = q.shape
    page_len = k_pages.shape[1]
    W = tables.shape[1]
    chunks = group_chunks(group, dh)
    tables = torch.as_tensor(tables, device=q.device).to(torch.int32)\
        .contiguous()
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)\
        .contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for sl in chunks:
            # a chunk's queries and output contiguous, as the kernel takes them
            qc = q[:, :, sl].contiguous()
            oc = out if len(chunks) == 1 else torch.empty_like(qc)
            err = lib.marlin_paged_attention(
                _DTYPES[q.dtype], qc.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                oc.data_ptr(), B, kvh, qc.shape[2], dh, page_len, W,
                _score_div(dh), stream)
            _build.check(lib, err, f"paged_decode_attention q "
                                   f"{tuple(qc.shape)} pages "
                                   f"{tuple(k_pages.shape)} W {W}")
            paged_decode_attention.launches += 1
            if oc is not out:
                out[:, :, sl] = oc
    return out


paged_decode_attention.launches = 0
