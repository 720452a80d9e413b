"""Fused paged decode-attention: read the KV page slab in place.

Counterpart of ``marlin_tpu/ops/paged_attention.py``. Its Pallas TPU kernel
becomes the CUDA kernels of ``csrc/paged_attention.cu`` (built and bound by
``ops/_build.py``), split-K over the context: the split kernel's blocks each
take one (row, kv head, chunk of query heads) and a run of the row's table
entries, read their pages through the block table (the context is never
gathered into a copy) and reduce them to an online-softmax state; a combine
kernel merges the splits' states. :func:`split_plan` sizes the splits from
shapes alone, so the wrapper never waits on the card.

Shapes follow the slab (:func:`~marlin_tpu_torch.models.transformer
.init_kv_pages`): K/V pages ``(num_pages, page_len, kv_heads, dh)``, queries
in the grouped decode form ``(B, kv_heads, group, dh)``. Numerics follow the
TPU kernel: f32 scores divided by ``sqrt(dh)``, positions ``>= lengths[b]``
at −1e30, lengths clamped to ``[1, W·page_len]``, online softmax, ``p`` cast
to q's dtype before ``p·v`` (at the running maximum of the warp that reads
the position, where the TPU kernel casts at its page-by-page one), f32
accumulators, the output in q's dtype. Dummy rows (all-zero tables) read
page 0.

The page-length rule. On the TPU, ``page_len`` must be a multiple of the
8-row sublane tile, because a page is one VMEM block. The CUDA kernel copies
a page position by position (each position's ``dh`` elements are
contiguous) and masks by position, so on Hopper any ``page_len >= 1`` is
legal: :data:`PAGE_MULTIPLE` is 1, and :func:`align_page_len`, the one place
that applies the rule, only validates.

:func:`paged_decode_attention` runs the kernels for CUDA tensors (raising on
a failed build or launch) and :func:`paged_decode_attention_plain` for CPU
tensors. ``paged_decode_attention.launches`` counts launches of the split
kernel (one per call), ``.combine_launches`` those of the combine kernel,
which follows it when the plan has more than one split. A lane of the
kernel holds ``dh / 32`` elements (rounded up to a power of two) of each
query head of its chunk, 64 values at most, so a chunk holds at most
``KERNEL_GROUP_DH // lane_dh(dh)`` heads, and never more than
:data:`KERNEL_GROUP_HEADS` (:func:`group_chunks`); the chunks of a wide group
are blocks of the same launch. Every query head attends on its own, so the
chunks give exactly the whole group's result.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .local import precision_scope

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "align_page_len", "paged_attention_cost", "group_chunks",
           "lane_dh", "split_plan", "PagedPlan", "PAGE_MULTIPLE",
           "KERNEL_GROUP_DH", "KERNEL_GROUP_HEADS"]

# pages are sized to a multiple of this many positions (module docstring)
PAGE_MULTIPLE = 1

# query heads x lane_dh(dh) one block of the kernel holds: 32 lanes x 64
# values, and at most 16 query heads, whose m and l a lane holds besides
# (csrc/paged_attention.cu: kMaxLaneValues, kMaxHeads)
KERNEL_GROUP_DH = 2048
KERNEL_GROUP_HEADS = 16
# the split plan (csrc/paged_attention.cu: kMaxSplitPages, kMaxRows)
MAX_SPLIT_PAGES = 1024
MAX_ROWS = 8
# splits are added while the grid has fewer than BLOCKS_PER_SM_FLOOR blocks an
# SM, up to BLOCKS_PER_SM_TARGET blocks an SM and MAX_OCC_SPLITS splits
BLOCKS_PER_SM_FLOOR, BLOCKS_PER_SM_TARGET, MAX_OCC_SPLITS = 2, 4, 64
# bytes of K and V in one run of a warp's ring
RUN_BYTES = 2048

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


def lane_dh(dh: int) -> int:
    """The elements of a head a warp's lanes hold: ``dh`` rounded up to 32
    times a power of two (each lane holds ``lane_dh(dh) // 32``)."""
    return 32 * (1 << max(0, math.ceil(dh / 32) - 1).bit_length())


def group_chunks(group: int, dh: int) -> list[slice]:
    """Slices of the group axis, each of at most
    ``min(KERNEL_GROUP_HEADS, KERNEL_GROUP_DH // lane_dh(dh))`` query heads:
    the query heads one block of the kernel takes. Raises for ``dh`` above
    :data:`KERNEL_GROUP_DH`, where not even one head fits."""
    if dh > KERNEL_GROUP_DH:
        raise ValueError(f"paged_decode_attention: dh = {dh} exceeds the "
                         f"kernel's {KERNEL_GROUP_DH}")
    step = min(KERNEL_GROUP_HEADS, KERNEL_GROUP_DH // lane_dh(dh))
    return [slice(g0, min(g0 + step, group)) for g0 in range(0, group, step)]


class PagedPlan(NamedTuple):
    """How the kernel cuts one call: ``splits`` splits of ``split_pages``
    table entries each (the last may be shorter), ``rows`` positions in a
    warp's run, the group in ``chunks`` chunks of ``chunk_heads`` query
    heads."""
    splits: int
    split_pages: int
    rows: int
    chunk_heads: int
    chunks: int


def split_plan(batch: int, kv_heads: int, group: int, dh: int,
               table_width: int, itemsize: int, sm_count: int) -> PagedPlan:
    """The split-K plan of one call, from shapes alone (never ``lengths``).

    The grid has one block per (row, kv head, chunk) and split. While those
    blocks without splits number fewer than 2 an SM, the table is split so
    the grid holds about 4 blocks an SM (at most 64 splits, never more than
    ``table_width``); otherwise there is one split, which writes the output
    itself. A split holds at most :data:`MAX_SPLIT_PAGES` table entries. A
    warp's run holds about :data:`RUN_BYTES` of K and V."""
    chunk_heads = min(group, KERNEL_GROUP_HEADS,
                      KERNEL_GROUP_DH // lane_dh(dh))
    chunks = -(-group // chunk_heads)
    items = batch * kv_heads * chunks
    if items >= BLOCKS_PER_SM_FLOOR * sm_count:
        splits = 1
    else:
        splits = min(table_width, -(-BLOCKS_PER_SM_TARGET * sm_count // items),
                     MAX_OCC_SPLITS)
    splits = max(splits, -(-table_width // MAX_SPLIT_PAGES))
    split_pages = -(-table_width // splits)
    splits = -(-table_width // split_pages)
    rows = max(1, min(MAX_ROWS, RUN_BYTES // (2 * dh * itemsize)))
    return PagedPlan(splits, split_pages, rows, chunk_heads, chunks)


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
    plan = split_plan(B, kvh, group, dh, W, q.element_size(),
                      _build.sm_count(q.device))
    tables = torch.as_tensor(tables, device=q.device).to(torch.int32)\
        .contiguous()
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)\
        .contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    # the splits' states: acc (dh), m, l per query head, in f32
    part = None if plan.splits == 1 else torch.empty(
        (B, kvh, plan.splits, group, dh + 2), dtype=torch.float32,
        device=q.device)
    vec = (dh * q.element_size()) % 16 == 0 and k_pages.data_ptr() % 16 == 0 \
        and v_pages.data_ptr() % 16 == 0
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_paged_attention(
            _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), B, kvh,
            group, dh, page_len, W, plan.split_pages, plan.splits,
            plan.chunk_heads, plan.rows, int(vec), _score_div(dh), stream)
    _build.check(lib, err, f"paged_decode_attention q {tuple(q.shape)} pages "
                           f"{tuple(k_pages.shape)} W {W} {plan}")
    paged_decode_attention.launches += 1
    paged_decode_attention.combine_launches += plan.splits > 1
    return out


paged_decode_attention.launches = 0
# launches of the combine kernel, which follows the split kernel's when the
# plan has more than one split
paged_decode_attention.combine_launches = 0
