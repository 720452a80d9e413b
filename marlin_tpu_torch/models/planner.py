"""Serving memory arithmetic: KV page sizes and the device budget.

Counterpart of the serving half of ``marlin_tpu/models/planner.py``. The
training planner (``plan_context``, which compiles the training step against
a compile-only TPU topology) has no CUDA counterpart yet (ROADMAP).
"""

from __future__ import annotations

import torch

from ..config import resolve_device

__all__ = ["usable_hbm_bytes", "kv_page_bytes", "request_pages"]


def usable_hbm_bytes(device=None) -> int:
    """Device memory this process can still fill on ``device`` (default: the
    configured one): the free bytes CUDA reports (``torch.cuda.mem_get_info``)
    plus what PyTorch's caching allocator already holds, which it hands out
    again. Raises without CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"usable_hbm_bytes needs a CUDA device, got {dev}")
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free) + int(torch.cuda.memory_reserved(dev))


def kv_page_bytes(params: dict, heads: int, page_len: int,
                  compute_dtype=None) -> int:
    """Bytes of ONE KV page across every layer: layers x {k,v} x page_len x
    kv_heads x dh in the compute dtype — the paged admission unit."""
    from .transformer import _cdtype, _n_layers

    d = params["emb"].shape[1]
    dh = d // heads
    kv_dim = params["l0"]["wk"].shape[1]  # kv_heads * dh (GQA-aware)
    itemsize = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    return _n_layers(params) * 2 * page_len * (kv_dim // dh) * dh * itemsize


def request_pages(prompt_len: int, steps: int, page_len: int) -> int:
    """KV pages one request can ever write: cache positions run
    ``[0, prompt_len + steps - 1)`` (the final token is never decoded from),
    rounded up to whole pages — the admission charge and the allocation."""
    if prompt_len < 1 or steps < 1 or page_len < 1:
        raise ValueError(f"prompt_len/steps/page_len must be >= 1, got "
                         f"{(prompt_len, steps, page_len)}")
    return -(-(prompt_len + steps - 1) // page_len)
