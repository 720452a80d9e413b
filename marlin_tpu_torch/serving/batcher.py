"""Shape buckets: the jax-free helpers of ``marlin_tpu/serving/batcher.py``.

A bucket is a ``(P_bucket, steps_bucket)`` pair: a request pads its prompt up
to the smallest fitting ``P_bucket``, and the bucket sizes its cache extent.
The claim queues (``BatchFormer``), the dense-slab ``SlotPool`` and the warmup
and AOT helpers come with the engine slice.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

__all__ = ["normalize_buckets", "pick_bucket", "bucket_kv_bytes"]

Bucket = tuple[int, int]  # (P_bucket, steps_bucket)


def normalize_buckets(buckets: Iterable[Sequence[int]]) -> tuple[Bucket, ...]:
    """Validate and sort a bucket set ascending by (P, steps) — the order
    :func:`pick_bucket` scans, so the smallest fitting bucket is hit first."""
    out = []
    for b in buckets:
        p, s = int(b[0]), int(b[1])
        if p < 1 or s < 1:
            raise ValueError(f"bucket dims must be >= 1, got {(p, s)}")
        out.append((p, s))
    if not out:
        raise ValueError("at least one (P, steps) bucket is required")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate buckets in {out}")
    return tuple(sorted(out))


def pick_bucket(prompt_len: int, steps: int,
                buckets: Sequence[Bucket]) -> Bucket | None:
    """The smallest bucket holding a ``prompt_len``-token prompt generating
    ``steps`` tokens, or None when nothing fits (an admission rejection)."""
    for p, s in buckets:
        if prompt_len <= p and steps <= s:
            return (p, s)
    return None


def bucket_kv_bytes(params: dict, heads: int, bucket: Bucket,
                    compute_dtype=None, batch: int = 1) -> int:
    """KV-cache bytes of one bucket row (times ``batch``): layers x 2 x
    (P + steps) x kv_heads x dh in the compute dtype."""
    from ..models.transformer import _cdtype, _n_layers

    p, s = bucket
    d = params["emb"].shape[1]
    dh = d // heads
    kv_dim = params["l0"]["wk"].shape[1]  # kv_heads * dh (GQA-aware)
    itemsize = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    return _n_layers(params) * 2 * (p + s) * (kv_dim // dh) * dh \
        * itemsize * batch
