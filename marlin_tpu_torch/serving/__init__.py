"""Serving: the paged KV pool and the bucket helpers it needs. The engine's
request loop (``ServeEngine``), obs and resilience come with a later slice."""

from .batcher import bucket_kv_bytes, normalize_buckets, pick_bucket  # noqa: F401
from .kvpool import (  # noqa: F401
    PagedGroup,
    PagedKVPool,
    PagePoolExhausted,
    auto_num_pages,
    warmup_paged,
)
