"""Serving: the continuous-batching engine over the paged KV pool.

Counterpart of ``marlin_tpu/serving/``: :class:`ServeEngine` (the paged
path), the request contracts, the serving metrics, the BucketProgram seam
with the ALS, PageRank and classification programs, and the pool and bucket
helpers. The dense-slab control, cross-engine
migration and the supervisor, router and fleet are not ported yet (ROADMAP).

Quick start::

    from marlin_tpu_torch.serving import Request, ServeEngine

    with ServeEngine(params, heads=lm.heads) as eng:
        eng.warmup()                              # builds the kernels once
        h = eng.submit(Request(prompt=[1, 2, 3], steps=16))
        tokens = h.result(timeout=60).tokens
"""

from .batcher import (  # noqa: F401
    BatchFormer,
    bucket_kv_bytes,
    normalize_buckets,
    pick_bucket,
)
from .engine import ServeEngine  # noqa: F401
from .kvpool import (  # noqa: F401
    PagedGroup,
    PagedKVPool,
    PagePoolExhausted,
    auto_num_pages,
    warmup_paged,
)
from .metrics import ServeMetrics, percentile  # noqa: F401
from .programs import (  # noqa: F401
    PROGRAM_REGISTRY,
    ALSScoreProgram,
    BucketProgram,
    ClassifyProgram,
    PagedLMProgram,
    PageRankQueryProgram,
    ProgramRowSet,
    available_programs,
    register_program,
)
from .request import (  # noqa: F401
    STATUS_ERROR,
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTTING_DOWN,
    AdmissionQueue,
    Request,
    Result,
    ResultHandle,
)
