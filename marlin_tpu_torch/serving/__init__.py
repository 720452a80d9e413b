"""Serving: the continuous-batching engine over the paged KV pool, and the
fleet around it.

Counterpart of ``marlin_tpu/serving/``: :class:`ServeEngine` (the paged
path, with cross-engine migration through the MGRT blob and declared
SLOs), the request contracts, the serving metrics, the BucketProgram seam
with the ALS, PageRank and classification programs, the pool and bucket
helpers, supervised worker recovery (:class:`Supervisor`), the
multi-replica :class:`Router` with failover, rolling restarts and elastic
membership, and the SLO-burn-driven :class:`FleetController`. The
dense-slab control is not ported yet (ROADMAP).

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
from .engine import MigrationError, ServeEngine  # noqa: F401
from .kvpool import (  # noqa: F401
    MigrationCorruptError,
    PagedGroup,
    PagedKVPool,
    PagePoolExhausted,
    auto_num_pages,
    warmup_paged,
)
from .fleet import FleetController  # noqa: F401
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
from .router import Router  # noqa: F401
from .supervisor import Supervisor  # noqa: F401
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
