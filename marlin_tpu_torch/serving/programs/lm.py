"""The LM decode path (paged or dense-slab) as the first BucketProgram.

Counterpart of ``marlin_tpu/serving/programs/lm.py``.

This is the extraction end of the refactor: the *policy* the engine's
``_submit`` used to hardcode for LM traffic — bucket rounding
(:func:`~marlin_tpu_torch.serving.batcher.pick_bucket`), page-unit admission
pricing (:func:`~marlin_tpu_torch.models.planner.request_pages` × page
bytes), the pool-capacity refusal, and the ProgramCosts keys
— now answers through the same :class:`~.base.BucketProgram` surface every
other program uses. The *mechanism* (chunked prefill, the decode step, KV
page bookkeeping) stays in the engine's paged loop: LM rows execute the
engine's own code path, which is what keeps greedy output equal to
``lm_generate`` — the acceptance bar for this seam. :meth:`PagedLMProgram.step` is therefore deliberately unreachable;
the freeze/adopt hooks are likewise the engine's KV-blob export, not ours.
"""

from __future__ import annotations

import threading

from ..batcher import bucket_kv_bytes, pick_bucket
from . import register_program
from .base import BucketProgram

__all__ = ["PagedLMProgram"]


@register_program
class PagedLMProgram(BucketProgram):
    """token prompt → generated tokens via the engine's paged/slab loops."""

    name = "lm"
    cost_program = "lm_decode_paged"
    resource_unit = ("actual KV pages x page bytes (paged) / "
                     "bucket slab bytes (slab)")

    def __init__(self, engine):
        # no super().__init__: LM's batch axis is the engine's max_batch,
        # not the serve_program_batches widths shared by one-shot programs
        self._eng = engine
        self._lock = threading.Lock()
        self.widths = (engine.max_batch,)
        self.width = engine.max_batch

    # ---------------------------------------------------------------- policy
    def buckets(self):
        return list(self._eng.buckets)

    def validate(self, request):
        if request.prompt is None:
            return "program 'lm' needs a token prompt"
        return None

    def pick_bucket(self, request):
        return pick_bucket(request.prompt.shape[0], request.steps,
                           self._eng.buckets)

    def refuse_no_bucket(self, request):
        return (f"no bucket fits prompt_len={request.prompt.shape[0]} "
                f"steps={request.steps} (buckets {list(self._eng.buckets)})")

    def admission_cost(self, request, bucket):
        eng = self._eng
        if not eng.paged:
            # a slab row holds the bucket's whole extent
            return bucket_kv_bytes(eng.params, eng.heads, bucket,
                                   eng.compute_dtype)
        # admission charges the request's ACTUAL pages (the memory its
        # cache rows can ever write — planner.request_pages), not the
        # bucket worst case: short requests in long buckets stop reserving
        # capacity they never use
        from ...models.planner import request_pages

        pages = request_pages(request.prompt.shape[0], request.steps,
                              eng._page_len)
        if pages > eng._num_pages - 1:
            raise ValueError(
                f"request needs {pages} KV pages but the pool holds "
                f"{eng._num_pages - 1} (serve_num_pages)")
        return pages * eng._page_bytes

    def program_key(self, bucket, width=None):
        return self._eng._prog_key(bucket)

    # ------------------------------------------------------------- mechanism
    def warmup(self) -> int:
        # ServeEngine.warmup drives the LM compiles directly (paged program
        # identity includes the live pool's slab shape)
        return 0

    def step(self, bucket, requests):  # pragma: no cover - engine-executed
        raise RuntimeError(
            "LM rows execute in the engine's paged/slab loops, not via "
            "BucketProgram.step")
