"""BucketProgram — the program-shaped seam in the serving engine.

Counterpart of ``marlin_tpu/serving/programs/base.py``. Model buffers are
counted as torch tensors (``_ledger_register``), and a program's cost
record is an analytic ``{"flops", "bytes accessed"}`` dict
(``_capture_cost``): the port has no compiler to ask.

The engine's production spine (AdmissionQueue backpressure, static-bucket
batch forming, the single worker thread, supervisor retry, freeze/adopt
migration, the ``serve`` event stream) was built for paged LM decode but is
not LM-specific: what the spine actually needs from a workload is a handful
of *policy* answers — which static bucket does this request round up to,
what does it cost the admission budget, what's the compiled-program key for
ProgramCosts — plus one *mechanism*: execute a padded batch of rows. A
:class:`BucketProgram` is exactly that contract. The paged-LM path is the
first implementation (:mod:`.lm`); other workloads ride the same spine as
additional request types keyed by ``Request.program``.

Resource-unit contract: ``admission_cost`` is charged against the engine's
one AdmissionQueue HBM budget, so every program prices requests in *bytes
of device residency the request adds while in flight* — KV pages for LM,
one padded score row for ALS/PageRank, one feature row for classification.
Heterogeneous traffic then shares a single honest budget instead of
per-program quotas that fragment it.

Non-LM programs here are **one-shot**: a request is admitted, parked in a
host-side :class:`ProgramRowSet` (the non-KV analog of a paged pool), and
answered by the next batched device call for its bucket. One step retires
the whole batch, which is what makes drain/close, crash recovery, and
freeze/adopt migration compose for free — a live program row is
indistinguishable from a queued one up to its ``queue_s`` clock, so the
engine can always fall back to re-queueing the entry (exactly-once is the
handle's job, not the row's).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

from ...config import get_config
from ...obs import perf

__all__ = ["BucketProgram", "ProgramRowSet"]


class ProgramRowSet:
    """Host-side row parking for one program bucket — the structural twin of
    a paged pool (``entries`` + ``occupied_slots``/``live_slots``/
    ``free_slots``) with no device state, so the engine's crash handler,
    recovery sweep, and freeze path iterate it with the same code that walks
    KV pools."""

    def __init__(self, bucket, width: int):
        self.bucket = bucket
        self.width = int(width)
        self.entries: list[Any] = [None] * self.width

    def occupied_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is not None]

    # the engine's row-level walkers ask for live_slots(); every occupied
    # program row is live (one-shot programs have no prefill phase)
    live_slots = occupied_slots

    def free_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is None]

    def assign(self, slot: int, entry) -> None:
        assert self.entries[slot] is None, f"slot {slot} occupied"
        self.entries[slot] = entry

    def release(self, slot: int) -> None:
        self.entries[slot] = None


class BucketProgram:
    """One servable workload: policy (buckets, admission cost, program keys)
    plus the batched step that answers requests.

    Lifecycle (the engine drives every arrow)::

        submit ──► validate ──► pick_bucket ──► admission_cost ──► queue
                                                      │ reject/expire
        queue ──► admit (ProgramRowSet slot / KV claim) ──► step ──► Result
                                                      │ crash/freeze
        freeze ──► (state blob | fallback requeue) ──► adopt on the target

    Subclasses implement the policy surface (:meth:`pick_bucket`,
    :meth:`admission_cost`, :meth:`program_key`, :meth:`warmup`,
    :meth:`step`) and may override :meth:`validate`, :meth:`freeze`, and
    :meth:`adopt`. ``name`` keys the registry and ``Request.program``;
    ``cost_program`` names the ProgramCosts family the step timings land
    in; ``resource_unit`` documents what ``admission_cost`` bytes mean.

    Batch widths are the static shape axis shared by all programs: the
    ``serve_program_batches`` config knob lists the padded widths, a step
    pads its live rows up to the smallest fitting width, and compiles are
    bounded by ``len(widths) x len(buckets())`` per program."""

    name: str = ""
    cost_program: str = ""
    resource_unit: str = "bytes resident per in-flight request"

    def __init__(self):
        cfg = get_config()
        widths = tuple(sorted({int(w) for w in cfg.serve_program_batches}))
        if not widths or widths[0] < 1:
            raise ValueError(
                f"serve_program_batches must be positive ints, got "
                f"{cfg.serve_program_batches!r}")
        self.widths = widths
        #: row capacity of one ProgramRowSet (the largest padded width)
        self.width = widths[-1]
        # guards hot model swaps against the worker thread's step reads
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- policy
    def buckets(self) -> Sequence[tuple]:
        """The static program-bucket tuples this program compiles for."""
        raise NotImplementedError

    def validate(self, request) -> str | None:
        """Synchronous payload check at submit; a string rejects the
        request with that reason, None admits it to bucket selection."""
        return None

    def pick_bucket(self, request) -> tuple | None:
        """Smallest program bucket that fits the request, or None (the
        engine refuses with :meth:`refuse_no_bucket`'s message)."""
        raise NotImplementedError

    def refuse_no_bucket(self, request) -> str:
        return (f"no bucket fits program={self.name!r} request "
                f"(buckets {list(self.buckets())})")

    def admission_cost(self, request, bucket) -> int:
        """Bytes of device residency this request adds while in flight —
        charged against the engine's single AdmissionQueue HBM budget."""
        raise NotImplementedError

    def program_key(self, bucket, width: int | None = None) -> str:
        """ProgramCosts key for one compiled (bucket, width) variant."""
        raise NotImplementedError

    def step_width(self, live: int) -> int:
        """Smallest configured padded width covering ``live`` rows."""
        for w in self.widths:
            if w >= live:
                return w
        return self.width

    # ------------------------------------------------------------- mechanism
    def warmup(self) -> int:
        """Compile every (bucket, width) variant ahead of traffic and land
        its cost record in ProgramCosts; returns the variant count."""
        raise NotImplementedError

    def step(self, bucket, requests) -> list:
        """Answer one padded batch: ``requests`` are the live rows of one
        program bucket (len ≤ ``width``); returns one host-side result
        value per request, in order. Must route through a compiled
        program cached per (bucket, padded width)."""
        raise NotImplementedError

    # ------------------------------------------------------------- migration
    def freeze(self, entry) -> Any:
        """Export device state for one live row at freeze time. None (the
        default) means the row has no exportable state — the engine
        re-queues it through the migration ``fallback`` lane and the
        target simply re-executes it (safe: the handle, not the row,
        guarantees exactly-once)."""
        return None

    def adopt(self, entry, state=None) -> None:
        """Import a row frozen by :meth:`freeze` on the source engine.
        One-shot programs have nothing to import."""
        return None

    # --------------------------------------------------------------- helpers
    def _ledger_register(self, *trees) -> None:
        """Account this program's device-resident model buffers in the
        process :class:`~marlin_tpu_torch.obs.memledger.MemoryLedger`
        (component ``program``): the bytes of every tensor in ``trees``
        (nested dicts, lists and tuples walked) — called at construction
        and after every hot ``swap_model``, where the free-then-register
        pair debits the old weights and credits the new ones exactly (the
        ledger entry name is per-instance, so two programs of one class
        never collide). Never raises — accounting must not fail a swap."""
        try:
            from ...obs import memledger

            nbytes = sum(_tensor_bytes(t) for t in trees)
            led = memledger.get_ledger()
            entry = f"program:{self.name}#{id(self)}"
            led.free(entry, strict=False)
            led.register(entry, nbytes, "program",
                         owner=f"program:{self.name}")
        except Exception:
            pass

    def _capture_cost(self, key: str, cost: dict) -> None:
        """Land one cost record (``{"flops", "bytes accessed"}`` per call,
        counted from the shapes) in ProgramCosts unless already tried —
        warmup bookkeeping shared by every program."""
        costs = perf.get_program_costs()
        if not costs.tried(self.cost_program, key):
            costs.capture(self.cost_program, key, cost=cost)


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors and arrays in a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel()) * int(tree.element_size())
    return int(getattr(tree, "nbytes", 0) or 0)
