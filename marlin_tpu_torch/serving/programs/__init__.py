"""The BucketProgram registry: servable workloads keyed by
``Request.program``.

``PROGRAM_REGISTRY`` maps a program name to its :class:`~.base
.BucketProgram` subclass; :func:`register_program` is the class decorator
that populates it at import time. The engine resolves ``Request.program``
against the *instances* it was constructed with (``ServeEngine(...,
programs=[...])``) — the registry is the catalog (error messages, docs
tables, tooling), the engine's instance map is the routing table, and the
two agree by construction because every instance's class registered here.

Counterpart of ``marlin_tpu/serving/programs/__init__.py``: the LM program
(:class:`PagedLMProgram`) and the one-shot ALS, PageRank and classification
programs over the port's ``ml`` models; any :class:`BucketProgram` a caller
writes rides the same lane.
"""

from __future__ import annotations

__all__ = ["PROGRAM_REGISTRY", "register_program", "available_programs",
           "BucketProgram", "ProgramRowSet", "PagedLMProgram",
           "ALSScoreProgram", "PageRankQueryProgram", "ClassifyProgram"]

#: program name -> BucketProgram subclass
PROGRAM_REGISTRY: dict[str, type] = {}


def register_program(cls):
    """Class decorator: catalog one BucketProgram subclass by its name."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if name in PROGRAM_REGISTRY:
        raise ValueError(
            f"program {name!r} already registered by "
            f"{PROGRAM_REGISTRY[name].__name__}")
    PROGRAM_REGISTRY[name] = cls
    return cls


def available_programs() -> list[str]:
    return sorted(PROGRAM_REGISTRY)


from .base import BucketProgram, ProgramRowSet  # noqa: E402
from .lm import PagedLMProgram  # noqa: E402
from .als import ALSScoreProgram  # noqa: E402
from .pagerank import PageRankQueryProgram  # noqa: E402
from .classify import ClassifyProgram  # noqa: E402
