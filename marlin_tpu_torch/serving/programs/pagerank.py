"""Incremental PageRank queries as a BucketProgram.

Counterpart of ``marlin_tpu/serving/programs/pagerank.py``. The graph stays
resident in edge form (:class:`~marlin_tpu_torch.ml.pagerank
.TransitionOperator` — the never-densify representation) next to a live
rank vector. A request names a node (payload ``{"node": int, "k": int?}``)
and gets the top-k *out-neighbors of that node by current global rank*,
computed as one batched edge mask + ``torch.topk`` over the resident arrays.
Tied ranks (two neighbors of equal rank, or one neighbor reached by
duplicate edges) may come out in another order than ``lax.top_k``'s.

"Incremental" is :meth:`PageRankQueryProgram.refresh`: between queries the
operator advances the resident rank vector by a few power-iteration steps
(:func:`~marlin_tpu_torch.ml.pagerank._pagerank_step`, the step the offline
solver runs), so ranks track the graph without blocking the serving path —
queries read whatever vector is installed, and swaps are atomic under the
program lock.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...config import get_config
from ...ml.pagerank import (TransitionOperator, _pagerank_step,
                            build_transition_operator)
from ...obs import perf
from . import register_program
from .base import BucketProgram

__all__ = ["PageRankQueryProgram"]


def _pr_neighbor_topk(src, dst, ranks, nodes, k: int):
    """Top-k out-neighbors by rank for a padded batch of query nodes: mask
    the edge list per query row, score each edge by its destination's rank,
    top-k over the edge axis. (W, E) is the honest cost of an unsorted
    adjacency — the admission budget charges exactly this row."""
    sel = src[None, :] == nodes[:, None]                       # (W, E)
    scored = torch.where(sel, ranks.index_select(0, dst)[None, :],
                         torch.full((), -math.inf, device=ranks.device))
    vals, eidx = torch.topk(scored, k, dim=1)
    return vals, dst[eidx]


def _pr_refresh(r, src, dst, inv_deg, dangling, damping, n: int,
                iterations: int):
    for _ in range(iterations):
        r = _pagerank_step(r, src, dst, None, inv_deg, dangling, damping, n)
    return r


@register_program
class PageRankQueryProgram(BucketProgram):
    """node → top-k out-neighbors by live PageRank over a resident graph."""

    name = "pagerank"
    cost_program = "pagerank_query"
    resource_unit = "one padded edge-mask row: num_edges x 4 bytes"

    def __init__(self, edges, n: int | None = None, damping: float = 0.85):
        super().__init__()
        op = (edges if isinstance(edges, TransitionOperator)
              else build_transition_operator(edges, n))
        if op.mesh is not None or op.weight is not None:
            raise ValueError("serving wants an unsharded operator "
                             "(build without mesh=)")
        self._op = op
        self.n = int(op.n)
        self.num_edges = int(op.nnz)
        dev = op.src.device
        self._damping = torch.tensor(damping, dtype=torch.float32, device=dev)
        self._ranks = torch.full((self.n,), 1.0 / self.n, dtype=torch.float32,
                                 device=dev)
        cfg = get_config()
        ks = tuple(sorted({int(k) for k in cfg.serve_program_topk
                           if int(k) <= self.num_edges}))
        if not ks:
            raise ValueError(
                f"no serve_program_topk value fits num_edges="
                f"{self.num_edges} (got {cfg.serve_program_topk!r})")
        self._ks = ks
        self.refresh_count = 0
        self._ledger_register(op.src, op.dst, op.inv_deg, op.dangling,
                              self._ranks)

    def refresh(self, iterations: int = 1) -> np.ndarray:
        """Advance the resident rank vector ``iterations`` power steps and
        install it atomically; returns the new ranks (host copy)."""
        op = self._op
        with self._lock:
            r = self._ranks
        r = _pr_refresh(r, op.src, op.dst, op.inv_deg, op.dangling,
                        self._damping, self.n, int(iterations))
        with self._lock:
            self._ranks = r
            self.refresh_count += 1
        return r.cpu().numpy()

    def ranks(self) -> np.ndarray:
        with self._lock:
            return self._ranks.cpu().numpy()

    # ---------------------------------------------------------------- policy
    def buckets(self):
        return [(k,) for k in self._ks]

    def validate(self, request):
        p = request.payload
        if not isinstance(p, dict) or "node" not in p:
            return (f"program {self.name!r} needs payload "
                    f"{{'node': int, 'k': int?}}, got {type(p).__name__}")
        node = p["node"]
        if not 0 <= int(node) < self.n:
            return f"node {node} out of range [0, {self.n})"
        k = int(p.get("k", self._ks[0]))
        if k < 1:
            return f"k must be >= 1, got {k}"
        return None

    def pick_bucket(self, request):
        k = int(request.payload.get("k", self._ks[0]))
        for kb in self._ks:
            if kb >= k:
                return (kb,)
        return None

    def refuse_no_bucket(self, request):
        return (f"no bucket fits program='pagerank' k="
                f"{request.payload.get('k')} (k buckets {list(self._ks)})")

    def admission_cost(self, request, bucket):
        return self.num_edges * 4

    def program_key(self, bucket, width=None):
        return perf.program_key(
            prog=self.name, n=self.n, edges=self.num_edges, k=bucket[0],
            width=width or self.width)

    def _cost(self, k: int, w: int) -> dict:
        """Analytic cost of one step: a compare and a select per (row,
        edge); the edge arrays and ranks read, the top-k written."""
        e = self.num_edges
        return {"flops": 2.0 * w * e,
                "bytes accessed": 4.0 * (2 * e + self.n) + 12.0 * w * k}

    # ------------------------------------------------------------- mechanism
    def warmup(self) -> int:
        """One step per (k, padded width), and its cost record."""
        n = 0
        op = self._op
        with self._lock:
            ranks = self._ranks
        for (k,) in self.buckets():
            for w in self.widths:
                self._capture_cost(self.program_key((k,), w), self._cost(k, w))
                nodes = torch.zeros((w,), dtype=torch.int32,
                                    device=op.src.device)
                _pr_neighbor_topk(op.src, op.dst, ranks, nodes, k)
                n += 1
        return n

    def step(self, bucket, requests):
        (k,) = bucket
        op = self._op
        w = self.step_width(len(requests))
        nodes = np.full((w,), -1, np.int32)  # -1 matches no src: empty rows
        for i, r in enumerate(requests):
            nodes[i] = int(r.payload["node"])
        with self._lock:
            ranks = self._ranks
        vals, items = _pr_neighbor_topk(
            op.src, op.dst, ranks, torch.from_numpy(nodes).to(op.src.device),
            k)
        # the one read of the card per program step
        vals, items = vals.cpu().numpy(), items.cpu().numpy()
        out = []
        for i, r in enumerate(requests):
            want = int(r.payload.get("k", k))
            good = np.isfinite(vals[i, :want])  # < k out-neighbors pad -inf
            out.append({"items": items[i, :want][good].copy(),
                        "scores": vals[i, :want][good].copy()})
        return out
