"""PageRank as iterated mat-vec.

Counterpart of ``marlin_tpu/ml/pagerank.py``. The reference example
(examples/PageRank.scala) builds a link matrix and multiplies it against the
rank vector per iteration (:46-58), one Spark job per step; the JAX package
runs the power iteration as one jitted ``lax.fori_loop``. Here it is a loop
on the operator's device that reads nothing on the host until the end.

Graph-scale input never densifies: :func:`build_transition_operator` keeps the
graph as (src, dst) edge arrays, sorted by destination on the host, plus an
out-degree table, and a step is a gather of ``r[src] / outdeg[src]`` and an
``index_add_`` into the destinations (the ``segment_sum`` of the JAX
package). ``index_add_`` on the card sums with atomics, so the order of the
f32 sums, and the last bits of the ranks, vary from run to run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from ..interop import to_tensor
from ..ops.local import precision_scope

__all__ = ["pagerank", "build_transition_matrix", "build_transition_operator",
           "TransitionOperator"]

_MESH_ITEM = "ROADMAP queue 1 item 12"


def _check_world_of_one(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"PageRank over a mesh of {mesh.size} devices: the edge-parallel "
            f"reduce across devices is not ported yet — {_MESH_ITEM}")


def build_transition_matrix(edges, n: int | None = None) -> np.ndarray:
    """Column-stochastic transition matrix from (src, dst) edge pairs.
    Dangling nodes get uniform columns."""
    edges = np.asarray(list(edges), dtype=np.int64)
    if edges.size == 0:
        raise ValueError("empty edge list")
    if n is None:
        n = int(edges.max()) + 1
    m = np.zeros((n, n), np.float32)
    np.add.at(m, (edges[:, 1], edges[:, 0]), 1.0)
    colsum = m.sum(axis=0)
    dangling = colsum == 0
    m[:, ~dangling] /= colsum[~dangling]
    m[:, dangling] = 1.0 / n
    return m


@dataclasses.dataclass
class TransitionOperator:
    """Column-stochastic link operator held in edge-list form: applying it to a
    rank vector is ``index_add_(r[src]/outdeg[src], dst)`` plus the dangling
    mass spread uniformly — the math of :func:`build_transition_matrix`
    without the n×n materialization."""

    src: torch.Tensor  # (E,) int32
    dst: torch.Tensor  # (E,) int32, sorted ascending
    inv_deg: torch.Tensor  # (n,) f32, 1/outdegree, 0 at dangling nodes
    dangling: torch.Tensor  # (n,) f32, 1.0 at dangling nodes
    n: int
    mesh: object | None = None
    weight: torch.Tensor | None = None  # (E,) f32 edge validity

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def nnz(self):
        return int(self.src.shape[0])


def build_transition_operator(edges, n: int | None = None,
                              mesh=None) -> TransitionOperator:
    """Edge-list transition operator from (src, dst) pairs — the graph-scale
    input path (reference: examples/PageRank.scala:46-58). O(E + n) memory;
    duplicate edges weight as in :func:`build_transition_matrix` (each
    contributes one out-link). ``edges`` is an (E, 2) array-like or
    iterable of pairs.

    The degrees and the destination sort are host numpy; the arrays then go
    to ``mesh``'s device, or the configured one. With ``mesh`` the operator
    carries it and an all-ones ``weight``, as the JAX package's edge-sharded
    form does at one device."""
    _check_world_of_one(mesh)
    edges = np.asarray(edges if hasattr(edges, "ndim") else list(edges),
                       dtype=np.int64)
    if edges.size == 0:
        raise ValueError("empty edge list")
    edges = edges.reshape(-1, 2)
    if n is None:
        n = int(edges.max()) + 1
    deg = np.bincount(edges[:, 0], minlength=n).astype(np.float32)
    dangling = (deg == 0).astype(np.float32)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(
        np.float32)
    # sorted by destination once at build time, as the JAX package sorts for
    # its indices_are_sorted scatter: the adds into one destination are
    # adjacent
    order = np.argsort(edges[:, 1], kind="stable")
    src = edges[order, 0].astype(np.int32)
    dst = edges[order, 1].astype(np.int32)
    dev = mesh.device if mesh is not None else resolve_device(None)
    weight = (torch.ones(len(src), dtype=torch.float32, device=dev)
              if mesh is not None else None)
    return TransitionOperator(to_tensor(src, device=dev),
                              to_tensor(dst, device=dev),
                              to_tensor(inv_deg, device=dev),
                              to_tensor(dangling, device=dev), n, mesh,
                              weight)


def _pagerank_step(r, src, dst, weight, inv_deg, dangling, damping, n):
    """One power-iteration step in edge form: gather per-edge contributions,
    add them into their destinations (the reduceByKey of
    examples/PageRank.scala:52), spread the dangling mass uniformly.
    ``damping`` is an f32 tensor, so every term rounds in f32."""
    contrib = (r * inv_deg).index_select(0, src)
    if weight is not None:
        contrib = contrib * weight
    acc = torch.zeros_like(r).index_add_(0, dst, contrib)
    d_mass = torch.sum(r * dangling)
    r = damping * (acc + d_mass / n) + (1.0 - damping) / n
    return r / torch.sum(r)


def _pagerank_edges(src, dst, weight, inv_deg, dangling, damping, n: int,
                    iterations: int, mesh=None) -> torch.Tensor:
    """``iterations`` steps from the uniform vector on the operator's
    device. ``mesh`` is the operator's; only a world of one runs."""
    _check_world_of_one(mesh)
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=src.device)
    for _ in range(iterations):
        r = _pagerank_step(r, src, dst, weight, inv_deg, dangling, damping, n)
    return r


def _pagerank_fori(m: torch.Tensor, damping, iterations: int) -> torch.Tensor:
    """Power iteration against a dense or sparse COO matrix ``m``."""
    n = m.shape[0]
    dtype = torch.promote_types(m.dtype, torch.float32)
    damping = damping.to(dtype)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=m.device)
    with precision_scope(None):
        for _ in range(iterations):
            mr = (torch.sparse.mm(m, r[:, None])[:, 0] if m.is_sparse
                  else m @ r)
            r = damping * mr + (1.0 - damping) / n
            r = r / torch.sum(r)
    return r


def pagerank(link_matrix, damping: float = 0.85,
             iterations: int = 20) -> np.ndarray:
    """Run power iteration. ``link_matrix`` is a DenseMatrix/SparseVecMatrix/
    array holding a column-stochastic transition matrix (use
    :func:`build_transition_matrix` to build one from an edge list), or a
    :class:`TransitionOperator` from :func:`build_transition_operator` for
    graph-scale edge lists that must never densify. Sparse operands stay
    sparse. Returns the ranks on the host, read once at the end."""
    from ..matrix.sparse import SparseVecMatrix

    if isinstance(link_matrix, TransitionOperator):
        op = link_matrix
        d = torch.tensor(damping, dtype=torch.float32, device=op.src.device)
        r = _pagerank_edges(op.src, op.dst, op.weight, op.inv_deg,
                            op.dangling, d, op.n, int(iterations), op.mesh)
        return r.cpu().numpy()
    if isinstance(link_matrix, SparseVecMatrix):
        arr = link_matrix.bcoo
    elif hasattr(link_matrix, "logical"):
        arr = link_matrix.logical()
    else:
        arr = to_tensor(link_matrix, device=resolve_device(None))
    d = torch.tensor(damping, dtype=torch.float32, device=arr.device)
    return _pagerank_fori(arr, d, int(iterations)).cpu().numpy()
