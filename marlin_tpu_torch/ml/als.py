"""Alternating least squares on explicit or implicit ratings.

Counterpart of ``marlin_tpu/ml/als.py``. The reference ports the old MLlib
blocked ALS (ml/ALSHelp.scala): factor blocks with in/out link tables, a
message-passing shuffle per half-iteration, per-user normal equations
accumulated with BLAS dspr (:236-254), solved via an explicit ``inv(AᵀA)``
(:388-392). The JAX package gathers the fixed side's factors by index,
``segment_sum``s the per-rating outer products ``v vᵀ`` per row, and solves
the rank×rank systems batched with ``jnp.linalg.solve``.

Here the same half-step runs as eager torch on the factors' device: the
segment sums are ``index_add_`` (atomics on the card, so the order of the f32
sums varies from run to run), and the batched solve is
``torch.linalg.solve_ex(check_errors=False)``. A row with no ratings has a
singular system under weighted λ (``reg = λ·0``); its solution is masked to
exactly 0 after the solve, as the reference masks its NaN, and no error flag
is read back, so a half-step never waits for the card.

The blocked mode (the JAX package's ``shard_map`` + ``lax.scan`` over
segment blocks) is a loop over a static ``(total_blocks, max_nnz)`` layout
packed once on the host: the stat tensor materializes one ``segment_block``
at a time, which is what lets a million users fit the card. Nothing in the
sweeps reads the card; only the two index-max reads and the host packing
before the loop do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import threefry
from ..ops.local import precision_scope

__all__ = ["als_run", "ALSModel"]

_MESH_ITEM = "ROADMAP queue 1 item 12"


@dataclasses.dataclass
class ALSModel:
    user_features: object  # DenseVecMatrix (num_users × rank)
    product_features: object  # DenseVecMatrix (num_items × rank)

    def predict(self, users, items) -> torch.Tensor:
        u = self.user_features.logical()
        v = self.product_features.logical()
        users = torch.as_tensor(users, device=u.device).long()
        items = torch.as_tensor(items, device=v.device).long()
        return torch.sum(u[users] * v[items], dim=1)

    def rmse(self, coo) -> float:
        pred = self.predict(coo.row_indices, coo.col_indices)
        err = pred - coo.values.to(pred.device, pred.dtype)
        return float(torch.sqrt(torch.mean(err * err)))


def _chunked_segment_stats(factors_other, seg_ids, other_ids, ratings,
                           num_segments, weight=None, chunk: int | None = None):
    """Accumulate per-segment XᵀX / Xᵀy / counts over nnz in bounded chunks:
    the (chunk, rank, rank) outer-product tensor never holds more than 2²⁴
    elements (64 MB of f32), so huge rating sets stay in device memory. The
    extra segment ``num_segments`` swallows padding entries."""
    nnz = ratings.shape[0]
    rank = factors_other.shape[1]
    if chunk is None:
        chunk = max(1, (1 << 24) // (rank * rank))
    chunk = max(1, min(chunk, nnz))
    dt, dev = factors_other.dtype, factors_other.device
    xtx = torch.zeros((num_segments + 1, rank, rank), dtype=dt, device=dev)
    xty = torch.zeros((num_segments + 1, rank), dtype=dt, device=dev)
    counts = torch.zeros((num_segments + 1,), dtype=dt, device=dev)
    for a in range(0, nnz, chunk):
        s = seg_ids[a:a + chunk]
        vt = factors_other.index_select(0, other_ids[a:a + chunk])
        r = ratings[a:a + chunk]
        outer = vt[:, :, None] * vt[:, None, :]
        if weight is not None:
            outer = outer * weight[a:a + chunk, None, None]
        xtx.index_add_(0, s, outer)
        xty.index_add_(0, s, vt * r[:, None])
        counts.index_add_(0, s, torch.ones_like(r))
    return xtx[:num_segments], xty[:num_segments], counts[:num_segments]


def _masked_solve(a, rhs, counts):
    """Batched solve of ``a x = rhs``; rows with no ratings come out exactly
    0. No error flag is read back (their systems may be singular)."""
    sol = torch.linalg.solve_ex(a, rhs[..., None], check_errors=False)[0]
    sol = sol[..., 0]
    return torch.where(counts[:, None] > 0, sol, torch.zeros_like(sol))


def _solve_explicit_stats(xtx, xty, counts, lam, weighted):
    """Batched regularized normal-equation solve from accumulated stats —
    not the reference's explicit ``inv(AᵀA)`` (ALSHelp.scala:388-392)."""
    reg = lam * (counts[:, None] if weighted
                 else torch.ones_like(counts)[:, None])
    eye = torch.eye(xtx.shape[-1], dtype=xtx.dtype, device=xtx.device)
    return _masked_solve(xtx + reg[:, :, None] * eye, xty, counts)


def _solve_implicit_stats(yty, corr, rhs, counts, lam):
    eye = torch.eye(yty.shape[0], dtype=yty.dtype, device=yty.device)
    return _masked_solve(yty[None] + corr + lam * eye[None], rhs, counts)


def _solve_side(factors_other, seg_ids, other_ids, ratings, rank, lam,
                num_segments, weighted):
    """One explicit half-step: recompute `num_segments` factor rows from the
    fixed other side. seg_ids: which row each rating belongs to; other_ids:
    which fixed factor it references (ALSHelp.scala:292-382)."""
    with precision_scope("highest"):
        xtx, xty, counts = _chunked_segment_stats(
            factors_other, seg_ids, other_ids, ratings, num_segments)
        return _solve_explicit_stats(xtx, xty, counts, lam, weighted)


def _solve_side_implicit(factors_other, seg_ids, other_ids, ratings, lam,
                         alpha, num_segments):
    """One implicit-feedback half-step (Hu/Koren/Volinsky; the reference's
    implicitPrefs path, ALSHelp.scala:188-200, 292-382): solve
    (YᵀY + Yᵀ(C−I)Y + λI) x = Yᵀ C p  per row, with the dense YᵀY computed
    once and only the (c−1)-weighted corrections segment-summed."""
    with precision_scope("highest"):
        yty = factors_other.T @ factors_other
        conf_minus_1 = alpha * ratings  # c = 1 + alpha*r
        corr, rhs, counts = _chunked_segment_stats(
            factors_other, seg_ids, other_ids, 1.0 + conf_minus_1,
            num_segments, weight=conf_minus_1)
        return _solve_implicit_stats(yty, corr, rhs, counts, lam)


def _block_ratings_by_segment(seg_ids, other_ids, vals, num_segments,
                              n_dev: int, block: int):
    """Host-side prep for the blocked path: sort ratings by owning segment and
    pack them into a dense ``(total_blocks, max_nnz)`` layout where block ``b``
    holds exactly the ratings of segments ``[b·block, (b+1)·block)`` — the
    static layout that replaces the reference's in/out link tables
    (ALSHelp.scala:101-165). Padding entries carry segment id ``block`` (the
    swallow segment of ``_chunked_segment_stats``) and rating 0."""
    seg = np.asarray(seg_ids)
    oth = np.asarray(other_ids)
    val = np.asarray(vals)
    segs_per_dev = -(-num_segments // (n_dev * block)) * block
    padded_segments = segs_per_dev * n_dev
    total_blocks = padded_segments // block
    order = np.argsort(seg, kind="stable")
    seg, oth, val = seg[order], oth[order], val[order]
    blk = seg // block
    counts = np.bincount(blk, minlength=total_blocks).astype(np.int64)
    max_nnz = -(-max(int(counts.max()), 8) // 8) * 8
    starts = np.cumsum(counts) - counts
    pos = np.arange(seg.shape[0]) - starts[blk]
    sid = np.full((total_blocks, max_nnz), block, np.int32)
    oid = np.zeros((total_blocks, max_nnz), np.int32)
    v = np.zeros((total_blocks, max_nnz), np.float32)
    sid[blk, pos] = (seg % block).astype(np.int32)
    oid[blk, pos] = oth.astype(np.int32)
    v[blk, pos] = val.astype(np.float32)
    return sid, oid, v, padded_segments


def _solve_side_sharded(factors_other, blk_sid, blk_oid, blk_val, lam, alpha,
                        *, mesh, block, weighted, implicit):
    """One blocked half-step: each segment block's stats are accumulated and
    solved in turn (the JAX package's ``lax.scan`` over the blocks a device
    owns, at one device), so the ``(segments, rank, rank)`` stat tensor never
    exists beyond one block. Returns the ``(total_blocks · block, rank)``
    padded factors."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"blocked ALS over a mesh of {mesh.size} devices: the sharded "
            f"half-step is not ported yet — {_MESH_ITEM}")
    with precision_scope("highest"):
        yty = factors_other.T @ factors_other if implicit else None
        out = []
        for s, o, r in zip(blk_sid, blk_oid, blk_val):
            if implicit:
                cm1 = alpha * r
                corr, rhs, counts = _chunked_segment_stats(
                    factors_other, s, o, 1.0 + cm1, block, weight=cm1)
                out.append(_solve_implicit_stats(yty, corr, rhs, counts, lam))
            else:
                xtx, xty, counts = _chunked_segment_stats(factors_other, s, o,
                                                          r, block)
                out.append(_solve_explicit_stats(xtx, xty, counts, lam,
                                                 weighted))
        return torch.cat(out)


def als_run(ratings, rank: int, iterations: int = 10, lam: float = 0.01,
            seed: int = 0, weighted_lambda: bool = True, mesh=None,
            implicit_prefs: bool = False, alpha: float = 1.0,
            num_user_blocks: int = -1, num_product_blocks: int = -1,
            shard: bool | None = None, segment_block: int = 4096) -> ALSModel:
    """Run blocked ALS (ALSHelp.ALSRun, ml/ALSHelp.scala:34-96) on the
    ratings' device.

    ``ratings`` is a CoordinateMatrix of (user, product, rating). Factors are
    initialized on the unit sphere like ``randomFactor``
    (ALSHelp.scala:170-179), from the JAX package's threefry draws of
    ``key(seed)`` (its normals may differ in the last place: ``erfinv`` is
    PyTorch's). ``implicit_prefs``/``alpha`` select the implicit-feedback
    formulation. ``num_user_blocks``/``num_product_blocks`` are accepted for
    signature parity and ignored.

    ``shard`` selects the blocked solver: stats materialize one
    ``segment_block`` at a time instead of ``(num_segments, rank, rank)`` at
    once. ``None`` enables it when the full stat tensor of either side would
    exceed 256 MB, the JAX package's rule."""
    del num_user_blocks, num_product_blocks
    from ..matrix.dense import DenseVecMatrix

    mesh = mesh or ratings.mesh
    num_users, num_items = ratings.shape
    # entries carried over from a JAX jit may hold padding (indices ==
    # shape); two scalar reads decide, so clean ratings never pay a host
    # copy of the entry arrays
    if ratings.nnz and (int(torch.max(ratings.row_indices)) >= num_users
                        or int(torch.max(ratings.col_indices)) >= num_items):
        ratings = ratings.compact()
    dev = mesh.device
    users = ratings.row_indices.to(dev, torch.int32)
    items = ratings.col_indices.to(dev, torch.int32)
    vals = ratings.values.to(dev, torch.float32)

    key_u, key_v = threefry.split(threefry.prng_key(seed, dev))
    u = threefry.normal(key_u, (num_users, rank))
    u = torch.abs(u) / torch.sqrt(torch.sum(u * u, dim=1, keepdim=True))
    v = threefry.normal(key_v, (num_items, rank))
    v = torch.abs(v) / torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))

    n_dev = mesh.size
    if shard is None:
        stat_bytes = 4 * rank * rank * max(num_users, num_items)
        shard = stat_bytes > (1 << 28)

    if shard:
        u, v = _als_sharded(mesh, u, v, users, items, vals, num_users,
                            num_items, iterations, lam, alpha,
                            weighted_lambda, implicit_prefs, segment_block,
                            n_dev)
    else:
        for _ in range(iterations):
            # products fixed -> update users, then users fixed -> products
            if implicit_prefs:
                u = _solve_side_implicit(v, users, items, vals, lam, alpha,
                                         num_users)
                v = _solve_side_implicit(u, items, users, vals, lam, alpha,
                                         num_items)
            else:
                u = _solve_side(v, users, items, vals, rank, lam, num_users,
                                weighted_lambda)
                v = _solve_side(u, items, users, vals, rank, lam, num_items,
                                weighted_lambda)

    return ALSModel(DenseVecMatrix.from_array(u, mesh),
                    DenseVecMatrix.from_array(v, mesh))


def _als_sharded(mesh, u, v, users, items, vals, num_users, num_items,
                 iterations, lam, alpha, weighted_lambda, implicit_prefs,
                 segment_block, n_dev):
    """Drive the blocked half-steps: pack both rating orientations once on
    the host (user-sorted for the user update, item-sorted for the item
    update), move the packed blocks to the device, and alternate half-steps.
    Factors stay padded across the loop and are sliced once at the end."""
    if n_dev > 1:
        raise NotImplementedError(
            f"blocked ALS over a mesh of {n_dev} devices: the sharded "
            f"half-step is not ported yet — {_MESH_ITEM}")
    dev = u.device
    block = max(8, min(segment_block, -(-max(num_users, num_items) // n_dev)))

    users_np, items_np, vals_np = (users.cpu().numpy(), items.cpu().numpy(),
                                   vals.cpu().numpy())
    u_sid, u_oid, u_val, pad_users = _block_ratings_by_segment(
        users_np, items_np, vals_np, num_users, n_dev, block)
    v_sid, v_oid, v_val, pad_items = _block_ratings_by_segment(
        items_np, users_np, vals_np, num_items, n_dev, block)
    u_sid, u_oid, u_val, v_sid, v_oid, v_val = (
        torch.from_numpy(x).to(dev)
        for x in (u_sid, u_oid, u_val, v_sid, v_oid, v_val))

    u = torch.nn.functional.pad(u, (0, 0, 0, pad_users - num_users))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad_items - num_items))
    for _ in range(iterations):
        u = _solve_side_sharded(v, u_sid, u_oid, u_val, lam, alpha,
                                mesh=mesh, block=block,
                                weighted=weighted_lambda,
                                implicit=implicit_prefs)
        v = _solve_side_sharded(u, v_sid, v_oid, v_val, lam, alpha,
                                mesh=mesh, block=block,
                                weighted=weighted_lambda,
                                implicit=implicit_prefs)
    return u[:num_users], v[:num_items]
