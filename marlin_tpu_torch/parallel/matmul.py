"""Distributed matrix multiply strategies.

Counterpart of ``marlin_tpu/parallel/matmul.py``: the replication matrix
multiply ("RMM", matrix/BlockMatrix.scala:149-220), the broadcast multiply
for small operands (DenseVecMatrix.scala:196-207, 1660-1680), the
partitioner-scheduled contraction ("gspmd") and the ring, chosen by the
reference's adaptive dispatch (DenseVecMatrix.scala:196-231).

With no process group every strategy is one local product (``torch.matmul``
at the requested precision, ops.local.local_matmul): there is nothing to
replicate, split or reduce. Over ``torch.distributed`` ranks
(:func:`~marlin_tpu_torch.mesh.initialize_distributed`):

- :func:`rmm_matmul` lays the world's ranks on the (m, k, n) grid of the
  CARMA split; each rank multiplies its (m, k) block of A by its (k, n)
  block of B, an ``all_reduce`` over the k line sums them (the JAX
  package's ``psum``), and a gather over the world assembles C;
- :func:`broadcast_matmul` uses the replicated operand each rank already
  holds (``sc.broadcast``), takes this rank's row block of A (or column
  block of B) times it, and gathers the blocks;
- :func:`gspmd_matmul` has no partitioner to defer to: it runs the RMM
  split :func:`_resolve_strategy` would choose (ROADMAP queue 3);
- ``"ring"`` is :func:`~marlin_tpu_torch.parallel.ring.ring_matmul`.

All functions take/return *logical* (unpadded) tensors, the same on every
rank, except :func:`matmul_padded`, which takes and returns its matrices'
padded layouts and runs the strategy's function on the logical slices.
Each strategy function lands its multiply's analytic cost in the process
``ProgramCosts`` registry (:func:`_capture_matmul_cost`) under the JAX
package's program names and keys, once per rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import get_config, resolve_device
from ..mesh import (Mesh, default_mesh, distributed, pad_to_multiple,
                    rank_grid, world_size)
from ..ops.local import local_matmul
from . import collectives as col
from .carma import split_method

_M, _K, _N = "m", "k", "n"


class UnknownStrategyError(ValueError):
    """Raised when a matmul ``strategy`` name is not one the engine knows.

    A dedicated type so the autotuner can skip unsupported candidates without
    matching on message text (any other ``ValueError`` from an engine is a
    genuinely broken run and must surface)."""


def _check_inner(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return m, k, n


def _capture_matmul_cost(program: str, a, b, **meta) -> None:
    """Land one multiply's cost model in the process ProgramCosts registry,
    keyed as the JAX package keys its own (``shape=MxKxN dtype=... **meta``).
    Eager torch has no compiled cost model to read, so the cost is the
    multiply's analytic one: ``2mkn`` flops and each operand read and the
    result written once (the counts ``tune_multiply`` uses). Gated on
    ``tried``: one set lookup per call after a configuration's first.
    Reads shapes and dtypes only, never the card's data; never raises.
    Inside a ``torch.compile`` trace (:func:`marlin_tpu_torch.lazy.fuse`)
    it lands nothing, as the JAX package's jitted chains land none."""
    from ..obs import perf

    if torch.compiler.is_compiling():
        return
    try:
        m, k = a.shape
        n = b.shape[1]
        key = perf.program_key(shape=f"{m}x{k}x{n}",
                               dtype=str(a.dtype).replace("torch.", ""),
                               **meta)
        costs = perf.get_program_costs()
        if costs.tried(program, key):
            return
        ia, ib = a.element_size(), b.element_size()
        costs.capture(program, key, cost={
            "flops": 2.0 * m * k * n,
            "bytes accessed": float(m * k * ia + k * n * ib
                                    + m * n * max(ia, ib))})
    except Exception:
        pass


def build_rmm_mesh(split: tuple[int, int, int], devices=None) -> Mesh:
    """Arrange devices into the (m_split, k_split, n_split) grid chosen by the
    CARMA heuristic (the descendant of ``MatrixMultPartitioner``'s m·k·n
    partition space): with a process group, the first m·k·n ranks of the
    world (every rank must call it); else ``devices`` (default: the
    configured device). Raises when the split needs more devices than
    exist."""
    pm, pk, pn = split
    need = pm * pk * pn
    have = world_size() if distributed() else \
        len(list(devices) if devices is not None else [None])
    if need > have:
        raise ValueError(f"split {split} needs {need} devices, have {have}")
    if distributed():
        return rank_grid(split, (_M, _K, _N))
    devs = list(devices) if devices is not None else [resolve_device()]
    return Mesh(torch.device(devs[0]), (pm, pk, pn), (_M, _K, _N))


def _rmm_ranks(a, b, mesh3: Mesh, precision, accum_dtype):
    """The RMM across ranks, logical in/out: each rank of the (m, k, n) grid
    multiplies its blocks, an ``all_reduce`` over its k line sums the
    partial products, and a gather over the world assembles C from the
    k = 0 ranks (a rank past the grid contributes zeros and computes
    nothing)."""
    import torch.distributed as dist

    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = mesh3.grid
    mp, kp, np_ = (pad_to_multiple(m, pm), pad_to_multiple(k, pk),
                   pad_to_multiple(n, pn))
    a = F.pad(a, (0, kp - k, 0, mp - m))
    b = F.pad(b, (0, np_ - n, 0, kp - k))
    bm, bk, bn = mp // pm, kp // pk, np_ // pn
    rank = dist.get_rank()
    if rank < mesh3.size:
        i, kk, j = (mesh3.coords()[ax] for ax in (_M, _K, _N))
        c = local_matmul(a[i * bm:(i + 1) * bm, kk * bk:(kk + 1) * bk],
                         b[kk * bk:(kk + 1) * bk, j * bn:(j + 1) * bn],
                         precision, accum_dtype).contiguous()
        dist.all_reduce(c, group=mesh3.group(_K))
    else:
        c = torch.zeros((bm, bn), dtype=accum_dtype, device=a.device)
    parts = [torch.empty_like(c) for _ in range(world_size())]
    dist.all_gather(parts, c)
    rows = [torch.cat([parts[(i * pk) * pn + j] for j in range(pn)], dim=1)
            for i in range(pm)]
    return torch.cat(rows, dim=0)[:m, :n]


def rmm_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    split: tuple[int, int, int] | None = None,
    devices=None,
    precision: str | None = None,
    accum_dtype=None,
) -> torch.Tensor:
    """3-D replicated matmul over an (m, k, n) device grid.

    ``split=None`` runs the CARMA heuristic over the shapes and the device
    count (DenseVecMatrix.scala:214-218); an explicit split mirrors
    ``multiply(other, (m, k, n))`` (DenseVecMatrix.scala:109-141) and must
    fit the devices. With one device the grid is (1, 1, 1): one product."""
    m, k, n = _check_inner(a, b)
    if distributed():
        n_dev = world_size()
    else:
        n_dev = len(list(devices)) if devices is not None else 1
    if split is None:
        split = split_method(m, k, n, n_dev)
    mesh3 = build_rmm_mesh(split, devices)
    _capture_matmul_cost("rmm_matmul", a, b, split="x".join(map(str, split)))
    if mesh3.ranks is not None:
        return _rmm_ranks(a, b, mesh3, precision, accum_dtype or a.dtype)
    return local_matmul(a, b, precision, accum_dtype)


def broadcast_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: Mesh | None = None,
    replicate: str = "b",
    precision: str | None = None,
    accum_dtype=None,
) -> torch.Tensor:
    """Small-operand multiply: replicate one side (the analog of Spark's
    ``collect`` + ``sc.broadcast``, DenseVecMatrix.scala:196-207 and
    1660-1680) and keep the big side where it is. Across ranks every rank
    already holds the replicated operand whole (the logical in/out
    contract), so only the big one is split, by rows (``replicate="b"``) or
    columns (``"a"``) over every rank of the mesh, and the blocks of C are
    gathered. One device: one product."""
    if replicate not in ("a", "b"):
        raise ValueError(f"replicate must be 'a' or 'b', got {replicate!r}")
    m, _, n = _check_inner(a, b)
    _capture_matmul_cost("broadcast_matmul", a, b, replicate=replicate)
    if mesh is None and distributed():
        mesh = default_mesh()
    if mesh is None or mesh.ranks is None:
        return local_matmul(a, b, precision, accum_dtype)
    flat = rank_grid((mesh.size,), ("all",))
    p = flat.size
    if replicate == "b":
        big = F.pad(a, (0, 0, 0, pad_to_multiple(m, p) - m))
        c = local_matmul(col.block(big, flat, "all", 0), b, precision,
                         accum_dtype)
        return col.all_gather_cat(c, flat, "all", 0)[:m]
    big = F.pad(b, (0, pad_to_multiple(n, p) - n))
    c = local_matmul(a, col.block(big, flat, "all", 1), precision,
                     accum_dtype)
    return col.all_gather_cat(c, flat, "all", 1)[:, :n]


def gspmd_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: Mesh | None = None,
    precision: str | None = None,
    accum_dtype=None,
) -> torch.Tensor:
    """The contraction whose collective schedule the partitioner picks. No
    partitioner exists here: across ranks it runs the CARMA RMM split over
    the mesh's ranks (ROADMAP queue 3); on one device, one product."""
    m, k, n = _check_inner(a, b)
    if mesh is None and distributed():
        mesh = default_mesh()
    _capture_matmul_cost("gspmd_matmul", a, b,
                         devices=1 if mesh is None else mesh.size)
    if mesh is None or mesh.ranks is None:
        return local_matmul(a, b, precision, accum_dtype)
    mesh3 = build_rmm_mesh(split_method(m, k, n, mesh.size))
    return _rmm_ranks(a, b, mesh3, precision, accum_dtype or a.dtype)


_STRATEGIES = ("auto", "broadcast", "broadcast_a", "rmm", "gspmd", "ring")


def _resolve_strategy(
    mkn: tuple[int, int, int],
    itemsize: int,
    strategy: str,
    broadcast_threshold_mb: float | None,
) -> str:
    """Shared auto-dispatch (DenseVecMatrix.scala:196-231): broadcast when one
    operand is under the threshold, else CARMA RMM."""
    if strategy not in _STRATEGIES:
        raise UnknownStrategyError(
            f"unknown matmul strategy: {strategy!r} (one of {_STRATEGIES})"
        )
    if strategy != "auto":
        return strategy
    m, k, n = mkn
    threshold = (
        broadcast_threshold_mb
        if broadcast_threshold_mb is not None
        else get_config().broadcast_threshold_mb
    )
    if k * n * itemsize / 1e6 <= threshold:
        return "broadcast"
    if m * k * itemsize / 1e6 <= threshold:
        return "broadcast_a"
    return "rmm"


def matmul_padded(
    a_pad: torch.Tensor,
    b_pad: torch.Tensor,
    mkn: tuple[int, int, int],
    mesh: Mesh,
    out_pad: tuple[int, int],
    strategy: str = "auto",
    split: tuple[int, int, int] | None = None,
    broadcast_threshold_mb: float | None = None,
    precision: str | None = None,
    accum_dtype=None,
) -> torch.Tensor | None:
    """Padded-in / padded-out multiply: ``a_pad``/``b_pad`` carry their
    matrices' zero-padded layouts and ``mkn`` the logical (m, k, n); the
    result comes back zero-padded to ``out_pad``. The product is the
    strategy's own function on the logical slices, so it lands that
    function's cost row.

    Returns ``None`` where the JAX package has no fused program either (an
    RMM split that does not fill the mesh, or the ring); callers then take
    :func:`matmul` on the logical tensors."""
    m, k, n = mkn
    strategy = _resolve_strategy(mkn, b_pad.element_size(), strategy,
                                 broadcast_threshold_mb)
    a, b = a_pad[:m, :k], b_pad[:k, :n]
    accum_dtype = accum_dtype or a_pad.dtype
    if strategy == "rmm":
        if split is None:
            split = split_method(m, k, n, mesh.size)
        if split[0] * split[1] * split[2] != mesh.size:
            return None
        c = rmm_matmul(a, b, split, [mesh.device] * mesh.size, precision,
                       accum_dtype)
    elif strategy == "ring":
        return None
    elif strategy == "gspmd":
        c = gspmd_matmul(a, b, mesh, precision, accum_dtype)
    else:
        c = broadcast_matmul(a, b, mesh, "a" if strategy == "broadcast_a"
                             else "b", precision, accum_dtype)
    mp_out, np_out = out_pad
    if (mp_out, np_out) != (m, n):
        c = F.pad(c, (0, np_out - n, 0, mp_out - m))
    return c


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: Mesh | None = None,
    strategy: str = "auto",
    split: tuple[int, int, int] | None = None,
    broadcast_threshold_mb: float | None = None,
    precision: str | None = None,
    accum_dtype=None,
) -> torch.Tensor:
    """Adaptive distributed matmul — the dispatch logic of
    ``DenseVecMatrix.multiply(other, cores, broadcastThreshold)``
    (DenseVecMatrix.scala:196-231): broadcast when one operand is small,
    otherwise CARMA-split RMM over the mesh."""
    mesh = mesh or default_mesh()
    strategy = _resolve_strategy(
        (a.shape[0], a.shape[1], b.shape[1]), b.element_size(), strategy,
        broadcast_threshold_mb,
    )
    if strategy == "broadcast":
        return broadcast_matmul(a, b, mesh, "b", precision, accum_dtype)
    if strategy == "broadcast_a":
        return broadcast_matmul(a, b, mesh, "a", precision, accum_dtype)
    if strategy == "rmm":
        return rmm_matmul(a, b, split, [mesh.device] * mesh.size, precision,
                          accum_dtype)
    if strategy == "gspmd":
        return gspmd_matmul(a, b, mesh, precision, accum_dtype)
    from .ring import ring_matmul

    return ring_matmul(a, b, mesh, mesh.axis_names[0], precision,
                       accum_dtype)
