"""Distributed matrix multiply strategies, at world size 1.

Counterpart of ``marlin_tpu/parallel/matmul.py``: the replication matrix
multiply ("RMM", matrix/BlockMatrix.scala:149-220), the broadcast multiply
for small operands (DenseVecMatrix.scala:196-207, 1660-1680), the
partitioner-scheduled contraction ("gspmd") and the ring, chosen by the
reference's adaptive dispatch (DenseVecMatrix.scala:196-231).

On one device every strategy is one local product (``torch.matmul`` at the
requested precision, ops.local.local_matmul): there is nothing to replicate,
split or reduce. The API and the dispatch stay as they are — strategy names,
the broadcast threshold, the CARMA split and its device-count check, the
error types — so the multi-device schedules can come back on
``torch.distributed`` without changing a caller.

All functions take/return *logical* (unpadded) tensors, except
:func:`matmul_padded`, which takes and returns its matrices' padded layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import get_config, resolve_device
from ..mesh import Mesh, default_mesh
from ..ops.local import local_matmul
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


def build_rmm_mesh(split: tuple[int, int, int], devices=None) -> Mesh:
    """Arrange devices into the (m_split, k_split, n_split) grid chosen by the
    CARMA heuristic (the descendant of ``MatrixMultPartitioner``'s m·k·n
    partition space). Raises when the split needs more devices than exist."""
    devs = list(devices) if devices is not None else [resolve_device()]
    pm, pk, pn = split
    need = pm * pk * pn
    if need > len(devs):
        raise ValueError(f"split {split} needs {need} devices, have {len(devs)}")
    return Mesh(torch.device(devs[0]), (pm, pk, pn), (_M, _K, _N))


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
    devs = list(devices) if devices is not None else [resolve_device()]
    if split is None:
        split = split_method(m, k, n, len(devs))
    build_rmm_mesh(split, devs)
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
    1660-1680) and keep the big side where it is. One device: one product."""
    if replicate not in ("a", "b"):
        raise ValueError(f"replicate must be 'a' or 'b', got {replicate!r}")
    _check_inner(a, b)
    return local_matmul(a, b, precision, accum_dtype)


def gspmd_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: Mesh | None = None,
    precision: str | None = None,
    accum_dtype=None,
) -> torch.Tensor:
    """The contraction whose collective schedule the partitioner picks; on
    one device, one product."""
    _check_inner(a, b)
    return local_matmul(a, b, precision, accum_dtype)


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
    result comes back zero-padded to ``out_pad``.

    Returns ``None`` where the JAX package has no fused program either (an
    RMM split that does not fill the mesh, or the ring); callers then take
    :func:`matmul` on the logical tensors."""
    m, k, n = mkn
    strategy = _resolve_strategy(mkn, b_pad.element_size(), strategy,
                                 broadcast_threshold_mb)
    if strategy == "rmm":
        if split is None:
            split = split_method(m, k, n, mesh.size)
        if split[0] * split[1] * split[2] != mesh.size:
            return None
    elif strategy == "ring":
        return None
    c = local_matmul(a_pad[:m, :k], b_pad[:k, :n], precision,
                     accum_dtype or a_pad.dtype)
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
    # ring: one device holds the whole ring, so one product
    _check_inner(a, b)
    return local_matmul(a, b, precision, accum_dtype)
