"""The device mesh, as a world of one.

Counterpart of ``marlin_tpu/mesh.py``. There a mesh is a ``jax.sharding.Mesh``
over many devices and matrices carry a ``NamedSharding`` on it. This port runs
on one device, so a :class:`Mesh` is that device plus a grid whose axes all
have size 1: every "sharded" layout is the whole tensor on the device, and the
strategies of ``parallel/matmul.py`` reduce to one local product. The names
(``ROWS``/``COLS``, ``create_mesh``, ``default_mesh``) stay, so that the
multi-device strategies can grow back onto ``torch.distributed`` later.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .config import resolve_device

ROWS = "rows"
COLS = "cols"

_default_mesh: "Mesh | None" = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device and a named grid over it (every axis of size 1 here)."""

    device: torch.device
    grid: tuple[int, ...] = (1, 1)
    axis_names: tuple[str, ...] = (ROWS, COLS)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return math.prod(self.grid)


def best_grid(n_devices: int) -> tuple[int, int]:
    """Factor ``n_devices`` into the most square (rows, cols) grid, preferring
    rows >= cols."""
    best = (n_devices, 1)
    for r in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % r == 0:
            best = (n_devices // r, r)
    return best


def create_mesh(
    shape: Sequence[int] | None = None,
    axis_names: Sequence[str] = (ROWS, COLS),
    device=None,
) -> Mesh:
    """A mesh over ``device`` (default: the configured one). The world has one
    device, so ``shape`` must multiply to 1."""
    dev = resolve_device(device)
    if shape is None:
        shape = best_grid(1)
    if math.prod(shape) != 1:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {math.prod(shape)} devices, "
            "have 1")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                         f"{tuple(axis_names)}")
    return Mesh(dev, tuple(int(s) for s in shape), tuple(axis_names))


def default_mesh() -> Mesh:
    """The mesh set by :func:`set_default_mesh`, else one over the configured
    device (built per call, so ``config_context(device=...)`` is honoured)."""
    if _default_mesh is not None:
        return _default_mesh
    return create_mesh()


def set_default_mesh(mesh: Mesh | None) -> None:
    global _default_mesh
    _default_mesh = mesh


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
