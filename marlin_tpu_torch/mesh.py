"""The device mesh: a world of one, or a grid over ``torch.distributed`` ranks.

Counterpart of ``marlin_tpu/mesh.py``. There a mesh is a ``jax.sharding.Mesh``
over many devices and matrices carry a ``NamedSharding`` on it. Here a
:class:`Mesh` is a device and a named grid:

- With no process group (the default), every axis has size 1: every
  "sharded" layout is the whole tensor on the device, and the strategies of
  ``parallel/`` reduce to one local product.
- After :func:`initialize_distributed`, :func:`create_mesh` lays the world's
  ranks out row-major on a grid whose product is the world size, and builds
  one process group per line of ranks along each axis (every rank creates
  every group, in the same order, as ``torch.distributed.new_group``
  requires). The multi-rank functions of ``parallel/`` and
  ``models/pipeline_lm.py`` take this rank's slice of their *logical*
  inputs, run their collectives over these groups and return the logical
  result on every rank, as the JAX package's ``shard_map`` programs do.

The sharding helpers (:func:`row_sharding`, :func:`block_sharding`,
:func:`replicated_sharding`) return a :class:`Sharding`, which names the
mesh axis each tensor dimension is split over and cuts this rank's block
(:meth:`Sharding.local`). On a mesh over ranks the port's matrices and
vectors hold only their rank's block of the zero-padded array under their
sharding (``matrix/dense.py``); :class:`Sharding` gives the padded shape,
the block bounds of any rank, and the owner of a global index, and
``parallel/collectives.py:redistribute`` moves blocks between layouts.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Sequence

import torch

from .config import resolve_device

ROWS = "rows"
COLS = "cols"

# how long a collective may wait before the process group raises
DIST_TIMEOUT_S = 60.0

_default_mesh: "Mesh | None" = None
# (ranks, grid, axis) -> this rank's process group along that axis
_GROUPS: dict = {}
# the device the process group was initialised for
_world_device: torch.device | None = None


def distributed() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group, 1 without one."""
    return torch.distributed.get_world_size() if distributed() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device and a named grid. ``ranks`` is ``None`` for the world of one
    (every axis of size 1), else the global ranks laid out row-major on the
    grid. Hashable: the process groups live in a module table keyed by the
    mesh's ranks, grid and axis."""

    device: torch.device
    grid: tuple[int, ...] = (1, 1)
    axis_names: tuple[str, ...] = (ROWS, COLS)
    ranks: tuple[int, ...] | None = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return math.prod(self.grid)

    def coords(self, pos: int | None = None) -> dict[str, int]:
        """The coordinate on each axis of the rank at row-major position
        ``pos`` of the grid (default: this rank; all 0 in a world of
        one)."""
        if pos is None:
            if self.ranks is None:
                return {a: 0 for a in self.axis_names}
            pos = self.ranks.index(torch.distributed.get_rank())
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.grid)):
            pos, out[name] = divmod(pos, n)
        return {a: out[a] for a in self.axis_names}

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords()[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis`` (``None`` in a world of
        one)."""
        if self.ranks is None:
            return None
        return _GROUPS[(self.ranks, self.grid, self.axis_names.index(axis))]

    def line(self, axis: str) -> list[int]:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        here = self.coords()
        return [self.ranks[_ravel(dict(here, **{axis: i}), self)]
                for i in range(self.shape[axis])]


def over_ranks(mesh: Mesh | None, axes: Sequence[str] | None = None) -> bool:
    """Whether ``mesh`` lies over ``torch.distributed`` ranks: the test that
    picks a function's multi-rank path (a one-rank world takes it too). A
    mesh that is not over ranks but has more than one device on one of
    ``axes`` (default: every axis) raises ``ValueError``."""
    if mesh is None:
        return False
    if getattr(mesh, "ranks", None) is not None:
        return True
    for axis in (mesh.axis_names if axes is None else axes):
        if mesh.shape[axis] != 1:
            raise ValueError(f"a '{axis}' axis of {mesh.shape[axis]} devices "
                             f"needs a mesh over torch.distributed ranks "
                             f"(initialize_distributed, then create_mesh)")
    return False


def _ravel(coords: dict, mesh: Mesh) -> int:
    pos = 0
    for name, n in zip(mesh.axis_names, mesh.grid):
        pos = pos * n + coords[name]
    return pos


def _build_groups(mesh: Mesh) -> None:
    """Create one process group per line of ranks along each axis. Every rank
    runs this for every mesh, in the same order, so the groups match."""
    dist = torch.distributed
    for ax in range(len(mesh.grid)):
        key = (mesh.ranks, mesh.grid, ax)
        if key in _GROUPS:
            continue
        others = [range(n) for i, n in enumerate(mesh.grid) if i != ax]
        mine = None
        for rest in itertools.product(*others):
            line = []
            for j in range(mesh.grid[ax]):
                c = list(rest)
                c.insert(ax, j)
                line.append(mesh.ranks[_ravel(dict(zip(mesh.axis_names, c)),
                                              mesh)])
            g = dist.new_group(ranks=line,
                               timeout=datetime.timedelta(
                                   seconds=DIST_TIMEOUT_S))
            if dist.get_rank() in line:
                mine = g
        _GROUPS[key] = mine


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> None:
    """Join a ``torch.distributed`` world: the counterpart of
    ``jax.distributed.initialize`` (the reference's SparkContext
    bring-up). ``coordinator_address`` is ``host:port`` or an init URL
    (``tcp://host:port``, ``file:///path``); ``None`` reads the ``env://``
    variables ``torchrun`` sets, as do ``num_processes`` and ``process_id``
    (the card then is ``LOCAL_RANK``'s).

    ``device`` (default: the configured one) picks the backend: NCCL on a
    CUDA device, each rank on ``cuda:{process_id % device_count}``; gloo only
    when the caller asks for the CPU. Without CUDA and without that request
    it raises (:func:`~marlin_tpu_torch.config.resolve_device`). Every
    collective waits at most :data:`DIST_TIMEOUT_S` seconds."""
    global _world_device
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        local = (int(os.environ.get("LOCAL_RANK", 0)) if process_id is None
                 else process_id) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if dev.type == "cuda":
        kw["device_id"] = dev
    torch.distributed.init_process_group(
        backend, init_method=init,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S), **kw)
    _world_device = dev


def shutdown_distributed() -> None:
    """Destroy the process group and forget its meshes, so later calls run
    in a world of one again."""
    global _world_device, _default_mesh
    if distributed():
        torch.distributed.destroy_process_group()
    _GROUPS.clear()
    _world_device = None
    if _default_mesh is not None and _default_mesh.ranks is not None:
        _default_mesh = None


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
    """A mesh over the world's ranks (default grid: :func:`best_grid` of the
    world size), or over ``device`` (default: the configured one) in a world
    of one. ``shape`` must multiply to the world size. With a process group
    every rank must call this with the same arguments: it builds the axes'
    groups collectively."""
    n = world_size()
    if shape is None:
        shape = best_grid(n)
    if math.prod(shape) != n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {math.prod(shape)} devices, "
            f"have {n}")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                         f"{tuple(axis_names)}")
    grid = tuple(int(s) for s in shape)
    if not distributed():
        return Mesh(resolve_device(device), grid, tuple(axis_names))
    return rank_grid(grid, axis_names)


def rank_grid(grid: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the first ``prod(grid)`` ranks of the world, row-major,
    with its axes' process groups; a rank past them holds no coordinate.
    Every rank must call it with the same arguments."""
    grid = tuple(int(s) for s in grid)
    dev = _world_device if _world_device is not None else resolve_device()
    mesh = Mesh(dev, grid, tuple(axis_names),
                tuple(range(math.prod(grid))))
    _build_groups(mesh)
    return mesh


def default_mesh() -> Mesh:
    """The mesh set by :func:`set_default_mesh`, else one over the world (a
    world of one: over the configured device, built per call, so
    ``config_context(device=...)`` is honoured)."""
    if _default_mesh is not None:
        return _default_mesh
    return create_mesh()


def set_default_mesh(mesh: Mesh | None) -> None:
    global _default_mesh
    _default_mesh = mesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axis each tensor dimension is split over (``None``:
    replicated), the counterpart of ``NamedSharding(mesh, P(*spec))``. A
    split dimension is zero-padded to a multiple of its axis's size (the JAX
    package's ``pad_to_multiple`` rule) and cut into equal blocks; the rank
    at grid coordinate ``c`` holds block ``c[axis]`` of each split
    dimension, as JAX's addressable shard at that coordinate does. The
    collectives (``parallel/collectives.py``) cut and move blocks through
    it."""

    mesh: Mesh
    spec: tuple

    def axis(self, dim: int) -> str | None:
        return self.spec[dim] if dim < len(self.spec) else None

    def divisors(self, ndim: int) -> tuple[int, ...]:
        """How many blocks each of ``ndim`` dimensions is cut into."""
        axes = [self.axis(d) for d in range(ndim)]
        return tuple(1 if a is None else self.mesh.shape[a] for a in axes)

    def padded_shape(self, shape) -> tuple[int, ...]:
        """``shape`` zero-padded so each split dimension divides by its
        axis."""
        return tuple(pad_to_multiple(int(n), g)
                     for n, g in zip(shape, self.divisors(len(shape))))

    def block_shape(self, padded) -> tuple[int, ...]:
        return tuple(int(n) // g
                     for n, g in zip(padded, self.divisors(len(padded))))

    def positions(self) -> range:
        """The row-major grid positions of the mesh's ranks."""
        return range(self.mesh.size)

    def rank_of(self, pos: int) -> int:
        """The global rank at grid position ``pos`` (0 in a world of
        one)."""
        return 0 if self.mesh.ranks is None else self.mesh.ranks[pos]

    def block_index(self, pos: int | None = None, ndim: int = 2) -> tuple:
        """The block coordinate (one per dimension) the rank at ``pos``
        holds (default: this rank)."""
        here = self.mesh.coords(pos)
        axes = [self.axis(d) for d in range(ndim)]
        return tuple(0 if a is None else here[a] for a in axes)

    def bounds(self, padded, pos: int | None = None
               ) -> tuple[tuple[int, int], ...]:
        """``(start, stop)`` in each dimension of the block that the rank at
        ``pos`` (default: this rank) holds of an array of ``padded``
        shape."""
        blk = self.block_shape(padded)
        idx = self.block_index(pos, len(padded))
        return tuple((i * b, (i + 1) * b) for i, b in zip(idx, blk))

    def owner(self, dim: int, index: int, padded) -> int:
        """The coordinate, on ``dim``'s axis, of the blocks holding global
        ``index`` of dimension ``dim`` (0 for a replicated dimension)."""
        return int(index) // self.block_shape(padded)[dim]

    def replica_id(self, pos: int | None = None) -> int:
        """Which copy of its block the rank at ``pos`` holds: its row-major
        index over the mesh axes the spec does not name (JAX's
        ``replica_id``; 0 where every axis is named)."""
        here = self.mesh.coords(pos)
        rid = 0
        for name, n in zip(self.mesh.axis_names, self.mesh.grid):
            if name not in self.spec:
                rid = rid * n + here[name]
        return rid

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the logical tensor ``x`` (each split
        dimension must divide by its axis's size)."""
        here = self.mesh.coords()
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not "
                                 f"divide by the {axis!r} axis ({n})")
            step = x.shape[dim] // n
            x = x.narrow(dim, here[axis] * step, step)
        return x


def row_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (ROWS, None))


def block_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (ROWS, COLS))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def mesh_shape(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape[ROWS], mesh.shape[COLS]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
