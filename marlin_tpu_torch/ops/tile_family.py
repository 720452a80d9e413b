"""The tiling families of the hand-written GEMM and of the BSR SpMM.

Counterpart of ``marlin_tpu/ops/tile_family.py``. For the GEMM, there the
family is every MXU-aligned power-of-two (bm, bn, bk) block shape pruned by a
12 MiB VMEM budget. Here the axes are the CTA tiles ``csrc/gemm.cu`` is
instantiated for, so the family proposes exactly the kernels the library
holds: bm is one or two consumer warpgroups of 64 rows, bn the wgmma width,
bk the 4-byte words of a stage's rows, 32 = one 128-byte swizzled row (the
TF32 halves of 16 f32 values of k, or 64 bf16 values). The kernel fills the
227 KB a Hopper block can have with as many ring stages as fit
(:func:`stages`), each holding the A and B tiles; :func:`smem_bytes` is that
model, and pruning keeps it within the budget. The surviving tiles are
ranked by the same analytic traffic model and handed to
``autotune.tune_gemm`` to time.

Candidate names keep the ``"pallas:BMxBNxBK"`` spelling, so autotune cache
entries parse the same way in both packages.

The BSR family (:func:`bsr_candidates`) is the JAX package's as it is: the
chunked formulation at chunk sizes around its default buffer budget, plus the
kernel, spelled ``"chunked:N"`` and ``"pallas"``. Pure arithmetic: no torch,
no device.
"""

from __future__ import annotations

__all__ = ["TileCandidate", "gemm_candidates", "parse_gemm_candidate",
           "bsr_candidates", "parse_bsr_candidate",
           "smem_bytes", "stages", "gemm_traffic_bytes", "select_tile",
           "is_instantiated", "SMEM_BUDGET_BYTES", "BM_AXIS", "BN_AXIS",
           "BK_AXIS"]

# The instantiated CTA tiles: every (bm, bn, bk) in the product of these axes
# (keep in step with the MARLIN_TILE list in csrc/gemm.cu). A block runs a
# producer warpgroup and bm/64 consumer warpgroups.
BM_AXIS = (64, 128)
BN_AXIS = (64, 128)
BK_AXIS = (32,)

# Dynamic shared memory one Hopper block may use (232,448 bytes; above 48 KB
# after cudaFuncSetAttribute, which the launcher always calls).
SMEM_BUDGET_BYTES = 232_448
# csrc/gemm.cu's kMaxStages and kSmemReserve: the ring's most stages, and
# the bytes beside them (1024 to align the swizzled tiles, 16 of mbarriers a
# stage)
MAX_STAGES = 16
SMEM_RESERVE = 1024 + 16 * MAX_STAGES


class TileCandidate(tuple):
    """(bm, bn, bk) with its autotune spelling. A tuple subclass so the
    candidate sorts/equates by geometry and still carries the name."""

    __slots__ = ()

    def __new__(cls, bm: int, bn: int, bk: int):
        return super().__new__(cls, (int(bm), int(bn), int(bk)))

    @property
    def bm(self) -> int:
        return self[0]

    @property
    def bn(self) -> int:
        return self[1]

    @property
    def bk(self) -> int:
        return self[2]

    @property
    def name(self) -> str:
        return f"pallas:{self[0]}x{self[1]}x{self[2]}"

    def __repr__(self):
        return f"TileCandidate({self[0]}, {self[1]}, {self[2]})"


def parse_gemm_candidate(name: str) -> TileCandidate:
    """``"pallas:BMxBNxBK"`` → :class:`TileCandidate` (the autotune cache
    stores names; the dispatcher needs numbers back)."""
    if not isinstance(name, str) or not name.startswith("pallas:"):
        raise ValueError(f"not a pallas gemm candidate: {name!r}")
    parts = name[len("pallas:"):].split("x")
    if len(parts) != 3:
        raise ValueError(f"malformed gemm candidate: {name!r}")
    return TileCandidate(*(int(p) for p in parts))


def parse_bsr_candidate(name: str) -> int | None:
    """``"chunked:N"`` → N, ``"pallas"`` → None (the BSR kernel has no
    free tiling — its block shape is the matrix's)."""
    if name == "pallas":
        return None
    if not isinstance(name, str) or not name.startswith("chunked:"):
        raise ValueError(f"not a bsr candidate: {name!r}")
    return int(name[len("chunked:"):])


def _stage_bytes(bm: int, bn: int, bk: int) -> int:
    """One ring stage: the A and B tiles in rows of bk 4-byte words (the
    TF32 halves of 16 f32 values of k, or 64 bf16 values)."""
    return (bm + bn) * bk * 4


def stages(bm: int, bn: int, bk: int) -> int:
    """The ring stages the kernel keeps: as many as fit the budget, at most
    ``MAX_STAGES`` (csrc/gemm.cu's ``Cfg::kStages``)."""
    return min(MAX_STAGES,
               (SMEM_BUDGET_BYTES - SMEM_RESERVE) // _stage_bytes(bm, bn, bk))


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one block (``Cfg::kSmem``): the ring's
    stages and the reserve. The same for f32 and bf16 operands: a stage's
    rows are 128 bytes either way."""
    return SMEM_RESERVE + stages(bm, bn, bk) * _stage_bytes(bm, bn, bk)


def is_instantiated(c: TileCandidate) -> bool:
    """Whether the library holds a kernel for tile ``c``."""
    return c.bm in BM_AXIS and c.bn in BN_AXIS and c.bk in BK_AXIS


def _pad_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _fit(dim: int, axis: tuple[int, ...], cap: int) -> int:
    """The smallest axis value that covers ``dim``, but no more than ``cap``
    (the largest value when none covers it)."""
    covering = [v for v in axis if v >= dim]
    return min(cap, covering[0] if covering else axis[-1])


def _clamp(m: int, n: int, k: int, c: TileCandidate) -> TileCandidate:
    """The tile the kernel will actually run (the counterpart of the JAX
    family's clamp): a block dim wider than the problem needs shrinks to the
    smallest instantiated value that still covers the problem, so on small
    problems distinct candidates collapse to one kernel — the family dedupes
    on this, never timing the same kernel twice under two names."""
    return TileCandidate(_fit(m, BM_AXIS, c.bm), _fit(n, BN_AXIS, c.bn),
                         _fit(k, BK_AXIS, c.bk))


def select_tile(m: int, n: int, k: int, bm: int, bn: int,
                bk: int) -> TileCandidate:
    """The instantiated tile ``pallas_matmul(a, b, bm, bn, bk)`` runs: each
    requested dim rounds down to the largest axis value not above it (the
    smallest value when none is), then clamps to the problem as
    :func:`_clamp` does. A family candidate selects itself."""
    def floor(v, axis):
        below = [x for x in axis if x <= v]
        return below[-1] if below else axis[0]

    return _clamp(m, n, k, TileCandidate(floor(bm, BM_AXIS),
                                         floor(bn, BN_AXIS),
                                         floor(bk, BK_AXIS)))


def gemm_traffic_bytes(m: int, k: int, n: int, bm: int, bn: int, bk: int,
                       itemsize: int = 4) -> float:
    """Analytic device-memory traffic of the (bm, bn, bk)-blocked m×k×n
    matmul, the ranking score (the JAX family's model): each of the
    (mp/bm)·(np/bn) output tiles streams its full A row-panel and B
    column-panel, so A moves once per output-column block and B once per
    output-row block, and the tile grid's overhang counts as traffic."""
    mp, np_, kp = _pad_up(m, bm), _pad_up(n, bn), _pad_up(k, bk)
    a_reads = mp * kp * (np_ // bn) * itemsize
    b_reads = kp * np_ * (mp // bm) * itemsize
    out_writes = mp * np_ * itemsize
    return float(a_reads + b_reads + out_writes)


def gemm_candidates(m: int, k: int, n: int, itemsize: int = 4,
                    max_candidates: int = 6) -> list[TileCandidate]:
    """The (bm, bn, bk) family for an m×k×n problem: enumerate the
    instantiated tiles, clamp to the problem (dedupe collapsed tiles), drop
    those over the shared-memory budget, rank by
    :func:`gemm_traffic_bytes`, return the ``max_candidates`` best. Always
    non-empty: every tile's ring is cut to the budget."""
    if min(m, k, n) < 1:
        raise ValueError(f"degenerate problem: {m}x{k}x{n}")
    seen: dict[TileCandidate, float] = {}
    for bm in BM_AXIS:
        for bn in BN_AXIS:
            for bk in BK_AXIS:
                c = _clamp(m, n, k, TileCandidate(bm, bn, bk))
                if c in seen or smem_bytes(*c) > SMEM_BUDGET_BYTES:
                    continue
                seen[c] = gemm_traffic_bytes(m, k, n, c.bm, c.bn, c.bk,
                                             itemsize)
    ranked = sorted(seen.items(), key=lambda kv: (kv[1], kv[0]))
    return [c for c, _ in ranked[:max_candidates]]


def bsr_candidates(block_size: int, nnzb: int, p: int) -> list[str]:
    """The BSR SpMM family: the chunked formulation at power-of-two
    ``chunk_blocks`` sizes bracketing its default ~32 MB-buffer rule
    (:func:`~marlin_tpu_torch.ops.sparse_bsr.bsr_spmm`'s default — smaller
    chunks cut the gather and product buffers, larger ones launch fewer
    batches), plus the kernel. Strings, ready for the autotune cache; decode
    with :func:`parse_bsr_candidate`. The budget counts elements, as in the
    JAX package."""
    if block_size < 1 or nnzb < 1 or p < 1:
        raise ValueError(
            f"degenerate bsr problem: bs={block_size} nnzb={nnzb} p={p}")
    default = max(1, (1 << 23) // (block_size * max(p, block_size)))
    sizes = sorted({max(1, min(c, nnzb))
                    for c in (default // 4, default // 2, default,
                              default * 2)})
    return [f"chunked:{c}" for c in sizes] + ["pallas"]
