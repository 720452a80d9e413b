"""BSR (block-sparse row) matrices: structured sparsity as dense block products.

Counterpart of ``marlin_tpu/ops/sparse_bsr.py``. Storage: ``blocks``
``(nnzb, bs, bs)`` dense block data, ``block_rows``/``block_cols`` ``(nnzb,)``
int32 indices into the ``(m/bs × n/bs)`` block grid, kept sorted by block row.
Each stored block contributes one ``(bs × bs) @ (bs × p)`` product to the
output rows of its block row.

Two formulations of ``bsr @ b``, picked by :meth:`BsrMatrix.multiply`:

- :func:`bsr_spmm` (``"chunked"``): chunks of stored blocks gather their B
  panels by block column, multiply with one ``torch.bmm`` and ``index_add_``
  the products into their block rows. The JAX package computes this outside
  any Pallas kernel, with XLA's einsum and segment-sum, so here it stays
  PyTorch's.
- :func:`bsr_spmm_pallas` (``"pallas"``): the hand-written CUDA kernel
  ``csrc/bsr_spmm.cu`` (the port of the TPU kernel ``_bsr_pallas_kernel``):
  one thread block per output tile loops over its block row's blocks, so no
  product is materialised and nothing is scattered. Block sizes that are
  multiples of 64 run on the tensor cores (3xTF32 ``wgmma`` for f32, one bf16
  pass for bf16, fed by TMA, after the GEMM's pre-pass of B); the rest on the
  CUDA cores (:func:`bsr_tile` says which). For CPU tensors it runs its plain
  version, :func:`bsr_spmm_pallas_plain`.

``"auto"`` asks the autotune ranking over both
(:func:`~marlin_tpu_torch.parallel.autotune.best_bsr_strategy`), timed once
per configuration on the device at hand. The JAX package's speed verdict
between the two was taken on a TPU and does not carry over.

The factories work on the host in numpy, as the JAX package's do (sort and
``reduceat``; a COO input is never densified), and put the result on
``device`` (default: the configured one).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..interop import to_host, to_tensor
from . import _build
from .local import precision_scope
from .pallas_kernels import gemm_prepare_b

__all__ = ["BsrMatrix", "bsr_from_dense", "bsr_from_coo", "bsr_spmm",
           "bsr_spmm_pallas", "bsr_spmm_pallas_plain", "bsr_tile"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class BsrMatrix:
    def __init__(self, blocks, block_rows, block_cols, shape, block_size: int):
        dev = blocks.device if isinstance(blocks, torch.Tensor) else None
        blocks = to_tensor(blocks, device=dev)
        block_rows = to_tensor(block_rows, torch.int32, blocks.device)
        block_cols = to_tensor(block_cols, torch.int32, blocks.device)
        # keep blocks sorted by block row: the kernel walks each block row's
        # blocks as one contiguous range (stable, so the JAX package's order
        # of blocks within a row is kept)
        if block_rows.numel() > 1 and \
                bool((block_rows[1:] < block_rows[:-1]).any()):
            order = torch.argsort(block_rows, stable=True)
            blocks, block_rows, block_cols = (
                blocks[order], block_rows[order], block_cols[order])
        self.blocks = blocks  # (nnzb, bs, bs)
        self.block_rows = block_rows  # (nnzb,) int32
        self.block_cols = block_cols  # (nnzb,) int32
        self.shape = tuple(int(s) for s in shape)
        self.block_size = int(block_size)

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def density(self) -> float:
        nbr = -(-self.shape[0] // self.block_size)
        nbc = -(-self.shape[1] // self.block_size)
        return self.nnzb / max(1, nbr * nbc)

    def to_dense(self) -> torch.Tensor:
        bs = self.block_size
        m, n = self.shape
        nbr, nbc = -(-m // bs), -(-n // bs)
        out = torch.zeros((nbr, nbc, bs, bs), dtype=self.blocks.dtype,
                          device=self.blocks.device)
        out.index_put_((self.block_rows.long(), self.block_cols.long()),
                       self.blocks, accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(nbr * bs, nbc * bs)[:m, :n]

    def multiply(self, b, chunk_blocks: int | None = None,
                 backend: str = "chunked") -> torch.Tensor:
        """``backend="pallas"`` runs the CUDA kernel (:func:`bsr_spmm_pallas`);
        ``"chunked"`` the gather + ``bmm`` + ``index_add_`` formulation;
        ``"auto"`` consults the autotune ranking over both
        (:func:`~marlin_tpu_torch.parallel.autotune.best_bsr_strategy`, timed
        once per configuration, the winner kept per device name)."""
        if backend == "auto":
            if chunk_blocks is not None:
                raise ValueError(
                    "chunk_blocks applies only to backend='chunked'")
            from ..parallel import autotune
            from .tile_family import parse_bsr_candidate

            cb = parse_bsr_candidate(autotune.best_bsr_strategy(self, b))
            if cb is None:
                return bsr_spmm_pallas(self, b)
            return bsr_spmm(self, b, cb)
        if backend == "pallas":
            if chunk_blocks is not None:
                raise ValueError(
                    "chunk_blocks applies only to backend='chunked'")
            return bsr_spmm_pallas(self, b)
        if backend != "chunked":
            raise ValueError(f"unknown BSR backend: {backend!r}")
        return bsr_spmm(self, b, chunk_blocks)

    def __repr__(self):
        return (f"BsrMatrix(shape={self.shape}, bs={self.block_size}, "
                f"nnzb={self.nnzb}, block_density={self.density:.4f})")


def bsr_from_dense(a, block_size: int = 128, tol: float = 0.0,
                   device=None) -> BsrMatrix:
    """Extract the nonzero bs×bs blocks of a dense matrix (zero-padding ragged
    edges). Blocks whose max |entry| <= tol are dropped."""
    a, dtype = to_host(a)
    m, n = a.shape
    bs = block_size
    mp, np_ = -(-m // bs) * bs, -(-n // bs) * bs
    if (mp, np_) != (m, n):
        a = np.pad(a, ((0, mp - m), (0, np_ - n)))
    grid = a.reshape(mp // bs, bs, np_ // bs, bs).transpose(0, 2, 1, 3)
    mags = np.abs(grid).max(axis=(2, 3))
    bi, bj = np.nonzero(mags > tol)
    dev = resolve_device(device)
    return BsrMatrix(to_tensor(grid[bi, bj], dtype, dev),
                     to_tensor(bi, torch.int32, dev),
                     to_tensor(bj, torch.int32, dev), (m, n), bs)


def bsr_from_coo(rows, cols, vals, shape, block_size: int = 128,
                 device=None) -> BsrMatrix:
    """Build BSR directly from COO triplets without ever densifying —
    memory is O(nnzb · bs²) (the BSR itself). Duplicate entries are summed."""
    rows = to_host(rows)[0].astype(np.int64)
    cols = to_host(cols)[0].astype(np.int64)
    vals, dtype = to_host(vals)
    m, n = shape
    bs = block_size
    dev = resolve_device(device)
    if vals.size == 0:
        if dtype is None and vals.dtype == np.int64:
            dtype = torch.float32
        return BsrMatrix(to_tensor(np.zeros((0, bs, bs), vals.dtype), dtype,
                                   dev),
                         torch.zeros((0,), dtype=torch.int32, device=dev),
                         torch.zeros((0,), dtype=torch.int32, device=dev),
                         (m, n), bs)
    nbc = -(-n // bs)
    block_id = (rows // bs) * nbc + (cols // bs)
    uniq, inv = np.unique(block_id, return_inverse=True)
    # sort + reduceat: accumulation in the values' own dtype with O(nnz) extra
    # memory, as in the JAX package
    flat = inv * (bs * bs) + (rows % bs) * bs + (cols % bs)
    order = np.argsort(flat, kind="stable")
    fs, vs = flat[order], vals[order]
    starts = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    sums = np.add.reduceat(vs, starts)
    blocks = np.zeros(len(uniq) * bs * bs, vals.dtype)
    blocks[fs[starts]] = sums
    return BsrMatrix(to_tensor(blocks.reshape(len(uniq), bs, bs), dtype, dev),
                     to_tensor(uniq // nbc, torch.int32, dev),
                     to_tensor(uniq % nbc, torch.int32, dev), (m, n), bs)


def _dense_operand(b) -> torch.Tensor:
    """The right operand as a tensor: a matrix's logical view, a tensor as
    it is, anything else on the configured device."""
    if hasattr(b, "logical"):
        return b.logical()
    return b if isinstance(b, torch.Tensor) else to_tensor(b)


def _check_operands(bsr: BsrMatrix, b: torch.Tensor) -> None:
    if b.ndim != 2 or b.shape[0] != bsr.shape[1]:
        raise ValueError(f"inner dim mismatch: {bsr.shape} @ {tuple(b.shape)}")
    if bsr.blocks.device != b.device:
        raise ValueError(f"operands on different devices: {bsr.blocks.device} "
                         f"and {b.device}")


def bsr_spmm_pallas_plain(bsr: BsrMatrix, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel: an f32 ``torch.bmm`` of every block
    with its gathered B panel (B's rows past n read as zero), ``index_add_`` by
    block row, then a cast to ``promote(blocks, b)``. Block rows with no
    block stay zero."""
    _check_operands(bsr, b)
    m, n = bsr.shape
    bs, p = bsr.block_size, b.shape[1]
    out_dtype = torch.promote_types(bsr.blocks.dtype, b.dtype)
    nbr, np_ = -(-m // bs), -(-n // bs) * bs
    panels = F.pad(b.float(), (0, 0, 0, np_ - n)).reshape(np_ // bs, bs, p)
    out = torch.zeros((nbr, bs, p), dtype=torch.float32, device=b.device)
    if bsr.nnzb:
        with precision_scope("highest"):
            prod = torch.bmm(bsr.blocks.float(),
                             panels[bsr.block_cols.long()])
        out.index_add_(0, bsr.block_rows.long(), prod)
    return out.reshape(nbr * bs, p)[:m].to(out_dtype)


def bsr_tile(bs: int, p: int, n_block_rows: int, sm_count: int,
             itemsize: int):
    """The kernel instance for block size ``bs``: ``(bm, bn)`` of the
    tensor-core instance, or None for the CUDA-core one (``bs`` not a
    multiple of 64, the depth of a bf16 stage). bm is 128 rows (two consumer
    warpgroups) where ``bs`` allows, else 64; bn is 128 columns of p, or 64
    where p is that narrow, where 128-wide tiles would leave SMs idle, or
    for f32 at bm 128 (whose 128 x 128 tile would spill its registers)."""
    if bs % 64:
        return None
    bm = 128 if bs % 128 == 0 else 64
    tiles = n_block_rows * (bs // bm) * -(-p // 128)
    narrow = p <= 64 or tiles < sm_count or (itemsize == 4 and bm == 128)
    return bm, 64 if narrow else 128


def bsr_spmm_pallas(bsr: BsrMatrix, b) -> torch.Tensor:
    """``bsr @ b`` through the CUDA kernel ``csrc/bsr_spmm.cu``: one thread
    block per output tile sums its block row's products in registers, in
    f32, and writes the tile once (block rows with no block are written as
    zeros). f32 and bf16 operands run the kernel, on the tensor cores where
    :func:`bsr_tile` gives a tile (then B goes through the GEMM's pre-pass
    first, one more launch); the result is in ``promote(blocks, b)``.
    Operands wider than f32 go to :func:`bsr_spmm`,
    which accumulates in the promoted type, as the JAX package does. CPU
    tensors run :func:`bsr_spmm_pallas_plain`. A failed build or launch
    raises; ``bsr_spmm_pallas.launches`` counts launches of the kernel,
    ``.prep_launches`` those of the pre-pass."""
    b = _dense_operand(b)
    _check_operands(bsr, b)
    m, _ = bsr.shape
    p = b.shape[1]
    out_dtype = torch.promote_types(bsr.blocks.dtype, b.dtype)
    if torch.promote_types(out_dtype, torch.float32) != torch.float32:
        return bsr_spmm(bsr, b)
    if bsr.nnzb == 0:
        return torch.zeros((m, p), dtype=out_dtype, device=b.device)
    if b.device.type == "cpu":
        return bsr_spmm_pallas_plain(bsr, b)
    if b.device.type != "cuda":
        raise ValueError(f"bsr_spmm_pallas: unsupported device {b.device}")
    # f16 (the one other type within f32) computes as f32
    kdtype = out_dtype if out_dtype in _DTYPES else torch.float32
    bs = bsr.block_size
    nbr = -(-m // bs)
    if m == 0 or p == 0:
        return torch.zeros((m, p), dtype=out_dtype, device=b.device)
    blocks = bsr.blocks.to(kdtype).contiguous()
    bb = b.to(kdtype).contiguous()
    bcols = bsr.block_cols.contiguous()
    # row_ptr[r] = blocks before block row r, from the sorted block rows
    # (torch.bincount would wait on the card for the largest block row)
    row_ptr = torch.searchsorted(
        bsr.block_rows, torch.arange(nbr + 1, dtype=torch.int32,
                                     device=b.device))
    out = torch.empty((m, p), dtype=kdtype, device=b.device)
    tile = bsr_tile(bs, p, nbr, _build.sm_count(b.device), bb.element_size())
    if tile is not None:
        ks, bt_k = gemm_prepare_b(bb)
        if blocks.data_ptr() % 16:  # TMA reads from a 16-byte-aligned base
            blocks = blocks.clone()
    lib = _build.load_library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tile is None:
            err = lib.marlin_bsr_spmm(_DTYPES[kdtype], blocks.data_ptr(),
                                      bcols.data_ptr(), row_ptr.data_ptr(),
                                      bb.data_ptr(), out.data_ptr(), m,
                                      bsr.shape[1], p, bs, nbr, stream)
        else:
            err = lib.marlin_bsr_spmm_tc(
                _DTYPES[kdtype], tile[0], tile[1], blocks.data_ptr(),
                bcols.data_ptr(), row_ptr.data_ptr(), bt_k.data_ptr(),
                out.data_ptr(), m, p, ks, bs, bsr.nnzb, nbr, stream)
    _build.check(lib, err, f"bsr_spmm_pallas {bsr.shape} bs={bs} "
                 f"nnzb={bsr.nnzb} p={p} tile={tile}")
    bsr_spmm_pallas.launches += 1
    bsr_spmm_pallas.prep_launches += tile is not None
    return out if kdtype == out_dtype else out.to(out_dtype)


bsr_spmm_pallas.launches = 0
# launches of the GEMM's pre-pass of B ahead of the tensor-core instance
bsr_spmm_pallas.prep_launches = 0


def bsr_spmm(bsr: BsrMatrix, b, chunk_blocks: int | None = None
             ) -> torch.Tensor:
    """``bsr @ b`` with dense result: chunks of ``chunk_blocks`` stored blocks
    (default: ~32 MB of gather and product buffers, the JAX package's rule)
    gather their B panels, multiply in one ``torch.bmm`` and ``index_add_``
    into their block rows. The last chunk is simply shorter: eager PyTorch
    needs no padding blocks or spill row to keep shapes static. Accumulates
    in ``promote(blocks, b, f32)`` (IEEE f32, no TF32, for f32 and bf16) and
    returns ``promote(blocks, b)``."""
    b = _dense_operand(b)
    _check_operands(bsr, b)
    m, n = bsr.shape
    bs, p = bsr.block_size, b.shape[1]
    if bsr.nnzb == 0:
        return torch.zeros((m, p), dtype=b.dtype, device=b.device)
    np_ = -(-n // bs) * bs
    nbr = -(-m // bs)
    if chunk_blocks is None:
        chunk_blocks = max(1, (1 << 23) // (bs * max(p, bs)))
    nnzb = bsr.nnzb
    chunk = max(1, min(chunk_blocks, nnzb))
    out_dtype = torch.promote_types(bsr.blocks.dtype, b.dtype)
    accum = torch.promote_types(out_dtype, torch.float32)
    panels = F.pad(b.to(accum), (0, 0, 0, np_ - n)).reshape(np_ // bs, bs, p)
    brows, bcols = bsr.block_rows.long(), bsr.block_cols.long()
    out = torch.zeros((nbr, bs, p), dtype=accum, device=b.device)
    with precision_scope("highest"):
        for s in range(0, nnzb, chunk):
            prod = torch.bmm(bsr.blocks[s:s + chunk].to(accum),
                             panels[bcols[s:s + chunk]])
            out.index_add_(0, brows[s:s + chunk], prod)
    return out.reshape(nbr * bs, p)[:m].to(out_dtype)
