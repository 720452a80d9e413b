"""The hand-written kernel layer: a tensor-core GEMM and the pad-masking fill.

Counterpart of ``marlin_tpu/ops/pallas_kernels.py``, whose two Pallas TPU
kernels become CUDA C++ kernels for Hopper (``csrc/gemm.cu`` and
``csrc/masked_fill.cu``, built and bound by ``ops/_build.py``):

- :func:`pallas_matmul` — ``a @ b`` with f32 accumulation, output in the
  input dtype. Reached through ``ops.gemm(backend="pallas")`` and the tile
  tuner ``parallel.autotune.tune_gemm``/``best_gemm``; the default dense
  multiply leaves its product to ``torch.matmul``, as the JAX package leaves
  it to XLA.
- :func:`masked_fill` — zero everything outside the logical (rows, cols)
  region, in one pass.

Each wrapper keeps the name and contract of its JAX counterpart and runs:

- its kernel for a CUDA tensor (or raises: a failed build or launch is an
  error, never a fallback);
- its plain PyTorch version (``*_plain``, beside it here) for a CPU tensor.

``<wrapper>.launches`` counts kernel launches, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .tile_family import select_tile

_GEMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_matmul(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and "
                         f"{b.device}")
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")


def pallas_matmul_plain(a: torch.Tensor, b: torch.Tensor, bm: int = 256,
                        bn: int = 256, bk: int = 512) -> torch.Tensor:
    """The plain version of the GEMM kernel: pad to the tile grid of the tile
    the kernel would run, multiply in f32, cast to ``a.dtype``, slice back."""
    _check_matmul(a, b)
    m, k = a.shape
    n = b.shape[1]
    t = select_tile(m, n, k, bm, bn, bk)
    mp, np_, kp = (-(-m // t.bm) * t.bm, -(-n // t.bn) * t.bn,
                   -(-k // t.bk) * t.bk)
    a_p = F.pad(a.float(), (0, kp - k, 0, mp - m))
    b_p = F.pad(b.float(), (0, np_ - n, 0, kp - k))
    return (a_p @ b_p)[:m, :n].to(a.dtype)


def _k_stride(k: int, itemsize: int) -> int:
    """Values of k in a row of the K-major operands: k rounded up to the 16
    values whose TF32 halves the f32 layout keeps side by side, or for bf16
    to 16 bytes, the step TMA requires of a global stride."""
    e = 16 if itemsize == 4 else 16 // itemsize
    return -(-k // e) * e


def gemm_prepare(a: torch.Tensor, b: torch.Tensor):
    """The GEMM's pre-pass on the card: ``(ks, a_k, bt_k)``, the K-major
    operands ``csrc/gemm.cu`` reads, A's m rows and B's n columns, ``ks``
    values of k each (zeros past k). f32 splits every value into its TF32
    halves and keeps them side by side, hi then lo, in blocks of 16 values:
    rows of ``2 * ks`` floats. bf16 only transposes B, and uses ``a`` itself
    where its rows are 16-byte aligned. Operands as :func:`pallas_matmul`
    checks them."""
    m, k = a.shape
    n = b.shape[1]
    ks = _k_stride(k, a.element_size())
    w = 2 * ks if a.dtype == torch.float32 else ks
    copy_a = w != k or a.data_ptr() % 16 != 0
    scratch = torch.empty(((m if copy_a else 0) + n) * w, dtype=a.dtype,
                          device=a.device)
    a_k = scratch[:m * w].view(m, w) if copy_a else a
    bt_k = scratch[scratch.numel() - n * w:].view(n, w)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_gemm_prep(_GEMM_DTYPES[a.dtype], a.data_ptr(),
                                   b.data_ptr(), a_k.data_ptr(),
                                   bt_k.data_ptr(), m, n, k, ks, stream)
    _build.check(lib, err, f"pallas_matmul pre-pass {m}x{k}x{n}")
    return ks, a_k, bt_k


def gemm_prepare_b(b: torch.Tensor):
    """B alone through the GEMM's pre-pass on the card (A's copy skipped):
    ``(ks, bt_k)``, B's n columns as K-major rows of ``ks`` values of k, laid
    out as :func:`gemm_prepare` lays them out. The BSR kernel's right
    operand; ``b`` contiguous, f32 or bf16."""
    k, n = b.shape
    ks = _k_stride(k, b.element_size())
    w = 2 * ks if b.dtype == torch.float32 else ks
    bt_k = torch.empty((n, w), dtype=b.dtype, device=b.device)
    lib = _build.load_library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        # a == a_k tells the pre-pass to skip A
        err = lib.marlin_gemm_prep(_GEMM_DTYPES[b.dtype], b.data_ptr(),
                                   b.data_ptr(), b.data_ptr(),
                                   bt_k.data_ptr(), 0, n, k, ks, stream)
    _build.check(lib, err, f"gemm_prepare_b {k}x{n}")
    return ks, bt_k


def pallas_matmul(a: torch.Tensor, b: torch.Tensor, bm: int = 256,
                  bn: int = 256, bk: int = 512) -> torch.Tensor:
    """Tiled ``a @ b`` with f32 accumulation and the output in ``a.dtype``
    (f32 or bf16 on the card) — same contract as ops.gemm.

    ``(bm, bn, bk)`` selects one of the kernel's instantiated CTA tiles
    (:func:`~marlin_tpu_torch.ops.tile_family.select_tile`); the tile family
    proposes exactly those. On the card: the pre-pass
    (:func:`gemm_prepare`), then the tensor-core kernel, which masks the
    ragged edge itself; f32 runs three TF32 products (3xTF32), bf16 one."""
    _check_matmul(a, b)
    if a.device.type == "cpu":
        return pallas_matmul_plain(a, b, bm, bn, bk)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_matmul: unsupported device {a.device}")
    if a.dtype not in _GEMM_DTYPES:
        raise TypeError(f"pallas_matmul: the kernel takes float32 or bfloat16, "
                        f"got {a.dtype}")
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    t = select_tile(m, n, k, bm, bn, bk)
    ks, a_k, bt_k = gemm_prepare(a, b)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    # the kernel's count of tile waves issued, which its blocks wait on
    waves = torch.zeros(1, dtype=torch.int32, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_gemm(_GEMM_DTYPES[a.dtype], t.bm, t.bn, t.bk,
                              a_k.data_ptr(), bt_k.data_ptr(), out.data_ptr(),
                              m, n, k, ks, waves.data_ptr(), stream)
    _build.check(lib, err, f"pallas_matmul {m}x{k}x{n} tile {t.name}")
    pallas_matmul.launches += 1
    return out


pallas_matmul.launches = 0


def masked_fill_plain(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The plain version of the fill kernel: an index comparison and
    ``torch.where``."""
    r = torch.arange(x.shape[0], device=x.device)[:, None] < rows
    c = torch.arange(x.shape[1], device=x.device)[None, :] < cols
    return torch.where(r & c, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def masked_fill(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero everything outside the logical (rows, cols) region — the pad
    invariant restore, as a single pass. Returns a new tensor; values inside
    the region keep their bits."""
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return masked_fill_plain(x, rows, cols)
    if x.device.type != "cuda":
        raise ValueError(f"masked_fill: unsupported device {x.device}")
    if x.element_size() not in (2, 4, 8):
        raise TypeError(f"masked_fill: unsupported element size of {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_masked_fill(x.data_ptr(), out.data_ptr(),
                                     x.shape[0], x.shape[1], int(rows),
                                     int(cols), x.element_size(), stream)
    _build.check(lib, err, f"masked_fill {tuple(x.shape)}")
    masked_fill.launches += 1
    return out


masked_fill.launches = 0

