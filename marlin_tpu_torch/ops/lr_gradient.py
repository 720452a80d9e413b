"""One step of full-batch logistic-gradient descent over rows of (label,
features), with one read of the stored rows (``csrc/lr_gradient.cuh``, its
entry points in ``csrc/lr_gradient.cu``; built and bound by
``ops/_build.py`` as the ``"lr"`` library).

The rows are read where they lie: column 0 is the label and stands for the
intercept's 1, so no copy of the matrix is made. A step is

    margin = -(w[0] + x @ w[1:]),  mul = 1 / (1 + exp(margin)) - label,
    g = [sum(mul), x.T @ mul],     w = w - g * scale

over the first ``valid_rows`` rows (rows past them, a rank's padding,
contribute nothing). Rows are float32, bfloat16 or float64; the weights,
the gradient and the arithmetic are float64 for float64 rows and float32
otherwise (:func:`step_dtype`). The JAX package has no kernel for it: its
``_lr_fori`` leaves both mat-vecs to XLA over a copy with the intercept in
place of the label.

- :func:`lr_step` runs the kernel on a CUDA tensor it takes and raises, with
  the reason :func:`lr_step_refusal` gives, for any other;
  :func:`lr_step_plain` is the same step in plain PyTorch, its yardstick.
- :func:`lr_plan` is the kernel's cut of the rows into slabs (one stage of
  its shared-memory ring) and chunks (one partial gradient row each).

``lr_step.launches`` counts the gradient kernel's launches, so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import torch

from . import _build

# mirror kStageBytes, kWarps, kRowsKC and kMaxCols in csrc/lr_gradient.cuh
STAGE_BYTES = 34 * 1024
WARPS = 8
ROWS_KC = 32
MAX_COLS = 8192
# rows of a thread's serial run of row terms in a chunk's partial row: a
# chunk is RUN_ROWS rows a warp (one thread a column, wide rows) or RUN_ROWS
# a warp times the warps (a warp a row), before it is rounded to whole slabs
RUN_ROWS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def step_dtype(dtype: torch.dtype) -> torch.dtype:
    """The weights' and the arithmetic's dtype for rows of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def max_cols(dtype: torch.dtype) -> int:
    """The widest row of ``dtype`` the kernel takes: 8192 columns, or as many
    as one stage holds with its alignment's slack."""
    size = torch.empty((), dtype=dtype).element_size()
    return min(MAX_COLS, (STAGE_BYTES - 32) // size)


def _wide(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel splits a row's columns over the block (more than 32
    columns a lane; float64 16, its registers being twice as wide)."""
    kc = ROWS_KC // 2 if dtype == torch.float64 else ROWS_KC
    return n > 32 * kc


def lr_step_refusal(arr: torch.Tensor) -> str | None:
    """Why the kernel does not take ``arr`` (rows of (label, features)), or
    None when it does."""
    if arr.ndim != 2:
        return f"expected a 2-D tensor, got shape {tuple(arr.shape)}"
    if arr.dtype not in _DTYPES:
        return (f"dtype {arr.dtype}: the kernel reads float32, bfloat16 and "
                f"float64")
    n, widest = arr.shape[1], max_cols(arr.dtype)
    if not 1 <= n <= widest:
        return f"{n} columns: the kernel takes 1 to {widest} of {arr.dtype}"
    if n > 1 and arr.stride(1) != 1:
        return (f"column stride {arr.stride(1)}: the kernel reads unit "
                f"strides (.contiguous() makes such a copy)")
    if arr.shape[0] > 1 and arr.stride(0) < n:
        return f"row stride {arr.stride(0)} below the row's {n} columns"
    if arr.data_ptr() % arr.element_size() != 0:
        return "the data is not aligned to its element's size"
    if arr.device.type != "cuda":
        return f"device {arr.device}: the kernel runs on CUDA"
    return None


def lr_plan(rows: int, n: int, stride: int,
            dtype: torch.dtype = torch.float32) -> tuple[int, int, int]:
    """``(slab_rows, chunk_rows, chunks)`` for ``rows`` rows of ``n`` values
    of ``dtype`` ``stride`` values apart: a slab is as many rows as one stage
    holds (a multiple of the warps where a warp takes a row and the stage
    holds that many), a chunk whole slabs of about RUN_ROWS rows a thread's
    serial run."""
    size = torch.empty((), dtype=dtype).element_size()
    fit = (STAGE_BYTES - 32 - size * n) // (size * stride) + 1
    run = RUN_ROWS if _wide(n, dtype) else RUN_ROWS * WARPS
    slab = min(run, fit)
    if not _wide(n, dtype) and slab >= WARPS:
        slab -= slab % WARPS
    chunk = slab * -(-run // slab)
    return slab, chunk, -(-rows // chunk)


def lr_step_plain(arr: torch.Tensor, w: torch.Tensor, scale,
                  valid_rows: int, reduce=None) -> torch.Tensor:
    """The plain version of the kernel's step: the same step over the first
    ``valid_rows`` rows of ``arr`` in place, in PyTorch, in ``w``'s dtype;
    ``reduce`` (the sum over ranks) takes the gradient before the update.
    Returns the new weights."""
    rows = arr[:max(0, min(arr.shape[0], int(valid_rows)))].to(w.dtype)
    margin = -(rows[:, 1:] @ w[1:] + w[0])
    mul = 1.0 / (1.0 + torch.exp(margin)) - rows[:, 0]
    g = torch.cat([mul.sum()[None], rows[:, 1:].T @ mul])
    if reduce is not None:
        g = reduce(g)
    return w - g * scale


def lr_step(arr: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            valid_rows: int, reduce=None) -> torch.Tensor:
    """One step over the first ``valid_rows`` rows of ``arr`` (rows of
    (label, features) on a CUDA card) from the weights ``w``, moved by
    ``scale`` (a one-element tensor on ``arr``'s device) times the gradient;
    ``w`` and ``scale`` are of :func:`step_dtype`. ``reduce`` (the sum over
    ranks) takes the gradient before the update. ``w`` is updated in place
    and returned; two calls on the same input give the same bits."""
    why = lr_step_refusal(arr)
    if why is not None:
        raise ValueError(f"lr_step: {why}")
    n, dtype = arr.shape[1], step_dtype(arr.dtype)
    for name, t, size in (("w", w, n), ("scale", scale, 1)):
        if t.device != arr.device or t.dtype != dtype \
                or t.numel() != size or not t.is_contiguous():
            raise ValueError(f"lr_step: {name} must be {size} contiguous "
                             f"{dtype} on {arr.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    code = _DTYPES[arr.dtype]
    rows = max(0, min(arr.shape[0], int(valid_rows)))
    stride = arr.stride(0) if arr.shape[0] > 1 else n
    slab, chunk, chunks = lr_plan(rows, n, stride, arr.dtype)
    partial = torch.empty((chunks, n), dtype=dtype, device=arr.device)
    lib = _build.load_library("lr")
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream().cuda_stream
        if chunks:
            err = lib.marlin_lr_grad(
                code, arr.data_ptr(), rows, n, stride, w.data_ptr(),
                partial.data_ptr(), slab, chunk, chunks,
                min(chunks, _build.sm_count(arr.device)), stream)
            _build.check(lib, err, f"lr_step {tuple(arr.shape)} {arr.dtype}")
            lr_step.launches += 1
        if reduce is None:
            err = lib.marlin_lr_reduce(code, partial.data_ptr(), chunks, n,
                                       None, w.data_ptr(), scale.data_ptr(),
                                       stream)
        else:
            g = torch.empty(n, dtype=dtype, device=arr.device)
            err = lib.marlin_lr_reduce(code, partial.data_ptr(), chunks, n,
                                       g.data_ptr(), None, None, stream)
            _build.check(lib, err, f"lr_step reduce {n}")
            g = reduce(g).contiguous()
            err = lib.marlin_lr_reduce(code, g.data_ptr(), 1, n, None,
                                       w.data_ptr(), scale.data_ptr(), stream)
        _build.check(lib, err, f"lr_step update {n}")
    return w


lr_step.launches = 0
