"""Build and bind the hand-written CUDA kernels.

The sources in ``marlin_tpu_torch/csrc/`` have a plain C interface and make
two libraries: ``"lr"``, the logistic-gradient step (``lr_gradient*.cu``)
alone, and ``"kernels"``, every other source, so a process that runs only
logistic regression builds only its kernel. At a library's first use each of
its ``.cu`` is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one shared library, which is loaded
with ``ctypes``. It lands in ``build/marlin_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of the library's name, its sources, the
headers they may include (``*.cuh``) and the flags, so an edited file rebuilds
and an unchanged tree loads at once. Nothing is built at import.

``nvcc`` is taken from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``.
A failed build raises :class:`KernelBuildError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..obs import trace as obs_trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "marlin_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the sources of the "lr" library; the "kernels" library is every other one
LR_SOURCES = ("lr_gradient.cu", "lr_gradient_bf16.cu", "lr_gradient_f64.cu")
LIB_NAMES = {"kernels": "libmarlin_kernels.so", "lr": "libmarlin_lr.so"}
# Flags for one source on top of NVCC_FLAGS. At ptxas's default -O3 the
# backward kernels' schedule, and that of the forward's d <= 256 instances,
# holds so many loads in flight that they spill past their 255 registers;
# -O1 keeps them all without a spill (the backward's sixteen at the same
# speed on an H100).
SOURCE_FLAGS = {"flash_attention_bwd.cu": ("-Xptxas", "-O1"),
                "flash_attention_wide.cu": ("-Xptxas", "-O1")}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # the "kernels" library, once loaded
_lr_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _sources(lib: str = "kernels") -> list[Path]:
    if lib not in LIB_NAMES:
        raise ValueError(f"no kernel library {lib!r}; the libraries are "
                         f"{sorted(LIB_NAMES)}")
    return [p for p in sorted(CSRC.glob("*.cu"))
            if (p.name in LR_SOURCES) == (lib == "lr")]


def _digest(lib: str = "kernels") -> str:
    """A hash of the library's name, the flags, its sources and the headers
    they may include, so an edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    h.update(lib.encode())
    for src in _sources(lib) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                               "/usr/local/cuda/bin and PATH)")
    return found


def build_dir(lib: str = "kernels") -> Path:
    return BUILD_ROOT / _digest(lib)


def _compile(out_dir: Path, lib: str = "kernels") -> None:
    """One nvcc per source, all running at once, then one link. The compiler's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel) is kept
    in ``ptxas.log`` beside the library."""
    nvcc = _nvcc()
    procs = []
    for src in _sources(lib):
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / (LIB_NAMES[lib] + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out_dir / LIB_NAMES[lib])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: left to ctypes' default they
    # would be passed as 32-bit ints and cut
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # dtype, a, b, a_k, bt_k, m, n, k, ks, stream
    lib.marlin_gemm_prep.argtypes = [i, p, p, p, p, ll, ll, ll, ll, p]
    lib.marlin_gemm_prep.restype = i
    # dtype, bm, bn, bk, a_k, bt_k, c, m, n, k, ks, waves, stream
    lib.marlin_gemm.argtypes = [i, i, i, i, p, p, p, ll, ll, ll, ll, p, p]
    lib.marlin_gemm.restype = i
    lib.marlin_masked_fill.argtypes = [p, p, ll, ll, ll, ll, i, p]
    lib.marlin_masked_fill.restype = i
    f = ctypes.c_float
    # dtype, q, k_pages, v_pages, tables, lengths, out, part, B, kvh, group,
    # dh, page_len, W, split_pages, splits, chunk_heads, rows, vec, score_div,
    # stream
    lib.marlin_paged_attention.argtypes = [i] + [p] * 7 + [i] * 11 + [f, p]
    lib.marlin_paged_attention.restype = i
    # dtype, q, k, v, m, l, acc in and out, H, sq, skv, dqk, dv, strides, ...
    lib.marlin_flash_fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                     i, ll, ll, ll, ll, ll, ll, i, i, i, i, f,
                                     p]
    lib.marlin_flash_fwd.restype = i
    # the wgmma design's entry takes the same arguments
    lib.marlin_flash_fwd_sm90.argtypes = lib.marlin_flash_fwd.argtypes
    lib.marlin_flash_fwd_sm90.restype = i
    # dtype, q, k, v, dout, lse, delta, outputs..., then the shared tail
    # (H, sq, skv, dqk, dv, strides, ...)
    bwd_tail = [i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, f,
                p]
    lib.marlin_flash_bwd_dkv.argtypes = [i] + [p] * 8 + bwd_tail
    lib.marlin_flash_bwd_dkv.restype = i
    lib.marlin_flash_bwd_dq.argtypes = [i] + [p] * 7 + bwd_tail
    lib.marlin_flash_bwd_dq.restype = i
    # dtype, blocks, bcols, row_ptr, b, out, m, n, p, bs, n_block_rows, stream
    lib.marlin_bsr_spmm.argtypes = [i, p, p, p, p, p, ll, ll, ll, i, ll, p]
    lib.marlin_bsr_spmm.restype = i
    # dtype, bm, bn, blocks, bcols, row_ptr, bt_k, out, m, p, ks, bs, nnzb,
    # n_block_rows, stream
    lib.marlin_bsr_spmm_tc.argtypes = [i, i, i, p, p, p, p, p, ll, ll, ll, i,
                                       ll, ll, p]
    lib.marlin_bsr_spmm_tc.restype = i
    return _bind_error_string(lib)


def _bind_lr(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # dtype, x, rows, n, stride, w, partial, slab_rows, chunk_rows, chunks,
    # grid, stream
    lib.marlin_lr_grad.argtypes = [i, p, ll, ll, ll, p, p, i, ll, ll, i, p]
    lib.marlin_lr_grad.restype = i
    # dtype, partial, parts, n, g, w, scale, stream
    lib.marlin_lr_reduce.argtypes = [i, p, ll, ll, p, p, p, p]
    lib.marlin_lr_reduce.restype = i
    return _bind_error_string(lib)


def _bind_error_string(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.marlin_error_string.argtypes = [ctypes.c_int]
    lib.marlin_error_string.restype = ctypes.c_char_p
    return lib


def load_library(lib: str = "kernels") -> ctypes.CDLL:
    """The kernel library ``lib`` (``"kernels"`` or ``"lr"``), built on
    first use. Concurrent processes serialise on a lock file in the build
    directory; threads on a lock here."""
    global _lib, _lr_lib
    with _lock:
        loaded = _lr_lib if lib == "lr" else _lib
        if loaded is not None:
            return loaded
        out_dir = build_dir(lib)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            if not (out_dir / LIB_NAMES[lib]).exists():
                t0 = time.perf_counter()
                with obs_trace.span("build"):
                    _compile(out_dir, lib)
                from ..obs.collectors import record_compile

                record_compile(time.perf_counter() - t0)
        so = ctypes.CDLL(str(out_dir / LIB_NAMES[lib]))
        if lib == "lr":
            _lr_lib = _bind_lr(so)
            return _lr_lib
        _lib = _bind(so)
        return _lib


def ptxas_report(lib: str = "kernels") -> str:
    """The ``-Xptxas -v`` output of the library's current build ("" before
    a build)."""
    log = build_dir(lib) / "ptxas.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached: a host query, no
    wait on the card), which the kernels' launch plans size their grids by."""
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.marlin_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
