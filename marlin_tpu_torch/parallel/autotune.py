"""Empirical multiply-strategy, GEMM-tile and BSR-backend autotuning.

Counterpart of ``marlin_tpu/parallel/autotune.py``. The reference picks its
multiply statically (DenseVecMatrix.scala:196-231, MTUtils.scala:150-175) and
ships ``RMMcompare`` for a human to time the candidates; here each viable
engine — a multiply strategy, a tile of the hand-written GEMM against
``torch.matmul``, or a BSR SpMM backend (the chunked formulation at a few
chunk sizes against the BSR kernel) — is timed on the live operands once per
configuration, and the winner is cached in-process and on disk
(``config.autotune_cache_path``).

Every candidate the tuners time must run: on the card the tile family
proposes only tiles the kernel library was built with and the BSR family
only the kernel and the chunked path, so a candidate that raises is a bug and
its error propagates (the JAX tuner skips such a candidate, because its
generator can propose a tile Mosaic rejects). Only
:class:`~marlin_tpu_torch.parallel.matmul.UnknownStrategyError` from a
multiply strategy is skipped. On the CPU the ``"pallas"`` candidates run the
kernels' plain versions, as every kernel wrapper does for CPU tensors.

Timing: one untimed call first, then ``reps`` calls back to back, forced once
by ``utils.profiling.evaluate`` (``torch.cuda.synchronize`` on the card). The
BSR tuner times card tensors with CUDA events instead, in several rounds, and
counts candidates whose rounds overlap the fastest's as tied (see
:func:`tune_bsr`): at ``bench_all.py`` ``config_bsr``'s shape the kernel and
the best chunk size lie within a few per cent of each other, where two
host-clock repetitions ranked them in either order from one run to the next.
"""

from __future__ import annotations

import json
import os
import platform
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..config import get_config, resolve_device
from .matmul import UnknownStrategyError

__all__ = ["tune_multiply", "best_strategy", "tune_gemm", "best_gemm",
           "tune_bsr", "best_bsr_strategy", "clear_cache"]

_CACHE: dict[tuple, str] = {}

# Disk layer: tuned winners persist across processes, keyed by the
# stringified in-memory key, which carries shapes, dtypes, precision, mesh
# shape and the device's name — an entry never leaks across a hardware
# change. Versioned like the JAX package's file; the file name differs, so
# the two packages never read each other's winners.
_DISK_LOCK = threading.Lock()
_disk: dict[str, str] | None = None
_disk_path_loaded: str | None = None
_DISK_VERSION = 2
_DEFAULT_PATH = (Path(__file__).resolve().parents[2] / "build"
                 / "marlin_tpu_torch" / "autotune.json")


def _disk_path() -> str | None:
    """Resolved persistence path; None when disabled (config path "")."""
    p = get_config().autotune_cache_path
    if p == "":
        return None
    return str(_DEFAULT_PATH) if p is None else p


def _disk_layer() -> dict[str, str]:
    """The persisted winners, (re)loaded when first touched or when the
    configured path changed. Unreadable/corrupt files degrade to empty —
    autotune must never fail a multiply over a cache file."""
    global _disk, _disk_path_loaded
    path = _disk_path()
    if path is None:
        return {}
    if _disk is None or _disk_path_loaded != path:
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("__version__") != _DISK_VERSION:
                _disk = {}
            else:
                _disk = {k: v for k, v in data.items() if isinstance(v, str)}
        except (OSError, ValueError):
            _disk = {}
        _disk_path_loaded = path
    return _disk


def _persist(key: tuple, winner: str) -> None:
    """Merge one winner into the disk layer atomically (tmp + rename), the
    file re-read under a lock first so concurrent writers' winners are kept
    (threads share ``_DISK_LOCK``; processes a ``fcntl`` lock on a sidecar
    file)."""
    global _disk
    path = _disk_path()
    if path is None:
        return
    with _DISK_LOCK:
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        except OSError:
            return  # read-only FS: in-process cache still works
        import fcntl

        with open(path + ".lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            _disk = None  # force a fresh read: pick up other processes' writes
            layer = _disk_layer()
            layer[repr(key)] = winner
            try:
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                           suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump({"__version__": _DISK_VERSION, **layer}, f,
                              indent=1, sort_keys=True)
                os.replace(tmp, path)
            except OSError:
                pass


def _device_sig(device: torch.device) -> tuple[str, str]:
    """(platform, device name) — the hardware half of every cache key."""
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return device.type, platform.processor() or platform.machine()


def _operand_meta(other):
    """(shape, dtype, spec) of the right operand — spec present only for
    distributed matrices (a raw tensor has no layout of its own)."""
    data = getattr(other, "data", other)
    shape = tuple(getattr(other, "shape", None) or np.shape(data))
    dtype = getattr(data, "dtype", torch.float32)
    spec = tuple(getattr(other, "spec", ()) or ())
    return shape, dtype, spec


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size() \
        if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def _cache_key(mat, other, precision):
    other_shape, other_dtype, other_spec = _operand_meta(other)
    mesh = mat.mesh
    return (
        type(mat).__name__,
        mat.shape,
        tuple(mat.spec),
        other_shape,
        other_spec,
        str(mat.data.dtype),
        str(other_dtype),
        precision,
        tuple(sorted(mesh.shape.items())),
        *_device_sig(mesh.device),
    )


def _candidates(mat, other_shape, other_itemsize) -> list[str]:
    """Viable engines: always gspmd + rmm + ring; the two broadcast forms
    only when the replicated operand is within 4x the configured threshold.
    Each operand is sized with its OWN itemsize."""
    m, k = mat.shape
    n = other_shape[1]
    a_itemsize = mat.data.element_size()
    threshold = 4 * get_config().broadcast_threshold_mb
    cands = ["gspmd", "rmm", "ring"]
    if k * n * other_itemsize / 1e6 <= threshold:
        cands.append("broadcast")
    if m * k * a_itemsize / 1e6 <= threshold:
        cands.append("broadcast_a")
    return cands


def _time(run, reps: int) -> float:
    """Seconds per call of ``run``: one untimed call, then ``reps`` timed."""
    from ..utils.profiling import evaluate

    evaluate(run())
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = run()
    evaluate(out)
    return (time.perf_counter() - t0) / reps


def tune_multiply(mat, other, strategies=None, reps: int = 3,
                  precision: str | None = None) -> list[tuple[str, float]]:
    """Time each candidate strategy for ``mat.multiply(other)`` and return
    ``[(strategy, seconds_per_multiply), ...]`` fastest-first.

    With the default (full) candidate set the winner is cached, so
    ``strategy="tuned"`` multiplies of the same configuration dispatch
    straight to it; an explicit ``strategies`` subset is timed without
    touching the cache."""
    other_shape, other_dtype, _ = _operand_meta(other)
    if len(other_shape) != 2:
        raise ValueError(
            f"tune_multiply needs a 2-D right operand, got shape {other_shape}"
            " — matrix @ vector dispatch does not go through the tuner"
        )
    if mat.shape[1] != other_shape[0]:
        raise ValueError(f"inner dim mismatch: {mat.shape} @ {other_shape}")
    explicit = strategies is not None
    if not explicit:
        strategies = _candidates(mat, other_shape, _itemsize(other_dtype))
    results = []
    for s in strategies:
        try:
            secs = _time(lambda: mat.multiply(other, strategy=s,
                                              precision=precision), reps)
        except UnknownStrategyError:
            continue  # a rejected name is skippable; anything else surfaces
        results.append((s, secs))
    if not results:
        raise ValueError("no viable multiply strategy could be timed")
    results.sort(key=lambda kv: kv[1])
    if not explicit:
        key = _cache_key(mat, other, precision)
        _CACHE[key] = results[0][0]
        _persist(key, results[0][0])
    return results


def best_strategy(mat, other, precision: str | None = None) -> str:
    """Cached winner for this configuration — memory layer first, then the
    on-disk layer, tuning only on a miss in both."""
    from .matmul import _STRATEGIES

    key = _cache_key(mat, other, precision)
    if key not in _CACHE:
        with _DISK_LOCK:
            persisted = _disk_layer().get(repr(key))
        if persisted in _STRATEGIES:
            _CACHE[key] = persisted
        else:
            tune_multiply(mat, other, precision=precision)
    return _CACHE[key]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device())


def _gemm_key(m: int, k: int, n: int, dtype, device: torch.device) -> tuple:
    return ("gemm", (int(m), int(k), int(n)), str(dtype), *_device_sig(device))


def tune_gemm(a, b, candidates=None, reps: int = 3) -> list[tuple[str, float]]:
    """Time ``torch.matmul`` (``"xla"``) against the hand-written GEMM's tile
    family for the local ``a @ b`` and return ``[(candidate, seconds)]``
    fastest-first. Default candidates come from
    :func:`~marlin_tpu_torch.ops.tile_family.gemm_candidates` plus ``"xla"``;
    the winner is cached (memory + disk, device-name keyed) for
    :func:`best_gemm`. An explicit ``candidates`` subset is timed without
    touching the cache."""
    from ..ops import tile_family
    from ..ops.local import gemm as xla_gemm
    from ..ops.pallas_kernels import pallas_matmul

    a, b = _as_tensor(a), _as_tensor(b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dim mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    explicit = candidates is not None
    if candidates is None:
        candidates = ["xla"] + [c.name for c in tile_family.gemm_candidates(
            m, k, n, a.element_size())]

    def run(name):
        if name == "xla":
            return xla_gemm(a, b)
        t = tile_family.parse_gemm_candidate(name)
        return pallas_matmul(a, b, bm=t.bm, bn=t.bn, bk=t.bk)

    results = sorted(((name, _time(lambda: run(name), reps))
                      for name in candidates), key=lambda kv: kv[1])
    if not results:
        raise ValueError("no gemm candidate to time")
    if not explicit:
        key = _gemm_key(m, k, n, a.dtype, a.device)
        _CACHE[key] = results[0][0]
        _persist(key, results[0][0])
    return results


def _valid_gemm_name(name) -> bool:
    if name == "xla":
        return True
    try:
        from ..ops import tile_family

        # a name from an older family parses but has no kernel: re-tune
        return tile_family.is_instantiated(
            tile_family.parse_gemm_candidate(name))
    except (TypeError, ValueError):
        return False


def best_gemm(a, b, reps: int = 3) -> str:
    """Cached winning gemm candidate for these operands' configuration
    (``"xla"`` or ``"pallas:BMxBNxBK"``), tuning on a miss in both cache
    layers. Persisted names are validated before trust."""
    a, b = _as_tensor(a), _as_tensor(b)
    key = _gemm_key(a.shape[0], a.shape[1], b.shape[1], a.dtype, a.device)
    if key not in _CACHE:
        with _DISK_LOCK:
            persisted = _disk_layer().get(repr(key))
        if _valid_gemm_name(persisted):
            _CACHE[key] = persisted
        else:
            tune_gemm(a, b, reps=reps)
    return _CACHE[key]


def _bsr_key(bsr, p: int, dtype, device: torch.device) -> tuple:
    return ("bsr", bsr.shape, bsr.block_size, bsr.nnzb, int(p), str(dtype),
            *_device_sig(device))


# card tensors: rounds of back-to-back calls per BSR candidate, timed with
# CUDA events (CPU tensors keep the JAX package's one round of 2 calls)
_BSR_CARD_ROUNDS = 5
_BSR_CARD_REPS = 5


def _rounds(run, reps: int, rounds: int, device: torch.device) -> list[float]:
    """Seconds per call of ``run`` in each of ``rounds`` rounds of ``reps``
    back-to-back calls, after one untimed call: CUDA events on the card, the
    host clock (:func:`_time`) elsewhere."""
    if device.type != "cuda":
        return [_time(run, reps) for _ in range(rounds)]
    with torch.cuda.device(device):
        run()
        out = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3 / reps)
    return out


def _bsr_winner(samples: dict[str, list[float]]) -> str:
    """The BSR candidate ``"auto"`` runs, from each candidate's per-round
    seconds: the fastest by median, unless the kernel's rounds overlap the
    fastest's (its quickest round no slower than their slowest). Within that
    spread the two are a tie, and the kernel takes it: every output element
    has one writer (the chunked path's ``index_add_`` sums with atomics on
    the card), and it allocates no chunk buffer."""
    fastest = min(samples, key=lambda nm: float(np.median(samples[nm])))
    kernel = samples.get("pallas")
    if kernel is not None and min(kernel) <= max(samples[fastest]):
        return "pallas"
    return fastest


def tune_bsr(bsr, b, candidates=None,
             reps: int | None = None) -> list[tuple[str, float]]:
    """Time the BSR SpMM family (the chunked formulation at a few
    ``chunk_blocks`` and the kernel,
    :func:`~marlin_tpu_torch.ops.tile_family.bsr_candidates`) for
    ``bsr @ b`` and return ``[(candidate, median seconds)]``, the winner
    (:func:`_bsr_winner`) first and the rest fastest-first, caching the
    winner (memory + disk, device-name keyed) for :func:`best_bsr_strategy`.
    Card tensors are timed in 5 rounds of ``reps`` (default 5) calls by CUDA
    events; CPU tensors in one round of ``reps`` (default 2) calls by the host
    clock. An explicit ``candidates`` subset is timed without
    touching the cache."""
    from ..ops import tile_family
    from ..ops.sparse_bsr import _dense_operand

    arr = _dense_operand(b)
    p = arr.shape[1] if arr.ndim == 2 else 1
    on_card = arr.device.type == "cuda"
    reps = reps or (_BSR_CARD_REPS if on_card else 2)
    rounds = _BSR_CARD_ROUNDS if on_card else 1
    explicit = candidates is not None
    if candidates is None:
        candidates = tile_family.bsr_candidates(bsr.block_size, bsr.nnzb, p)
    if not candidates:
        raise ValueError("no bsr candidate to time")

    def run(name):
        cb = tile_family.parse_bsr_candidate(name)
        if cb is None:
            return bsr.multiply(arr, backend="pallas")
        return bsr.multiply(arr, chunk_blocks=cb)

    samples = {name: _rounds(lambda: run(name), reps, rounds, arr.device)
               for name in candidates}
    winner = _bsr_winner(samples)
    results = sorted(((name, float(np.median(s))) for name, s in
                      samples.items()),
                     key=lambda kv: (kv[0] != winner, kv[1]))
    if not explicit:
        key = _bsr_key(bsr, p, arr.dtype, arr.device)
        _CACHE[key] = winner
        _persist(key, winner)
    return results


def _valid_bsr_name(name) -> bool:
    try:
        from ..ops import tile_family

        tile_family.parse_bsr_candidate(name)
        return True
    except (TypeError, ValueError):
        return False


def best_bsr_strategy(bsr, b, reps: int | None = None) -> str:
    """Cached winning BSR candidate (``"chunked:N"`` or ``"pallas"``) for
    this (shape, block structure, panel width, dtype, device) configuration,
    tuning on a miss in both cache layers — the consultation point of
    ``BsrMatrix.multiply(backend="auto")``. Persisted names are validated
    before trust."""
    from ..ops.sparse_bsr import _dense_operand

    arr = _dense_operand(b)
    p = arr.shape[1] if arr.ndim == 2 else 1
    key = _bsr_key(bsr, p, arr.dtype, arr.device)
    if key not in _CACHE:
        with _DISK_LOCK:
            persisted = _disk_layer().get(repr(key))
        if _valid_bsr_name(persisted):
            _CACHE[key] = persisted
        else:
            tune_bsr(bsr, arr, reps=reps)
    return _CACHE[key]


def clear_cache() -> None:
    """Clear BOTH layers: the in-process dict and the persisted file."""
    global _disk, _disk_path_loaded
    _CACHE.clear()
    with _DISK_LOCK:
        _disk, _disk_path_loaded = None, None
        path = _disk_path()
        if path is not None:
            for p in (path, path + ".lock"):
                try:
                    os.remove(p)
                except OSError:
                    pass
