"""Sharded array checkpointing and crash-safe training-state checkpoint/resume.

Counterpart of ``marlin_tpu/io/checkpoint.py``, with torch tensors as the
leaves: saved from wherever they lie, restored onto the template leaf's
device and dtype. The on-disk layout is the JAX package's, so a generation
written by either package loads in the other for the same state. That needs
the same leaf order: ``jax.tree.flatten`` visits dict keys *sorted*, while
``torch.utils._pytree`` keeps insertion order, so this module flattens a
state itself, in JAX's order (:func:`tree_flatten`): dicts by sorted key,
lists and tuples (named tuples included) in order, ``None`` and empty
containers with no leaf, the port's matrices and vectors by their ``data``
tensor, and everything else (tensors, arrays, Python scalars) as one leaf.
A process group of ``torch.distributed``, when one is initialized, takes the
place of JAX's processes; without one the world is a single process. A
matrix or vector on a mesh over several ranks is a leaf that spans
processes: each rank writes its own block under its global index (JAX's
addressable shards), and a restore reads only the new rank's region from the
shard files that overlap it, so a checkpoint saved on one world size
restores onto another.

The reference has *no* training-state checkpointing — only text-format matrix
persistence — and it inherits fault tolerance from Spark's lineage
recomputation. Without lineage, checkpoint-restart is explicit: iterative
workloads (NN/ALS/LR/PageRank, the LM trainer) save their full state every k
steps and resume after a failure.

Two layers:
- :func:`save_sharded` / :func:`load_sharded` — per-shard ``.npy`` files plus a
  small JSON manifest; each process writes only the shards it owns
  (multi-host friendly), and loading re-places shards onto the target sharding.
- :func:`save_checkpoint` / :func:`load_checkpoint` — a pytree-of-arrays
  training checkpoint with step counter, for the iterative workloads.

Crash-safety protocol (exercised through :mod:`marlin_tpu_torch.utils.faults`):

- **Atomic commit** — every generation is a directory ``ckpt_<step>``. Local
  saves stage into ``ckpt_<step>.tmp`` and commit via ``os.replace``; remote
  paths (no atomic rename) write in place and commit by writing the
  ``COMMITTED`` marker last. Readers refuse a marker-less generation, so a
  write torn by a crash is never visible.
- **Integrity** — every payload file's CRC32 and size are recorded in a
  per-process ``integrity_<proc>.json`` manifest inside the generation and
  re-verified on load; a mismatch raises :class:`CheckpointCorruptError`.
- **Retention** — ``save_checkpoint(..., keep=k)`` (or the ``ckpt_keep``
  config) prunes all but the newest ``k`` committed generations after each
  commit; :func:`list_generations` lets readers walk backward to the newest
  generation that still verifies.

Paths may carry a URL scheme (``hdfs://``, ``s3://``, ``memory://`` …): they
route through the :mod:`marlin_tpu_torch.io.fs` hook — with retrying remote IO
(:mod:`marlin_tpu_torch.utils.retry`) — the checkpoint analog of the reference's
save-matrices-to-HDFS regime (utils/MTUtils.scala:350-392). Local paths keep
``mmap`` shard reads.
"""

from __future__ import annotations

import contextlib
import io as _io
import itertools
import json
import os
import re
import zlib
from collections import OrderedDict

import numpy as np
import torch

from ..config import get_config
from ..obs import trace as _trace
from ..utils import faults as _faults
from ..utils.tracing import get_default_event_log
from .fs import (ensure_dir, join_path, list_names, local_path, open_path,
                 remove_path)

__all__ = ["save_sharded", "load_sharded", "save_checkpoint", "load_checkpoint",
           "CheckpointCorruptError", "list_generations", "prune_generations",
           "verify_generation", "tree_flatten", "tree_unflatten"]

#: commit marker written last inside a generation directory — remote paths
#: have no atomic rename, so the marker's existence IS the commit
_COMMITTED = "COMMITTED"

_GEN_DIR_RE = re.compile(r"ckpt_(\d+)")
_GEN_NPZ_RE = re.compile(r"ckpt_(\d+)\.npz")


@contextlib.contextmanager
def _span_event(name: str, **fields):
    """One span + one timed EventLog record around a checkpoint operation:
    the record (kind ``"ckpt"``, ``seconds``, ``ok`` — it lands even when
    the body raises) carries the span's ids, and so does everything the
    body causes (retrying remote IO, fault records), joining the whole
    save/restore into one trace in the JSONL."""
    with _trace.span(name):
        log = get_default_event_log()
        if log is None:
            yield
        else:
            with log.timed("ckpt", **fields):
                yield


_stage_ids = itertools.count()


@contextlib.contextmanager
def _staging_accounted(tag: str):
    """Account a checkpoint staging buffer — the ``BytesIO`` a leaf is
    serialized into before it lands on storage — in the process
    :class:`~marlin_tpu_torch.obs.memledger.MemoryLedger` (component ``ckpt``) for
    exactly the staging window. The body calls the yielded ``note(nbytes)``
    once the buffer is built (its size is unknown up front); the entry is
    debited when the write finishes or raises. Accounting never fails a
    save."""
    name = f"ckpt:{tag}#{next(_stage_ids)}"
    led = None
    try:
        from ..obs.memledger import get_ledger

        led = get_ledger()
    except Exception:
        led = None

    def note(nbytes: int) -> None:
        if led is not None:
            try:
                led.register(name, max(int(nbytes), 0), "ckpt")
            except Exception:
                pass

    try:
        yield note
    finally:
        if led is not None:
            try:
                led.free(name, strict=False)
            except Exception:
                pass


class CheckpointCorruptError(RuntimeError):
    """A checkpoint generation exists but cannot be trusted: missing commit
    marker (torn write), failed CRC32 verification, or an unreadable
    integrity manifest. Recovery should fall back to an older generation."""


def _gen_name(step: int) -> str:
    return f"ckpt_{step:08d}"


def _write_bytes(path: str, data) -> dict:
    """Write ``data`` (bytes or a memoryview — callers pass
    ``BytesIO.getbuffer()`` to avoid copying large payloads) to ``path`` and
    return its integrity record. The CRC is computed from the *intended*
    bytes, never read back from storage — a torn write therefore always
    disagrees with the recorded checksum."""
    _faults.fire("ckpt.write", path=path)
    with open_path(path, "wb") as f:
        f.write(data)
    return {"crc32": zlib.crc32(data) & 0xFFFFFFFF, "bytes": len(data)}


def _crc_of(path: str) -> tuple[int, int]:
    """(crc32, size) of a file, streamed in bounded chunks."""
    crc = 0
    size = 0
    with open_path(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _process() -> tuple[int, int]:
    """(index, count) of this process: its ``torch.distributed`` rank and
    world size when a process group is initialized, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(name: str) -> None:
    del name  # a torch.distributed barrier carries no name
    torch.distributed.barrier()


# ------------------------------------------------------------- leaf order
def _matrix_types() -> tuple:
    from ..matrix.dense import DenseMatrix
    from ..matrix.vector import DistributedVector

    return DenseMatrix, DistributedVector


def tree_flatten(tree, owners: list | None = None) -> tuple[list, object]:
    """``(leaves, spec)`` of a state in ``jax.tree.flatten``'s order: dicts
    by sorted key, lists/tuples/named tuples in order, ``None`` with no leaf,
    the port's matrices and vectors as their ``data`` tensor (the JAX
    package's pytree registration of them), anything else as one leaf.
    :func:`tree_unflatten` rebuilds the state from the spec. ``owners``,
    when given, receives per leaf the matrix or vector it is the data of
    (else ``None``)."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", type(node), keys, [walk(node[k]) for k in keys],
                    list(node))
        if isinstance(node, (list, tuple)):
            return ("seq", type(node), [walk(x) for x in node])
        if isinstance(node, _matrix_types()):
            leaves.append(node.data)
            if owners is not None:
                owners.append(node)
            return ("matrix", node)
        leaves.append(node)
        if owners is not None:
            owners.append(None)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(spec, leaves) -> object:
    """The inverse of :func:`tree_flatten`: ``leaves`` put back into the
    structure ``spec`` describes."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "matrix":
            m = node[1]
            out = object.__new__(type(m))
            out.__dict__.update(m.__dict__)
            out.data = next(it)
            return out
        if kind == "dict":
            _, typ, keys, kids, order = node
            built = {k: build(c) for k, c in zip(keys, kids)}
            built = {k: built[k] for k in order}  # the template's key order
            return built if typ is dict else typ(built)
        _, typ, kids = node
        items = [build(c) for c in kids]
        if hasattr(typ, "_fields"):  # a named tuple
            return typ(*items)
        return typ(items)

    return build(spec)


def _host_array(x) -> np.ndarray:
    """A leaf as the numpy array its file holds (bf16 tensors as their raw
    16-bit words: numpy has no bf16 of its own)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _restore_leaf(arr: np.ndarray, tmpl):
    """A stored array restored like the template leaf: a tensor onto its
    device and dtype, a Python scalar as its type, anything else as numpy in
    the template's dtype."""
    if isinstance(tmpl, torch.Tensor):
        if tmpl.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
                and arr.dtype.kind in "uV":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, (bool, int, float, complex)) and np.ndim(arr) == 0:
        return type(tmpl)(np.asarray(arr).item())
    return np.asarray(arr, dtype=getattr(tmpl, "dtype", None))


class _ByteLRU:
    """A byte-bounded LRU of fname -> ndarray for remote shard downloads.

    Unbounded caching would hold the entire global array's worth of downloaded
    shards in host RAM for the duration of a restore whose target regions
    collectively touch every file; bounding trades a possible re-download for
    a hard host-memory ceiling."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0

    def get(self, fname):
        data = self._entries.get(fname)
        if data is not None:
            self._entries.move_to_end(fname)  # refresh recency
        return data

    def put(self, fname, data: np.ndarray) -> None:
        if data.nbytes > self.max_bytes:
            return  # a single oversized shard would evict everything for nothing
        prev = self._entries.pop(fname, None)
        if prev is not None:
            self._bytes -= prev.nbytes
        while self._bytes + data.nbytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
        self._entries[fname] = data
        self._bytes += data.nbytes


def _clear_stale_shards(path: str) -> None:
    """Drop leftover ``shard_*``/``manifest_*`` files before re-saving into an
    existing directory. A save under a different sharding or process count
    writes differently-named files, and :func:`_read_manifests` would happily
    mix the stale ones into a restore. Proc 0 clears, with a barrier so no
    process writes while another still clears. A filesystem that cannot
    delete a stale file gets an error rather than a save that would restore
    as a silent old/new mix — a failed save is recoverable, corrupt data is
    not."""
    proc, nproc = _process()
    multiproc = nproc > 1
    if not multiproc or proc == 0:
        try:
            names = list_names(path)
        except (FileNotFoundError, OSError):
            names = []
        stuck = [n for n in names
                 if (n.startswith("shard_") or n.startswith("manifest_"))
                 and not remove_path(join_path(path, n))]
        if stuck:
            raise RuntimeError(
                f"cannot clear stale shard files under {path} (filesystem "
                f"without delete support?): {stuck} — re-saving here would "
                "mix old and new shards on restore; save to a fresh "
                "directory instead")
    if multiproc:
        _barrier("marlin_shard_clear")


def _spans(x) -> bool:
    """Whether ``x`` is a matrix or vector holding one block of a mesh over
    ranks."""
    return getattr(getattr(x, "mesh", None), "ranks", None) is not None


def save_sharded(arr, path: str) -> dict:
    """Write one .npy per shard + a JSON manifest. A tensor lies whole on one
    device, so it is one shard covering the whole array (a matrix of a world
    of one is saved by its logical tensor). A matrix or vector on a mesh
    over ranks writes this rank's block of its padded array under the
    block's global index, with its ``replica_id`` (> 0 for the copies along
    a mesh axis its spec does not name); every rank calls it. Returns the
    integrity records ``{relname: {"crc32", "bytes"}}`` of the files this
    process wrote (folded into the checkpoint-level integrity manifest by
    :func:`save_checkpoint`). The layout is the JAX package's, so either
    package's :func:`load_sharded` reads it."""
    if _spans(arr):
        shape = arr._padded_shape
        sh = arr.sharding
        starts = [a for a, _ in sh.bounds(shape)]
        index = [list(b) for b in sh.bounds(shape)]
        replica = sh.replica_id()
        arr = arr.data
    else:
        if hasattr(arr, "logical"):
            arr = arr.logical()
        shape = tuple(arr.shape)
        starts, index, replica = [0] * len(shape), [[0, d] for d in shape], 0
    ensure_dir(path)
    _clear_stale_shards(path)
    proc, _ = _process()
    integ: dict[str, dict] = {}
    host = _host_array(arr)
    fname = f"shard_{replica}_{'_'.join(map(str, starts))}.npy"
    with _staging_accounted(fname) as note:
        buf = _io.BytesIO()
        np.save(buf, host)
        note(buf.getbuffer().nbytes)
        rec = _write_bytes(join_path(path, fname), buf.getbuffer())
    integ[fname] = rec
    shards = [{"file": fname, "index": index, "replica_id": replica,
               "crc32": rec["crc32"]}]
    manifest = {
        "shape": list(shape),
        "dtype": str(arr.dtype).replace("torch.", ""),
        "shards": shards,
        "process_index": proc,
    }
    mname = f"manifest_{proc}.json"
    _faults.fire("ckpt.manifest", path=join_path(path, mname))
    integ[mname] = _write_bytes(join_path(path, mname),
                                json.dumps(manifest).encode())
    return integ


def _read_manifests(path: str):
    manifests = []
    for name in list_names(path):
        if name.startswith("manifest_"):
            with open_path(join_path(path, name)) as f:
                manifests.append(json.load(f))
    if not manifests:
        raise FileNotFoundError(f"no checkpoint manifests under {path}")
    shape = tuple(manifests[0]["shape"])
    name = manifests[0]["dtype"]
    # bf16 shards hold raw 16-bit words (numpy has no bf16 of its own)
    dtype = np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)
    # replica-0 shards only, deduped by index (replicated shardings store the
    # same region once per owning process)
    files = {}
    for man in manifests:
        for sh in man["shards"]:
            if sh["replica_id"] != 0:
                continue
            key = tuple(
                (a if a is not None else 0, b if b is not None else d)
                for (a, b), d in zip(sh["index"], shape)
            )
            files.setdefault(key, sh["file"])
    return shape, dtype, files, name == "bfloat16"


def _read_region(path, files, region, shape, dtype, cache=None):
    """Materialize one target-shard region by slicing only the saved shard
    files that overlap it (memory-mapped, so a file contributes just the
    overlapping rows — never the whole global array). ``cache`` (remote
    loads) holds fname -> array across the per-device callbacks so a shard
    file overlapping several target regions downloads once, not per region."""
    bounds = tuple(s.indices(d) for s, d in zip(region, shape))
    out = np.empty(tuple(b[1] - b[0] for b in bounds), dtype)
    covered = 0
    for key, fname in files.items():
        overlap = tuple(
            (max(a, lo), min(b, hi)) for (a, b), (lo, hi, _) in zip(key, bounds)
        )
        if any(a >= b for a, b in overlap):
            continue
        lp = local_path(path)
        if lp is not None:
            data = np.load(os.path.join(lp, fname), mmap_mode="r")
        else:
            data = cache.get(fname) if cache is not None else None
            if data is None:
                # remote: read the (single-shard-sized) file through the hook;
                # mmap needs a real fd, and a shard file is bounded by design
                with open_path(join_path(path, fname), "rb") as f:
                    data = np.load(f)
                if cache is not None:
                    cache.put(fname, data)
        src = tuple(slice(a - ka, b - ka) for (a, b), (ka, _) in zip(overlap, key))
        dst = tuple(slice(a - lo, b - lo) for (a, b), (lo, _, _) in zip(overlap, bounds))
        out[dst] = data[src]
        covered += int(np.prod([b - a for a, b in overlap]))
    if covered != out.size:
        raise ValueError(
            f"checkpoint at {path} does not cover region {bounds}: "
            f"{covered}/{out.size} elements present (missing manifests from "
            "other hosts?)"
        )
    return out


def load_sharded(path: str, sharding=None) -> torch.Tensor:
    """Restore a sharded-array checkpoint as one tensor, assembled from the
    shard files that cover it (memory-mapped locally; remote shard downloads
    go through a byte-bounded LRU, ``ckpt_cache_bytes``, so a file is fetched
    once) — written by either package under any sharding.

    ``sharding`` is where the tensor goes. A
    :class:`~marlin_tpu_torch.mesh.Sharding` over ranks gives this rank's
    block of the saved array zero-padded to that sharding's grid, read only
    from the files that overlap it (on the mesh's device). Otherwise the
    whole array, on a device, a :class:`~marlin_tpu_torch.mesh.Mesh` (its
    device) or a tensor (its device); None is the configured device."""
    from ..config import resolve_device
    from ..mesh import Sharding

    if isinstance(sharding, Sharding) and sharding.mesh.ranks is not None:
        shape = _read_manifests(path)[0]
        return _load_region(path, sharding.bounds(
            sharding.padded_shape(shape)), sharding.mesh.device)
    shape, dtype, files, bf16 = _read_manifests(path)
    if isinstance(sharding, torch.Tensor):
        device = sharding.device
    else:
        device = resolve_device(getattr(sharding, "device", sharding))
    cache = _ByteLRU(get_config().ckpt_cache_bytes)
    full = tuple(slice(0, d) for d in shape)
    host = torch.from_numpy(_read_region(path, files, full, shape, dtype,
                                         cache))
    if bf16:
        host = host.view(torch.bfloat16)
    return host.to(device)


def _load_region(path: str, bounds, device) -> torch.Tensor:
    """The ``bounds`` block (``(start, stop)`` a dimension) of a saved
    array; zero where it reaches past the saved shape (a grid's pad)."""
    shape, dtype, files, bf16 = _read_manifests(path)
    inside = tuple((min(a, n), min(b, n)) for (a, b), n in zip(bounds, shape))
    out = np.zeros(tuple(b - a for a, b in bounds), dtype)
    if all(b > a for a, b in inside):
        region = tuple(slice(a, b) for a, b in inside)
        part = _read_region(path, files, region, shape, dtype,
                            _ByteLRU(get_config().ckpt_cache_bytes))
        out[tuple(slice(0, b - a) for a, b in inside)] = part
    host = torch.from_numpy(out)
    if bf16:
        host = host.view(torch.bfloat16)
    return host.to(device)


def _fits(saved, owner) -> bool:
    """Whether a saved padded array holds ``owner``'s logical matrix: each
    saved dimension is its logical size zero-padded to a grid axis (of at
    most :data:`_MAX_GRID_AXIS` devices)."""
    logical = owner.shape if hasattr(owner, "_shape") else (owner.length,)
    return len(saved) == len(logical) and all(
        n <= s < n + _MAX_GRID_AXIS for s, n in zip(saved, logical))


# the largest grid axis whose padding a restore accepts
_MAX_GRID_AXIS = 256


def _owner_block(arr: np.ndarray, owner) -> torch.Tensor:
    """The block of a saved whole (padded) array that ``owner``, a matrix
    or vector over ranks, holds on this rank, on its device and dtype."""
    from ..matrix.dense import _cut

    if not _fits(arr.shape, owner):
        raise ValueError(f"saved array of shape {arr.shape} does not hold a "
                         f"matrix of shape {getattr(owner, 'shape', None)} — "
                         "the checkpoint belongs to a different "
                         "configuration")
    blk = _cut(arr, owner.sharding.bounds(owner._padded_shape))
    return _restore_leaf(np.ascontiguousarray(blk), owner.data)


def list_generations(path: str, committed_only: bool = True) -> list[int]:
    """Sorted steps of the checkpoint generations under ``path``. With
    ``committed_only`` (the default), a generation directory counts only when
    its ``COMMITTED`` marker exists — torn or in-progress writes are invisible.
    Legacy single-file ``ckpt_<step>.npz`` generations (whose single rename
    was their commit) always count. Returns [] when ``path`` doesn't exist."""
    try:
        names = list_names(path)
    except (FileNotFoundError, OSError):
        return []
    steps = set()
    for n in names:
        m = _GEN_NPZ_RE.fullmatch(n)
        if m:
            steps.add(int(m.group(1)))
            continue
        m = _GEN_DIR_RE.fullmatch(n)
        if not m:
            continue
        if not committed_only:
            steps.add(int(m.group(1)))
            continue
        try:
            if _COMMITTED in list_names(join_path(path, n)):
                steps.add(int(m.group(1)))
        except (FileNotFoundError, OSError):
            continue
    return sorted(steps)


def verify_generation(path: str, step: int) -> None:
    """Check one committed generation's integrity: the ``COMMITTED`` marker
    exists and every file recorded in the integrity manifests matches its
    CRC32 and size. Raises :class:`CheckpointCorruptError` otherwise. A
    legacy single-file ``ckpt_<step>.npz`` generation carries no integrity
    data and passes vacuously (its single rename was its commit)."""
    try:
        names = list_names(path)
    except (FileNotFoundError, OSError):
        names = []
    if _gen_name(step) not in names and f"{_gen_name(step)}.npz" in names:
        return
    _verify_generation(join_path(path, _gen_name(step)))


def _verify_generation(base: str) -> None:
    try:
        names = list_names(base)
    except (FileNotFoundError, OSError) as e:
        raise CheckpointCorruptError(f"{base}: unreadable generation: {e}") from e
    if _COMMITTED not in names:
        raise CheckpointCorruptError(
            f"{base}: no {_COMMITTED} marker — torn or in-progress write")
    manifests = [n for n in names
                 if n.startswith("integrity_") and n.endswith(".json")]
    if not manifests:
        raise CheckpointCorruptError(
            f"{base}: committed but carries no integrity manifest")
    for mn in manifests:
        try:
            with open_path(join_path(base, mn)) as f:
                man = json.load(f)
            files = man["files"]
        except (ValueError, KeyError, OSError) as e:  # JSONDecodeError is a
            raise CheckpointCorruptError(               # ValueError
                f"{base}/{mn}: unreadable integrity manifest: {e!r}") from e
        for rel, rec in files.items():
            try:
                crc, size = _crc_of(join_path(base, rel))
            except (FileNotFoundError, OSError) as e:
                raise CheckpointCorruptError(
                    f"{base}/{rel}: listed in {mn} but unreadable: {e}") from e
            if size != rec["bytes"] or crc != rec["crc32"]:
                raise CheckpointCorruptError(
                    f"{base}/{rel}: checksum mismatch — manifest says "
                    f"crc32={rec['crc32']} bytes={rec['bytes']}, file has "
                    f"crc32={crc} bytes={size}")


def prune_generations(path: str, keep: int) -> list[int]:
    """Delete all but the newest ``keep`` committed generations; returns the
    pruned steps. Torn debris — marker-less generation directories and
    ``.tmp`` staging dirs — older than the newest committed generation is
    also reclaimed (it is exactly what crashes leave behind; anything at or
    past the newest commit might be a writer still in flight and is left
    alone). Deletion is best-effort (a remote filesystem without ``rm``
    keeps its extra generations rather than failing the save)."""
    if keep <= 0:
        return []
    committed = list_generations(path)
    if not committed:
        return []
    pruned = []
    for step in committed[:-keep]:
        removed = remove_path(join_path(path, _gen_name(step)), recursive=True)
        removed = remove_path(join_path(path, _gen_name(step) + ".npz")) or removed
        if removed:
            pruned.append(step)
    try:
        names = list_names(path)
    except (FileNotFoundError, OSError):
        return pruned
    newest = committed[-1]
    for n in names:
        m = _GEN_DIR_RE.fullmatch(n[:-4]) if n.endswith(".tmp") else None
        if m is None:
            m = _GEN_DIR_RE.fullmatch(n)
            if m is None or int(m.group(1)) in committed:
                continue
        if int(m.group(1)) < newest:
            remove_path(join_path(path, n), recursive=True)
    return pruned


def save_checkpoint(state, path: str, step: int, keep: int | None = None) -> None:
    """Save a training state (a tree of tensors: weights, optimizer
    moments, …; see :func:`tree_flatten`).

    Where every leaf lies whole on each process, the state goes into one
    ``state.npz`` from process 0. Where a leaf spans processes (a matrix or
    vector on a mesh over several ranks), every leaf gets its own entry:
    a spanning leaf a :func:`save_sharded` directory to which every rank
    writes its block, the others one ``.npy`` from process 0 — the JAX
    package's multi-process layout. :func:`load_checkpoint` reads either.

    Either way the payload lands inside one generation directory that is
    committed atomically (local: staged in ``ckpt_<step>.tmp`` and renamed;
    remote: ``COMMITTED`` marker written last) with per-file CRC32s in an
    integrity manifest — a reader can never observe a torn checkpoint.

    ``keep`` bounds retention to the newest ``keep`` committed generations
    (None defers to the ``ckpt_keep`` config; 0 keeps everything).
    """
    with _span_event("ckpt.save", ev="save", step=step):
        _save_checkpoint(state, path, step, keep)


def _save_checkpoint(state, path: str, step: int, keep: int | None) -> None:
    ensure_dir(path)
    final = join_path(path, _gen_name(step))
    _faults.fire("ckpt.write", path=final, step=step)
    owners: list = []
    leaves, _ = tree_flatten(state, owners)
    proc, nproc = _process()
    multiproc = nproc > 1
    lp = local_path(path)
    if lp is not None:
        # local: stage, then commit via atomic rename
        work = final + ".tmp"
        if proc == 0:
            remove_path(work, recursive=True)   # debris of a crashed attempt
            remove_path(final, recursive=True)  # re-save of the same step
    else:
        # remote: no atomic rename — write in place, the marker commits.
        # A same-step re-save first drops the whole old generation; where the
        # filesystem can't delete trees, withdraw at least the marker and the
        # stale integrity manifests (a re-save under fewer processes would
        # otherwise leave integrity_<proc>.json files naming deleted shards,
        # and the healthy new generation would fail verification).
        work = final
        if proc == 0 and not remove_path(final, recursive=True):
            remove_path(join_path(final, _COMMITTED))
            try:
                for n in list_names(final):
                    if n.startswith("integrity_"):
                        remove_path(join_path(final, n))
            except (FileNotFoundError, OSError):
                pass
    if multiproc:
        _barrier(f"marlin_ckpt_stage_{step}")
    integ: dict[str, dict] = {}
    spans = multiproc and any(o is not None and _spans(o) for o in owners)
    if spans:
        ensure_dir(work)
        for i, (x, o) in enumerate(zip(leaves, owners)):
            if o is not None and _spans(o):
                sub = save_sharded(o, join_path(work, f"leaf_{i}"))
                integ.update({f"leaf_{i}/{k}": v for k, v in sub.items()})
            elif proc == 0:  # leaves whole on every rank: once
                with _staging_accounted(f"leaf_{i}.npy") as note:
                    buf = _io.BytesIO()
                    np.save(buf, _host_array(x))
                    note(buf.getbuffer().nbytes)
                    integ[f"leaf_{i}.npy"] = _write_bytes(
                        join_path(work, f"leaf_{i}.npy"), buf.getbuffer())
    # otherwise every leaf lies whole on each process: one state.npz from
    # one writer (proc 0), as concurrent same-file writes would tear
    elif not multiproc or proc == 0:
        ensure_dir(work)
        with _staging_accounted("state.npz") as note:
            buf = _io.BytesIO()
            np.savez(buf, **{f"leaf_{i}": _host_array(x)
                             for i, x in enumerate(leaves)})
            note(buf.getbuffer().nbytes)
            integ["state.npz"] = _write_bytes(
                join_path(work, "state.npz"), buf.getbuffer())
    if integ:
        mname = f"integrity_{proc}.json"
        _faults.fire("ckpt.manifest", path=join_path(work, mname))
        _write_bytes(join_path(work, mname),
                     json.dumps({"step": step, "files": integ}).encode())
    # every process reaches here with its shards durably written before the
    # generation commits — a torn checkpoint is never visible to a reader
    if multiproc:
        _barrier(f"marlin_ckpt_payload_{step}")
    # single-writer commit + 'latest' (ADVICE r4): identical concurrent
    # writes are benign on POSIX but undefined through remote-FS hooks
    # (object stores can fail or tear concurrent same-object puts) — proc 0
    # alone commits and flips the pointer, after the payload barrier above
    # guaranteed durability. The trailing barrier keeps save_checkpoint's
    # postcondition ("this step is committed and latest on return") true on
    # EVERY process, not just proc 0.
    if proc == 0:
        with open_path(join_path(work, _COMMITTED), "w") as f:
            f.write(f"{step}\n")
        if lp is not None:
            os.replace(os.path.join(lp, _gen_name(step) + ".tmp"),
                       os.path.join(lp, _gen_name(step)))
    if multiproc:
        _barrier(f"marlin_ckpt_commit_{step}")
    if proc == 0:
        with open_path(join_path(path, "latest"), "w") as f:
            f.write(str(step))
    if multiproc:
        _barrier(f"marlin_ckpt_latest_{step}")
    if keep is None:
        keep = get_config().ckpt_keep
    if keep and proc == 0:
        prune_generations(path, keep)


def load_checkpoint(state_like, path: str, step: int | None = None,
                    verify: bool = True):
    """Restore a checkpoint into the structure of ``state_like``.
    Returns (state, step). ``step=None`` loads the newest *committed*
    generation; a torn (marker-less) generation is never eligible, and with
    ``verify`` (the default) every file is CRC32-checked against the
    integrity manifest first — corruption raises
    :class:`CheckpointCorruptError` so recovery can fall back to an older
    generation (see :meth:`ResilientLoop._try_resume`).

    ``state_like`` is a real template, not just a structure: restored leaves
    must match its shapes (a mismatch means the checkpoint belongs to a
    different model configuration — error, never silently swap
    architectures), and each leaf is cast to the template leaf's dtype and
    placed on its device."""
    with _span_event("ckpt.load", ev="load", step=step):
        return _load_checkpoint(state_like, path, step, verify)


def _load_checkpoint(state_like, path: str, step: int | None, verify: bool):
    if step is None:
        gens = list_generations(path)
        if gens:
            step = gens[-1]
        else:
            # legacy pointer-file discovery (pre-atomic-commit layouts)
            with open_path(join_path(path, "latest")) as f:
                step = int(f.read().strip())
    gname = _gen_name(step)
    names = set(list_names(path))
    if gname in names:
        base = join_path(path, gname)
        sub = set(list_names(base))
        if _COMMITTED not in sub:
            raise CheckpointCorruptError(
                f"{base}: no {_COMMITTED} marker — torn or in-progress write")
        if verify:
            _verify_generation(base)
        if "state.npz" in sub:
            return _load_npz(state_like, join_path(base, "state.npz"),
                             path, step), step
        return _load_checkpoint_dir(state_like, base, path, step), step
    if f"{gname}.npz" in names:  # legacy single-file layout
        return _load_npz(state_like, join_path(path, f"{gname}.npz"),
                         path, step), step
    raise FileNotFoundError(f"no checkpoint for step {step} under {path}")


def _load_npz(state_like, npz_path: str, path: str, step: int):
    """Restore the single-file npz layout (template-validated)."""
    lp = local_path(npz_path)
    if lp is not None:
        data = np.load(lp)
    else:
        # npz is a zip: needs a seekable stream; buffer the remote read
        with open_path(npz_path, "rb") as f:
            data = np.load(_io.BytesIO(f.read()))
    owners: list = []
    leaves, treedef = tree_flatten(state_like, owners)
    n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
    if n_stored != len(leaves):
        raise ValueError(
            f"checkpoint at {path} step {step} has {n_stored} leaves but the "
            f"template expects {len(leaves)} — the checkpoint belongs to a "
            "different configuration"
        )
    new_leaves = []
    for i, tmpl in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if owners[i] is not None and _spans(owners[i]):
            new_leaves.append(_owner_block(arr, owners[i]))
            continue
        tmpl_shape = tuple(getattr(tmpl, "shape", arr.shape))
        if tuple(arr.shape) != tmpl_shape:
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(arr.shape)} but the "
                f"template expects {tmpl_shape} — the checkpoint at {path} "
                "belongs to a different configuration"
            )
        new_leaves.append(_restore_leaf(arr, tmpl))
    return tree_unflatten(treedef, new_leaves)


def _load_checkpoint_dir(state_like, base: str, path: str, step: int):
    """Restore the per-leaf directory layout written by a multi-process save.
    Global leaves restore through :func:`load_sharded` onto the TEMPLATE
    leaf's sharding — the current run's process count and mesh, not the
    saving run's — so a 2-process checkpoint resumes cleanly in 1 process
    and vice versa (the region reads pull only the overlapping shard files)."""
    owners: list = []
    leaves, treedef = tree_flatten(state_like, owners)
    names = set(list_names(base))
    n_stored = sum(1 for n in names if re.fullmatch(r"leaf_\d+(\.npy)?", n))
    if n_stored != len(leaves):
        raise ValueError(
            f"checkpoint at {path} step {step} has {n_stored} leaves but the "
            f"template expects {len(leaves)} — the checkpoint belongs to a "
            "different configuration")
    new_leaves = []
    for i, tmpl in enumerate(leaves):
        owner = owners[i]
        if owner is not None and _spans(owner):
            sub = join_path(base, f"leaf_{i}")
            if f"leaf_{i}" in names:  # this rank's region of the shards
                if not _fits(_read_manifests(sub)[0], owner):
                    raise ValueError(
                        f"checkpoint leaf {i} at {path} step {step} does not "
                        f"hold a matrix of shape {owner.shape} — it belongs "
                        "to a different configuration")
                leaf = _load_region(sub, owner.sharding.bounds(
                    owner._padded_shape), tmpl.device).to(tmpl.dtype)
            else:
                with open_path(join_path(base, f"leaf_{i}.npy"), "rb") as f:
                    leaf = _owner_block(np.load(f), owner)
            new_leaves.append(leaf)
            continue
        if f"leaf_{i}" in names:  # a sharded-array directory
            leaf = load_sharded(join_path(base, f"leaf_{i}"),
                                sharding=tmpl if isinstance(
                                    tmpl, torch.Tensor) else "cpu")
            if isinstance(tmpl, torch.Tensor):
                leaf = leaf.to(tmpl.dtype)
            else:
                leaf = _restore_leaf(leaf.numpy(), tmpl)
        elif f"leaf_{i}.npy" in names:
            with open_path(join_path(base, f"leaf_{i}.npy"), "rb") as f:
                arr = np.load(f)
            leaf = _restore_leaf(arr, tmpl)
        else:
            raise ValueError(
                f"checkpoint at {path} step {step} is missing leaf {i} — it "
                f"belongs to a different configuration "
                f"(template has {len(leaves)} leaves)")
        tmpl_shape = tuple(getattr(tmpl, "shape", leaf.shape))
        if tuple(leaf.shape) != tmpl_shape:
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(leaf.shape)} but the "
                f"template expects {tmpl_shape} — the checkpoint at {path} "
                "belongs to a different configuration")
        new_leaves.append(leaf)
    return tree_unflatten(treedef, new_leaves)
