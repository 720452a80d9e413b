"""Paged KV-cache pool: block-table paging + copy-on-write prefix sharing.

Counterpart of ``marlin_tpu/serving/kvpool.py``. ONE page slab per engine
(:func:`~marlin_tpu_torch.models.transformer.init_kv_pages` — ``(num_pages,
page_len, kvh, dh)`` per layer, torch tensors on the params' device, shared by
every bucket) plus host-side bookkeeping per row, in numpy as in the JAX
package:

- **Block tables** — each live row holds an ordered list of page ids
  covering its positions; the decode step reads by table, the chunked
  prefill writes by table
  (:func:`~marlin_tpu_torch.models.transformer.lm_decode_paged` /
  :func:`~marlin_tpu_torch.models.transformer.lm_prefill_paged`).
- **Free-list allocation + refcounts** — a request allocates exactly
  :func:`~marlin_tpu_torch.models.planner.request_pages` pages; every
  retirement path releases them exactly once; page 0 is a permanently pinned
  dummy that absorbs out-of-extent reads and writes.
- **Copy-on-write prefix sharing** — completed FULL pages of prompt tokens
  are cached under a rolling hash (page k's key folds page k-1's key, so a
  key names a whole prefix): a later request whose prompt starts with the
  same pages takes a reference instead of re-prefilling. The page holding
  the prompt's LAST token is never shared, so shared pages are read-only by
  construction; :meth:`PagedKVPool.ensure_writable` still implements the
  full COW contract (a fresh page and a device
  :func:`~marlin_tpu_torch.models.transformer.kv_page_copy`) as the gate the
  scheduler runs before every write. Cached pages are LRU-evicted
  leaf-first when allocation needs room.

The slab is updated in place by the programs (PyTorch has no donation);
``pool.pages`` still takes their return value, as with JAX.
:func:`paged_program_key` and :func:`capture_paged_costs` are the roofline
bookkeeping of the paged programs, the costs counted from the shapes.

Cross-engine migration moves rows and prefix-cache chains between pools
through the JAX package's MGRT blob, byte for byte: a blob either package
exports imports into the other. Page contents travel as the slab's raw
element bytes (bf16 as its 16-bit words, so no numpy bf16 is needed); the
export gathers the pages on the device with ``index_select`` and reads them
with one synchronous ``.cpu()``, and the import writes them with
``index_copy_`` into the live slab tensors in place.

Single-threaded by contract: only the scheduler touches a pool.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["PagedKVPool", "PagedGroup", "PagePoolExhausted",
           "MigrationCorruptError", "auto_num_pages", "warmup_paged",
           "paged_program_key", "capture_paged_costs"]


class PagePoolExhausted(RuntimeError):
    """alloc() found fewer free+evictable pages than requested."""


class MigrationCorruptError(RuntimeError):
    """A migration blob failed structural or CRC validation on import —
    truncation, bit flips, or a geometry mismatch between pools. Import
    never partially applies a corrupt blob."""


# Migration wire format (the JAX package's): a flat sequence of
# 32-byte-header chunks, each body independently CRC32-framed so a torn or
# bit-flipped blob ALWAYS raises on import instead of resurrecting garbage
# KV state on the target replica.
#   header: magic "MGRT" | crc32(body) | kind | body_len | 12 pad bytes
_MIG_MAGIC = b"MGRT"
_MIG_HDR = struct.Struct("<4sIIQ12x")  # 32 bytes
_MIG_META = 1      # JSON metadata (geometry + per-row/per-entry manifest)
_MIG_ROW = 2       # one row's page contents, layers in order, k then v
_MIG_PREFIX = 3    # prefix-cache pages (one body for the whole entry set)


def _mig_frame(kind: int, body: bytes) -> bytes:
    return _MIG_HDR.pack(_MIG_MAGIC, zlib.crc32(body) & 0xFFFFFFFF, kind,
                         len(body)) + body


def _mig_chunks(blob: bytes) -> list[tuple[int, bytes]]:
    """Split and validate a migration blob; raises on any corruption."""
    out = []
    off = 0
    n = len(blob)
    while off < n:
        if n - off < _MIG_HDR.size:
            raise MigrationCorruptError(
                f"truncated chunk header at offset {off}")
        magic, crc, kind, length = _MIG_HDR.unpack_from(blob, off)
        if magic != _MIG_MAGIC:
            raise MigrationCorruptError(
                f"bad chunk magic {magic!r} at offset {off}")
        off += _MIG_HDR.size
        body = blob[off:off + length]
        if len(body) != length:
            raise MigrationCorruptError(
                f"truncated chunk body at offset {off}: "
                f"need {length} bytes, have {len(body)}")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise MigrationCorruptError(
                f"chunk CRC mismatch at offset {off}")
        out.append((kind, body))
        off += length
    return out


def _mig_default(o):
    """json.dumps default: numpy scalars/arrays from group vectors."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def _mig_meta(blob: bytes, kind: str) -> tuple[dict, list]:
    """Validate ``blob``'s chunks and parse its meta chunk, which must be
    of ``kind``; returns (meta, the chunks after it)."""
    chunks = _mig_chunks(blob)
    if not chunks or chunks[0][0] != _MIG_META:
        raise MigrationCorruptError("blob does not start with a meta "
                                    "chunk")
    try:
        meta = json.loads(chunks[0][1].decode())
    except ValueError as exc:
        raise MigrationCorruptError(f"meta chunk not JSON: {exc}")
    if meta.get("version") != 1 or meta.get("kind") != kind:
        raise MigrationCorruptError(
            f"unsupported blob version/kind: {meta.get('version')}/"
            f"{meta.get('kind')}")
    return meta, chunks[1:]

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def auto_num_pages(buckets, max_batch: int, page_len: int) -> int:
    """The default pool size (the engine's ``num_pages=0``): every bucket's full
    slot width at its full extent — the dense-slab steady state, so a
    paged-vs-slab A/B holds device capacity equal — plus one slack page
    per slot (chunk scatter spill) and the dummy page 0. Short requests
    use fewer pages than this budget assumes; the surplus is what the
    prefix cache lives in."""
    pages = 1  # the dummy
    for p, s in buckets:
        pages += max_batch * (-(-(p + s) // page_len) + 1)
    return pages


class _CacheEntry:
    __slots__ = ("page", "parent", "children")

    def __init__(self, page: int, parent: bytes | None):
        self.page = page
        self.parent = parent
        self.children = 0


class PagedKVPool:
    """Host-side owner of one engine's page slab (see module docstring).

    ``pages`` is the device slab dict; the scheduler assigns it the return
    value of every program call. Counters (``hits``/``misses``/``cow_copies``/
    ``evictions``) feed the serving metrics."""

    def __init__(self, params: dict, heads: int, num_pages: int,
                 page_len: int, compute_dtype: str | None = None,
                 prefix_cache: bool = True):
        from ..models.transformer import init_kv_pages

        self.page_len = int(page_len)
        self.num_pages = int(num_pages)
        self.compute_dtype = compute_dtype
        self.pages = init_kv_pages(params, num_pages, page_len, heads,
                                   compute_dtype)
        # pop() hands out ascending ids; page 0 never enters the list
        self._free = list(range(num_pages - 1, 0, -1))
        self._ref = np.zeros(num_pages, np.int32)
        self._ref[0] = 1  # the dummy page is pinned forever
        self._cache: OrderedDict[bytes, _CacheEntry] = OrderedDict()
        self.prefix_cache_enabled = bool(prefix_cache)
        self.hits = 0
        self.misses = 0
        self.cow_copies = 0
        self.evictions = 0

    # ------------------------------------------------------------- capacity

    @property
    def capacity(self) -> int:
        """Allocatable pages (everything but the dummy)."""
        return self.num_pages - 1

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        """Pages held by rows and/or the prefix cache."""
        return self.capacity - len(self._free)

    def shared_count(self) -> int:
        """Pages with more than one referent (cache + row, or row + row)."""
        return int((self._ref[1:] > 1).sum())

    def cached_count(self) -> int:
        return len(self._cache)

    def stats(self) -> dict:
        return {"total": self.capacity, "used": self.used_count(),
                "shared": self.shared_count(),
                "cached": self.cached_count(), "hits": self.hits,
                "misses": self.misses, "cow_copies": self.cow_copies,
                "evictions": self.evictions}

    # ----------------------------------------------------- alloc / refcount

    def alloc(self, n: int) -> list[int]:
        """``n`` fresh pages (refcount 1 each), evicting cache-only pages
        LRU as needed. Raises :class:`PagePoolExhausted` when free +
        evictable < n — unreachable under the auto-sized pool (module
        docstring: allocation is row-bounded), guarded anyway."""
        while len(self._free) < n and self._evict_one():
            pass
        if len(self._free) < n:
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free and nothing "
                f"evictable ({self.used_count()}/{self.capacity} used, "
                f"{self.cached_count()} cached)")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def retain(self, pages) -> None:
        """One more referent per page (prefix-share acquisition)."""
        for p in pages:
            assert self._ref[p] > 0, f"retain of unowned page {p}"
            self._ref[p] += 1

    def release(self, pages) -> None:
        """Drop one referent per page; pages at zero return to the free
        list. Every retirement path funnels here exactly once per row
        (PagedGroup.release returns the row's distinct real pages)."""
        for p in pages:
            if p == 0:
                continue  # dummy padding in a table slice — never counted
            self._ref[p] -= 1
            assert self._ref[p] >= 0, f"page {p} released below zero"
            if self._ref[p] == 0:
                self._free.append(int(p))

    # -------------------------------------------------------- prefix cache

    @staticmethod
    def _page_key(prev: bytes, tokens: np.ndarray) -> bytes:
        """Rolling hash: page k's key digests (page k-1's key || page k's
        tokens), so one key identifies the whole prefix through page k."""
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def _share_limit(self, prompt_len: int) -> int:
        """Positions eligible for sharing: whole pages strictly before the
        prompt's last token — that token's page is always re-prefilled (its
        logits seed the first sample) and then written by decode, so it can
        never be a shared page."""
        return ((prompt_len - 1) // self.page_len) * self.page_len

    def match_prefix(self, prompt: np.ndarray) -> tuple[int, list[int]]:
        """Longest cached prefix of ``prompt`` in whole pages:
        ``(shared_len, pages)``, with one reference taken per matched page
        (the caller's row now co-owns them read-only). Counts a hit when
        at least one page matched, else a miss."""
        if not self.prefix_cache_enabled:
            return 0, []
        prompt = np.asarray(prompt, np.int32)
        limit = self._share_limit(len(prompt))
        pages: list[int] = []
        key = b""
        k = 0
        while (k + 1) * self.page_len <= limit:
            key = self._page_key(
                key, prompt[k * self.page_len:(k + 1) * self.page_len])
            e = self._cache.get(key)
            if e is None:
                break
            self._cache.move_to_end(key)  # LRU touch
            pages.append(e.page)
            k += 1
        if pages:
            self.retain(pages)
            self.hits += 1
        else:
            self.misses += 1
        return len(pages) * self.page_len, pages

    def insert_prefix(self, prompt: np.ndarray, row_pages) -> int:
        """Cache the row's completed full prompt pages (called once, when
        the row's prefill finishes — the pages' contents are final from
        then on). ``row_pages`` is the row's block table in position order.
        Already-cached prefixes are skipped (no double reference); each
        newly cached page gains one cache-owned reference that outlives
        the row. Returns pages inserted."""
        if not self.prefix_cache_enabled:
            return 0
        prompt = np.asarray(prompt, np.int32)
        limit = self._share_limit(len(prompt))
        key = b""
        inserted = 0
        for k in range(limit // self.page_len):
            parent = key if k else None
            key = self._page_key(
                key, prompt[k * self.page_len:(k + 1) * self.page_len])
            e = self._cache.get(key)
            if e is not None:
                self._cache.move_to_end(key)
                continue
            page = int(row_pages[k])
            self._cache[key] = entry = _CacheEntry(page, parent)
            if parent is not None:
                self._cache[parent].children += 1
            del entry
            self.retain([page])
            inserted += 1
        return inserted

    def _evict_one(self) -> bool:
        """Evict the LRU cache entry that is a chain leaf (no cached
        children — evicting mid-chain would orphan unreachable deeper
        entries) and has no live readers (refcount is the cache's own).
        Returns False when nothing qualifies."""
        for key, e in self._cache.items():  # OrderedDict: oldest first
            if e.children == 0 and self._ref[e.page] == 1:
                del self._cache[key]
                if e.parent is not None:
                    self._cache[e.parent].children -= 1
                self.release([e.page])
                self.evictions += 1
                return True
        return False

    # ------------------------------------------------------- copy-on-write

    def ensure_writable(self, table: np.ndarray, idx: int) -> bool:
        """Copy-on-write gate for one block-table slot: if the page has
        other referents (shared prefix, cache), allocate a fresh page,
        device-copy the contents (:func:`kv_page_copy`), move this row's
        reference, and point the table at the copy. Returns True when a
        copy happened. The scheduler calls this before every page it is
        about to write; in steady state
        writes only ever target exclusively-owned pages (see
        :meth:`_share_limit`), so this is a cheap refcount check — but it
        is the contract that makes sharing safe against any future
        scheduler change, and the unit tests drive it directly."""
        from ..models.transformer import kv_page_copy

        page = int(table[idx])
        if page == 0 or self._ref[page] <= 1:
            return False
        fresh = self.alloc(1)[0]
        self.pages = kv_page_copy(self.pages, page, fresh)
        self.release([page])
        table[idx] = fresh
        self.cow_copies += 1
        return True

    # ------------------------------------------------- cross-pool migration

    def _layer_names(self) -> list[str]:
        return sorted(self.pages, key=lambda s: int(s[1:]))

    def _slabs(self) -> list[torch.Tensor]:
        """The slab tensors in blob order: layers in order, k then v."""
        return [t for name in self._layer_names() for t in self.pages[name]]

    def _host_pages(self, pids) -> list[np.ndarray]:
        """Pages ``pids`` of every slab tensor as raw bytes on the host, one
        ``(len(pids), page_bytes)`` uint8 array per tensor in blob order:
        gathered on the device, read back with one synchronous copy."""
        slabs = self._slabs()
        idx = torch.as_tensor(list(pids), dtype=torch.long,
                              device=slabs[0].device)
        with torch.no_grad():
            flat = torch.cat([t.index_select(0, idx).reshape(-1)
                              for t in slabs])
            host = flat.view(torch.uint8).cpu().numpy()
        page_nb = self._page_nbytes()
        bounds = np.cumsum([len(idx) * nb for nb in page_nb])[:-1]
        return [part.reshape(len(idx), nb)
                for part, nb in zip(np.split(host, bounds), page_nb)]

    def _write_pages(self, writes) -> None:
        """Write host page bytes into the slab tensors in place:
        ``writes[i]`` is a list of (page ids, uint8 bytes of those pages)
        for the i-th slab tensor in blob order."""
        for t, parts in zip(self._slabs(), writes):
            if not parts:
                continue
            ids = [p for pids, _ in parts for p in pids]
            data = np.concatenate([b.reshape(-1) for _, b in parts])
            src = torch.from_numpy(data).view(t.dtype).reshape(
                (len(ids),) + tuple(t.shape[1:]))
            with torch.no_grad():
                t.index_copy_(0, torch.as_tensor(ids, device=t.device),
                              src.to(t.device))

    def _geometry(self) -> dict:
        names = self._layer_names()
        leaf = self.pages[names[0]][0]
        # the JAX package writes str(np.dtype(...)): "float32", "bfloat16"
        return {"page_len": self.page_len, "layers": names,
                "dtype": str(leaf.dtype).removeprefix("torch."),
                "shapes": [list(self.pages[nm][0].shape[1:])
                           for nm in names]}

    def _check_geometry(self, meta: dict) -> None:
        geo = self._geometry()
        for field in ("page_len", "layers", "dtype", "shapes"):
            if meta.get(field) != geo[field]:
                raise MigrationCorruptError(
                    f"pool geometry mismatch on {field!r}: blob has "
                    f"{meta.get(field)!r}, target pool has {geo[field]!r}")

    def _page_nbytes(self) -> list[int]:
        """Bytes of one page of each slab tensor, in blob order."""
        return [t[0].numel() * t.element_size() for t in self._slabs()]

    def _row_nbytes(self, n_pages: int) -> int:
        return n_pages * sum(self._page_nbytes())

    def export_rows(self, rows) -> bytes:
        """Serialize a row set into a CRC-framed host blob. Each element of
        ``rows`` is a dict carrying the row's block table in position order
        (``pages``), its prompt/cursor/sampling manifest (engine-provided;
        travels verbatim in the meta chunk), and ``rid``. Page contents are
        gathered device→host once for the whole set. The blob is
        self-contained: :meth:`import_rows` on any pool with matching
        geometry — of either package — rebuilds the rows without reference
        to this pool."""
        meta = {"version": 1, "kind": "rows", **self._geometry(),
                "rows": [dict(r, pages=[int(p) for p in r["pages"]])
                         for r in rows]}
        host = self._host_pages(p for r in meta["rows"] for p in r["pages"])
        blob = [_mig_frame(
            _MIG_META, json.dumps(meta, default=_mig_default).encode())]
        off = 0
        for r in meta["rows"]:
            n = len(r["pages"])
            blob.append(_mig_frame(_MIG_ROW, b"".join(
                part[off:off + n].tobytes() for part in host)))
            off += n
        return b"".join(blob)

    def import_rows(self, blob: bytes) -> list[dict]:
        """Rebuild an exported row set in THIS pool: validate every chunk
        (corruption always raises :class:`MigrationCorruptError`), then per
        row run the NORMAL allocation path — :meth:`match_prefix` first, so
        a migrated shared prefix re-deduplicates against the target's cache
        (and against earlier rows of this same blob, whose completed prompt
        pages are re-inserted as they land), then :meth:`alloc` for the
        remainder — and write the imported page contents into the slab.
        Returns the row manifests with target-space ``pages``/``n_shared``/
        ``shared_len`` rebound; the caller binds them to entries. On any
        failure every page this call allocated is released (pages already
        content-written stay valid for the cache entries that reference
        them), so a failed import leaks nothing."""
        meta, chunks = _mig_meta(blob, "rows")
        self._check_geometry(meta)
        bodies = [b for kind, b in chunks if kind == _MIG_ROW]
        if len(bodies) != len(meta["rows"]):
            raise MigrationCorruptError(
                f"row count mismatch: meta lists {len(meta['rows'])} rows, "
                f"blob carries {len(bodies)} page chunks")
        for row, body in zip(meta["rows"], bodies):
            if len(body) != self._row_nbytes(len(row["pages"])):
                raise MigrationCorruptError(
                    f"row {row.get('rid')}: page payload is {len(body)} "
                    f"bytes, expected "
                    f"{self._row_nbytes(len(row['pages']))}")
        page_nb = self._page_nbytes()
        writes: list[list] = [[] for _ in page_nb]
        out: list[dict] = []
        taken: list[list[int]] = []
        try:
            for row, body in zip(meta["rows"], bodies):
                prompt = np.asarray(row["prompt"], np.int32)
                n_pages = len(row["pages"])
                shared_len, spages = self.match_prefix(prompt)
                owned = self.alloc(n_pages - len(spages))
                pages = list(spages) + owned
                taken.append(pages)
                if owned:
                    raw = np.frombuffer(body, np.uint8)
                    off = 0
                    for w, nb in zip(writes, page_nb):
                        part = raw[off:off + n_pages * nb].reshape(n_pages,
                                                                   nb)
                        w.append((owned, part[len(spages):]))
                        off += n_pages * nb
                row = dict(row, pages=pages, n_shared=len(spages),
                           shared_len=shared_len)
                out.append(row)
                if int(row.get("pf_next", -1)) < 0:
                    # prefill completed on the source: publish the prompt's
                    # full pages so later arrivals — including later rows
                    # of this same blob — share instead of re-importing
                    self.insert_prefix(prompt, pages)
        except BaseException:
            # pages already claimed hold valid content once written — write
            # them so any cache entry inserted above stays safe, then drop
            # the row refs
            self._write_pages(writes)
            for pages in taken:
                self.release(pages)
            raise
        self._write_pages(writes)
        return out

    def export_prefixes(self, n: int) -> bytes | None:
        """The N hottest prefix-cache entries (MRU end of the LRU order),
        closed over their parent chains (a child without its ancestors can
        never be matched), as a CRC-framed blob for warming a peer's cache.
        Keys are the content hashes themselves — no prompt tokens travel.
        Returns None when there is nothing to export."""
        if not self.prefix_cache_enabled or not self._cache:
            return None
        selected: set[bytes] = set()
        for key in list(self._cache)[-max(1, int(n)):]:
            while key is not None and key not in selected:
                selected.add(key)
                key = self._cache[key].parent

        def depth(k: bytes) -> int:
            d = 0
            e = self._cache[k]
            while e.parent is not None:
                d += 1
                e = self._cache[e.parent]
            return d

        ordered = sorted(selected, key=depth)  # parents import first
        entries = []
        for key in ordered:
            e = self._cache[key]
            entries.append({
                "key": key.hex(),
                "parent": None if e.parent is None else e.parent.hex()})
        host = self._host_pages(self._cache[key].page for key in ordered)
        body = b"".join(part[i].tobytes() for i in range(len(ordered))
                        for part in host)
        meta = {"version": 1, "kind": "prefixes", **self._geometry(),
                "entries": entries}
        return (_mig_frame(_MIG_META, json.dumps(meta).encode())
                + _mig_frame(_MIG_PREFIX, body))

    def import_prefixes(self, blob: bytes) -> int:
        """Warm this pool's prefix cache from a peer's
        :meth:`export_prefixes` blob: each entry allocates one page (LRU
        eviction may make room; exhaustion stops the warm early rather than
        failing it), takes the cache-owned reference, and links into the
        parent chain. Entries already cached (or whose parent did not make
        the cut) are skipped. Returns entries inserted."""
        if not self.prefix_cache_enabled:
            return 0
        meta, chunks = _mig_meta(blob, "prefixes")
        self._check_geometry(meta)
        bodies = [b for kind, b in chunks if kind == _MIG_PREFIX]
        body = bodies[0] if bodies else b""
        per_entry = self._row_nbytes(1)
        if len(body) != per_entry * len(meta["entries"]):
            raise MigrationCorruptError(
                f"prefix payload is {len(body)} bytes, expected "
                f"{per_entry * len(meta['entries'])}")
        page_nb = self._page_nbytes()
        raw = np.frombuffer(body, np.uint8)
        writes: list[list] = [[] for _ in page_nb]
        inserted = 0
        for i, ent in enumerate(meta["entries"]):
            key = bytes.fromhex(ent["key"])
            parent = None if ent["parent"] is None \
                else bytes.fromhex(ent["parent"])
            if key in self._cache:
                self._cache.move_to_end(key)
                continue
            if parent is not None and parent not in self._cache:
                continue  # chain broken (parent evicted/skipped)
            try:
                page = self.alloc(1)[0]
            except PagePoolExhausted:
                break  # a partial warm is still a warm
            off = i * per_entry
            for w, nb in zip(writes, page_nb):
                w.append(([page], raw[off:off + nb]))
                off += nb
            self._cache[key] = _CacheEntry(page, parent)
            if parent is not None:
                self._cache[parent].children += 1
            inserted += 1
        self._write_pages(writes)
        return inserted

    # -------------------------------------------------------------- audit

    def audit(self, groups=()) -> dict:
        """Cross-check every pool invariant: refcounts vs block-table
        references vs the free list vs prefix-cache ownership, the pinned
        dummy page, and cache parent/children chain consistency. ``groups``
        is the engine's live :class:`PagedGroup` set — row-side references
        are only checkable when the caller passes them (chaos tests and
        ``GET /debug/kvpool`` do). Returns ``{"ok": bool, "errors": [...],
        **stats}``; read-only, never raises."""
        errors: list[str] = []
        expect = np.zeros(self.num_pages, np.int64)
        expect[0] = 1  # the dummy pin
        for g in groups:
            for slot in g.occupied_slots():
                for p in (g.row_pages[slot] or []):
                    p = int(p)
                    if not 0 < p < self.num_pages:
                        errors.append(f"row table references out-of-range "
                                      f"page {p}")
                        continue
                    expect[p] += 1
        children: dict[bytes, int] = {}
        for key, e in self._cache.items():
            if not 0 < e.page < self.num_pages:
                errors.append(f"cache entry references out-of-range page "
                              f"{e.page}")
                continue
            expect[e.page] += 1
            if e.parent is not None:
                if e.parent not in self._cache:
                    errors.append(f"cache entry for page {e.page} orphaned: "
                                  f"parent key missing")
                else:
                    children[e.parent] = children.get(e.parent, 0) + 1
        for key, e in self._cache.items():
            want = children.get(key, 0)
            if e.children != want:
                errors.append(f"cache entry for page {e.page}: children "
                              f"count {e.children} != {want} actual")
        free = [int(p) for p in self._free]
        fs = set(free)
        if len(fs) != len(free):
            errors.append("free list contains duplicate pages")
        if 0 in fs:
            errors.append("dummy page 0 is on the free list")
        if int(self._ref[0]) < 1:
            errors.append(f"dummy page 0 unpinned (refcount "
                          f"{int(self._ref[0])})")
        for p in fs:
            if not 0 < p < self.num_pages:
                errors.append(f"free list holds out-of-range page {p}")
            elif int(self._ref[p]) != 0:
                errors.append(f"free page {p} has refcount "
                              f"{int(self._ref[p])}")
            if int(expect[p]) != 0 and 0 < p < self.num_pages:
                errors.append(f"free page {p} is still referenced by a row "
                              f"or cache entry")
        for p in range(1, self.num_pages):
            ref = int(self._ref[p])
            if p in fs:
                continue
            if ref == 0:
                errors.append(f"page {p} leaked: refcount 0 but not on the "
                              f"free list")
            elif groups and ref != int(expect[p]):
                errors.append(f"page {p}: refcount {ref} != "
                              f"{int(expect[p])} referents")
            elif not groups and ref < int(expect[p]):
                errors.append(f"page {p}: refcount {ref} below its "
                              f"{int(expect[p])} cache references")
        return {"ok": not errors, "errors": errors, **self.stats()}


class PagedGroup:
    """Per-bucket row bookkeeping over a shared :class:`PagedKVPool` — the
    paged analog of the JAX package's ``SlotPool``. Owns the per-row vectors
    the decode program takes, each row's block table and prefill cursor,
    and the host-side emitted-token stream (tokens never live on device in
    paged mode: the decode program takes ``cur_tokens`` and returns the
    next ones, so results are assembled host-side). Single-threaded — only
    the engine worker touches a group."""

    def __init__(self, bucket, width: int, page_len: int,
                 prefill_chunk: int):
        p, s = bucket
        self.bucket = bucket
        self.width = width
        self.page_len = page_len
        #: block-table width for DECODE: pages covering the bucket extent
        self.pages_per_row = -(-(p + s) // page_len)
        #: compiled chunk width in tokens: whole pages, never wider than
        #: the prompt extent (a narrow bucket compiles the smaller
        #: program), and CAPPED below the per-iteration token budget
        #: (``prefill_chunk``) — the program's cost is fixed at its
        #: width whatever the real token count, so a wide program makes a
        #: prefix-hit row's short tail (the prefix-cache win) as expensive
        #: as a full prefill; the engine instead runs several small chunks
        #: per iteration up to the budget
        cap = max(64, 4 * page_len)
        self.chunk = min(_round_up(max(1, prefill_chunk), page_len),
                         _round_up(p, page_len),
                         _round_up(cap, page_len))
        self.chunk_pages = self.chunk // page_len
        #: stored table width: decode extent + chunk spill (a final chunk
        #: starting near the extent scatters into these dummy-page slots)
        self.table_width = self.pages_per_row + self.chunk_pages
        self.tables = np.zeros((width, self.table_width), np.int32)
        self.entries: list = [None] * width
        self.positions = np.zeros(width, np.int32)
        self.steps_done = np.zeros(width, np.int32)
        self.lengths = np.zeros(width, np.int32)
        self.seeds = np.zeros(width, np.uint32)
        self.temperature = np.zeros(width, np.float32)
        self.top_p = np.ones(width, np.float32)   # 1.0 = nucleus filter off
        self.top_k = np.zeros(width, np.int32)    # 0 = rank filter off
        self.cur_tok = np.zeros(width, np.int32)
        self.ttft_s: list = [None] * width
        #: next chunk_start per row; -1 = not prefilling (free or decoding)
        self.pf_next = np.full(width, -1, np.int64)
        self.prompts: list = [None] * width   # chunk-padded prompt arrays
        self.emitted: list = [None] * width   # host-side generated tokens
        self.row_pages: list = [None] * width  # table pages, position order
        self.shared_pages = np.zeros(width, np.int32)

    # --------------------------------------------------------------- state

    def occupied_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is not None]

    def live_slots(self) -> list[int]:
        """Decode-ready rows (prefill complete)."""
        return [i for i, e in enumerate(self.entries)
                if e is not None and self.pf_next[i] < 0]

    def prefilling_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries)
                if e is not None and self.pf_next[i] >= 0]

    def free_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is None]

    def occupancy(self) -> float:
        return len(self.live_slots()) / self.width

    # ---------------------------------------------------------- transitions

    def assign(self, slot: int, entry, pages: list[int], shared_len: int,
               n_shared: int) -> None:
        """Bind an admitted entry: ``pages`` is the row's full block table
        in position order (``n_shared`` prefix-cache pages first, then the
        freshly allocated remainder); prefill resumes at ``shared_len``."""
        r = entry.request
        n = r.prompt.shape[0]
        self.entries[slot] = entry
        self.lengths[slot] = n
        self.tables[slot, :] = 0
        self.tables[slot, :len(pages)] = pages
        self.row_pages[slot] = list(pages)
        self.shared_pages[slot] = n_shared
        self.pf_next[slot] = shared_len
        padded = np.zeros(_round_up(n, self.chunk), np.int32)
        padded[:n] = r.prompt
        self.prompts[slot] = padded
        self.positions[slot] = 0
        self.steps_done[slot] = 0
        self.cur_tok[slot] = 0
        self.seeds[slot] = np.uint32(r.seed)
        self.temperature[slot] = r.temperature
        self.top_p[slot] = 1.0 if r.top_p is None else r.top_p
        self.top_k[slot] = 0 if r.top_k is None else r.top_k
        self.emitted[slot] = []
        self.ttft_s[slot] = None

    def finish_prefill(self, slot: int, first: int) -> None:
        """The final chunk landed: the row becomes decode-ready with its
        first emitted token in hand (= the slab path's prefill contract)."""
        self.pf_next[slot] = -1
        self.positions[slot] = self.lengths[slot]
        self.steps_done[slot] = 1
        self.cur_tok[slot] = first
        self.emitted[slot] = [int(first)]

    def restore(self, slot: int, entry, row: dict,
                pages: list[int]) -> None:
        """Bind a MIGRATED row mid-stream (:meth:`PagedKVPool.import_rows`
        manifest): like :meth:`assign` but restoring the source replica's
        cursors — position, steps_done, current token, emitted stream, and
        the prefill cursor for rows frozen mid-prefill. With the imported
        KV pages in place, decode resumes bit-identically: the sampling
        stream is ``fold_in(key(seed), step)``, composition-independent,
        so only (seed, steps_done, KV, cur_tok) matter — all restored."""
        r = entry.request
        n = int(row["length"])
        self.entries[slot] = entry
        self.lengths[slot] = n
        self.tables[slot, :] = 0
        self.tables[slot, :len(pages)] = pages
        self.row_pages[slot] = list(pages)
        self.shared_pages[slot] = int(row["n_shared"])
        self.pf_next[slot] = int(row["pf_next"])
        padded = np.zeros(_round_up(n, self.chunk), np.int32)
        padded[:n] = r.prompt
        self.prompts[slot] = padded
        self.positions[slot] = int(row["position"])
        self.steps_done[slot] = int(row["steps_done"])
        self.cur_tok[slot] = int(row["cur_tok"])
        self.seeds[slot] = np.uint32(r.seed)
        self.temperature[slot] = r.temperature
        self.top_p[slot] = 1.0 if r.top_p is None else r.top_p
        self.top_k[slot] = 0 if r.top_k is None else r.top_k
        self.emitted[slot] = [int(t) for t in row["emitted"]]
        self.ttft_s[slot] = row.get("ttft_s")

    def release(self, slot: int) -> list[int]:
        """Free the slot on ANY retirement path; returns the row's pages
        for the caller to hand to :meth:`PagedKVPool.release` — the single
        page-release funnel per row."""
        pages = self.row_pages[slot] or []
        self.entries[slot] = None
        self.tables[slot, :] = 0
        self.row_pages[slot] = None
        self.shared_pages[slot] = 0
        self.pf_next[slot] = -1
        self.positions[slot] = 0
        self.steps_done[slot] = 0
        self.lengths[slot] = 0
        self.cur_tok[slot] = 0
        self.temperature[slot] = 0.0
        self.top_p[slot] = 1.0
        self.top_k[slot] = 0
        self.prompts[slot] = None
        self.emitted[slot] = None
        self.ttft_s[slot] = None
        return pages

    # -------------------------------------------------------- decode inputs

    def decode_inputs(self):
        """(tables, positions, cur_tokens) with every non-live row masked
        to the dummy table/position — a prefilling row's REAL pages must
        never be scribbled by its dummy decode write."""
        live = np.zeros(self.width, bool)
        live[self.live_slots()] = True
        tables = np.where(live[:, None],
                          self.tables[:, :self.pages_per_row], 0)
        positions = np.where(live, self.positions, 0)
        cur = np.where(live, self.cur_tok, 0)
        return tables, positions, cur


# ---------------------------------------------------------------- programs


def paged_program_key(params: dict, bucket, max_batch: int,
                      page_len: int, compute_dtype=None,
                      kernel: str = "gather") -> str:
    """Roofline-accounting key for one bucket's PAGED programs, the JAX
    package's key string: the slab geometry joins the identity, and so does
    the decode-attention backend (gather and the kernel are different
    programs with different rooflines)."""
    from .batcher import bucket_program_key

    key = bucket_program_key(params, bucket, max_batch,
                             compute_dtype) + f"/page{page_len}"
    return key if kernel == "gather" else key + f"/k{kernel}"


def paged_decode_cost(params: dict, heads: int, max_batch: int,
                      pages_per_row: int, page_len: int,
                      compute_dtype=None, moe: tuple | None = None) -> dict:
    """Analytic cost of one ``lm_decode_paged`` call over full tables: the
    projections, MLP and head of ``max_batch`` one-token rows
    (:func:`~.batcher.lm_call_cost` without attention) plus, per layer, the
    decode kernel's own count
    (:func:`~marlin_tpu_torch.ops.paged_attention.paged_attention_cost`)."""
    from ..models.transformer import _cdtype, _n_layers
    from ..ops.paged_attention import paged_attention_cost
    from .batcher import lm_call_cost

    d = params["emb"].shape[1]
    dh = d // heads
    kvh = params["l0"]["wk"].shape[1] // dh
    item = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    out = lm_call_cost(params, heads, max_batch, 1, 0, compute_dtype,
                       attention=False, moe=moe)
    kc = paged_attention_cost(max_batch, pages_per_row, page_len, kvh,
                              heads // kvh, dh, item)
    n = _n_layers(params)
    return {f: out[f] + n * kc[f] for f in ("flops", "bytes accessed")}


def capture_paged_costs(params: dict, heads: int, bucket, max_batch: int,
                        pool: PagedKVPool, prefill_chunk: int,
                        compute_dtype: str | None = None,
                        moe: tuple | None = None,
                        key: str | None = None,
                        kernel: str = "gather") -> None:
    """Record the analytic cost models of a bucket's paged program pair in
    the process ProgramCosts registry, gated per (program, key) like
    :func:`~.batcher.capture_bucket_costs`: ``lm_prefill_paged`` is one
    chunk of the bucket's chunk width over the row's table extent,
    ``lm_decode_paged`` :func:`paged_decode_cost` (the same count for either
    ``kernel``: it is the work the step must do). Never raises (observability
    must not fail warmup or a dispatch)."""
    from ..obs import perf
    from .batcher import lm_call_cost

    costs = perf.get_program_costs()
    programs = ("lm_prefill_paged", "lm_decode_paged")
    try:
        if key is None:
            key = paged_program_key(params, bucket, max_batch, pool.page_len,
                                    compute_dtype, kernel)
        if all(costs.tried(name, key) for name in programs):
            return
        g = PagedGroup(bucket, max_batch, pool.page_len, prefill_chunk)
        costs.capture("lm_prefill_paged", key, cost=lm_call_cost(
            params, heads, 1, g.chunk, g.table_width * pool.page_len,
            compute_dtype, moe=moe))
        costs.capture("lm_decode_paged", key, cost=paged_decode_cost(
            params, heads, max_batch, g.pages_per_row, pool.page_len,
            compute_dtype, moe))
    except Exception:
        if key is not None:
            for name in programs:  # even a failed count marks the attempt
                costs.capture(name, key)


def warmup_paged(params: dict, heads: int, buckets, max_batch: int,
                 pool: PagedKVPool, prefill_chunk: int,
                 compute_dtype=None, moe: tuple | None = None,
                 kernel: str = "gather") -> int:
    """Run every bucket's paged program pair once against dummy page 0, plus
    the page copy: builds the CUDA kernels and warms the allocator and the
    library handles before traffic, and records each bucket's cost models
    (:func:`capture_paged_costs`). All dummy writes land in page 0. Returns
    the buckets warmed."""
    from ..models.transformer import (kv_page_copy, lm_decode_paged,
                                      lm_prefill_paged)
    from .batcher import normalize_buckets

    buckets = normalize_buckets(buckets)
    for bucket in buckets:
        g = PagedGroup(bucket, max_batch, pool.page_len, prefill_chunk)
        capture_paged_costs(params, heads, bucket, max_batch, pool,
                            prefill_chunk, compute_dtype, moe, kernel=kernel)
        pool.pages, _ = lm_prefill_paged(
            params, pool.pages, np.zeros(g.table_width, np.int32),
            np.zeros(g.chunk, np.int32), 0, 1, heads=heads,
            page_len=pool.page_len, compute_dtype=compute_dtype, moe=moe)
        w = max_batch
        pool.pages, _ = lm_decode_paged(
            params, pool.pages, np.zeros((w, g.pages_per_row), np.int32),
            np.zeros(w, np.int32), np.zeros(w, np.int32),
            np.zeros(w, np.int32), np.zeros(w, np.uint32),
            np.zeros(w, np.float32), np.ones(w, np.float32),
            np.zeros(w, np.int32), heads=heads, page_len=pool.page_len,
            compute_dtype=compute_dtype, moe=moe, kernel=kernel)
    pool.pages = kv_page_copy(pool.pages, 0, 0)
    dev = pool.pages["l0"][0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return len(buckets)
