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
``pool.pages`` still takes their return value, as with JAX. The migration
blob (``export_rows``/``import_rows``/``*_prefixes``, ``PagedGroup.restore``)
and ``capture_paged_costs`` come with the engine slice (ROADMAP).

Single-threaded by contract: only the scheduler touches a pool.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

__all__ = ["PagedKVPool", "PagedGroup", "PagePoolExhausted",
           "auto_num_pages", "warmup_paged"]


class PagePoolExhausted(RuntimeError):
    """alloc() found fewer free+evictable pages than requested."""

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



def warmup_paged(params: dict, heads: int, buckets, max_batch: int,
                 pool: PagedKVPool, prefill_chunk: int,
                 compute_dtype=None, kernel: str = "gather") -> int:
    """Run every bucket's paged program pair once against dummy page 0, plus
    the page copy: builds the CUDA kernels and warms the allocator and the
    library handles before traffic. All dummy writes land in page 0. Returns
    the buckets warmed."""
    import torch

    from ..models.transformer import (kv_page_copy, lm_decode_paged,
                                      lm_prefill_paged)
    from .batcher import normalize_buckets

    buckets = normalize_buckets(buckets)
    for bucket in buckets:
        g = PagedGroup(bucket, max_batch, pool.page_len, prefill_chunk)
        pool.pages, _ = lm_prefill_paged(
            params, pool.pages, np.zeros(g.table_width, np.int32),
            np.zeros(g.chunk, np.int32), 0, 1, heads=heads,
            page_len=pool.page_len, compute_dtype=compute_dtype)
        w = max_batch
        pool.pages, _ = lm_decode_paged(
            params, pool.pages, np.zeros((w, g.pages_per_row), np.int32),
            np.zeros(w, np.int32), np.zeros(w, np.int32),
            np.zeros(w, np.int32), np.zeros(w, np.uint32),
            np.zeros(w, np.float32), np.ones(w, np.float32),
            np.zeros(w, np.int32), heads=heads, page_len=pool.page_len,
            compute_dtype=compute_dtype, kernel=kernel)
    pool.pages = kv_page_copy(pool.pages, 0, 0)
    dev = pool.pages["l0"][0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return len(buckets)
