"""The port's paged KV pool against the JAX package's.

Pool mechanics mirror the first six tests of tests/test_paging.py
(refcounts, the pinned dummy, prefix match and its limit, leaf-first LRU
eviction, copy-on-write with a device page copy, page arithmetic), run on
BOTH pools with the same calls, which must leave the same bookkeeping. Then
one request loop (``paged_serve_loop.serve_bucket``: admit, chunked
``lm_prefill_paged``, ``lm_decode_paged`` steps, release, in the order of the
JAX engine's paged loop) runs over each package's pool with the same params;
the streams must be equal, the pools' statistics equal and both audits clean.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import batcher as jbatcher
from marlin_tpu.serving import kvpool as jkv
from marlin_tpu_torch import interop
from marlin_tpu_torch.models import planner as tplanner
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.serving import batcher as tbatcher
from marlin_tpu_torch.serving import kvpool as tkv
from paged_serve_loop import serve_bucket

HEADS = 2
PAGE_LEN = 4
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return JaxLM(vocab=32, d_model=16, heads=HEADS, layers=2,
                 seed=9).init_params()


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


def _pools(jparams, tparams, num_pages):
    return (jkv.PagedKVPool(jparams, HEADS, num_pages=num_pages,
                            page_len=PAGE_LEN),
            tkv.PagedKVPool(tparams, HEADS, num_pages=num_pages,
                            page_len=PAGE_LEN))


def _same_books(jp, tp):
    assert tp.stats() == jp.stats()
    assert tp._free == jp._free
    assert np.array_equal(tp._ref, jp._ref)
    assert [(k, e.page, e.parent, e.children) for k, e in tp._cache.items()] \
        == [(k, e.page, e.parent, e.children) for k, e in jp._cache.items()]
    assert tp.audit()["ok"] and jp.audit()["ok"]


# ------------------------------------------------------------ pool units


def test_alloc_free_refcount(jparams, tparams):
    for pool, exhausted in zip(_pools(jparams, tparams, 9),
                               (jkv.PagePoolExhausted,
                                tkv.PagePoolExhausted)):
        assert pool.capacity == 8 and pool.free_count() == 8
        a = pool.alloc(3)
        b = pool.alloc(2)
        assert len(set(a) | set(b)) == 5 and 0 not in a + b
        assert pool.used_count() == 5
        pool.retain(a)
        pool.release(a)
        assert pool.used_count() == 5 and pool.shared_count() == 0
        pool.release(a)
        assert pool.used_count() == 2 and pool.free_count() == 6
        pool.release(b)
        assert pool.used_count() == 0
        with pytest.raises(exhausted):
            pool.alloc(pool.capacity + 1)
    _same_books(*_pools(jparams, tparams, 9))


def test_dummy_page_is_pinned(jparams, tparams):
    jp, tp = _pools(jparams, tparams, 4)
    for pool in (jp, tp):
        assert 0 not in pool.alloc(3)
        pool.release([0, 0])
        assert pool.free_count() == 0
    _same_books(jp, tp)


def test_prefix_cache_match_insert_and_limit(jparams, tparams):
    jp, tp = _pools(jparams, tparams, 32)
    for pool in (jp, tp):
        prompt = np.arange(10, dtype=np.int32)  # share limit = 8
        assert pool.match_prefix(prompt) == (0, [])
        pages = pool.alloc(3)
        assert pool.insert_prefix(prompt, pages) == 2
        sl, shared = pool.match_prefix(prompt)
        assert sl == 8 and shared == pages[:2] and pool.hits == 1
        sl, shared2 = pool.match_prefix(np.arange(8, dtype=np.int32))
        assert sl == 4  # the prompt's last page is never shared
        pool.release(shared + shared2)
        fork = np.concatenate([np.arange(4), [99, 98, 97, 96], [1, 2]])
        sl, shared3 = pool.match_prefix(fork.astype(np.int32))
        assert sl == 4 and shared3 == pages[:1]
        pool.release(shared3)
        pool.release(pages)
        assert pool.used_count() == pool.cached_count() == 2
    _same_books(jp, tp)


def test_prefix_cache_lru_eviction_is_leaf_first(jparams, tparams):
    jp, tp = _pools(jparams, tparams, 8)
    for pool, exhausted in ((jp, jkv.PagePoolExhausted),
                            (tp, tkv.PagePoolExhausted)):
        long = np.arange(13, dtype=np.int32)  # 3 cacheable pages
        pages = pool.alloc(4)
        pool.insert_prefix(long, pages)
        pool.release(pages)
        assert pool.cached_count() == 3 and pool.free_count() == 4
        got = pool.alloc(5)
        assert len(got) == 5 and pool.evictions == 1
        pool.release(got)
        sl, shared = pool.match_prefix(long)
        assert sl == 8 and len(shared) == 2
        with pytest.raises(exhausted):
            pool.alloc(pool.free_count() + 1)
        pool.release(shared)
        pool.alloc(pool.free_count() + 1)
        assert pool.evictions == 2 and pool.cached_count() == 1
    _same_books(jp, tp)


def test_copy_on_write_splits_shared_page(jparams, tparams):
    jp, tp = _pools(jparams, tparams, 8)
    page = jp.alloc(1)[0]
    assert tp.alloc(1)[0] == page
    k0 = jp.pages["l0"][0]
    jp.pages["l0"] = (k0.at[page].set(7.0), jp.pages["l0"][1])
    tp.pages["l0"][0][page] = 7.0
    for pool in (jp, tp):
        table = np.array([page], np.int32)
        assert not pool.ensure_writable(table, 0)
        pool.retain([page])
        assert pool.ensure_writable(table, 0)
        fresh = int(table[0])
        assert fresh != page and pool.cow_copies == 1
        assert float(np.asarray(pool.pages["l0"][0][fresh]).min()) == 7.0
        assert pool.used_count() == 2 and pool.shared_count() == 0
        assert not pool.ensure_writable(table, 0)
    _same_books(jp, tp)


def test_page_arithmetic_and_buckets(jparams, tparams):
    assert tplanner.kv_page_bytes(tparams, HEADS, 4) == 2 * 2 * 4 * 2 * 8 * 4
    for args in (((8, 4),), 2, 4), (((64, 32), (256, 64)), 8, 16):
        assert tkv.auto_num_pages(*args) == jkv.auto_num_pages(*args)
    buckets = ((256, 64), (64, 32), (64, 8))
    assert tbatcher.normalize_buckets(buckets) == \
        jbatcher.normalize_buckets(buckets)
    nb = tbatcher.normalize_buckets(buckets)
    for p, s in ((10, 5), (64, 32), (65, 1), (300, 1)):
        assert tbatcher.pick_bucket(p, s, nb) == jbatcher.pick_bucket(p, s, nb)
    for dt in (None, "bfloat16"):
        assert tbatcher.bucket_kv_bytes(tparams, HEADS, (64, 32), dt, 3) == \
            jbatcher.bucket_kv_bytes(jparams, HEADS, (64, 32), dt, 3)
    for bad in ([], [(0, 1)], [(4, 4), (4, 4)]):
        with pytest.raises(ValueError):
            tbatcher.normalize_buckets(bad)
    with pytest.raises(ValueError, match="num_pages"):
        tt.init_kv_pages(tparams, 1, 4, HEADS)


def test_paged_group_matches_jax():
    """Chunk geometry, table width, assign / finish / decode inputs /
    release of the row bookkeeping."""
    req = types.SimpleNamespace(prompt=np.arange(11, dtype=np.int32), seed=4,
                                temperature=0.5, top_p=None, top_k=3)
    entry = types.SimpleNamespace(request=req)
    groups = [m.PagedGroup((16, 8), 3, PAGE_LEN, 8) for m in (jkv, tkv)]
    for g in groups:
        g.assign(1, entry, [5, 6, 7], 4, 1)
    for g in groups:
        assert g.prefilling_slots() == [1] and g.free_slots() == [0, 2]
        g.finish_prefill(1, 9)
    for a, b in zip(groups[0].decode_inputs(), groups[1].decode_inputs()):
        assert np.array_equal(a, b)
    jg, tg = groups
    assert (tg.chunk, tg.table_width, tg.pages_per_row) == \
        (jg.chunk, jg.table_width, jg.pages_per_row)
    for name in ("tables", "positions", "steps_done", "lengths", "seeds",
                 "temperature", "top_p", "top_k", "cur_tok"):
        assert np.array_equal(getattr(tg, name), getattr(jg, name)), name
    assert tg.release(1) == jg.release(1) == [5, 6, 7]


# ------------------------------------------------------ the request loop


def _serve(kv, T, params, requests, kernel):
    streams, pool, audit, _, _ = serve_bucket(
        kv, T, params, HEADS, PAGE_LEN, requests, bucket=(20, 6), width=4,
        prefill_chunk=8, kernel=kernel)
    return streams, pool, audit


def test_request_loop_matches_jax_pool(jparams, tparams):
    """Four requests, two sharing a 12-token prefix (a prefix-cache hit, and
    a forced copy-on-write split), one sampled: the port's pool with either
    decode backend serves the JAX pool's streams, with the same statistics
    and clean audits; greedy streams equal lm_generate's."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, 32, 12)
    prompts = [np.concatenate([system, rng.integers(0, 32, 6)]),
               np.concatenate([system, rng.integers(0, 32, 3)]),
               rng.integers(0, 32, 9), rng.integers(0, 32, 17)]
    requests = [(p, 6, seed, temp) for p, seed, temp in
                zip(prompts, (1, 2, 3, 4), (0.0, 0.0, 0.9, 0.0))]
    want, jpool, jaudit = _serve(jkv, jt, jparams, requests, "gather")
    assert jaudit["ok"], jaudit["errors"]
    assert jaudit["hits"] == 1 and jaudit["cow_copies"] == 1
    for kernel in ("gather", "pallas"):
        got, tpool, taudit = _serve(tkv, tt, tparams, requests, kernel)
        assert got == want, kernel
        assert taudit == jaudit
        for name in jpool.pages:
            for a, b in zip(jpool.pages[name], tpool.pages[name]):
                np.testing.assert_allclose(b[1:].numpy(), np.asarray(a)[1:],
                                           rtol=KV_TOL, atol=KV_TOL)
    for prompt, steps, seed, temp in requests:
        if temp == 0.0:
            ref = np.asarray(jt.lm_generate(
                jparams, jnp.asarray(prompt, jnp.int32), jax.random.key(0),
                heads=HEADS, max_len=len(prompt) + steps, steps=steps))
            assert want[seed] == ref[len(prompt):].tolist()


def test_warmup_paged_touches_only_the_dummy(tparams):
    pool = tkv.PagedKVPool(tparams, HEADS, num_pages=12, page_len=PAGE_LEN)
    assert tkv.warmup_paged(tparams, HEADS, ((8, 4), (16, 4)), 2, pool, 8,
                            kernel="pallas") == 2
    for kv in pool.pages.values():
        for t in kv:
            assert float(t[1:].abs().max()) == 0.0
    assert pool.audit()["ok"] and pool.used_count() == 0
