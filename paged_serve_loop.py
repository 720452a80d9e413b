"""One bucket of a paged KV pool, served in the order of the serving engine.

``serve_bucket`` drives requests through the device programs that the JAX
engine's paged loop calls (``marlin_tpu/serving/engine.py``: ``_admit_paged``,
``_prefill_one_chunk``, ``_step_paged``), in the same order: warm-up against
the dummy page, admit (prefix match, then alloc), chunked ``lm_prefill_paged`` behind the copy-on-write
gate, ``lm_decode_paged`` steps over the whole bucket, release.

The pool and transformer modules are arguments, so the same loop runs over
the port (``marlin_tpu_torch``, as ``chip_smoke.py`` does on the card) and over
the JAX package (as ``tests/test_torch_kvpool.py`` does to compare the two).
A request's page count comes from the port's planner: it is pure arithmetic,
the same in both packages.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from marlin_tpu_torch.models.planner import request_pages


def serve_bucket(kv, T, params, heads: int, page_len: int, requests, bucket,
                 width: int, prefill_chunk: int, kernel: str):
    """Serve ``requests`` — ``(prompt, steps, seed, temperature)`` each, at
    most ``width`` of them — through one ``bucket`` of a pool built by
    ``kv.PagedKVPool`` at ``kv.auto_num_pages`` pages, with the model
    functions of module ``T`` and decode backend ``kernel``.

    ``kv.warmup_paged`` first runs each program once against the dummy page,
    as the engine does at start. Then each request is admitted and prefilled in turn, so later prompts can hit
    the prefix cache; then all decode together, one ``lm_decode_paged`` step
    per iteration and one host sync per step, and each row is released when
    it has emitted its ``steps`` tokens (the first comes from prefill). The
    second request must share a prefix with the first: it splits its last
    shared page before its prefill, so every serve runs copy-on-write.

    Returns ``(streams, pool, audit, decode_steps, decode_s)``: the emitted
    tokens keyed by seed, the pool, its audit after the last release, and the
    number and host-clock seconds of the decode steps."""
    pool = kv.PagedKVPool(params, heads,
                          num_pages=kv.auto_num_pages([bucket], width,
                                                      page_len),
                          page_len=page_len)
    kv.warmup_paged(params, heads, [bucket], width, pool, prefill_chunk,
                    kernel=kernel)
    group = kv.PagedGroup(bucket, width, page_len, prefill_chunk)
    C = group.chunk
    for i, (prompt, steps, seed, temp) in enumerate(requests):
        req = types.SimpleNamespace(prompt=np.asarray(prompt, np.int32),
                                    steps=steps, seed=seed, temperature=temp,
                                    top_p=None, top_k=None)
        slot = group.free_slots()[0]
        n = len(req.prompt)
        shared_len, spages = pool.match_prefix(req.prompt)
        owned = pool.alloc(request_pages(n, steps, page_len) - len(spages))
        group.assign(slot, types.SimpleNamespace(request=req), spages + owned,
                     shared_len, len(spages))
        if i == 1:
            j = len(spages) - 1
            if j < 0 or not pool.ensure_writable(group.tables[slot], j):
                raise AssertionError("request 1 shares no page to split")
            group.row_pages[slot][j] = int(group.tables[slot, j])
        while group.pf_next[slot] >= 0:
            cs = int(group.pf_next[slot])
            chunk = group.prompts[slot][cs:cs + C]
            chunk = np.concatenate([chunk, np.zeros(C - len(chunk), np.int32)])
            for j in range(cs // page_len,
                           min((cs + C) // page_len, group.pages_per_row)):
                pool.ensure_writable(group.tables[slot], j)
            pool.pages, first = T.lm_prefill_paged(
                params, pool.pages, group.tables[slot], chunk, cs, n,
                heads=heads, page_len=page_len, seed=seed, temperature=temp)
            group.pf_next[slot] = cs + C
            if cs + C >= n:
                group.finish_prefill(slot, int(first))  # syncs the prefill
                pool.insert_prefix(req.prompt, group.row_pages[slot])
    streams = {}
    decode_steps = 0
    t0 = time.perf_counter()
    while group.live_slots():
        live = group.live_slots()
        for i in live:
            pool.ensure_writable(group.tables[i],
                                 int(group.positions[i]) // page_len)
        tables, positions, cur = group.decode_inputs()
        pool.pages, nxt = T.lm_decode_paged(
            params, pool.pages, tables, positions, cur, group.steps_done,
            group.seeds, group.temperature, group.top_p, group.top_k,
            heads=heads, page_len=page_len, kernel=kernel)
        # the one sync per step, as the engine's
        nxt = np.asarray(nxt.cpu() if isinstance(nxt, torch.Tensor) else nxt)
        decode_steps += 1
        for i in live:
            group.positions[i] += 1
            group.steps_done[i] += 1
            group.cur_tok[i] = int(nxt[i])
            group.emitted[i].append(int(nxt[i]))
            r = group.entries[i].request
            if group.steps_done[i] >= r.steps:
                streams[r.seed] = list(group.emitted[i])
                pool.release(group.release(i))
    decode_s = time.perf_counter() - t0
    return streams, pool, pool.audit([group]), decode_steps, decode_s

