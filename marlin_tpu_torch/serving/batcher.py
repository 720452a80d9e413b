"""Shape buckets and per-bucket claim queues for the serving engine.

Counterpart of ``marlin_tpu/serving/batcher.py``. A bucket is a
``(P_bucket, steps_bucket)`` pair: a request pads its prompt up to the
smallest fitting ``P_bucket``, and the bucket sizes its cache extent.
:class:`BatchFormer` keeps one priority-ordered FIFO per bucket, from which
the engine's freed rows claim work. :class:`SlotPool` is one bucket's
dense slab (the ``paged=False`` control), :func:`warmup_buckets` runs its
program pair once. :func:`bucket_program_key` and
:func:`capture_bucket_costs` are the roofline bookkeeping; the port has no
compiler to ask for a cost model, so the costs are counted from the shapes
(:func:`lm_call_cost`). The JAX package's AOT helpers (compiler memory
analysis) have no counterpart: eager PyTorch compiles nothing ahead.
"""

from __future__ import annotations

import collections
from typing import Iterable, Sequence

import numpy as np
import torch

__all__ = ["normalize_buckets", "pick_bucket", "bucket_kv_bytes",
           "BatchFormer", "SlotPool", "bucket_program_key",
           "capture_bucket_costs", "warmup_buckets", "lm_call_cost"]

Bucket = tuple[int, int]  # (P_bucket, steps_bucket)


def normalize_buckets(buckets: Iterable[Sequence[int]]) -> tuple[Bucket, ...]:
    """Validate and sort a bucket set ascending by (P, steps) — the order
    :func:`pick_bucket` scans, so the smallest fitting bucket is hit first."""
    out = []
    for b in buckets:
        p, s = int(b[0]), int(b[1])
        if p < 1 or s < 1:
            raise ValueError(f"bucket dims must be >= 1, got {(p, s)}")
        out.append((p, s))
    if not out:
        raise ValueError("at least one (P, steps) bucket is required")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate buckets in {out}")
    return tuple(sorted(out))


def pick_bucket(prompt_len: int, steps: int,
                buckets: Sequence[Bucket]) -> Bucket | None:
    """The smallest bucket holding a ``prompt_len``-token prompt generating
    ``steps`` tokens, or None when nothing fits (an admission rejection)."""
    for p, s in buckets:
        if prompt_len <= p and steps <= s:
            return (p, s)
    return None


def bucket_kv_bytes(params: dict, heads: int, bucket: Bucket,
                    compute_dtype=None, batch: int = 1) -> int:
    """KV-cache bytes of one bucket row (times ``batch``): layers x 2 x
    (P + steps) x kv_heads x dh in the compute dtype."""
    from ..models.transformer import _cdtype, _n_layers

    p, s = bucket
    d = params["emb"].shape[1]
    dh = d // heads
    kv_dim = params["l0"]["wk"].shape[1]  # kv_heads * dh (GQA-aware)
    itemsize = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    return _n_layers(params) * 2 * (p + s) * (kv_dim // dh) * dh \
        * itemsize * batch


class _Group:
    """One bucket's stream of pending entries, kept in dispatch order:
    higher priority first, FIFO among equals (stable sort on a monotonic
    sequence number keeps arrival order)."""

    def __init__(self):
        self.entries: list = []  # (-priority, seq, entry)

    def add(self, entry, seq: int) -> None:
        self.entries.append((-entry.request.priority, seq, entry))
        self.entries.sort(key=lambda t: t[:2])

    def take(self, n: int):
        taken = [e for _, _, e in self.entries[:n]]
        del self.entries[:n]
        return taken


class BatchFormer:
    """One priority-ordered claim queue per bucket. Sampling knobs never
    partition anything — they are per-row vectors in the decode step, so ANY
    mix shares a step, and nothing ripens: a freed row claims work at once.
    ``max_wait`` (seconds, >= 0) is checked and kept as the JAX package
    keeps it, and row-level scheduling ignores it, as there. Not thread-safe
    by itself — the engine calls it under its own condition lock (one
    mutator, one reader)."""

    def __init__(self, buckets: Sequence[Bucket], max_batch: int,
                 max_wait: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.buckets = normalize_buckets(buckets)
        self.max_batch = max_batch
        self.max_wait = max_wait  # nothing ripens: row-level ignores it
        self._groups: dict[Bucket, _Group] = collections.defaultdict(_Group)
        self._seq = 0

    def add(self, entry) -> None:
        """File one admitted entry under its bucket. ``entry.bucket`` and
        ``entry.enq_t`` were set at admission (engine.submit)."""
        self._groups[entry.bucket].add(entry, self._seq)
        self._seq += 1

    def pending(self) -> int:
        return sum(len(g.entries) for g in self._groups.values())

    def take_all(self) -> list:
        """Drain every pending entry (close() path — they get ShuttingDown
        results, never a decode)."""
        out = []
        for g in self._groups.values():
            out.extend(g.take(len(g.entries)))
        return out

    def pending_buckets(self) -> set:
        """Buckets that currently have pending entries (which groups might
        claim work this iteration)."""
        return {b for b, g in self._groups.items() if g.entries}

    def take_for_bucket(self, bucket: Bucket, n: int) -> list:
        """Up to ``n`` entries bound for ``bucket`` in dispatch order: a
        freed row takes the best pending request immediately."""
        return self._groups[bucket].take(n) if bucket in self._groups else []


class SlotPool:
    """One bucket's persistent KV slab for the dense-slab control
    (``ServeEngine(paged=False)``): which slot holds which entry, the per-row
    vectors the decode step takes (positions, emitted-step counts, sampling
    knobs; host numpy), and the slab itself (``caches`` from
    :func:`~marlin_tpu_torch.models.transformer.init_kv_slab` and the
    ``tokens`` rows, on the params' device, updated in place). Only the
    engine's worker touches a pool."""

    def __init__(self, params: dict, heads: int, bucket: Bucket, width: int,
                 compute_dtype: str | None = None):
        from ..models.transformer import init_kv_slab

        p, s = bucket
        self.bucket = bucket
        self.width = width
        self.max_len = p + s
        self.caches = init_kv_slab(params, width, self.max_len, heads,
                                   compute_dtype)
        self.tokens = torch.zeros((width, self.max_len), dtype=torch.long,
                                  device=params["emb"].device)
        self.entries: list = [None] * width
        # decode inputs; free slots keep position 0 (a harmless dummy step
        # inside their own row — see lm_decode_rows)
        self.positions = np.zeros(width, np.int32)
        self.steps_done = np.zeros(width, np.int32)
        self.lengths = np.zeros(width, np.int32)
        self.seeds = np.zeros(width, np.uint32)
        self.temperature = np.zeros(width, np.float32)
        self.top_p = np.ones(width, np.float32)   # 1.0 = nucleus filter off
        self.top_k = np.zeros(width, np.int32)    # 0 = rank filter off
        self.ttft_s = [None] * width

    def nbytes(self) -> int:
        """Device bytes of the slab (caches and token rows)."""
        return sum(t.numel() * t.element_size()
                   for kv in self.caches.values() for t in kv) \
            + self.tokens.numel() * self.tokens.element_size()

    def live_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is not None]

    def free_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is None]

    def occupancy(self) -> float:
        return len(self.live_slots()) / self.width

    def assign(self, slot: int, entry) -> None:
        """Bind an admitted entry to a freed slot after its prefill: the
        row's position is its first emitted token (= prompt length) and its
        sampling vectors come from the request."""
        r = entry.request
        self.entries[slot] = entry
        n = r.prompt.shape[0]
        self.lengths[slot] = n
        self.positions[slot] = n          # index of the last written token
        self.steps_done[slot] = 1         # prefill emitted the first token
        self.seeds[slot] = np.uint32(r.seed)
        self.temperature[slot] = r.temperature
        self.top_p[slot] = 1.0 if r.top_p is None else r.top_p
        self.top_k[slot] = 0 if r.top_k is None else r.top_k
        self.ttft_s[slot] = None

    def release(self, slot: int) -> None:
        """Free a slot on any retirement path (the next occupant's prefill
        overwrites the stale cache and token row whole)."""
        self.entries[slot] = None
        self.positions[slot] = 0
        self.steps_done[slot] = 0
        self.lengths[slot] = 0
        self.temperature[slot] = 0.0
        self.top_p[slot] = 1.0
        self.top_k[slot] = 0
        self.ttft_s[slot] = None


def _dummy_batch(bucket: Bucket, batch: int):
    """An inert full-width batch for a bucket: 1-token rows of token 0."""
    p, _ = bucket
    return np.zeros((batch, p), np.int32), np.ones((batch,), np.int32)


def bucket_program_key(params: dict, bucket: Bucket, max_batch: int,
                       compute_dtype=None) -> str:
    """The roofline-accounting key for one bucket's programs (obs/perf.py),
    the JAX package's key string. Capture sites and measurement sites (the
    engine's step/prefill timings) MUST both build the key here, or the
    cost/timing join silently misses."""
    from ..models.transformer import _cdtype, _n_layers
    from ..obs import perf

    p, s = bucket
    dt = str(_cdtype(compute_dtype, params)).replace("torch.", "")
    # the model geometry is part of the program identity: two models with
    # the same bucket/width/dtype run different programs with different
    # costs, and their entries must not collide
    v, d = params["emb"].shape
    return perf.program_key(bucket=f"{p}x{s}", rows=max_batch, dtype=dt,
                            model=f"v{v}d{d}l{_n_layers(params)}")


def lm_call_cost(params: dict, heads: int, rows: int, tokens: int,
                 context: int, compute_dtype=None,
                 attention: bool = True, moe: tuple | None = None) -> dict:
    """Analytic cost of one LM program call, in the keys of XLA's
    ``cost_analysis()``: ``rows`` rows of ``tokens`` new tokens each,
    attending over ``context`` cache positions, then the LM head once per
    row. FLOPs per token and layer: the q/k/v/o projections (2·d·n
    products), the FFN — dense 2·2·d·ff; a mixture-of-experts layer its
    router 2·d·E and its top-k experts k·2·2·d·ff (``moe``'s top_k, default
    2) — and the two attention contractions (2·2·context·d); the head
    2·d·vocab per row. Bytes: every weight a token can read, once (a MoE
    layer's router whole, and of its experts ``min(E, tokens·k)``: the most
    that many choices can reach), each row's K and V over ``context`` read
    once and its new entries written once, the embedding rows read and the
    f32 logits written. ``attention=False`` leaves the attention out of
    both, for a caller that counts it itself (the paged kernel's cost)."""
    from ..models.transformer import _cdtype, _moe_knobs, _n_layers

    v, d = params["emb"].shape
    n = _n_layers(params)
    kv_dim = params["l0"]["wk"].shape[1]
    top_k = _moe_knobs(moe)[0]
    item = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    toks = rows * tokens
    per_tok = 0.0   # flops of one token through every layer
    weights = nbytes(params["emb"]) + nbytes(params["ln_f"])
    for i in range(n):
        lp = params[f"l{i}"]
        per_tok += 2.0 * d * (2 * d + 2 * kv_dim)
        weights += sum(nbytes(lp[k]) for k in
                       ("wq", "wk", "wv", "wo", "ln1", "ln2"))
        if "moe" in lp:
            mp = lp["moe"]
            e, _, dff = mp["w1"].shape
            per_tok += 2.0 * d * e + top_k * 2.0 * 2 * d * dff
            reached = min(e, toks * top_k)
            weights += nbytes(mp["wg"]) + reached * (
                nbytes(mp["w1"]) + nbytes(mp["w2"])) // e
        else:
            per_tok += 2.0 * 2 * d * lp["w1"].shape[1]
            weights += nbytes(lp["w1"]) + nbytes(lp["w2"])
    flops = toks * per_tok + 2.0 * rows * d * v
    kv_new = rows * tokens * n * 2 * kv_dim * item
    bytes_ = weights + kv_new + toks * d * item + rows * v * 4
    if attention:
        flops += toks * n * 2.0 * 2.0 * context * d
        bytes_ += rows * n * 2.0 * context * kv_dim * item
    return {"flops": float(flops), "bytes accessed": float(bytes_)}


def capture_bucket_costs(params: dict, heads: int, bucket: Bucket,
                         max_batch: int, compute_dtype: str | None = None,
                         moe: tuple | None = None,
                         key: str | None = None) -> None:
    """Record the analytic cost models of a bucket's dense-slab program pair
    (``lm_prefill_slot``: one row's whole padded prompt over the bucket
    extent; ``lm_decode_rows``: ``max_batch`` rows of one token) in the
    process :class:`~marlin_tpu_torch.obs.perf.ProgramCosts` registry, gated
    per (program, key) so a repeated call costs two dict lookups. Never
    raises: cost capture is observability. The paged pair
    records through :func:`~.kvpool.capture_paged_costs`."""
    from ..obs import perf

    costs = perf.get_program_costs()
    if key is None:
        key = bucket_program_key(params, bucket, max_batch, compute_dtype)
    programs = ("lm_prefill_slot", "lm_decode_rows")
    if all(costs.tried(name, key) for name in programs):
        return
    p, s = bucket
    try:
        costs.capture("lm_prefill_slot", key, cost=lm_call_cost(
            params, heads, 1, p, p + s, compute_dtype, moe=moe))
        costs.capture("lm_decode_rows", key, cost=lm_call_cost(
            params, heads, max_batch, 1, p + s, compute_dtype, moe=moe))
    except Exception:
        for name in programs:  # even a failed count marks the attempt
            costs.capture(name, key)


def warmup_buckets(params: dict, heads: int, buckets: Sequence[Bucket],
                   max_batch: int, compute_dtype: str | None = None,
                   moe: tuple | None = None) -> int:
    """Run every bucket's dense-slab program pair once on dummy rows (a
    slot prefill and one decode step over a throwaway slab): builds the CUDA
    kernels the pair reaches and warms the allocator before traffic, and
    records each bucket's cost models (:func:`capture_bucket_costs`). Paged
    engines warm through :func:`~.kvpool.warmup_paged` instead. Returns the
    buckets warmed."""
    from ..models.transformer import lm_decode_rows, lm_prefill_slot

    buckets = normalize_buckets(buckets)
    for bucket in buckets:
        p, s = bucket
        prompts, _ = _dummy_batch(bucket, max_batch)
        capture_bucket_costs(params, heads, bucket, max_batch,
                             compute_dtype, moe)
        pool = SlotPool(params, heads, bucket, max_batch, compute_dtype)
        caches, tokens, _ = lm_prefill_slot(
            params, pool.caches, pool.tokens, 0, prompts[0], 1,
            heads=heads, max_len=p + s, compute_dtype=compute_dtype,
            moe=moe)
        _, _, nxt = lm_decode_rows(
            params, caches, tokens, pool.positions, pool.steps_done,
            pool.seeds, pool.temperature, pool.top_p, pool.top_k,
            heads=heads, max_len=p + s, compute_dtype=compute_dtype,
            moe=moe)
        if nxt.device.type == "cuda":
            torch.cuda.synchronize(nxt.device)
    return len(buckets)
