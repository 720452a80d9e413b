"""Shape buckets and per-bucket claim queues for the serving engine.

Counterpart of ``marlin_tpu/serving/batcher.py``. A bucket is a
``(P_bucket, steps_bucket)`` pair: a request pads its prompt up to the
smallest fitting ``P_bucket``, and the bucket sizes its cache extent.
:class:`BatchFormer` keeps one priority-ordered FIFO per bucket, from which
the engine's freed rows claim work. :func:`bucket_program_key` and
:func:`capture_bucket_costs` are the roofline bookkeeping; the port has no
compiler to ask for a cost model, so the costs are counted from the shapes
(:func:`lm_call_cost`). The dense-slab ``SlotPool``, ``warmup_buckets`` and
the AOT helpers belong to the slab control, which is not ported (ROADMAP).
"""

from __future__ import annotations

import collections
from typing import Iterable, Sequence

import torch

__all__ = ["normalize_buckets", "pick_bucket", "bucket_kv_bytes",
           "BatchFormer", "bucket_program_key", "capture_bucket_costs",
           "lm_call_cost"]

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
    mix shares a step, and nothing ripens: a freed row claims work at once
    (the JAX package's ``max_wait`` is accepted there and ignored, so it has
    no counterpart here). Not thread-safe by itself — the engine calls it under its own
    condition lock (one mutator, one reader)."""

    def __init__(self, buckets: Sequence[Bucket], max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.buckets = normalize_buckets(buckets)
        self.max_batch = max_batch
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
                 attention: bool = True) -> dict:
    """Analytic cost of one LM program call, in the keys of XLA's
    ``cost_analysis()``: ``rows`` rows of ``tokens`` new tokens each,
    attending over ``context`` cache positions, then the LM head once per
    row. FLOPs: the q/k/v/o projections and the MLP (2·d·n products per
    token and layer), the two attention contractions (2·2·context·d per
    token and layer) and the head (2·d·vocab per row). Bytes: every weight
    read once, each row's K and V over ``context`` read once and its new
    entries written once, the embedding rows read and the f32 logits
    written. ``attention=False`` leaves the attention out of both, for a
    caller that counts it itself (the paged kernel's cost)."""
    from ..models.transformer import _cdtype, _leaves, _n_layers

    v, d = params["emb"].shape
    n = _n_layers(params)
    kv_dim = params["l0"]["wk"].shape[1]
    dff = params["l0"]["w1"].shape[1]
    item = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    toks = rows * tokens
    dense = 2.0 * d * (d + 2 * kv_dim + d + 2 * dff)
    flops = toks * n * dense + 2.0 * rows * d * v
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    kv_new = rows * tokens * n * 2 * kv_dim * item
    bytes_ = weights + kv_new + toks * d * item + rows * v * 4
    if attention:
        flops += toks * n * 2.0 * 2.0 * context * d
        bytes_ += rows * n * 2.0 * context * kv_dim * item
    return {"flops": float(flops), "bytes accessed": float(bytes_)}


def capture_bucket_costs(params: dict, heads: int, bucket: Bucket,
                         max_batch: int, compute_dtype: str | None = None,
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
            params, heads, 1, p, p + s, compute_dtype))
        costs.capture("lm_decode_rows", key, cost=lm_call_cost(
            params, heads, max_batch, 1, p + s, compute_dtype))
    except Exception:
        for name in programs:  # even a failed count marks the attempt
            costs.capture(name, key)
