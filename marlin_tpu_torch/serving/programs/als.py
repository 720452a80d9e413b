"""ALS recommendation scoring as a BucketProgram.

Counterpart of ``marlin_tpu/serving/programs/als.py``. Factor matrices
trained by :mod:`marlin_tpu_torch.ml.als` stay resident on the device; a
request names a user (payload ``{"user": int, "k": int?}``) and gets that
user's top-k items by inner-product score — one gather, one (W, items)
product with TF32 off, one ``torch.topk``, batched over a padded width.
Buckets are the configured k values (``serve_program_topk``); a requested k
rounds up to the smallest bucket and the Result slices back down.

``torch.topk`` orders tied scores differently from ``lax.top_k``: the items
of a tie may come out in another order, never another set.

:meth:`ALSScoreProgram.swap_model` installs freshly trained factors
atomically under the program lock: the resident tensors keep their shapes,
and the worker reads both matrices under one lock acquisition, so a batch
never sees one old and one new factor matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import get_config, resolve_device
from ...interop import to_tensor
from ...obs import perf
from ...ops.local import precision_scope
from . import register_program
from .base import BucketProgram

__all__ = ["ALSScoreProgram"]


def _als_topk(user_factors, item_factors, users, k: int):
    """Top-k items for a padded batch of users: scores = U[users] @ Vᵀ."""
    u = user_factors.index_select(0, users)             # (W, rank)
    with precision_scope("highest"):
        scores = u @ item_factors.T                     # (W, items)
    return torch.topk(scores, k, dim=1)


def _factors(model):
    """f32 tensors from an ALSModel (or any .user_features/.product_features
    pair, or a raw (users, items) 2-tuple). Tensors keep their device;
    arrays go to the configured one."""
    uf = getattr(model, "user_features", None)
    pf = getattr(model, "product_features", None)
    if uf is None or pf is None:
        uf, pf = model
    if hasattr(uf, "logical"):
        uf = uf.logical()
    if hasattr(pf, "logical"):
        pf = pf.logical()
    dev = uf.device if isinstance(uf, torch.Tensor) else resolve_device(None)
    uf = to_tensor(uf, torch.float32, dev)
    pf = to_tensor(pf, torch.float32, dev)
    if uf.ndim != 2 or pf.ndim != 2 or uf.shape[1] != pf.shape[1]:
        raise ValueError(
            f"factor shapes disagree: users {tuple(uf.shape)}, items "
            f"{tuple(pf.shape)}")
    return uf, pf


@register_program
class ALSScoreProgram(BucketProgram):
    """user → top-k item recommendations against resident ALS factors."""

    name = "als"
    cost_program = "als_score"
    resource_unit = "one padded score row: num_items x 4 bytes"

    def __init__(self, model):
        super().__init__()
        self._uf, self._pf = _factors(model)
        self.num_users = int(self._uf.shape[0])
        self.num_items = int(self._pf.shape[0])
        self.rank = int(self._uf.shape[1])
        cfg = get_config()
        ks = tuple(sorted({int(k) for k in cfg.serve_program_topk
                           if int(k) <= self.num_items}))
        if not ks:
            raise ValueError(
                f"no serve_program_topk value fits num_items="
                f"{self.num_items} (got {cfg.serve_program_topk!r})")
        self._ks = ks
        self.swap_count = 0
        self._ledger_register(self._uf, self._pf)

    def swap_model(self, model) -> None:
        """Atomically install freshly trained factors. Shapes must match
        the resident model."""
        uf, pf = _factors(model)
        if (uf.shape, pf.shape) != (self._uf.shape, self._pf.shape):
            raise ValueError(
                f"swap_model shape mismatch: resident "
                f"({tuple(self._uf.shape)}, {tuple(self._pf.shape)}), new "
                f"({tuple(uf.shape)}, {tuple(pf.shape)})")
        uf, pf = uf.to(self._uf.device), pf.to(self._pf.device)
        with self._lock:
            self._uf, self._pf = uf, pf
            self.swap_count += 1
        self._ledger_register(self._uf, self._pf)

    # ---------------------------------------------------------------- policy
    def buckets(self):
        return [(k,) for k in self._ks]

    def validate(self, request):
        p = request.payload
        if not isinstance(p, dict) or "user" not in p:
            return (f"program {self.name!r} needs payload "
                    f"{{'user': int, 'k': int?}}, got {type(p).__name__}")
        user = p["user"]
        if not 0 <= int(user) < self.num_users:
            return (f"user {user} out of range [0, {self.num_users})")
        k = int(p.get("k", self._ks[0]))
        if k < 1:
            return f"k must be >= 1, got {k}"
        return None

    def pick_bucket(self, request):
        k = int(request.payload.get("k", self._ks[0]))
        for kb in self._ks:
            if kb >= k:
                return (kb,)
        return None

    def refuse_no_bucket(self, request):
        return (f"no bucket fits program='als' k="
                f"{request.payload.get('k')} (k buckets {list(self._ks)})")

    def admission_cost(self, request, bucket):
        return self.num_items * 4

    def program_key(self, bucket, width=None):
        return perf.program_key(
            prog=self.name, users=self.num_users, items=self.num_items,
            rank=self.rank, k=bucket[0], width=width or self.width)

    def _cost(self, k: int, w: int) -> dict:
        """Analytic cost of one step: the product's FLOPs; the gathered
        rows, the item factors and the top-k values and indices moved."""
        return {"flops": 2.0 * w * self.rank * self.num_items,
                "bytes accessed": 4.0 * (w * self.rank
                                         + self.num_items * self.rank)
                + 12.0 * w * k}

    # ------------------------------------------------------------- mechanism
    def warmup(self) -> int:
        """One step per (k, padded width), and its cost record."""
        n = 0
        with self._lock:
            uf, pf = self._uf, self._pf
        for (k,) in self.buckets():
            for w in self.widths:
                self._capture_cost(self.program_key((k,), w), self._cost(k, w))
                users = torch.zeros((w,), dtype=torch.int32, device=uf.device)
                _als_topk(uf, pf, users, k)
                n += 1
        return n

    def step(self, bucket, requests):
        (k,) = bucket
        w = self.step_width(len(requests))
        users = np.zeros((w,), np.int32)
        for i, r in enumerate(requests):
            users[i] = int(r.payload["user"])
        with self._lock:
            uf, pf = self._uf, self._pf
        vals, idx = _als_topk(uf, pf, torch.from_numpy(users).to(uf.device),
                              k)
        # the one read of the card per program step: a one-shot batch
        # retires here and its Result values are host data by contract
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        out = []
        for i, r in enumerate(requests):
            want = int(r.payload.get("k", k))
            out.append({"items": idx[i, :want].copy(),
                        "scores": vals[i, :want].copy()})
        return out
