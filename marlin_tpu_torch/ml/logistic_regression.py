"""Full-batch logistic regression through dense mat-vec products.

Counterpart of ``marlin_tpu/ml/logistic_regression.py``. The reference
example (examples/LogisticRegression.scala) runs full-batch LR where each
iteration is a distributed matrix-vector product against the broadcast
weight vector; ``DenseVecMatrix.lr`` (DenseVecMatrix.scala:1005-1035) is the
in-library variant (first column = label, replaced by an intercept). The
JAX package runs the whole optimisation as one jitted ``fori_loop``; here it
is a loop on the data's device whose step sizes are computed once up front,
so no iteration reads anything on the host. On a mesh over
``torch.distributed`` ranks each rank keeps its rows, and the gradient is
summed over the rows axis by one all-reduce an iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..ops.local import precision_scope

__all__ = ["logistic_regression", "LogisticRegressionModel"]


def _lr_fori(feats: torch.Tensor, labels: torch.Tensor, step_size: float,
             iters: int, total=None) -> torch.Tensor:
    """``iters`` steps of gradient descent on the logistic loss from w = 0,
    the step at iteration i ``step_size / m / sqrt(i + 1)`` in the data's
    float type, as the JAX package rounds it. ``total`` (rank rows): ``(m,
    valid, sum)`` — the whole row count, this rank's rows that are real,
    and the gradient's sum over the ranks."""
    m = feats.shape[0] if total is None else total[0]
    np_dtype = np.float32 if feats.dtype == torch.float32 else np.float64
    i = np.arange(iters, dtype=np_dtype)
    with obs_trace.span("lr.prepare"):
        scales = torch.from_numpy(
            np_dtype(step_size) / np_dtype(m) / np.sqrt(i + np_dtype(1.0))
        ).to(feats.device)
        w = torch.zeros((feats.shape[1],), dtype=feats.dtype,
                        device=feats.device)
    with precision_scope("highest"), obs_trace.span("lr.iterate"):
        for it in range(iters):
            margin = -(feats @ w)
            mul = 1.0 / (1.0 + torch.exp(margin)) - labels
            if total is None:
                w = w - (feats.T @ mul) * scales[it]
            else:
                g = total[2](feats.T @ torch.where(total[1], mul, 0.0))
                w = w - g * scales[it]
    return w


class LogisticRegressionModel:
    def __init__(self, weights: np.ndarray):
        self.weights = weights  # [intercept, w1, ..., wd]

    def predict_proba(self, x) -> np.ndarray:
        x = np.asarray(x)
        z = self.weights[0] + x @ self.weights[1:]
        return 1.0 / (1.0 + np.exp(-z))

    def predict(self, x) -> np.ndarray:
        return (self.predict_proba(x) > 0.5).astype(np.int32)


def logistic_regression(data, step_size: float = 1.0, iterations: int = 100
                        ) -> LogisticRegressionModel:
    """Train on a dense matrix whose rows are ``(label, features...)`` (the
    DenseVecMatrix.lr contract), or on such a tensor or array. Returns the
    fitted model; its weights are read on the host once, at the end."""
    if getattr(getattr(data, "mesh", None), "ranks", None) is not None:
        return LogisticRegressionModel(_lr_ranks(data, float(step_size),
                                                 int(iterations)))
    arr = data.logical() if hasattr(data, "logical") else torch.as_tensor(data)
    m = arr.shape[0]
    labels = arr[:, 0]
    with obs_trace.span("lr.prepare"):
        feats = torch.cat([torch.ones((m, 1), dtype=arr.dtype,
                                      device=arr.device), arr[:, 1:]], dim=1)
    w = _lr_fori(feats, labels, float(step_size), int(iterations))
    with obs_trace.span("lr.read"):
        return LogisticRegressionModel(w.cpu().numpy())


def _lr_ranks(data, step_size: float, iters: int) -> np.ndarray:
    """The rank-rows run of :func:`_lr_fori` (a BlockMatrix is
    redistributed to rows first)."""
    from ..matrix.dense import _reduce

    rows = data if len(data.spec) < 2 or data.spec[1] is None \
        else data.to_dense_vec_matrix()
    arr = rows.data
    m, n = rows.shape
    (r0, r1), _ = rows.sharding.bounds(rows._padded_shape)
    with obs_trace.span("lr.prepare"):
        valid = torch.arange(r0, r1, device=arr.device) < m
        feats = torch.cat([valid[:, None].to(arr.dtype), arr[:, 1:n]], dim=1)
    w = _lr_fori(feats, arr[:, 0], step_size, iters,
                 (m, valid, lambda g: _reduce(g, rows.mesh, (rows.spec[0],))))
    with obs_trace.span("lr.read"):
        return w.cpu().numpy()

