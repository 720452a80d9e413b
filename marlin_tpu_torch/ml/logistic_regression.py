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

On a CUDA card an iteration is one read of the stored rows by the fused
step (``ops/lr_gradient.py``), with the label column standing for the
intercept and no copy; a layout the kernel does not take raises there,
with its reason. Elsewhere (the CPU) the plain loop runs: two mat-vecs an
iteration over a copy with the intercept in place of the label, in float64
for float64 rows and in float32 otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..ops.local import precision_scope
from ..ops.lr_gradient import lr_step, lr_step_refusal, step_dtype

__all__ = ["logistic_regression", "LogisticRegressionModel"]


def _lr_fori(feats: torch.Tensor, labels: torch.Tensor, step_size: float,
             iters: int, total=None) -> torch.Tensor:
    """``iters`` steps of gradient descent on the logistic loss from w = 0,
    the step at iteration i ``step_size / m / sqrt(i + 1)`` in the data's
    float type, as the JAX package rounds it. ``total`` (rank rows): ``(m,
    valid, sum)`` — the whole row count, this rank's rows that are real,
    and the gradient's sum over the ranks."""
    m = feats.shape[0] if total is None else total[0]
    with obs_trace.span("lr.prepare"):
        scales = _step_sizes(step_size, m, iters, feats.dtype, feats.device)
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


def _step_sizes(step_size: float, m: int, iters: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """``step_size / m / sqrt(i + 1)`` for each iteration i, computed on the
    host in ``dtype`` (float32 or float64, as the JAX package rounds it)
    and uploaded to ``device`` once."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    i = np.arange(iters, dtype=np_dtype)
    return torch.from_numpy(
        np_dtype(step_size) / np_dtype(m) / np.sqrt(i + np_dtype(1.0))
    ).to(device)


def _fit(arr: torch.Tensor, step_size: float, iters: int, m: int,
         valid_rows: int, reduce=None) -> torch.Tensor:
    """The weights after ``iters`` steps over rows of (label, features): the
    first ``valid_rows`` of ``arr`` are real, ``m`` rows in all, and
    ``reduce`` sums the gradient over the ranks. On a CUDA card the fused
    step on the rows in place, refusing what it does not take; elsewhere
    :func:`_lr_fori` over a copy with the intercept (0 in rows past
    ``valid_rows``) in place of the label."""
    dtype = step_dtype(arr.dtype)
    if arr.device.type == "cuda":
        why = lr_step_refusal(arr)
        if why is not None:
            raise ValueError(f"logistic_regression on {arr.device}: {why}")
        with obs_trace.span("lr.prepare"):
            scales = _step_sizes(step_size, m, iters, dtype, arr.device)
            w = torch.zeros((arr.shape[1],), dtype=dtype, device=arr.device)
        with obs_trace.span("lr.iterate"):
            for it in range(iters):
                w = lr_step(arr, w, scales[it:it + 1], valid_rows, reduce)
        return w
    with obs_trace.span("lr.prepare"):
        valid = torch.arange(arr.shape[0], device=arr.device) < valid_rows
        feats = torch.cat([valid[:, None].to(dtype), arr[:, 1:].to(dtype)],
                          dim=1)
    total = None if reduce is None else (m, valid, reduce)
    return _lr_fori(feats, arr[:, 0].to(dtype), step_size, iters, total)


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
    w = _fit(arr, float(step_size), int(iterations), arr.shape[0],
             arr.shape[0])
    with obs_trace.span("lr.read"):
        return LogisticRegressionModel(w.cpu().numpy())


def _lr_ranks(data, step_size: float, iters: int) -> np.ndarray:
    """:func:`_fit` on this rank's rows, the gradient summed over the rows
    axis (a BlockMatrix is redistributed to rows first)."""
    from ..matrix.dense import _reduce

    rows = data if len(data.spec) < 2 or data.spec[1] is None \
        else data.to_dense_vec_matrix()
    arr = rows.data
    m, n = rows.shape
    (r0, r1), _ = rows.sharding.bounds(rows._padded_shape)
    w = _fit(arr[:, :n], step_size, iters, m, min(r1, m) - r0,
             lambda g: _reduce(g, rows.mesh, (rows.spec[0],)))
    with obs_trace.span("lr.read"):
        return w.cpu().numpy()
