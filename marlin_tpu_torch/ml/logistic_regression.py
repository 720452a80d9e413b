"""Full-batch logistic regression through dense mat-vec products.

Counterpart of ``marlin_tpu/ml/logistic_regression.py``. The reference
example (examples/LogisticRegression.scala) runs full-batch LR where each
iteration is a distributed matrix-vector product against the broadcast
weight vector; ``DenseVecMatrix.lr`` (DenseVecMatrix.scala:1005-1035) is the
in-library variant (first column = label, replaced by an intercept). The
JAX package runs the whole optimisation as one jitted ``fori_loop``; here it
is a loop on the data's device whose step sizes are computed once up front,
so no iteration reads anything on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.local import precision_scope

__all__ = ["logistic_regression", "LogisticRegressionModel"]


def _lr_fori(feats: torch.Tensor, labels: torch.Tensor, step_size: float,
             iters: int) -> torch.Tensor:
    """``iters`` steps of gradient descent on the logistic loss from w = 0,
    the step at iteration i ``step_size / m / sqrt(i + 1)`` in the data's
    float type, as the JAX package rounds it."""
    m = feats.shape[0]
    np_dtype = np.float32 if feats.dtype == torch.float32 else np.float64
    i = np.arange(iters, dtype=np_dtype)
    scales = torch.from_numpy(
        np_dtype(step_size) / np_dtype(m) / np.sqrt(i + np_dtype(1.0))
    ).to(feats.device)
    w = torch.zeros((feats.shape[1],), dtype=feats.dtype, device=feats.device)
    with precision_scope("highest"):
        for it in range(iters):
            margin = -(feats @ w)
            mul = 1.0 / (1.0 + torch.exp(margin)) - labels
            w = w - (feats.T @ mul) * scales[it]
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
    arr = data.logical() if hasattr(data, "logical") else torch.as_tensor(data)
    m = arr.shape[0]
    labels = arr[:, 0]
    feats = torch.cat([torch.ones((m, 1), dtype=arr.dtype, device=arr.device),
                       arr[:, 1:]], dim=1)
    w = _lr_fori(feats, labels, float(step_size), int(iterations))
    return LogisticRegressionModel(w.cpu().numpy())
