"""Full-batch logistic-gradient descent over rows of (label, features),
the semantics of ``DenseVecMatrix.lr``: the label column is replaced by a
1-intercept, w starts at 0, and step i moves w by ``step_size / m /
sqrt(i + 1)`` times the gradient sum over the rows."""

from __future__ import annotations

import math

import torch

from .matmul import tf32_round


def fit(data: torch.Tensor, step_size: float, iters: int, block: int,
        tf32: bool = False) -> torch.Tensor:
    """The weights ``[intercept, w1, ..., wd]`` after ``iters`` steps, in
    float64 over row blocks of ``block`` rows; with ``tf32`` in float32,
    each product's operands rounded to TF32."""
    m, n = data.shape
    dt = torch.float32 if tf32 else torch.float64
    rnd = tf32_round if tf32 else (lambda t: t)
    w = torch.zeros(n, dtype=dt, device=data.device)
    for it in range(iters):
        g = torch.zeros(n, dtype=dt, device=data.device)
        wr = rnd(w)
        for r0 in range(0, m, block):
            x = data[r0:r0 + block].to(dt, copy=True)
            y = x[:, 0].clone()
            x[:, 0] = 1.0
            x = rnd(x)
            mul = torch.sigmoid(x @ wr) - y
            g += x.T @ rnd(mul)
            del x
        w = w - g * (step_size / m / math.sqrt(it + 1))
    return w
