"""``DenseMatrix.lr(step_size, iters)``: full-batch logistic regression over
``m`` rows of (label, ``d`` float32 features uniform on [-1, 1)). The
labels are 0/1 draws of sigmoid(x . w*) for a planted w* ~ N(0, 12 / d)
(margins of standard deviation 2). A call is two mat-vecs an iteration,
``4 m (d + 1)`` FLOPs, and one read of the ``m x (d + 1)`` matrix an
iteration. The check holds the weights against the float64 reference
(``reference/lr.py``) on the rows drawn again from the seed: ``w_gap`` is
the largest gap over the largest |weight| of the reference."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.inputs import generator, uniform_rows
from portbench.reference import lr as ref_lr

TAG_X, TAG_W, TAG_Y = 1, 2, 3
CHECK_ROWS = 1_000_000  # rows of the reference's blocks


def draw(ctx, cfg) -> torch.Tensor:
    m, d, chunk = cfg["m"], cfg["d"], cfg["chunk_rows"]
    data = torch.empty((m, d + 1), dtype=torch.float32, device=ctx.device)
    w = torch.randn(d, generator=generator(ctx.seed, TAG_W, 0, ctx.device),
                    dtype=torch.float32, device=ctx.device) * math.sqrt(12 / d)
    for r0 in range(0, m, chunk):
        r1 = min(r0 + chunk, m)
        x = uniform_rows(ctx.seed, TAG_X, r0, r1, d, chunk, ctx.device)
        u = torch.rand(r1 - r0, generator=generator(ctx.seed, TAG_Y, r0 // chunk,
                                                    ctx.device),
                       dtype=torch.float32, device=ctx.device)
        data[r0:r1, 0] = (u < torch.sigmoid(x @ w)).float()
        data[r0:r1, 1:] = x
        del x, u
    return data


def counts(cfg, traffic) -> tuple[float, float]:
    """(FLOPs, bytes) of one call."""
    per_iter = cfg["m"] * (cfg["d"] + 1) * traffic["iters"]
    return 4.0 * per_iter, 4.0 * per_iter


class Case:
    def __init__(self, ctx, cfg, traffic):
        import marlin_tpu_torch as mt

        if ctx.world != 1:
            raise ValueError("the lr traffic runs in a world of one")
        self.ctx, self.cfg, self.traffic = ctx, cfg, traffic
        self.flops, self.bytes = counts(cfg, traffic)
        self.mat = mt.DenseVecMatrix.from_array(draw(ctx, cfg), ctx.mesh)

    def call(self):
        return self.mat.lr(self.traffic["step_size"], self.traffic["iters"])

    def keep(self, w):
        return np.array(w, dtype=np.float64)

    def control(self):
        """The reference in float32 with every product's operands rounded
        to TF32."""
        return ref_lr.fit(self.mat.data, self.traffic["step_size"],
                          self.traffic["iters"], CHECK_ROWS,
                          tf32=True).double().cpu().numpy()

    def release(self):
        del self.mat

    def check(self, kept) -> dict:
        data = draw(self.ctx, self.cfg)
        ref = ref_lr.fit(data, self.traffic["step_size"],
                         self.traffic["iters"], CHECK_ROWS).cpu().numpy()
        del data
        num = 0.0
        for w in kept:
            if w.shape != ref.shape:
                return {"w_gap": [float("inf"), 1.0]}
            num = max(num, float(np.abs(w - ref).max()))
        return {"w_gap": [num, float(np.abs(ref).max())]}
