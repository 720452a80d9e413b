"""C = A @ B through ``DenseMatrix.multiply`` (traffic ``strategy``), A and
B ``m x k`` and ``k x n`` float32 with entries uniform on [-1, 1). Over a
(p, 1) rank mesh each rank holds its row block of A and of B and gets its
row block of C. A call is ``2 m k n`` FLOPs and reads A and B and writes C
once. The check holds every row of C against float64 products of the
rows drawn again from the seed; ``c_gap`` is the largest gap over the
largest |entry| of the reference."""

from __future__ import annotations

import torch

from portbench.inputs import uniform_rows
from portbench.reference.matmul import product

TAG_A, TAG_B = 1, 2
CHECK_ROWS = 5000  # rows of C checked at once


def counts(cfg, traffic) -> tuple[float, float]:
    """(FLOPs, bytes) of one call."""
    m, k, n = cfg["m"], cfg["k"], cfg["n"]
    return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)


class Case:
    def __init__(self, ctx, cfg, traffic):
        import marlin_tpu_torch as mt
        from marlin_tpu_torch.mesh import ROWS

        self.ctx, self.cfg, self.traffic = ctx, cfg, traffic
        m, k, n = cfg["m"], cfg["k"], cfg["n"]
        self.flops, self.bytes = counts(cfg, traffic)
        p = ctx.world
        if m % p or k % p:
            raise ValueError(f"{p} ranks do not divide {m} x {k}")
        self.rows = (ctx.rank * m // p, (ctx.rank + 1) * m // p)
        ka = (ctx.rank * k // p, (ctx.rank + 1) * k // p)
        chunk, dev = cfg["chunk_rows"], ctx.device
        a = uniform_rows(ctx.seed, TAG_A, *self.rows, k, chunk, dev)
        b = uniform_rows(ctx.seed, TAG_B, *ka, n, chunk, dev)
        if p == 1:
            self.a = mt.DenseVecMatrix.from_array(a, ctx.mesh)
            self.b = mt.DenseVecMatrix.from_array(b, ctx.mesh)
        else:  # this rank's row blocks of the (p, 1) mesh's layout
            spec = (ROWS, None)
            self.a = mt.DenseVecMatrix(a, (m, k), ctx.mesh, spec)
            self.b = mt.DenseVecMatrix(b, (k, n), ctx.mesh, spec)

    def call(self, precision=None):
        return self.a.multiply(self.b, strategy=self.traffic["strategy"],
                               precision=precision)

    def keep(self, c):
        return c.data

    def control(self):
        """The program's own TF32 path (``precision="default"``)."""
        return self.keep(self.call(precision="default"))

    def release(self):
        del self.a, self.b

    def check(self, kept) -> dict:
        cfg, ctx = self.cfg, self.ctx
        k, n, chunk = cfg["k"], cfg["n"], cfg["chunk_rows"]
        r0, r1 = self.rows
        b = uniform_rows(ctx.seed, TAG_B, 0, k, n, chunk, ctx.device)
        num = den = 0.0
        for c in kept:
            if tuple(c.shape) != (r1 - r0, n):
                return {"c_gap": [float("inf"), 1.0]}
        for s in range(r0, r1, CHECK_ROWS):
            e = min(s + CHECK_ROWS, r1)
            ref = product(uniform_rows(ctx.seed, TAG_A, s, e, k, chunk,
                                       ctx.device), b)
            den = max(den, float(ref.abs().max()))
            for c in kept:
                num = max(num, float((c[s - r0:e - r0].double() - ref)
                                     .abs().max()))
            del ref
        return {"c_gap": [num, den]}
