"""``DenseMatrix.lu_decompose`` (traffic ``mode``) of an ``n x n`` float32
matrix R + shift I, R uniform on [-1, 1): strictly diagonally dominant by
columns, so partial pivoting, whether over the pivot block or the whole
column, swaps no row. A call is ``2 n^3 / 3`` FLOPs and reads A and writes
L and U once. The check, on the matrix drawn again from the seed:
``perm_mismatch`` counts the rows the permutation places apart from a
float64 LAPACK factorization's; ``lu_backward`` is the componentwise
backward error of L and U, the largest |A[perm] - L U| over |L| |U|,
entry by entry, in float64 (forward gaps of L and U against LAPACK's do
not tell TF32 trailing updates from float32 ones at this dominance, so
they are not compared)."""

from __future__ import annotations

import torch

from portbench.inputs import uniform_rows
from portbench.reference import lu as ref_lu

TAG_A = 1


def draw(ctx, cfg) -> torch.Tensor:
    n = cfg["m"]
    a = uniform_rows(ctx.seed, TAG_A, 0, n, n, cfg["chunk_rows"], ctx.device)
    a.diagonal().add_(float(cfg["lu_shift"]))
    return a


def counts(cfg, traffic) -> tuple[float, float]:
    """(FLOPs, bytes) of one call."""
    n = cfg["m"]
    return 2.0 * n ** 3 / 3.0, 4.0 * 3 * n * n


class Case:
    def __init__(self, ctx, cfg, traffic):
        import marlin_tpu_torch as mt

        if ctx.world != 1:
            raise ValueError("the LU traffic runs in a world of one")
        if cfg["m"] != cfg["k"]:
            raise ValueError("LU needs a square matrix")
        self.ctx, self.cfg, self.traffic = ctx, cfg, traffic
        self.flops, self.bytes = counts(cfg, traffic)
        self.mat = mt.DenseVecMatrix.from_array(draw(ctx, cfg), ctx.mesh)

    def call(self):
        return self.mat.lu_decompose(mode=self.traffic["mode"])

    def keep(self, out):
        l, u, perm = out
        return l.data, u.data, perm

    def control(self):
        """The reference's blocked LU in float32 with TF32 on, at the
        program's block size."""
        from marlin_tpu_torch.config import get_config

        lu, perm = ref_lu.blocked(self.mat.data, get_config().lu_base_size,
                                  tf32=True)
        eye = torch.eye(lu.shape[0], dtype=lu.dtype, device=lu.device)
        return torch.tril(lu, -1) + eye, torch.triu(lu), perm

    def release(self):
        del self.mat

    def check(self, kept) -> dict:
        n = self.cfg["m"]
        a = draw(self.ctx, self.cfg).double()
        _, perm = ref_lu.factor(a)
        mismatch = backward = 0.0
        for l, u, p in kept:
            if tuple(l.shape) != (n, n) or tuple(u.shape) != (n, n) \
                    or tuple(p.shape) != (n,):
                return {"perm_mismatch": [float("inf"), 1.0],
                        "lu_backward": [float("inf"), 1.0]}
            mismatch = max(mismatch, float((p.cpu() != perm).sum()))
            backward = max(backward, float(ref_lu.backward_error(
                a, l.double(), u.double(), p.to(a.device))))
        return {"perm_mismatch": [mismatch, 1.0],
                "lu_backward": [backward, 1.0]}
