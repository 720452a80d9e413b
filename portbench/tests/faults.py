"""Faults planted under the timed path, for the tests that see ``correct``
come out false. Each takes ``setattr`` (pytest's ``monkeypatch.setattr``
in one process; the builtin in a spawned rank, which ends with its run),
and :func:`blocked_lu` makes a small matrix take the blocked LU loop that
the cell's size takes. :func:`planted` is a rank's entry that plants one
of them and then runs the rank as the harness does."""

from __future__ import annotations

import functools

import numpy as np
import torch


def _planted(fault, rank, world, job, log):
    from portbench import harness

    globals()[fault]()
    return harness.run_rank(rank, world, job, log)


def planted(fault: str):
    """A rank entry for :func:`portbench.harness.run_cell` that plants
    ``fault`` (a function of this module, by name) on every rank."""
    return functools.partial(_planted, fault)


def blocked_lu(setattr=setattr):
    from marlin_tpu_torch.config import get_config

    setattr(get_config(), "lu_base_size", 16)
    setattr(get_config(), "local_fallback_dim", 8)


def _wrap_multiply(setattr, change):
    from marlin_tpu_torch.matrix.dense import DenseMatrix

    orig = DenseMatrix.multiply

    def multiply(self, other, *args, **kwargs):
        c = orig(self, other, *args, **kwargs)
        change(c.data)
        return c

    setattr(DenseMatrix, "multiply", multiply)


def mm_half_rows(setattr=setattr):
    """Half of the rows of A left out: their rows of C never computed."""
    _wrap_multiply(setattr, lambda c: c[c.shape[0] // 2:].zero_())


def mm_altered(setattr=setattr):
    """One entry of C altered where it is produced."""
    _wrap_multiply(setattr, lambda c: c[0, 0].add_(1.0))


def exchange_dropped(setattr=setattr):
    """The exchange between ranks left out: what a rank would receive stays
    zero."""
    import torch.distributed as dist

    def all_to_all_single(output, input, *args, **kwargs):
        output.zero_()

    setattr(dist, "all_to_all_single", all_to_all_single)


def _wrap_lr_fori(setattr, change):
    import importlib

    lr = importlib.import_module("marlin_tpu_torch.ml.logistic_regression")
    orig = lr._lr_fori

    def fori(feats, labels, step_size, iters, total=None):
        return orig(*change(feats, labels, step_size, iters), total)

    setattr(lr, "_lr_fori", fori)


def lr_skip_step(setattr=setattr):
    """One gradient step returns the weights unchanged."""
    _wrap_lr_fori(setattr, lambda f, y, s, i: (f, y, s, i - 1))


def lr_half_batch(setattr=setattr):
    """Half of the rows left out, the mean taken over the rest."""
    _wrap_lr_fori(setattr, lambda f, y, s, i: (f[:f.shape[0] // 2],
                                               y[:y.shape[0] // 2], s, i))


def lr_altered(setattr=setattr):
    """One weight altered where it is produced."""
    from marlin_tpu_torch.matrix.dense import DenseMatrix

    orig = DenseMatrix.lr

    def lr(self, step_size, iters):
        w = np.array(orig(self, step_size, iters))
        w[1] += 0.01 * np.abs(w).max()
        return w

    setattr(DenseMatrix, "lr", lr)


def lu_skip_step(setattr=setattr):
    """Every other trailing update of the blocked LU returns the trailing
    block unchanged."""
    blocked_lu(setattr)
    orig = torch.Tensor.addmm_
    calls = []

    def addmm_(self, *args, **kwargs):
        calls.append(1)
        return self if len(calls) % 2 else orig(self, *args, **kwargs)

    setattr(torch.Tensor, "addmm_", addmm_)


def lu_altered(setattr=setattr):
    """One entry of U altered where it is produced."""
    import marlin_tpu_torch.linalg as linalg

    blocked_lu(setattr)
    orig = linalg.lu_decompose

    def lu_decompose(mat, *args, **kwargs):
        l, u, p = orig(mat, *args, **kwargs)
        u.data[0, 1] += 0.01
        return l, u, p

    setattr(linalg, "lu_decompose", lu_decompose)


def _on_rank(rank, action, setattr):
    from marlin_tpu_torch.matrix.dense import DenseMatrix

    orig = DenseMatrix.multiply

    def multiply(self, other, *args, **kwargs):
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() == rank:
            action()
        return orig(self, other, *args, **kwargs)

    setattr(DenseMatrix, "multiply", multiply)


def rank2_raises(setattr=setattr):
    """Rank 2's calls fail."""
    def fail():
        raise RuntimeError("planted failure on rank 2")

    _on_rank(2, fail, setattr)


def rank1_hangs(setattr=setattr):
    """Rank 1's calls never return."""
    import time

    _on_rank(1, lambda: time.sleep(3600), setattr)
