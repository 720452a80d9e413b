"""The plain references at small sizes against NumPy in float64."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import lr as ref_lr
from portbench.reference import lu as ref_lu
from portbench.reference import matmul as ref_mm


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


def test_product_is_float64():
    a, b = _rand((33, 17), 1), _rand((17, 9), 2)
    c = ref_mm.product(a, b)
    assert c.dtype == torch.float64
    np.testing.assert_allclose(c.numpy(), a.double().numpy()
                               @ b.double().numpy(), rtol=0, atol=1e-13)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = _rand((1000,), 3) * 1e3
    x[:4] = torch.tensor([1.0, -2.5, 0.0, 1.0 + 2.0 ** -11])
    r = ref_mm.tf32_round(x)
    bits = r.view(torch.int32).numpy()
    assert not (bits & 0x1FFF).any()
    rel = np.abs(r.numpy().astype(np.float64) - x.numpy()) / np.maximum(
        np.abs(x.numpy()), 1e-30)
    assert rel.max() <= 2.0 ** -11
    assert r[:3].tolist() == [1.0, -2.5, 0.0]
    assert r[3].item() == 1.0  # a tie goes to the even mantissa


def _dominant(n, seed):
    a = _rand((n, n), seed)
    a.diagonal().add_(float(n))
    return a


@pytest.mark.parametrize("n", [5, 48])
def test_lu_factor_against_float64(n):
    a = _dominant(n, n)
    lu, perm = ref_lu.factor(a)
    l = np.tril(lu.numpy(), -1) + np.eye(n)
    u = np.triu(lu.numpy())
    np.testing.assert_allclose(l @ u, a.double().numpy()[perm.numpy()],
                               rtol=0, atol=1e-12 * n)
    assert perm.tolist() == list(range(n))  # dominant: no row moves


def test_perm_from_pivots_replays_the_swaps():
    piv = torch.tensor([3, 3, 3, 4], dtype=torch.int32)  # 1-based
    # swaps (0,2), (1,2), (2,2), (3,3) on [0, 1, 2, 3]
    assert ref_lu.perm_from_pivots(piv).tolist() == [2, 0, 1, 3]


def test_blocked_lu_equals_the_unblocked():
    a = _dominant(40, 4)
    lu, perm = ref_lu.blocked(a, 16, tf32=False)
    lu64, perm64 = ref_lu.factor(a)
    assert torch.equal(perm, perm64)
    np.testing.assert_allclose(lu.double().numpy(), lu64.numpy(), rtol=0,
                               atol=1e-5)


def _lr_numpy(data, step, iters):
    x = data.astype(np.float64).copy()
    y = x[:, 0].copy()
    x[:, 0] = 1.0
    m = x.shape[0]
    w = np.zeros(x.shape[1])
    for i in range(iters):
        mul = 1.0 / (1.0 + np.exp(-(x @ w))) - y
        w = w - step / m / np.sqrt(i + 1) * (x.T @ mul)
    return w


@pytest.mark.parametrize("tf32, tol", [(False, 1e-12), (True, 2e-3)])
def test_lr_fit_against_numpy(tf32, tol):
    data = _rand((300, 9), 5)
    data[:, 0] = (data[:, 0] > 0).float()
    want = _lr_numpy(data.numpy(), 1.0, 30)
    got = ref_lr.fit(data, 1.0, 30, block=128, tf32=tf32).double().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert data[:, 0].max() == 1.0  # the labels are left in place


def test_backward_error_of_exact_and_altered_factors():
    a = _dominant(24, 6)
    lu, perm = ref_lu.factor(a)
    l = torch.tril(lu, -1) + torch.eye(24, dtype=lu.dtype)
    u = torch.triu(lu)
    a64 = a.double()
    assert ref_lu.backward_error(a64, l, u, perm) < 1e-14
    u[3, 7] *= 1 + 1e-6
    assert ref_lu.backward_error(a64, l, u, perm) > 5e-7
