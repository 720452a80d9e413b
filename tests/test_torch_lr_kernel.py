"""The fused logistic-gradient kernel (``csrc/lr_gradient.cuh``, wrapper
``ops/lr_gradient.py:lr_step``) on the card, held against its plain version
``lr_step_plain`` (``cuda``-marked; each skips where there is no card).

Both sum in the step's dtype in other orders, so a step's move ``w_new - w``
is compared within STEP_TOL (float32 arithmetic: float32 and bfloat16 rows)
or STEP_TOL_F64 of the same sum over absolute values, in float64: the
rounding of a sum is bounded by its terms' sizes, not by the sum, which
cancels. A row's term ``|x| |mul|`` counts beside ``|mul|`` the rounding
that ``mul`` takes from its margin's sum, at most the sigmoid's slope (1/4)
times ``|x| . |w|``. Row counts that are no multiple of a
slab or a chunk, d from 1 to the widest row of each dtype (a warp a row up
to 1024 float32 columns, the block splitting the columns past it),
``valid_rows`` below the rows, padded rows and a start that is not 16-byte
aligned; two calls on the same input give the same bits, and each call is
one launch. A fit on the card runs the kernel in every dtype it takes, and
a layout it refuses raises there instead of running the plain loop.
"""

import importlib

import numpy as np
import pytest
import torch

import marlin_tpu_torch as tm
from marlin_tpu_torch.ops import lr_gradient as lg

tlr = importlib.import_module("marlin_tpu_torch.ml.logistic_regression")

STEP_TOL = 1e-5
STEP_TOL_F64 = 1e-12
FIT_TOL = 1e-5
FIT_TOL_F64 = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rows(gen, m, d, stride, offset, device, dtype=torch.float32):
    """m rows of (label, d features) of ``dtype`` laid ``stride`` values
    apart, the first ``offset`` values into their storage."""
    store = torch.full((offset + m * stride + 8,), float("nan"),
                       device=device, dtype=dtype)
    arr = store[offset:offset + m * stride].view(m, stride)[:, :d + 1]
    x = torch.rand((m, d), generator=gen, device=device) * 2 - 1
    w = torch.randn(d, generator=gen, device=device)
    arr[:, 1:] = x
    arr[:, 0] = (x @ w > 0).to(dtype)
    return arr


def _tol(dtype):
    return STEP_TOL_F64 if dtype == torch.float64 else STEP_TOL


def _check_step(arr, w, scale, valid):
    """Two kernel steps on the same input equal bit for bit, one launch
    each, and the move is the plain step's within the dtype's tolerance."""
    want = lg.lr_step_plain(arr, w, scale, valid)
    before = lg.lr_step.launches
    got = lg.lr_step(arr, w.clone(), scale, valid)
    again = lg.lr_step(arr, w.clone(), scale, valid)
    torch.cuda.synchronize()
    assert lg.lr_step.launches == before + 2
    assert torch.equal(got, again)
    assert not torch.isnan(got).any()
    err = ((got - w) - (want - w)).abs().double()
    bound = _bound(arr, w, scale, valid)
    tol = _tol(arr.dtype)
    assert bool((err <= tol * (bound + 1e-7)).all()), \
        float((err / (bound + 1e-30)).max())


def _bound(arr, w, scale, valid):
    """The move's terms in absolute value: scale times |x|.T (|mul| + |x|
    . |w| / 4) in float64, the label column as the intercept's 1."""
    x = arr[:valid].double().clone()
    y = x[:, 0].clone()
    x[:, 0] = 1.0
    mul = torch.sigmoid(x @ w.double()) - y
    margin = x.abs() @ w.double().abs() / 4
    return x.abs().T @ (mul.abs() + margin) * float(scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 20, 512, 1023, 1024, 2047, 8191])
@pytest.mark.parametrize("m, valid, pad, offset", [
    (1, 1, 0, 0),
    (2049, 2049, 0, 0),      # one row past a chunk
    (5003, 4000, 0, 1),      # valid rows below the rows; start 4 bytes in
    (777, 777, 5, 3),        # padded rows, start 12 bytes in
    (40_000, 39_999, 0, 2),  # many chunks, the last ragged
])
def test_kernel_matches_plain(cuda, d, m, valid, pad, offset):
    gen = torch.Generator(device=cuda).manual_seed(d * 7919 + m)
    arr = _rows(gen, m, d, d + 1 + pad, offset, cuda)
    assert (arr.data_ptr() % 16 == 0) == (offset % 4 == 0)
    w = torch.randn(d + 1, generator=gen, device=cuda) * 0.1
    scale = torch.tensor([0.5 / m], device=cuda)
    _check_step(arr, w, scale, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d", [
    (torch.bfloat16, 20), (torch.bfloat16, 512), (torch.bfloat16, 1500),
    (torch.bfloat16, 8191),
    (torch.float64, 20), (torch.float64, 511), (torch.float64, 512),
    (torch.float64, 3000), (torch.float64, 4347),
])
def test_kernel_matches_plain_in_other_dtypes(cuda, dtype, d):
    """bfloat16 rows (float32 arithmetic) and float64 rows, each side of
    the width where the block splits the columns and the widest row:
    padded rows, valid rows below the rows, a start one value past 16-byte
    alignment."""
    gen = torch.Generator(device=cuda).manual_seed(d * 31 + 7)
    arr = _rows(gen, 5003, d, d + 4, 1, cuda, dtype)
    assert arr.data_ptr() % 16 != 0
    w = torch.randn(d + 1, generator=gen, device=cuda,
                    dtype=lg.step_dtype(dtype)) * 0.1
    scale = torch.tensor([0.5 / 5003], device=cuda, dtype=w.dtype)
    _check_step(arr, w, scale, 4000)


@pytest.mark.cuda
def test_no_valid_rows_leaves_w(cuda):
    arr = torch.ones((64, 21), device=cuda)
    w = torch.randn(21, device=cuda)
    got = lg.lr_step(arr, w.clone(), torch.ones(1, device=cuda), 0)
    assert torch.equal(got, w)


@pytest.mark.cuda
def test_reduce_hook_between_sum_and_update(cuda):
    """The rank path: the summed gradient goes through ``reduce`` before
    the update (here doubled, as two ranks of the same rows would)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    arr = _rows(gen, 3000, 20, 21, 0, cuda)
    w = torch.randn(21, generator=gen, device=cuda) * 0.1
    scale = torch.tensor([1e-4], device=cuda)
    one = lg.lr_step(arr, w.clone(), scale, 3000)
    two = lg.lr_step(arr, w.clone(), scale, 3000, reduce=lambda g: 2 * g)
    twice = lg.lr_step(arr, w.clone(), scale * 2, 3000)
    torch.cuda.synchronize()
    assert torch.equal(two, twice)
    assert not torch.equal(one, two)


@pytest.mark.cuda
def test_refused_layouts_raise_on_the_card(cuda):
    """The wrapper and the fit raise, with the reason, on what the kernel
    does not take; the fit never turns to the plain loop on the card."""
    w, s = torch.zeros(9, device=cuda), torch.ones(1, device=cuda)
    with pytest.raises(ValueError, match="float32, bfloat16 and float64"):
        lg.lr_step(torch.zeros((6, 9), device=cuda, dtype=torch.float16),
                   w.half(), s.half(), 6)
    with pytest.raises(ValueError, match="column stride"):
        lg.lr_step(torch.zeros((9, 6), device=cuda).T, w, s, 6)
    with pytest.raises(ValueError, match="w must be"):
        lg.lr_step(torch.zeros((6, 9), device=cuda, dtype=torch.float64), w,
                   s, 6)
    before = lg.lr_step.launches
    for bad in (torch.zeros((9, 6), device=cuda).T,
                torch.zeros((4, lg.MAX_COLS + 1), device=cuda),
                torch.zeros((4, 9), device=cuda, dtype=torch.float16)):
        with pytest.raises(ValueError, match="logistic_regression on cuda"):
            tm.ml.logistic_regression(bad, 1.0, 2)
    assert lg.lr_step.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["DenseVecMatrix", "BlockMatrix"])
def test_fit_on_the_card_matches_the_plain_loop(cuda, kind):
    """``lr`` through the kernel (one launch an iteration, no copy of the
    matrix) against the plain loop on the same rows in float64."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    data = _rows(gen, 20_000, 512, 513, 0, cuda).contiguous()
    mat = getattr(tm, kind).from_array(data)
    before = lg.lr_step.launches
    got = mat.lr(1.0, 30)
    assert lg.lr_step.launches == before + 30
    want = _plain_fit_f64(data, 1.0, 30)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIT_TOL * np.abs(want).max())


def _plain_fit_f64(data, step_size, iters):
    """The plain loop (``_lr_fori``) in float64 on the same values, on the
    card: the intercept's copy, two mat-vecs an iteration."""
    x = data.double()
    feats = torch.cat([torch.ones_like(x[:, :1]), x[:, 1:]], dim=1)
    return tlr._lr_fori(feats, x[:, 0], step_size, iters).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 512),
                                      (torch.float64, 512),
                                      (torch.float32, 2047)])
def test_fit_on_the_card_runs_the_kernel_in_every_dtype(cuda, dtype, d):
    """``logistic_regression`` on bfloat16, float64 and wide float32 rows
    on the card: one launch an iteration, weights of the step's dtype, near
    the float64 plain loop on the same values."""
    gen = torch.Generator(device=cuda).manual_seed(d + 3)
    data = _rows(gen, 20_000, d, d + 1, 0, cuda, dtype).contiguous()
    before = lg.lr_step.launches
    got = tm.ml.logistic_regression(data, 1.0, 30).weights
    assert lg.lr_step.launches == before + 30
    assert got.dtype == (np.float64 if dtype == torch.float64
                         else np.float32)
    want = _plain_fit_f64(data, 1.0, 30)
    tol = FIT_TOL_F64 if dtype == torch.float64 else FIT_TOL
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
