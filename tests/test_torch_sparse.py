"""The sparse half of the sparse slice of marlin_tpu_torch against the JAX
package: ELL, the COO (BCOO) block ops, ``SparseVecMatrix``,
``CoordinateMatrix``, the seeded random draws and the interop carriers.

The same numpy inputs (made from a seed) go through ``marlin_tpu`` (on a 1×1
CPU mesh) and ``marlin_tpu_torch`` on the CPU.

Tolerances: index arrays and host-side factories are exact (the same
arithmetic); the seeded draws are bit for bit (integer hashing). f32 products:
rtol/atol 1e-4, as in tests/test_sparse.py, both against the JAX package and
against numpy in f64: the two frameworks sum the same products in another
order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import marlin_tpu as jmt
from marlin_tpu.mesh import create_mesh as jax_mesh
from marlin_tpu.ops import local as jlocal
from marlin_tpu.ops import sparse_ell as jell
import marlin_tpu_torch as tmt
from marlin_tpu_torch import config_context, interop, threefry
from marlin_tpu_torch.ops import local as tlocal
from marlin_tpu_torch.ops import sparse_ell as tell

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh((1, 1))


def _dense(seed, shape=(12, 10), density=0.2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    a[rng.random(shape) > density] = 0.0
    return a


# the operands of the COO block-op tests: one pair, so that the JAX package
# compiles its sparse contractions once per process
A = _dense(30, (12, 9), 0.3)
B = _dense(31, (9, 11), 0.3)


def _jbcoo(a):
    """``BCOO.fromdense(a)`` built from its numpy indices (row-major, as
    fromdense orders them), without compiling fromdense for each nse."""
    r, c = np.nonzero(a)
    return jsparse.BCOO((jnp.asarray(a[r, c]),
                         jnp.asarray(np.stack([r, c], 1).astype(np.int32))),
                        shape=a.shape)


def _coo(seed, shape, nnz, hub_row=None, hub_deg=0):
    """Random COO triplets (no duplicates), with an optional hub row holding
    ``hub_deg`` extra entries."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(shape[0] * shape[1], nnz, replace=False)
    rows, cols = flat // shape[1], flat % shape[1]
    if hub_row is not None:
        hub_cols = rng.choice(shape[1], hub_deg, replace=False)
        keep = rows != hub_row
        rows = np.r_[rows[keep], np.full(hub_deg, hub_row)]
        cols = np.r_[cols[keep], hub_cols]
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def _sorted_triplets(r, c, v):
    r, c, v = (np.asarray(x) for x in (r, c, v))
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def _same_triplets(got, want, exact_values=False):
    gr, gc, gv = _sorted_triplets(*got)
    wr, wc, wv = _sorted_triplets(*want)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gc, wc)
    if exact_values:
        np.testing.assert_array_equal(gv, wv)
    else:
        np.testing.assert_allclose(gv, wv, rtol=TOL, atol=TOL)


def _bcoo_triplets(x):
    return (np.asarray(x.indices[:, 0]), np.asarray(x.indices[:, 1]),
            np.asarray(x.data))


def _coo_tensor_triplets(x):
    x = x.coalesce()
    return (x.indices()[0].numpy(), x.indices()[1].numpy(),
            x.values().numpy())


# -------------------------------------------------------------------- ELL

@pytest.mark.parametrize("k_width", [None, 2, 8])
def test_ell_from_coo_matches_jax(k_width):
    rows, cols, vals = _coo(0, (40, 30), 120, hub_row=7, hub_deg=20)
    want = jell.ell_from_coo(rows, cols, vals, (40, 30), k_width=k_width)
    got = tell.ell_from_coo(rows, cols, vals, (40, 30), k_width=k_width)
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    assert got.k_width == want.k_width and got.nnz == want.nnz
    if want.residual is None:
        assert got.residual is None
    else:
        _same_triplets(_coo_tensor_triplets(got.residual),
                       _bcoo_triplets(want.residual), exact_values=True)


@pytest.mark.parametrize("chunk", [512, 7])
def test_ell_spmm_matches_jax(chunk):
    # density under 1 % with a hub row whose overflow takes the residual path
    shape = (600, 500)
    rows, cols, vals = _coo(1, shape, 2000, hub_row=11, hub_deg=120)
    b = np.random.default_rng(2).standard_normal((500, 9)).astype(np.float32)
    want_ell = jell.ell_from_coo(rows, cols, vals, shape, k_width=8)
    got_ell = tell.ell_from_coo(rows, cols, vals, shape, k_width=8)
    assert got_ell.residual is not None
    want = np.asarray(jell.ell_spmm(want_ell, jnp.asarray(b), chunk=chunk))
    got = tell.ell_spmm(got_ell, torch.from_numpy(b), chunk=chunk).numpy()
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, dense @ b, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="inner dim"):
        tell.ell_spmm(got_ell, torch.ones((3, 2)))


# ------------------------------------------------------------- COO block ops

def test_mult_sparse_dense_and_dense_sparse_match_jax():
    a = A
    d = np.random.default_rng(4).standard_normal((9, 6)).astype(np.float32)
    e = np.random.default_rng(5).standard_normal((7, 12)).astype(np.float32)
    ja = _jbcoo(a)
    ta = torch.from_numpy(a).to_sparse()
    np.testing.assert_allclose(
        tlocal.mult_sparse_dense(ta, torch.from_numpy(d)).numpy(),
        np.asarray(jlocal.mult_sparse_dense(ja, jnp.asarray(d))),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tlocal.mult_dense_sparse(torch.from_numpy(e), ta).numpy(),
        np.asarray(jlocal.mult_dense_sparse(jnp.asarray(e), ja)),
        rtol=TOL, atol=TOL)
    # a dense first operand is made sparse, as _to_bcoo does
    np.testing.assert_allclose(
        tlocal.mult_sparse_dense(torch.from_numpy(a), torch.from_numpy(d))
        .numpy(), a @ d, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["device", "host"])
def test_mult_sparse_sparse_matches_jax(route, jmesh):
    # both of the JAX package's routes (its host route is forced by lowering
    # spsp_device_max_products) against the port's one, torch.sparse.mm
    a, b = A, B
    limit = 1 if route == "host" else 1 << 27
    with jmt.config_context(spsp_device_max_products=limit):
        want = jlocal.mult_sparse_sparse(_jbcoo(a),
                                         _jbcoo(b))
    got = tlocal.mult_sparse_sparse(torch.from_numpy(a).to_sparse(),
                                    torch.from_numpy(b).to_sparse())
    assert got.is_coalesced() and tuple(got.shape) == (12, 11)
    gr, gc, gv = _coo_tensor_triplets(got)
    keep = gv != 0  # the device routes may keep products that cancelled
    wr, wc, wv = _bcoo_triplets(want)
    wkeep = wv != 0
    _same_triplets((gr[keep], gc[keep], gv[keep]),
                   (wr[wkeep], wc[wkeep], wv[wkeep]))
    np.testing.assert_allclose(got.to_dense().numpy(), a @ b, rtol=TOL,
                               atol=TOL)


def test_mult_sparse_sparse_bound_matches_jax():
    for seed in range(2):
        a = _dense(seed, (20, 15), 0.2)
        b = _dense(seed + 10, (15, 17), 0.3)
        want = jlocal.mult_sparse_sparse_bound(
            _jbcoo(a),
            _jbcoo(b))
        got = tlocal.mult_sparse_sparse_bound(torch.from_numpy(a).to_sparse(),
                                              torch.from_numpy(b))
        assert got == want and isinstance(got, int)


def test_block_multiply_dispatches_four_ways():
    a, b = A, B
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jl, jr, tl, tr in ((ja, jb, ta, tb),
                           (_jbcoo(a), jb, ta.to_sparse(), tb),
                           (ja, _jbcoo(b), ta, tb.to_sparse()),
                           (_jbcoo(a),
                            _jbcoo(b), ta.to_sparse(),
                            tb.to_sparse())):
        want = jlocal.block_multiply(jl, jr)
        got = tlocal.block_multiply(tl, tr)
        assert got.is_sparse == isinstance(want, jsparse.BCOO)
        want = want.todense() if isinstance(want, jsparse.BCOO) else want
        got = got.to_dense() if got.is_sparse else got
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------- the slice whole

# every format at 30 % density ("auto" picks "bcoo"), and "auto" below 1 %
# (it picks "ell")
@pytest.mark.parametrize("fmt,shape,density", [
    ("auto", (96, 64), 0.3), ("ell", (96, 64), 0.3), ("bcoo", (96, 64), 0.3),
    ("bsr", (96, 64), 0.3), ("auto", (300, 200), 0.005)])
def test_sparse_vec_matrix_multiply_matches_jax(fmt, shape, density, jmesh):
    a = _dense(8, shape, density)
    b = np.random.default_rng(9).standard_normal((shape[1], 10)).astype(
        np.float32)
    want = jmt.SparseVecMatrix.from_dense(a, jmesh).multiply(
        jmt.BlockMatrix.from_array(b, jmesh), format=fmt).to_numpy()
    got = tmt.SparseVecMatrix.from_dense(a).multiply(
        tmt.BlockMatrix.from_array(b), format=fmt)
    assert isinstance(got, tmt.BlockMatrix)
    np.testing.assert_allclose(got.to_numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.to_numpy(), a.astype(np.float64) @ b,
                               rtol=TOL, atol=TOL)


def test_sparse_vec_matrix_conversions_match_jax(jmesh):
    a = _dense(5, (40, 33), 0.1)
    jsp = jmt.SparseVecMatrix.from_dense(a, jmesh)
    tsp = tmt.SparseVecMatrix.from_dense(a)
    assert tsp.nnz == jsp.nnz and tsp.shape == jsp.shape
    np.testing.assert_array_equal(tsp.to_numpy(), jsp.to_numpy())
    for got, want in zip(tsp._coo_triplets(), jsp._coo_triplets()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsp.to_dense_vec_matrix().to_numpy(),
                                  jsp.to_dense_vec_matrix().to_numpy())
    tb, jb = tsp.to_bsr(16), jsp.to_bsr(16)
    np.testing.assert_array_equal(tb.blocks.numpy(), np.asarray(jb.blocks))
    np.testing.assert_array_equal(tb.block_rows.numpy(),
                                  np.asarray(jb.block_rows))
    assert tsp.to_bsr(16) is tb  # cached
    te, je = tsp.to_ell(), jsp.to_ell()
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    np.testing.assert_array_equal(te.vals.numpy(), np.asarray(je.vals))
    assert tsp.to_ell() is te
    with pytest.raises(ValueError, match="unknown SpMM format"):
        tsp.multiply(np.ones((33, 2), np.float32), format="csr")


def test_multiply_sparse_matches_jax(jmesh):
    a, b = A, B
    want = jmt.SparseVecMatrix(_jbcoo(a), a.shape, jmesh).multiply_sparse(
        jmt.SparseVecMatrix(_jbcoo(b), b.shape, jmesh))
    got = tmt.SparseVecMatrix.from_dense(a).multiply(
        tmt.SparseVecMatrix.from_dense(b))
    assert isinstance(got, tmt.CoordinateMatrix) and got.shape == want.shape
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=TOL,
                               atol=TOL)


def test_coordinate_matrix_round_trips_match_jax(jmesh):
    entries = [(0, 0, 1.0), (1, 2, 2.5), (3, 1, -1.0), (1, 2, 0.5)]
    jc = jmt.CoordinateMatrix.from_entries(entries, mesh=jmesh)
    tc = tmt.CoordinateMatrix.from_entries(entries)
    assert tc.shape == jc.shape == (4, 3) and tc.nnz == jc.nnz == 4
    assert tc.values.dtype == torch.float32
    np.testing.assert_array_equal(tc.to_numpy(), jc.to_numpy())
    for got, want in zip(tc.triplets(), jc.triplets()):
        np.testing.assert_array_equal(got, want)
    for conv in ("to_dense_vec_matrix", "to_block_matrix"):
        np.testing.assert_array_equal(getattr(tc, conv)().to_numpy(),
                                      getattr(jc, conv)().to_numpy())
    tsv, jsv = tc.to_sparse_vec_matrix(), jc.to_sparse_vec_matrix()
    np.testing.assert_array_equal(tsv.to_numpy(), jsv.to_numpy())
    back_t, back_j = tsv.to_coordinate_matrix(), jsv.to_coordinate_matrix()
    assert back_t.nnz == back_j.nnz == 3  # the duplicate was summed
    np.testing.assert_array_equal(back_t.to_numpy(), back_j.to_numpy())
    # padding entries (indices == shape) are filtered as in the JAX package
    jp = jmt.CoordinateMatrix([0, 4, 2], [1, 3, 2], [1.0, 0.0, 2.0],
                              shape=(4, 3), mesh=jmesh)
    tp = tmt.CoordinateMatrix([0, 4, 2], [1, 3, 2],
                              np.array([1.0, 0.0, 2.0], np.float32),
                              shape=(4, 3))
    for got, want in zip(tp.triplets(), jp.triplets()):
        np.testing.assert_array_equal(got, want)
    assert tp.compact().nnz == jp.compact().nnz == 2
    np.testing.assert_array_equal(tp.to_numpy(), jp.to_numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        tc.save_to_file_system("x")
    # als runs ml/als.py in both packages (duplicate entries included);
    # factors within 2e-4, tests/test_torch_ml.py's ALS tolerance
    tals, jals = tc.als(2, iterations=3), jc.als(2, iterations=3)
    for side in ("user_features", "product_features"):
        np.testing.assert_allclose(getattr(tals, side).to_numpy(),
                                   getattr(jals, side).to_numpy(), atol=2e-4)


@pytest.mark.parametrize("tol", [0.0, 0.8])
def test_dense_to_sparse_vec_matrix_matches_jax(tol, jmesh):
    a = np.random.default_rng(12).standard_normal((20, 14)).astype(np.float32)
    a[a < -0.5] = 0.0
    want = jmt.DenseVecMatrix.from_array(a, jmesh).to_sparse_vec_matrix(tol)
    got = tmt.DenseVecMatrix.from_array(a).to_sparse_vec_matrix(tol)
    assert isinstance(got, tmt.SparseVecMatrix) and got.nnz == want.nnz
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


# ---------------------------------------------------------- seeded draws

def test_sparse_vec_matrix_random_is_jax_bit_for_bit(jmesh):
    want = jmt.SparseVecMatrix.random(0, 300, 200, 0.01, mesh=jmesh)
    got = tmt.SparseVecMatrix.random(0, 300, 200, 0.01)
    assert got.nnz == want.nnz
    _same_triplets(got._coo_triplets(), want._coo_triplets(),
                   exact_values=True)
    with pytest.raises(ValueError, match="float32"):
        tmt.SparseVecMatrix.random(0, 4, 4, dtype=torch.float64)


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (600,), 0, 300), (1, (7, 5), -5, 17), (3, (1000,), 0, 2 ** 31 - 1),
    (4, (100,), -2 ** 31, 2 ** 31 - 1), (5, (50,), 10, 10),
    (6, (64,), -100, -3), (7, (33,), 0, 1 << 20), (11, (3,), 5, 2),
])
def test_randint_is_jax_bit_for_bit(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi,
                                         dtype=jnp.int32))
    got = threefry.randint(threefry.prng_key(seed), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- interop

def test_sparse_carriers_round_trip_jax(jmesh):
    a = _dense(5, (40, 33), 0.1)  # the conversions test's matrix
    jsp = jmt.SparseVecMatrix.from_dense(a, jmesh)
    tsp = interop.sparse_vec_matrix_from_numpy(
        np.asarray(jsp.bcoo.indices), np.asarray(jsp.bcoo.data), jsp.shape,
        device="cpu")
    assert tsp.nnz == jsp.nnz and tsp.shape == jsp.shape
    np.testing.assert_array_equal(tsp.to_numpy(), jsp.to_numpy())
    # BCOO padding (an index equal to the dimension) is dropped
    idx = np.r_[np.asarray(jsp.bcoo.indices), [[40, 33]]]
    data = np.r_[np.asarray(jsp.bcoo.data), [0.0]].astype(np.float32)
    assert interop.sparse_vec_matrix_from_numpy(
        idx, data, (40, 33), device="cpu").nnz == jsp.nnz
    jc = jsp.to_coordinate_matrix()
    tc = interop.coordinate_matrix_from_numpy(*jc.triplets(), jc.shape,
                                              device="cpu")
    np.testing.assert_array_equal(tc.to_numpy(), jc.to_numpy())
    for got, want in zip(tc.triplets(), jc.triplets()):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sparse_paths_match_cpu(cuda):
    """Every format of SparseVecMatrix.multiply, and multiply_sparse, on the
    card equal numpy (f32 tolerance)."""
    a = _dense(8, (300, 200), 0.005)
    b = np.random.default_rng(9).standard_normal((200, 10)).astype(np.float32)
    with config_context(device="cuda"):
        sp = tmt.SparseVecMatrix.from_dense(a)
        for fmt in ("auto", "ell", "bcoo", "bsr"):
            got = sp.multiply(tmt.BlockMatrix.from_array(b), format=fmt)
            assert got.device.type == "cuda"
            np.testing.assert_allclose(got.to_numpy(), a.astype(np.float64) @ b,
                                       rtol=TOL, atol=TOL, err_msg=fmt)
        spa, spb = (tmt.SparseVecMatrix.from_dense(x) for x in (A, B))
        out = spa.multiply_sparse(spb)
        assert out.values.device.type == "cuda"
        np.testing.assert_allclose(out.to_numpy(), A @ B, rtol=TOL, atol=TOL)
