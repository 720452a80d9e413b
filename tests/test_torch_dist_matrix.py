"""The matrices across ranks: rank-local ``DenseVecMatrix``, ``BlockMatrix``
and ``DistributedVector`` with their factories, operations, multiply, text
IO and chunk-store loads, against the JAX package on a 4-device CPU mesh.

One 4-rank gloo world (``_torch_dist.run_world``) runs every case; the JAX
package runs the same numpy inputs on ``jax.devices()[:4]`` as a (2, 2) or
(4, 1) mesh. Each rank's ``data`` comes back under a ``rank_`` key and must
equal, in shape and value, the JAX array's addressable shard on the device
at the same grid position; the gathered matrix must equal JAX's logical
one. Tolerances:

- exact for layouts, factories (``uniform`` bit for bit), elementwise
  results, the structure ops, IO and chunk stores;
- ``NORMAL_TOL`` (1e-6, relative and absolute) for ``normal``, whose
  ``erfinv`` is PyTorch's, not XLA's;
- ``RTOL`` (1e-5, with ``ATOL`` 1e-6 for entries near zero) for products
  and reductions in f32 (sums, norms, the Gramian, mat-vecs and every
  ``multiply`` strategy), whose summation order differs.
"""

import os

import numpy as np
import pytest

import jax

import marlin_tpu as jmt
from marlin_tpu import mesh as jmesh
from marlin_tpu.io import chunkstore as jcs
from marlin_tpu.io import text as jtext

from _torch_dist import run_world

WORLD = 4
RTOL = 1e-5
ATOL = 1e-6
NORMAL_TOL = 1e-6
# to_sparse_vec_matrix drops |x| <= SPARSE_TOL (about 38 % of a standard
# normal); its products hold within tests/test_torch_sparse.py's TOL
SPARSE_TOL = 0.5
SPMM_TOL = 1e-4


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(tmp):
    rng = np.random.default_rng(0)
    a = _f32(rng, 10, 7)
    files = tmp / "files"
    files.mkdir()
    with jax.default_device(jax.devices("cpu")[0]):
        m1 = jmesh.create_mesh((1, 1), devices=jax.devices()[:1])
        jtext.save_matrix(jmt.DenseVecMatrix.from_array(a * 3, m1),
                          str(files / "rows.txt"))
        jtext.save_matrix(jmt.BlockMatrix.from_array(
            a[:9, :6] - 1, jmesh.create_mesh((2, 2),
                                             devices=jax.devices()[:4])),
            str(files / "blocks.txt"), fmt="block")
    with open(files / "svm.txt", "w") as f:
        for i in (4, 0, 8, 2, 5, 1, 7, 3, 6):
            f.write(f"{i} 1:{i * 0.5} 4:{-i} 6:{i + 0.25}\n")
    jcs.write_chunkstore(str(files / "store.mchunk"), a[:9] + 2, chunk_rows=4)
    out_dir = tmp / "saved"
    out_dir.mkdir()
    ci = rng.integers(0, 9, 20)
    cj = rng.integers(0, 6, 20)
    return {
        "dm_layout": dict(a=a, v=_f32(rng, 9)),
        "dm_ops": dict(a=a, a2=(rng.random((10, 7)) + 0.5).astype(np.float32),
                       c=_f32(rng, 10, 3), perm=rng.permutation(10),
                       l=_f32(rng, 5, 10), x=_f32(rng, 7), u=_f32(rng, 9),
                       w=_f32(rng, 9)),
        "dm_multiply": dict(a=_f32(rng, 10, 7), b=_f32(rng, 7, 9)),
        "dm_io": dict(a=a, dir=np.array(str(out_dir)),
                      rows=np.array(str(files / "rows.txt")),
                      blocks=np.array(str(files / "blocks.txt")),
                      svm=np.array(str(files / "svm.txt")), svm_len=np.array(6),
                      store=np.array(str(files / "store.mchunk")),
                      ci=ci, cj=cj, cv=rng.random(20).astype(np.float32),
                      cshape=np.array([9, 6]), tol=np.array(SPARSE_TOL),
                      sb=_f32(rng, 7, 5)),
        "dm_spans": dict(a=_f32(rng, 16, 12), b=_f32(rng, 12, 8)),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_matrix")
    inputs = _inputs(tmp)
    return inputs, run_world(WORLD, list(inputs), inputs, tmp)


@pytest.fixture(scope="module")
def jm():
    devs = jax.devices()[:WORLD]
    return {"22": jmesh.create_mesh((2, 2), devices=devs),
            "41": jmesh.create_mesh((4, 1), devices=devs)}


def _shards(x, mesh):
    """The addressable shards of JAX's ``x`` (a matrix, vector or array) in
    the mesh's row-major device order: rank r's block."""
    data = getattr(x, "data", x)
    devs = list(mesh.devices.flat)
    out = [None] * len(devs)
    for sh in data.addressable_shards:
        out[devs.index(sh.device)] = np.asarray(sh.data)
    return np.stack(out)


def _same(got, key, jx, mesh, exact=True):
    """Rank blocks and the gathered result of ``key`` against JAX's."""
    want = _shards(jx, mesh)
    assert got[f"rank_{key}"].shape == want.shape, key
    whole = np.asarray(jx.to_numpy() if hasattr(jx, "to_numpy") else jx)
    if exact:
        np.testing.assert_array_equal(got[f"rank_{key}"], want, err_msg=key)
        np.testing.assert_array_equal(got[key], whole, err_msg=key)
    else:
        np.testing.assert_allclose(got[f"rank_{key}"], want, rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got[key], whole, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_factories_hold_only_their_block(run, jm):
    """from_array, random (uniform bit for bit), zeros/ones and the vector
    factories: each rank holds JAX's addressable shard, not the matrix."""
    inputs, out = run
    inp, got = inputs["dm_layout"], out["dm_layout"]
    for tag, mesh in jm.items():
        _same(got, f"vec{tag}", jmt.DenseVecMatrix.from_array(inp["a"], mesh),
              mesh)
        _same(got, f"blk{tag}", jmt.BlockMatrix.from_array(inp["a"], mesh),
              mesh)
        _same(got, f"uni{tag}", jmt.DenseVecMatrix.random(
            7, 10, 7, mesh=mesh, minval=-2.0, maxval=3.0), mesh)
        _same(got, f"buni{tag}", jmt.BlockMatrix.random(7, 10, 7, mesh=mesh),
              mesh)
        _same(got, f"ones{tag}", jmt.BlockMatrix.ones(5, 3, mesh=mesh), mesh)
        jn = jmt.BlockMatrix.random(5, 9, 6, dist="normal", mesh=mesh)
        np.testing.assert_allclose(got[f"rank_nrm{tag}"], _shards(jn, mesh),
                                   rtol=NORMAL_TOL, atol=NORMAL_TOL)
        _same(got, f"dv{tag}", jmt.DistributedVector.from_array(inp["v"],
                                                                mesh), mesh)
        _same(got, f"rv{tag}", jmt.DistributedVector.random(11, 9, mesh=mesh),
              mesh)
    # block bytes: a rank of the (2, 2) grid holds a quarter of the padded
    # BlockMatrix, a half of the DenseVecMatrix
    assert got["rank_blk22"].shape == (WORLD, 5, 4)
    assert got["rank_vec22"].shape == (WORLD, 5, 7)


def test_poisson_is_the_same_matrix_on_every_grid(run):
    """Each element draws from its own counter: the (2, 2) and (4, 1)
    grids give one logical matrix of non-negative integers."""
    got = run[1]["dm_layout"]
    np.testing.assert_array_equal(got["poi22"], got["poi41"])
    assert (got["poi22"] >= 0).all() and (got["poi22"] % 1 == 0).all()
    assert 2.0 < got["poi22"].mean() < 6.0  # rate 4 over 45 draws


def test_operations_on_blocks(run, jm):
    """Elementwise ops over mixed layouts, structure ops, conversions and
    the vector ops: blocks and results equal the JAX package's."""
    inputs, out = run
    inp, got = inputs["dm_ops"], out["dm_ops"]
    mesh = jm["22"]
    a = jmt.DenseVecMatrix.from_array(inp["a"], mesh)
    ab = jmt.BlockMatrix.from_array(inp["a2"], mesh)
    c = jmt.BlockMatrix.from_array(inp["c"], mesh)
    exact = {
        "add": a.add(ab), "sub": ab.subtract(a), "div": a.divide(ab),
        "had": a.dot_product(inp["a2"]), "sadd": a.add(1.5),
        "sdivby": ab.divide_by(2.0), "scale": ab.multiply(3.0),
        "t": a.transpose(), "tb": ab.transpose(), "cbind": a.c_bind(c),
        "rbind": ab.r_bind(inp["a"]), "srow": a.slice_by_row(3, 8),
        "scol": ab.slice_by_column(2, 5), "sub_m": a.get_sub_matrix(1, 8, 2, 6),
        "rrow": ab.repeat_by_row(3), "rcol": a.repeat_by_column(2),
        "toblk": a.to_block_matrix(), "tovec": ab.to_dense_vec_matrix(),
        "reshard": a.reshard(jax.sharding.PartitionSpec("cols", "rows")),
        "rowx": ab.row_exchange(inp["perm"]), "getitem": ab[2:7, 1:5],
    }
    for key, jx in exact.items():
        _same(got, key, jx, mesh)
    assert bool(got["dtype_kept"])
    np.testing.assert_array_equal(got["getrow"], np.asarray(ab[3, :]))
    close = {"gram": ab.gramian(), "gramv": a.gramian(),
             "mulby": ab.multiply_by(inp["l"]),
             "mv": a.multiply_vector(inp["x"]),
             "mg": ab.multiply_gramian_by(inp["x"])}
    for key, jx in close.items():
        _same(got, key, jx, mesh, exact=False)
    scalars = {"sum": a.sum(), "dot": None}
    for mode in ("1", "inf", "fro", "2"):
        scalars[f"norm_{mode}"] = ab.norm(mode)
        scalars[f"vnorm_{mode}"] = a.norm(mode)
    u = jmt.DistributedVector.from_array(inp["u"], mesh)
    w = jmt.DistributedVector.from_array(inp["w"], mesh)
    scalars.update(dot=u.dot(w), vsum=u.sum(), vnorm=u.norm(),
                   vnorm1=u.norm(1), vnorminf=u.norm(np.inf),
                   inner=u.transpose().multiply(w))
    for key, jx in scalars.items():
        np.testing.assert_allclose(got[key], np.asarray(jx), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    _same(got, "outer", u.multiply(w.transpose()), mesh)
    np.testing.assert_array_equal(got["rank_vadd"], _shards(u.add(w), mesh))


STRATEGIES = ("rmm221", "rmm122", "rmm411", "rmm_auto", "auto", "gspmd",
              "broadcast", "broadcast_a", "ring", "tuned", "subset")


@pytest.mark.parametrize("tag", STRATEGIES)
def test_multiply_strategies(run, jm, tag):
    """``a.multiply(b)`` by each strategy (explicit RMM splits, the
    autotuned choice, the ring and a split that does not fill the mesh):
    C's blocks and C equal the JAX package's product within RTOL."""
    inputs, out = run
    inp, got = inputs["dm_multiply"], out["dm_multiply"]
    mesh = jm["22"]
    a = jmt.DenseVecMatrix.from_array(inp["a"], mesh)
    b = jmt.BlockMatrix.from_array(inp["b"], mesh)
    kw = {"rmm221": dict(strategy="rmm", split=(2, 2, 1)),
          "rmm122": dict(strategy="rmm", split=(1, 2, 2)),
          "rmm411": dict(strategy="rmm", split=(4, 1, 1)),
          "rmm_auto": dict(strategy="rmm"), "auto": {},
          "gspmd": dict(strategy="gspmd"),
          "broadcast": dict(strategy="broadcast"),
          "broadcast_a": dict(strategy="broadcast_a"),
          "ring": dict(strategy="gspmd"), "tuned": dict(strategy="gspmd"),
          "subset": dict(strategy="rmm", split=(1, 1, 2))}[tag]
    _same(got, tag, a.multiply(b, **kw), mesh, exact=False)
    if tag == "broadcast":
        _same(got, "dense_b", a.multiply(inp["b"], strategy="broadcast"),
              mesh, exact=False)


def test_multiply_gathers_no_tensor_of_c_size(run):
    """Every all-gather, all-to-all and all-reduce a rank took part in
    during the RMM, gspmd and broadcast multiplies received fewer elements
    than C's logical 10 x 9: no rank formed C whole. (The ring and a split
    that does not fill the mesh keep their logical path, which gathers the
    inputs.)"""
    got = run[1]["dm_multiply"]
    for tag in ("rmm221", "rmm122", "rmm411", "rmm_auto", "auto", "gspmd",
                "broadcast", "broadcast_a"):
        assert got[f"rank_moved_{tag}"].max() < 10 * 9, tag


def test_rmm_spans_on_every_rank(run):
    """The (4, 1) RMM multiply under the profiler records, on every rank,
    one ``marlin.multiply`` holding one fetch, product, reduce and place
    span, and the ``remap`` plan and exchange of its three moves (A's and
    B's in fetch, C's in place) nested in them; C is still the product."""
    inp, got = run[0]["dm_spans"], run[1]["dm_spans"]
    # multiply, rmm.fetch, .product, .reduce, .place, remap.plan, .exchange
    assert got["rank_counts"].tolist() == [[1, 1, 1, 1, 1, 3, 3]] * WORLD
    # two remaps (A, B) in fetch and one (C) in place, each plan + exchange
    assert got["rank_remap_in"].tolist() == [[4, 2, 0]] * WORLD
    want = inp["a"].astype(np.float64) @ inp["b"]
    np.testing.assert_allclose(got["c"], want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_text_io_and_chunk_store(run, jm):
    """The port's saves equal the JAX package's byte for byte; the loaders
    of JAX-written files, a chunk store and the sparse and MTUtils
    conversions keep only each rank's block."""
    inputs, out = run
    inp, got = inputs["dm_io"], out["dm_io"]
    mesh = jm["22"]
    d = str(inp["dir"])
    jdir = os.path.join(d, "jax")
    os.makedirs(os.path.join(jdir, "desc"))
    a = jmt.DenseVecMatrix.from_array(inp["a"], mesh)
    jtext.save_matrix(a, os.path.join(jdir, "rows.txt"))
    jtext.save_matrix(jmt.BlockMatrix.from_array(inp["a"], mesh),
                      os.path.join(jdir, "blocks.txt"), fmt="block")
    jtext.save_matrix(a, os.path.join(jdir, "desc", "port_desc.txt"),
                      description=True)
    for port, jax_file in (("port_rows.txt", "rows.txt"),
                           ("port_blocks.txt", "blocks.txt"),
                           ("desc/port_desc.txt", "desc/port_desc.txt"),
                           ("desc/_description", "desc/_description")):
        with open(os.path.join(d, port), "rb") as f, \
                open(os.path.join(jdir, jax_file), "rb") as g:
            assert f.read() == g.read(), port
    _same(got, "rows", jtext.load_matrix_file(str(inp["rows"]), mesh), mesh)
    _same(got, "blocks", jtext.load_block_matrix_file(str(inp["blocks"]),
                                                      mesh), mesh)
    _same(got, "svm", jtext.load_svm_den_vec_matrix(
        str(inp["svm"]), int(inp["svm_len"]), mesh), mesh)
    _same(got, "store", jmt.DenseVecMatrix.from_array(inp["a"][:9] + 2, mesh),
          mesh)
    coo = jmt.CoordinateMatrix(inp["ci"], inp["cj"], inp["cv"],
                               shape=(9, 6))
    _same(got, "coo_vec", coo.to_dense_vec_matrix(mesh), mesh)
    _same(got, "coo_blk", coo.to_block_matrix(mesh), mesh)
    _same(got, "mtu", jmt.BlockMatrix.from_array(inp["a"], mesh), mesh)


def test_to_sparse_vec_matrix_over_ranks(run, jm):
    """A rank-local matrix's dense -> sparse conversion gathers it once and
    holds the JAX package's triplets whole on every rank (its BCOO is
    unplaced)."""
    inputs, out = run
    inp, got = inputs["dm_io"], out["dm_io"]
    want = jmt.DenseVecMatrix.from_array(inp["a"], jm["22"]) \
        .to_sparse_vec_matrix(float(inp["tol"]))
    for name, w in zip(("sp_rows", "sp_cols", "sp_vals"),
                       want._coo_triplets()):
        np.testing.assert_array_equal(got[name], np.asarray(w), err_msg=name)
    assert 0 < len(got["sp_vals"]) < inp["a"].size


@pytest.mark.parametrize("fmt", ["bcoo", "ell", "bsr"])
def test_sparse_multiply_by_rank_local_operand(run, jm, fmt):
    """``SparseVecMatrix.multiply`` of the converted matrix by a rank-local
    operand: each rank holds JAX's shard of ``BlockMatrix.from_array(out,
    mesh)``."""
    inputs, out = run
    inp, got = inputs["dm_io"], out["dm_io"]
    mesh = jm["22"]
    sp = jmt.DenseVecMatrix.from_array(inp["a"], mesh).to_sparse_vec_matrix(
        float(inp["tol"]))
    want = sp.multiply(jmt.DenseVecMatrix.from_array(inp["sb"], mesh),
                       format=fmt)
    assert isinstance(want, jmt.BlockMatrix)
    shards = _shards(want, mesh)
    assert got[f"rank_spmm_{fmt}"].shape == shards.shape
    np.testing.assert_allclose(got[f"rank_spmm_{fmt}"], shards, rtol=SPMM_TOL,
                               atol=SPMM_TOL)
    np.testing.assert_allclose(got[f"spmm_{fmt}"], want.to_numpy(),
                               rtol=SPMM_TOL, atol=SPMM_TOL)


def test_layout_moves_trace_under_fuse():
    """In a world of one the layout moves (``redistribute`` of a BlockMatrix
    operand, ``remap`` of a transpose) trace into one ``lazy.fuse`` graph
    and equal the eager chain (exact: the same operations)."""
    import torch

    import marlin_tpu_torch as tm
    from marlin_tpu_torch import lazy

    rng = np.random.default_rng(3)
    with tm.config_context(device="cpu"):
        a = tm.DenseVecMatrix.from_array(_f32(rng, 12, 12))
        b = tm.DenseVecMatrix.from_array(_f32(rng, 12, 12))
        c = tm.BlockMatrix.from_array(_f32(rng, 12, 12))

        def chain(a, b, c):
            return a.multiply(b).add(c).transpose().multiply(2.0)

        got = lazy.fuse(chain, backend="aot_eager")(a, b, c)
        want = chain(a, b, c)
    assert torch.equal(got.data, want.data)
