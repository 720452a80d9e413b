"""Sharded checkpoints with elastic restore, and linalg on row blocks, across
ranks, against the JAX package on a 4-device CPU mesh.

Spawned gloo worlds (``_torch_dist.run_world``) of 4, 2 and 1 ranks run the
port; the JAX package runs the same numpy inputs on ``jax.devices()[:4]``
as a (4, 1) mesh (the DenseVecMatrix rows) or a (2, 2) mesh (the
BlockMatrix). Each rank's block comes back under a ``rank_`` key and must
have the shape of JAX's addressable shard at the same grid position.
Tolerances:

- checkpoints: bit for bit; the elastic ``ResilientLoop`` runs continue the
  uninterrupted trajectory within ``rtol=1e-5`` (``ELASTIC_RTOL``), as
  ``tests/test_multihost.py`` holds the JAX package's;
- linalg, as ``tests/test_torch_linalg.py`` states it (f32 on both sides,
  other summation orders): LU ``perm`` equal and L, U, Cholesky, the
  inverse and the solves within ``TOL`` (1e-4) of the largest |entry|;
  SVD ``s`` within ``SVD_S_RTOL`` (1e-4), V and U within ``SVD_VEC_TOL``
  (1e-3) after each column's sign is aligned; ``lr`` weights within
  ``LR_TOL`` (1e-5).
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import marlin_tpu as jmt
from marlin_tpu import linalg as jla
from marlin_tpu import mesh as jmesh
from marlin_tpu.io import checkpoint as jck

from _torch_dist import run_world

ELASTIC_RTOL = 1e-5
TOL = 1e-4
SVD_S_RTOL, SVD_VEC_TOL = 1e-4, 1e-3
LR_TOL = 1e-5
N, BLOCK = 22, 4


@pytest.fixture(scope="module")
def jm():
    devs = jax.devices()[:4]
    return {"r": jmesh.create_mesh((4, 1), devices=devs),
            "b": jmesh.create_mesh((2, 2), devices=devs)}


def _dir(path):
    path.mkdir()
    return path


def _shards(x, mesh):
    data = getattr(x, "data", x)
    devs = list(mesh.devices.flat)
    out = [None] * len(devs)
    for sh in data.addressable_shards:
        out[devs.index(sh.device)] = np.asarray(sh.data)
    return np.stack(out)


# ------------------------------------------------------------ checkpoints

def test_sharded_checkpoint_across_packages_and_worlds(tmp_path, jm):
    """The port's 4-rank save_sharded is JAX's layout (read back by JAX's
    load_sharded onto its own (2, 2) mesh, bit for bit), and JAX's (2, 2)
    checkpoint restores onto 2 and 1 ranks, each rank reading its own
    region."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((10, 7)).astype(np.float32)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    out = run_world(4, ["ck_save"], {"ck_save": dict(
        a=a, dir=np.array(str(port_dir)), grid=np.array([2, 2]))},
        _dir(tmp_path / "w4"))["ck_save"]
    want = jmt.BlockMatrix.from_array(a, jm["b"])
    np.testing.assert_array_equal(out["rank_block"], _shards(want, jm["b"]))
    # one shard file a rank, named by its replica and global index
    assert sorted(f for r in out["rank_files"] for f in r
                  if f.startswith("shard_")) == [
        "shard_0_0_0.npy", "shard_0_0_4.npy", "shard_0_5_0.npy",
        "shard_0_5_4.npy"]
    back = jck.load_sharded(str(port_dir),
                            NamedSharding(jm["b"], P("rows", "cols")))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(want.data))

    jck.save_sharded(want.data, str(jax_dir))
    padded = np.asarray(want.data)  # (10, 8): the (2, 2) grid's pad
    for world, grid in ((2, (2, 1)), (1, (1, 1))):
        got = run_world(world, ["ck_load"], {"ck_load": dict(
            dir=np.array(str(jax_dir)), grid=np.array(grid))},
            _dir(tmp_path / f"w{world}"))["ck_load"]
        rows = -(-padded.shape[0] // grid[0])
        for r in range(world):
            want_rows = np.zeros((rows, padded.shape[1]), np.float32)
            part = padded[r * rows:(r + 1) * rows]
            want_rows[:len(part)] = part
            np.testing.assert_array_equal(got["rank_rows"][r], want_rows)
            np.testing.assert_array_equal(got["rank_blocks"][r], want_rows)


@pytest.mark.parametrize("first,second", [(2, 1), (1, 2)])
def test_resilient_loop_elastic(tmp_path, first, second):
    """A ResilientLoop over a rank-local DenseVecMatrix (9 x 7, padded to
    the grid) trained 6 steps on ``first`` ranks resumes on ``second`` ranks
    at step 6 and continues the uninterrupted 12-step trajectory."""
    rng = np.random.default_rng(7)
    target = rng.standard_normal((9, 7)).astype(np.float32)
    ckpt = tmp_path / "eckpt"

    def world(n, case, tag):
        inp = dict(target=target, dir=np.array(str(ckpt)),
                   grid=np.array([n, 1]))
        return run_world(n, [case], {case: inp}, _dir(tmp_path / tag))[case]

    saved = world(first, "ck_elastic_save", "save")
    assert len(saved["metrics"]) == 6
    resumed = world(second, "ck_elastic_resume", "resume")
    fresh = world(second, "ck_elastic_fresh", "fresh")
    assert len(resumed["metrics"]) == 6, "must resume at step 6, not replay"
    np.testing.assert_allclose(saved["metrics"], fresh["metrics"][:6],
                               rtol=ELASTIC_RTOL)
    np.testing.assert_allclose(resumed["metrics"], fresh["metrics"][6:],
                               rtol=ELASTIC_RTOL)
    np.testing.assert_allclose(resumed["w"], fresh["w"], rtol=ELASTIC_RTOL)
    np.testing.assert_array_equal(resumed["bias"], np.full(3, 12.0))
    assert resumed["rank_w"].shape == (second, -(-9 // second), 7)


# ------------------------------------------------------------------ linalg

def _la_inputs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N)).astype(np.float32)
    q = rng.standard_normal((N, N)).astype(np.float32)
    return dict(a=a, spd=(q @ q.T + N * np.eye(N)).astype(np.float32),
                block=np.array(BLOCK),
                rhs=rng.standard_normal((N, 2)).astype(np.float32),
                tall=rng.standard_normal((40, 12)).astype(np.float32),
                lr=np.concatenate([rng.random((30, 1)) > 0.5,
                                   rng.standard_normal((30, 5))],
                                  1).astype(np.float32))


@pytest.fixture(scope="module")
def la(tmp_path_factory):
    inp = _la_inputs()
    return inp, run_world(4, ["la"], {"la": inp},
                          tmp_path_factory.mktemp("la"))["la"]


def _blocks_close(got, key, jx, mesh, scale):
    want = _shards(jx, mesh)
    assert got[f"rank_{key}"].shape == want.shape, key
    np.testing.assert_allclose(got[f"rank_{key}"], want, rtol=0,
                               atol=TOL * scale, err_msg=key)
    np.testing.assert_allclose(got[key], jx.to_numpy(), rtol=0,
                               atol=TOL * scale, err_msg=key)


def _klass(tag):
    return jmt.DenseVecMatrix if tag == "r" else jmt.BlockMatrix


@pytest.mark.parametrize("tag", ["r", "b"])
@pytest.mark.parametrize("pivot,schedule", [("block", "shrinking"),
                                            ("block", "masked"),
                                            ("panel", "masked")])
def test_lu_on_row_blocks(la, jm, tag, pivot, schedule):
    """Blocked LU over the ranks (the BlockMatrix through the row layout
    and back): perm equal, L and U blocks and wholes within TOL."""
    inp, got = la
    a = _klass(tag).from_array(inp["a"], jm[tag])
    l, u, perm = jla.lu_decompose(a, mode="dist", block_size=BLOCK,
                                  pivot=pivot, schedule=schedule)
    key = f"{tag}_{pivot}_{schedule}"
    np.testing.assert_array_equal(got[f"perm_{key}"], np.asarray(perm))
    scale = np.abs(inp["a"]).max()
    _blocks_close(got, f"l_{key}", l, jm[tag], scale)
    _blocks_close(got, f"u_{key}", u, jm[tag], scale)


@pytest.mark.parametrize("tag", ["r", "b"])
def test_cholesky_inverse_solve_on_row_blocks(la, jm, tag):
    """Cholesky (both schedules), the inverse, ``solve`` (dist and local),
    ``lu_solve`` and ``cholesky_solve`` over the ranks."""
    inp, got = la
    mesh = jm[tag]
    a = _klass(tag).from_array(inp["a"], mesh)
    spd = _klass(tag).from_array(inp["spd"], mesh)
    for sched in ("shrinking", "masked"):
        want = jla.cholesky_decompose(spd, mode="dist", block_size=BLOCK,
                                      schedule=sched)
        _blocks_close(got, f"chol_{tag}_{sched}", want, mesh,
                      np.abs(want.to_numpy()).max())
    inv = jla.inverse(a, mode="dist", block_size=BLOCK)
    _blocks_close(got, f"inv_{tag}", inv, mesh, np.abs(inv.to_numpy()).max())
    x = np.asarray(jla.solve(a, inp["rhs"], mode="dist", block_size=BLOCK))
    for key, want in ((f"solve_{tag}", x), (f"solvev_{tag}", x[:, 0]),
                      (f"lusolve_{tag}", x)):
        np.testing.assert_allclose(got[key], want, rtol=0,
                                   atol=TOL * np.abs(x).max(), err_msg=key)
    xs = np.asarray(jla.solve(spd, inp["rhs"], mode="dist"))
    np.testing.assert_allclose(got[f"cholsolve_{tag}"], xs, rtol=0,
                               atol=TOL * np.abs(xs).max())
    l = jla.lu_decompose(a, mode="local")[0].to_numpy()
    np.testing.assert_allclose(got[f"local_{tag}"], l, rtol=0,
                               atol=TOL * np.abs(inp["a"]).max())


def _align_signs(v, ref):
    return v * np.where(np.sum(v * ref, axis=0) < 0, -1.0, 1.0)


@pytest.mark.parametrize("tag", ["r", "b"])
@pytest.mark.parametrize("mode", ["dist-eigs", "local-eigs", "local-svd"])
def test_svd_on_row_blocks(la, jm, tag, mode):
    """compute_svd's three modes: s, V and U's blocks (signs aligned)."""
    inp, got = la
    mesh = jm[tag]
    want = jla.compute_svd(_klass(tag).from_array(inp["tall"], mesh), 3,
                           mode=mode)
    np.testing.assert_allclose(got[f"s_{tag}_{mode}"], want.s,
                               rtol=SVD_S_RTOL)
    np.testing.assert_allclose(_align_signs(got[f"v_{tag}_{mode}"], want.v),
                               want.v, rtol=0, atol=SVD_VEC_TOL)
    key = f"svdu_{tag}_{mode}"
    sign = np.where(np.sum(got[f"v_{tag}_{mode}"] * want.v, axis=0) < 0,
                    -1.0, 1.0)
    ju = _shards(want.u, mesh)
    assert got[f"rank_{key}"].shape == ju.shape
    cols = ju.shape[2]
    # a BlockMatrix cuts U's k columns over the cols axis: each rank's slice
    # of the signs
    for r in range(4):
        c0 = 0 if tag == "r" else (r % 2) * cols
        s = np.ones(cols)
        s[:max(0, min(cols, 3 - c0))] = sign[c0:c0 + cols]
        np.testing.assert_allclose(got[f"rank_{key}"][r] * s, ju[r], rtol=0,
                                   atol=SVD_VEC_TOL)


@pytest.mark.parametrize("tag", ["r", "b"])
def test_lr_on_row_blocks(la, jm, tag):
    """DenseMatrix.lr over the ranks: the gradient summed by an
    all-reduce; weights within LR_TOL."""
    inp, got = la
    want = _klass(tag).from_array(inp["lr"], jm[tag]).lr(1.0, 20)
    np.testing.assert_allclose(got[f"lr_{tag}"], np.asarray(want), rtol=0,
                               atol=LR_TOL)
