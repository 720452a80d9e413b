"""The port's ML workloads (ALS, PageRank, the MLP trainer) against the JAX
package, on the CPU.

The same seeded numpy inputs go through ``marlin_tpu.ml`` (on a one-device
mesh, or the default 8-device CPU mesh where the reference's tests use it)
and through ``marlin_tpu_torch.ml`` under ``config_context(device="cpu")``.

Tolerances:

- ALS factors after 5 sweeps: within ``ALS_TOL`` (2e-4) of the JAX
  package's, absolute (the factors are O(1)). The initial factors come from
  the same threefry bits, but ``erfinv`` may differ in the last place and
  the segment sums add in other orders; five sweeps read 1.5e-5 at most
  here. Rows and columns with no ratings are exactly 0 in both packages.
- The half-steps from shared numpy factors (no initial draw): within
  ``HALF_TOL`` (1e-5) of the largest |entry|, relative.
- ``predict`` and ``rmse`` over shared factors: within 1e-6.
- PageRank ranks: within ``PR_TOL`` (1e-6) of the JAX package's (the f32
  sums of a step add in other orders).
- The MLP's initial params and its sampled batch indices: bit for bit.
  Losses and params after 5 steps of sgd, momentum and adam: within
  ``MLP_TOL`` (1e-5; adam's update divides by sqrt(ν̂), which magnifies an
  ulp of a small gradient, and read 1.9e-6 here; sgd and momentum 6e-8).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import marlin_tpu as jm
import marlin_tpu_torch as tm
from marlin_tpu_torch import interop
from marlin_tpu_torch.mesh import Mesh

jals = importlib.import_module("marlin_tpu.ml.als")
jnn = importlib.import_module("marlin_tpu.ml.neural_network")
jpr = importlib.import_module("marlin_tpu.ml.pagerank")
tals = importlib.import_module("marlin_tpu_torch.ml.als")
tnn = importlib.import_module("marlin_tpu_torch.ml.neural_network")
tpr = importlib.import_module("marlin_tpu_torch.ml.pagerank")

ALS_TOL = 2e-4
HALF_TOL = 1e-5
PR_TOL = 1e-6
MLP_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def mesh1():
    return jm.create_mesh((1, 1), devices=jax.devices()[:1])


# ------------------------------------------------------------------- ALS


def _ratings(seed=0, n_users=30, n_items=20, rank=4, density=0.5,
             implicit=False):
    """Low-rank ratings with user 3 and item 5 left without any."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n_users, rank)).astype(np.float32)
    v = rng.standard_normal((n_items, rank)).astype(np.float32)
    full = u @ v.T
    mask = rng.random((n_users, n_items)) < density
    mask[3] = False
    mask[:, 5] = False
    ui, ii = np.nonzero(mask)
    vals = (rng.integers(1, 10, len(ui)).astype(np.float32) if implicit
            else full[mask])
    return ui, ii, vals, (n_users, n_items)


MODES = {
    "weighted": dict(),
    "plain": dict(weighted_lambda=False),
    "implicit": dict(implicit_prefs=True, alpha=5.0),
}


@pytest.mark.parametrize("blocked", [False, True], ids=["unblocked",
                                                        "blocked"])
@pytest.mark.parametrize("mode", list(MODES))
def test_als_matches_jax(mesh1, mode, blocked):
    ui, ii, vals, shape = _ratings(implicit=mode == "implicit")
    kw = dict(rank=4, iterations=5, lam=0.05, shard=blocked, **MODES[mode])
    if blocked:
        kw["segment_block"] = 8
    jmod = jm.CoordinateMatrix(ui, ii, vals, shape=shape, mesh=mesh1).als(**kw)
    tmod = tm.CoordinateMatrix(ui, ii, vals, shape=shape).als(**kw)
    for side in ("user_features", "product_features"):
        a = getattr(jmod, side).to_numpy()
        b = getattr(tmod, side).to_numpy()
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=ALS_TOL)
    # the row and the column with no ratings: exactly 0 in both
    for model in (jmod, tmod):
        assert not np.any(model.user_features.to_numpy()[3])
        assert not np.any(model.product_features.to_numpy()[5])


def test_als_blocked_equals_unblocked():
    ui, ii, vals, shape = _ratings(seed=7, n_users=50)
    coo = tm.CoordinateMatrix(ui, ii, vals, shape=shape)
    rep = coo.als(rank=4, iterations=5, lam=0.05, shard=False)
    blk = coo.als(rank=4, iterations=5, lam=0.05, shard=True, segment_block=8)
    np.testing.assert_allclose(blk.user_features.to_numpy(),
                               rep.user_features.to_numpy(), atol=1e-5)
    assert blk.rmse(coo) < 0.3


def _stats_inputs(seed=1):
    ui, ii, vals, (n_users, n_items) = _ratings(seed=seed)
    rng = np.random.default_rng(seed + 100)
    v = rng.standard_normal((n_items, 4)).astype(np.float32)
    return ui.astype(np.int32), ii.astype(np.int32), vals, n_users, v


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("weighted", [True, False])
def test_als_explicit_half_step_from_shared_factors(weighted):
    ui, ii, vals, n_users, v = _stats_inputs()
    want = jals._solve_side(jnp.asarray(v), jnp.asarray(ui), jnp.asarray(ii),
                            jnp.asarray(vals), 4, 0.05, n_users, weighted)
    got = tals._solve_side(torch.from_numpy(v), torch.from_numpy(ui),
                           torch.from_numpy(ii), torch.from_numpy(vals), 4,
                           0.05, n_users, weighted)
    _close(got.numpy(), want, HALF_TOL)
    assert not got[3].any()


def test_als_implicit_half_step_from_shared_factors():
    ui, ii, vals, n_users, v = _stats_inputs(seed=2)
    want = jals._solve_side_implicit(jnp.asarray(v), jnp.asarray(ui),
                                     jnp.asarray(ii), jnp.asarray(vals), 0.1,
                                     5.0, n_users)
    got = tals._solve_side_implicit(torch.from_numpy(v), torch.from_numpy(ui),
                                    torch.from_numpy(ii),
                                    torch.from_numpy(vals), 0.1, 5.0, n_users)
    _close(got.numpy(), want, HALF_TOL)
    assert not got[3].any()


@pytest.mark.parametrize("implicit", [False, True])
def test_als_blocked_half_step_from_shared_factors(mesh1, implicit):
    ui, ii, vals, n_users, v = _stats_inputs(seed=3)
    packs = [jals._block_ratings_by_segment(ui, ii, vals, n_users, 1, 8),
             tals._block_ratings_by_segment(ui, ii, vals, n_users, 1, 8)]
    for a, b in zip(*packs):
        np.testing.assert_array_equal(b, a)
    sid, oid, val, padded = packs[1]
    want = jals._solve_side_sharded(
        jnp.asarray(v), jnp.asarray(sid), jnp.asarray(oid), jnp.asarray(val),
        jnp.float32(0.05), jnp.float32(5.0), mesh=mesh1, block=8,
        weighted=True, implicit=implicit)
    got = tals._solve_side_sharded(
        torch.from_numpy(v), torch.from_numpy(sid), torch.from_numpy(oid),
        torch.from_numpy(val), 0.05, 5.0, mesh=tm.create_mesh(), block=8,
        weighted=True, implicit=implicit)
    assert got.shape == (padded, 4)
    _close(got.numpy(), want, HALF_TOL)
    assert not got[n_users:].any() and not got[3].any()


def test_als_chunked_stats_match_one_chunk():
    ui, ii, vals, n_users, v = _stats_inputs(seed=4)
    args = (torch.from_numpy(v), torch.from_numpy(ui), torch.from_numpy(ii),
            torch.from_numpy(vals), n_users)
    whole = tals._chunked_segment_stats(*args)
    for chunk in (1, 7, 64):
        for a, b in zip(tals._chunked_segment_stats(*args, chunk=chunk),
                        whole):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_als_auto_shard_threshold():
    calls = []
    orig = tals._als_sharded

    def spy(*a, **k):
        calls.append(True)
        return orig(*a, **k)

    tals._als_sharded = spy
    try:
        # 300k users x rank 16: stats 4*16*16*300k = 307 MB > 256 MB
        rng = np.random.default_rng(8)
        ui = rng.integers(0, 300_000, 500).astype(np.int32)
        ii = rng.integers(0, 20, 500).astype(np.int32)
        coo = tm.CoordinateMatrix(ui, ii, rng.standard_normal(500).astype(
            np.float32), shape=(300_000, 20))
        model = coo.als(rank=16, iterations=1, lam=0.1)
        assert calls == [True], "auto shard heuristic did not engage"
        assert np.isfinite(model.rmse(coo))
        # unrated users come out exactly 0 on the blocked path too
        rated = np.zeros(300_000, bool)
        rated[ui] = True
        u = model.user_features.to_numpy()
        assert not u[~rated].any() and np.abs(u[rated]).sum(1).min() > 0
        ui2, ii2, vals2, shape2 = _ratings()
        tm.CoordinateMatrix(ui2, ii2, vals2, shape=shape2).als(
            rank=4, iterations=1)
        assert calls == [True]  # small stats: the unblocked path
    finally:
        tals._als_sharded = orig


def test_als_reduces_rmse_and_predicts(mesh1):
    ui, ii, vals, shape = _ratings(seed=0, density=0.5)
    coo = tm.CoordinateMatrix(ui, ii, vals, shape=shape)
    model = coo.als(rank=4, iterations=12, lam=0.05)
    assert model.rmse(coo) < 0.3
    assert model.user_features.shape == (shape[0], 4)
    # predict and rmse over the JAX package's factors, carried across
    jmod = jm.CoordinateMatrix(ui, ii, vals, shape=shape,
                               mesh=mesh1).als(rank=4, iterations=3)
    tmod = interop.als_model_from_numpy(jmod.user_features.to_numpy(),
                                        jmod.product_features.to_numpy(),
                                        device="cpu")
    users, items = [0, 1, 2, 29], [0, 0, 19, 4]
    np.testing.assert_allclose(tmod.predict(users, items).numpy(),
                               np.asarray(jmod.predict(users, items)),
                               atol=1e-6)
    jcoo = jm.CoordinateMatrix(ui, ii, vals, shape=shape, mesh=mesh1)
    assert abs(tmod.rmse(coo) - jmod.rmse(jcoo)) < 1e-6


def test_als_drops_padding_entries():
    ui, ii, vals, shape = _ratings(seed=5)
    clean = tm.CoordinateMatrix(ui, ii, vals, shape=shape).als(
        rank=4, iterations=3)
    # entries at index == shape are the JAX package's BCOO padding
    pui = np.concatenate([ui, [shape[0], 0]])
    pii = np.concatenate([ii, [0, shape[1]]])
    pvals = np.concatenate([vals, [9.0, 9.0]]).astype(np.float32)
    padded = tm.CoordinateMatrix(pui, pii, pvals, shape=shape).als(
        rank=4, iterations=3)
    np.testing.assert_array_equal(padded.user_features.to_numpy(),
                                  clean.user_features.to_numpy())


# -------------------------------------------------------------- PageRank

EDGES = [(1, 0), (2, 0), (3, 0), (0, 1), (2, 1), (3, 4), (4, 2), (3, 4),
         (2, 0)]  # two duplicates; node 5 is dangling and unreached


def test_transition_matrix_equal():
    np.testing.assert_array_equal(tpr.build_transition_matrix(EDGES, n=6),
                                  jpr.build_transition_matrix(EDGES, n=6))
    for mod in (tpr, jpr):
        with pytest.raises(ValueError, match="empty edge list"):
            mod.build_transition_matrix([])
        with pytest.raises(ValueError, match="empty edge list"):
            mod.build_transition_operator([])


@pytest.mark.parametrize("form", ["dense", "matrix", "sparse", "operator",
                                  "operator_mesh"])
def test_pagerank_matches_jax(form, mesh1):
    m = jpr.build_transition_matrix(EDGES, n=6)
    want = jpr.pagerank(m, iterations=60)
    if form == "dense":
        got = tpr.pagerank(m, iterations=60)
    elif form == "matrix":
        got = tpr.pagerank(tm.BlockMatrix.from_array(m), iterations=60)
    elif form == "sparse":
        got = tpr.pagerank(tm.SparseVecMatrix.from_dense(m), iterations=60)
    else:
        mesh = tm.create_mesh() if form == "operator_mesh" else None
        op = tpr.build_transition_operator(EDGES, n=6, mesh=mesh)
        assert op.nnz == 9 and op.shape == (6, 6)
        assert (op.weight is not None) == (mesh is not None)
        got = tpr.pagerank(op, iterations=60)
        jop = jpr.build_transition_operator(
            EDGES, n=6, mesh=mesh1 if mesh is not None else None)
        np.testing.assert_allclose(got, jpr.pagerank(jop, iterations=60),
                                   atol=PR_TOL)
    assert got.dtype == np.float32 and got.sum() == pytest.approx(1, abs=1e-6)
    np.testing.assert_allclose(got, want, atol=PR_TOL)
    assert got.argmax() == 0


def test_pagerank_operator_graph_scale():
    rng = np.random.default_rng(0)
    n, e = 20_000, 200_000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    top = tpr.build_transition_operator(edges, n=n)
    assert np.all(np.diff(top.dst.numpy()) >= 0)  # sorted by destination
    got = tpr.pagerank(top, iterations=5)
    want = jpr.pagerank(jpr.build_transition_operator(edges, n=n),
                        iterations=5)
    assert got.sum() == pytest.approx(1.0, abs=1e-4) and (got >= 0).all()
    np.testing.assert_allclose(got, want, atol=PR_TOL, rtol=1e-5)


def test_pagerank_mesh_of_many_refused():
    """Edges across devices need a mesh over torch.distributed ranks (the
    rank path: tests/test_torch_dist_ml.py)."""
    mesh = Mesh(torch.device("cpu"), (2, 1))
    with pytest.raises(ValueError, match="mesh over torch.distributed ranks"):
        tpr.build_transition_operator(EDGES, mesh=mesh)
    op = tpr.build_transition_operator(EDGES)
    with pytest.raises(ValueError, match="mesh over torch.distributed ranks"):
        tpr._pagerank_edges(op.src, op.dst, op.weight, op.inv_deg,
                            op.dangling, torch.tensor(0.85), op.n, 2, mesh)


# ------------------------------------------------------------------- MLP


@pytest.fixture(scope="module")
def separable():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 32)).astype(np.float32)
    w = rng.standard_normal((32, 4))
    y = np.argmax(x @ w, axis=1).astype(np.int64)
    return x, y


@pytest.mark.parametrize("sizes", [(32, 16, 4), (784, 1024, 10),
                                   (32, 16, 12, 4)])
def test_mlp_init_bit_equal(sizes):
    want = jnn.mlp_init(jax.random.key(3), sizes)
    got = tnn.mlp_init(3, sizes)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    nn_j = jnn.NeuralNetwork(32, (16, 12), 4, seed=5)
    nn_t = tnn.NeuralNetwork(32, (16, 12), 4, seed=5)
    assert nn_t.layer_sizes == nn_j.layer_sizes == (32, 16, 12, 4)
    pj, pt = nn_j.init_params(), nn_t.init_params()
    for k in pj:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


@pytest.mark.parametrize("m,batch", [(128, 16), (1000, 256), (262_144, 8192),
                                     (100, 256)])
def test_sampled_indices_bit_equal(m, batch):
    key_j, key_t = jax.random.key(11), tm.threefry.prng_key(11)
    for _ in range(4):
        key_j, sub_j = jax.random.split(key_j)
        key_t, sub_t = tm.threefry.split(key_t)
        b = min(batch, m)
        # the JAX package's sampling (_sampled_loss_and_grads)
        stride = max(1, m // b)
        offset = jax.random.randint(sub_j, (), 0, m)
        want = np.asarray((offset + jnp.arange(b) * stride) % m)
        got = tnn._sample_indices(sub_t, m, b)
        np.testing.assert_array_equal(got.numpy(), want)


def _train_both(x, y, iters=5, batch=16, **kw):
    nn_j = jnn.NeuralNetwork(32, 16, 4, seed=1, **kw)
    nn_t = tnn.NeuralNetwork(32, 16, 4, seed=1, **kw)
    pj, lj = nn_j.train(x, y, iterations=iters, batch_size=batch)
    pt, lt = nn_t.train(x, y, iterations=iters, batch_size=batch)
    return (nn_j, pj, lj), (nn_t, pt, lt)


def _params_close(pt, pj, tol=MLP_TOL):
    assert list(pt) == list(pj)
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.5), ("momentum", 0.3),
                                          ("adam", 0.01)])
def test_train_matches_jax(separable, optimizer, lr):
    x, y = separable
    (nn_j, pj, lj), (nn_t, pt, lt) = _train_both(
        x, y, learning_rate=lr, optimizer=optimizer)
    assert len(lt) == 5 and all(isinstance(v, float) for v in lt)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=MLP_TOL)
    _params_close(pt, pj)
    if optimizer == "sgd":
        assert nn_t.last_opt_state is None
    else:
        assert type(nn_t.last_opt_state).__name__ == (
            "AdamState" if optimizer == "adam" else "MomentumState")


def test_train_step_optax_sgd_equals_train_step(separable):
    x, y = separable
    params = tnn.mlp_init(0, (32, 16, 4))
    xt = torch.from_numpy(x)
    yt = torch.nn.functional.one_hot(torch.from_numpy(y), 4).float()
    key = tm.threefry.prng_key(4)
    p1, l1 = tnn.train_step(params, xt, yt, key, 16, 0.5)
    p2, state, l2 = tnn.train_step_optax(params, tnn.opt_init("sgd", params),
                                         xt, yt, key, 16, "sgd", 0.5)
    assert state == () and float(l1) == float(l2)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=1e-7)


def test_remat_equal_to_no_remat(separable):
    x, y = separable
    (_, pj, lj), (_, pt, lt) = _train_both(x, y, remat=True,
                                           learning_rate=0.5)
    plain = tnn.NeuralNetwork(32, 16, 4, seed=1, learning_rate=0.5)
    pp, lp = plain.train(x, y, iterations=5, batch_size=16)
    assert lt == lp
    for k in pp:
        torch.testing.assert_close(pt[k], pp[k], rtol=0, atol=0)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=MLP_TOL)


@pytest.mark.parametrize("activation", ["sigmoid", "relu", "tanh"])
def test_activations_match_jax(separable, activation):
    x, y = separable
    (_, pj, lj), (nn_t, pt, lt) = _train_both(x, y, activation=activation,
                                              learning_rate=0.2)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=MLP_TOL)
    _params_close(pt, pj)
    out_j = jnn.mlp_forward(pj, jnp.asarray(x), activation)
    out_t = tnn.mlp_forward(pt, torch.from_numpy(x), activation)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=MLP_TOL)


def test_unknown_activation_and_optimizer_refused(separable):
    x, y = separable
    for mod in (jnn, tnn):
        with pytest.raises(ValueError, match="unknown activation"):
            mod.NeuralNetwork(32, 8, 4, activation="sigmod").train(
                x, y, iterations=1, batch_size=32)
        with pytest.raises(ValueError, match="unknown optimizer"):
            mod.NeuralNetwork(32, 8, 4, optimizer="lbfgs").train(
                x, y, iterations=1, batch_size=32)


def test_one_hot_labels(separable):
    x, y = separable
    onehot = np.eye(4, dtype=np.float32)[y]
    _, from_int = tnn.NeuralNetwork(32, 8, 4, seed=2).train(
        x, y, iterations=5, batch_size=64)
    nn_t = tnn.NeuralNetwork(32, 8, 4, seed=2)
    _, from_onehot = nn_t.train(x, onehot, iterations=5, batch_size=64)
    _, jax_onehot = jnn.NeuralNetwork(32, 8, 4, seed=2).train(
        x, onehot, iterations=5, batch_size=64)
    assert from_onehot == from_int and np.isfinite(from_onehot).all()
    np.testing.assert_allclose(from_onehot, jax_onehot, atol=MLP_TOL)


def test_predict_and_accuracy(separable, tmp_path):
    x, y = separable
    nn_j = jnn.NeuralNetwork(32, 16, 4, seed=0, learning_rate=2.0)
    pj, _ = nn_j.train(x, y, iterations=60, batch_size=64)
    nn_t = tnn.NeuralNetwork(32, 16, 4, seed=0, learning_rate=2.0)
    pt = interop.mlp_params_from_numpy(jax.tree.map(np.asarray, pj),
                                       device="cpu")
    np.testing.assert_array_equal(nn_t.predict(pt, x), nn_j.predict(pj, x))
    acc = nn_t.accuracy(pt, tm.DenseVecMatrix.from_array(x), y)
    assert acc == nn_j.accuracy(pj, x, y) and acc > 0.5
    nn_t.save_weights(pt, str(tmp_path / "mlp"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "mlp.w1.csv",
                                          delimiter=","),
                               np.asarray(pj["w1"]), rtol=1e-6)
    with pytest.raises(ValueError, match="w0"):
        interop.mlp_params_from_numpy({"w1": np.ones((2, 2))})


@pytest.mark.parametrize("optimizer,lr", [("momentum", 0.3), ("adam", 0.01)])
def test_opt_state_carried_from_jax(separable, optimizer, lr):
    """Three steps in the JAX package, then its params and optax state carried
    across: the two packages' next two steps agree."""
    x, y = separable
    nn_j = jnn.NeuralNetwork(32, 16, 4, seed=3, learning_rate=lr,
                             optimizer=optimizer)
    pj, _ = nn_j.train(x, y, iterations=3, batch_size=16)
    state = jax.tree.map(np.asarray, nn_j.last_opt_state)
    pt = interop.mlp_params_from_numpy(jax.tree.map(np.asarray, pj),
                                       device="cpu")
    st = interop.mlp_opt_state_from_numpy(state, device="cpu")
    if optimizer == "adam":
        assert st.count == 3
    pj2, lj2 = nn_j.train(x, y, iterations=2, batch_size=16, params=pj,
                          opt_state=nn_j.last_opt_state)
    nn_t = tnn.NeuralNetwork(32, 16, 4, seed=3, learning_rate=lr,
                             optimizer=optimizer)
    pt2, lt2 = nn_t.train(x, y, iterations=2, batch_size=16, params=pt,
                          opt_state=st)
    np.testing.assert_allclose(lt2, lj2, rtol=0, atol=MLP_TOL)
    _params_close(pt2, pj2)
    sgd = jnn._build_tx("sgd", 0.1, 0.9).init(pj)
    assert interop.mlp_opt_state_from_numpy(
        jax.tree.map(np.asarray, sgd)) == ()
