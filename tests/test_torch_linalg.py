"""The port's dense factorizations, solves, SVD and logistic regression
against the JAX package.

The same seeded numpy inputs go through ``marlin_tpu.linalg`` on the
8-device CPU mesh (as ``tests/test_linalg.py`` builds it) and through
``marlin_tpu_torch.linalg`` on the CPU.

Tolerances:

- LU: ``perm`` equal; L and U within 1e-4 of max |A| (both sides f32 with
  other summation orders; the inputs have no ties between pivot
  candidates, so both packages' partial pivoting picks the same rows).
- Cholesky, inverse and solves: within 1e-4 of the largest |entry| of the
  JAX result.
- SVD: s within rtol 1e-4; V and U within 1e-3 per element after each
  column's sign is aligned with the JAX column's: a singular vector's sign
  is arbitrary, and the two packages' ``eigh`` builds choose it apart on the
  same matrix. The Lanczos start vector is the JAX package's own
  (``threefry.normal``), so the Lanczos basis, and with it s, follow the
  reference's.
- ``threefry.normal`` against ``jax.random.normal``: the uniform values are
  bit-equal; float32 within rtol 1e-5 (XLA's and PyTorch's f32 ``erfinv``
  differ by up to ~6e-6 relative near the tails, where erfinv is steep);
  bfloat16 within one bf16 ulp (rtol 2^-7).
- ``lr`` weights within 1e-5.

The ``cuda``-marked tests run the same calls on the card against the port's
own CPU run (perm equal, the rest as above) and check that the dist-mode
loops make no host sync; they skip where there is no card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import marlin_tpu as jm
import marlin_tpu_torch as tm
from marlin_tpu.linalg import factorizations as jfac
from marlin_tpu_torch import threefry
from marlin_tpu_torch.linalg import factorizations as tfac

TOL = 1e-4
SVD_S_RTOL, SVD_VEC_TOL = 1e-4, 1e-3
LR_TOL = 1e-5
NORMAL_F32_RTOL, NORMAL_BF16_RTOL = 1e-5, 2.0 ** -7


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# ------------------------------------------------------------------ inputs


def _well_conditioned(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return a + n * np.eye(n, dtype=np.float32)


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


def _swaps_in_blocks(n, seed):
    """Tiny diagonal entries: every pivot block swaps rows."""
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = 1e-8
    return a


def _shuffled_in_blocks(n, seed, b=64):
    """A well-conditioned matrix with its rows shuffled inside each block of
    ``b``: every pivot block of that size swaps rows, and the row holding
    each column's dominant entry lies in its pivot block."""
    rng = np.random.default_rng(seed)
    shuffle = np.concatenate([o + rng.permutation(min(b, n - o))
                              for o in range(0, n, b)])
    return _well_conditioned(n, seed)[shuffle]


def _zero_pivot_block(n=8, b=4):
    """tests/test_lu_panel_pivot_beats_block_pivot's input: the first pivot
    block is zero, good pivots lie below it."""
    a = np.zeros((n, n), np.float32)
    a[:b, b:] = np.eye(b)
    a[b:, :b] = np.eye(b)
    a[b:, b:] = 0.5 * np.eye(b)
    return a


INPUTS = {"well": _well_conditioned, "swaps": _swaps_in_blocks,
          "shuffled": _shuffled_in_blocks}  # shuffled: blocks of 64


def _pair(a, jmesh, kind="BlockMatrix"):
    return (getattr(jm, kind).from_array(a, jmesh),
            getattr(tm, kind).from_array(a))


def _close(got, want, tol=TOL, scale=None):
    got = got.to_numpy() if hasattr(got, "to_numpy") else np.asarray(got)
    want = want.to_numpy() if hasattr(want, "to_numpy") else np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _perm(p):
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


# ---------------------------------------------------------------- LU


@pytest.mark.parametrize("inp,n,mode,block,schedule,pivot", [
    ("well", 24, "local", None, "auto", "block"),
    ("well", 24, "dist", 8, "masked", "block"),
    ("well", 24, "dist", 8, "shrinking", "block"),
    ("well", 24, "dist", 8, "auto", "block"),
    ("well", 24, "dist", 5, "masked", "block"),
    ("well", 24, "dist", 5, "shrinking", "block"),
    ("well", 21, "dist", 7, "masked", "block"),   # 21 = 3 x 7: pads to 24
    ("well", 24, "dist", 8, "masked", "panel"),
    ("well", 24, "dist", 5, "auto", "panel"),
    ("swaps", 24, "dist", 8, "masked", "block"),
    ("swaps", 24, "dist", 8, "shrinking", "block"),
    ("swaps", 24, "dist", 8, "masked", "panel"),
    ("swaps", 24, "local", None, "auto", "block"),
    ("shuffled", 48, "dist", 16, "shrinking", "block"),
    ("shuffled", 48, "dist", 16, "masked", "panel"),
])
def test_lu_matches_jax(mesh, inp, n, mode, block, schedule, pivot):
    a = (_shuffled_in_blocks(n, 4, block) if inp == "shuffled"
         else INPUTS[inp](n, 4))
    jmat, tmat = _pair(a, mesh)
    kw = dict(mode=mode, block_size=block, schedule=schedule, pivot=pivot)
    jl, ju, jp = jm.linalg.lu_decompose(jmat, **kw)
    tl, tu, tp = tm.linalg.lu_decompose(tmat, **kw)
    assert isinstance(tp, torch.Tensor)
    np.testing.assert_array_equal(_perm(tp), np.asarray(jp))
    if inp != "well" and mode == "dist":
        assert not np.array_equal(_perm(tp), np.arange(n))
    scale = np.abs(a).max()
    _close(tl, jl, scale=scale)
    _close(tu, ju, scale=scale)
    np.testing.assert_allclose(a[_perm(tp)], tl.to_numpy() @ tu.to_numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("a,mode,block,pivot", [
    (np.array([[0.0, 1.0], [1.0, 0.0]], np.float32), "local", None, "block"),
    (_zero_pivot_block(), "dist", 4, "panel"),
])
def test_lu_pivoting_inputs_match_jax(mesh, a, mode, block, pivot):
    """tests/test_linalg.py's pivoting inputs: the local swap of
    test_lu_pivoting_needed, and test_lu_panel_pivot_beats_block_pivot's
    zero pivot block, which only panel pivoting factors."""
    jmat, tmat = _pair(a, mesh)
    kw = dict(mode=mode, block_size=block, pivot=pivot)
    jl, ju, jp = jm.linalg.lu_decompose(jmat, **kw)
    tl, tu, tp = tm.linalg.lu_decompose(tmat, **kw)
    np.testing.assert_array_equal(_perm(tp), np.asarray(jp))
    _close(tl, jl, scale=np.abs(a).max())
    _close(tu, ju, scale=np.abs(a).max())
    np.testing.assert_allclose(a[_perm(tp)], tl.to_numpy() @ tu.to_numpy(),
                               atol=1e-5)


# ------------------------------------------------- Cholesky and inverse


@pytest.mark.parametrize("n,mode,block,schedule", [
    (21, "local", None, "auto"),
    (21, "dist", 7, "masked"),
    (21, "dist", 7, "shrinking"),
    (21, "dist", 8, "auto"),      # pads to 24
    (21, "dist", 8, "shrinking"),
])
def test_cholesky_matches_jax(mesh, n, mode, block, schedule):
    a = _spd(n, 1)
    jmat, tmat = _pair(a, mesh)
    kw = dict(mode=mode, block_size=block, schedule=schedule)
    _close(tm.linalg.cholesky_decompose(tmat, **kw),
           jm.linalg.cholesky_decompose(jmat, **kw))


@pytest.mark.parametrize("a,mode,block,schedule,pivot", [
    (_well_conditioned(16, 2), "local", None, "auto", "block"),
    (_well_conditioned(16, 2), "dist", 8, "masked", "block"),
    (_well_conditioned(16, 2), "dist", 8, "shrinking", "block"),
    (_well_conditioned(21, 6), "dist", 7, "auto", "block"),
    (_well_conditioned(21, 6), "dist", 5, "auto", "block"),
    (_zero_pivot_block(), "dist", 4, "auto", "panel"),
])
def test_inverse_matches_jax(mesh, a, mode, block, schedule, pivot):
    jmat, tmat = _pair(a, mesh)
    kw = dict(mode=mode, block_size=block, schedule=schedule, pivot=pivot)
    got = tm.linalg.inverse(tmat, **kw)
    _close(got, jm.linalg.inverse(jmat, **kw))
    np.testing.assert_allclose(got.to_numpy() @ a, np.eye(a.shape[0]),
                               atol=1e-4)


# ---------------------------------------------------------------- solves


@pytest.mark.parametrize("mode,block", [("local", None), ("dist", 8),
                                        ("dist", 7)])
@pytest.mark.parametrize("rhs_cols", [None, 3])
def test_solve_matches_jax(mesh, mode, block, rhs_cols):
    n = 20
    a = _well_conditioned(n, 9)
    rng = np.random.default_rng(10)
    b = rng.standard_normal(n if rhs_cols is None else (n, rhs_cols)).astype(
        np.float32)
    jmat, tmat = _pair(a, mesh)
    want = jm.linalg.solve(jmat, b, mode=mode, block_size=block)
    got = tm.linalg.solve(tmat, b, mode=mode, block_size=block)
    assert tuple(got.shape) == b.shape
    _close(got.numpy(), want)
    # the method form
    _close(tmat.solve(b, mode=mode, block_size=block).numpy(), want)


@pytest.mark.parametrize("rhs_cols", [None, 2])
def test_lu_and_cholesky_solve_match_jax(mesh, rhs_cols):
    n = 18
    rng = np.random.default_rng(16)
    b = rng.standard_normal(n if rhs_cols is None else (n, rhs_cols)).astype(
        np.float32)
    a = _well_conditioned(n, 11)
    jmat, tmat = _pair(a, mesh)
    jf = jm.linalg.lu_decompose(jmat, mode="dist", block_size=8)
    tf = tm.linalg.lu_decompose(tmat, mode="dist", block_size=8)
    _close(tm.linalg.lu_solve(*tf, b).numpy(), jm.linalg.lu_solve(*jf, b))
    # perm given as numpy, and the rhs as a dense vector/matrix
    tb = (tm.DistributedVector.from_array(b) if rhs_cols is None
          else tm.DenseVecMatrix.from_array(b))
    _close(tm.linalg.lu_solve(tf[0], tf[1], _perm(tf[2]), tb).numpy(),
           jm.linalg.lu_solve(*jf, b))
    s = _spd(n, 15)
    jmat, tmat = _pair(s, mesh)
    jl = jm.linalg.cholesky_decompose(jmat, mode="dist")
    tl = tm.linalg.cholesky_decompose(tmat, mode="dist")
    _close(tm.linalg.cholesky_solve(tl, b).numpy(),
           jm.linalg.cholesky_solve(jl, b))


# ------------------------------------------------------------------ SVD


def _svd_input():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((40, 12))
            @ np.diag(np.linspace(10, 0.1, 12))).astype(np.float32)


def _align_signs(got, want):
    """``got``'s columns with the sign of ``want``'s (by their dot product)."""
    return got * np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)


@pytest.mark.parametrize("mode", ["local-svd", "local-eigs", "dist-eigs"])
def test_svd_matches_jax(row_mesh, mode):
    a = _svd_input()
    jmat, tmat = _pair(a, row_mesh, "DenseVecMatrix")
    want = jmat.compute_svd(4, mode=mode)
    got = tmat.compute_svd(4, mode=mode)
    assert isinstance(got.s, np.ndarray) and isinstance(got.v, np.ndarray)
    np.testing.assert_allclose(got.s, want.s, rtol=SVD_S_RTOL)
    np.testing.assert_allclose(_align_signs(got.v, want.v), want.v, rtol=0,
                               atol=SVD_VEC_TOL)
    np.testing.assert_allclose(_align_signs(got.u.to_numpy(), want.u.to_numpy()),
                               want.u.to_numpy(), rtol=0, atol=SVD_VEC_TOL)


def test_svd_auto_modes_and_no_u(row_mesh):
    """"auto" picks the mode by the reference's rule (here local-svd for
    n < 100); compute_u=False leaves u out; a rank-deficient input drops
    its numerically-zero singular values as the JAX package does."""
    a = _svd_input()
    a[:, -3:] = 0.0
    jmat, tmat = _pair(a, row_mesh, "DenseVecMatrix")
    for kw in (dict(k=3), dict(k=11, mode="local-eigs", compute_u=False)):
        want, got = jmat.compute_svd(**kw), tmat.compute_svd(**kw)
        assert got.s.shape == want.s.shape
        np.testing.assert_allclose(got.s, want.s, rtol=SVD_S_RTOL,
                                   atol=1e-4 * want.s[0])
        assert (got.u is None) == (want.u is None)


def test_symmetric_eigs_matches_jax():
    """Any tensor-to-tensor matvec: the eigenpairs of a symmetric matrix
    against the JAX package's jitted scan over a jax matvec."""
    s = _spd(30, 21)
    jv, jvec = jm.linalg.symmetric_eigs(lambda v: jnp.asarray(s) @ v, 30, 3,
                                        seed=4)
    ts = torch.from_numpy(s)
    tv, tvec = tm.linalg.symmetric_eigs(lambda v: ts @ v, 30, 3, seed=4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=SVD_S_RTOL)
    np.testing.assert_allclose(_align_signs(tvec.numpy(), np.asarray(jvec)),
                               np.asarray(jvec), rtol=0, atol=SVD_VEC_TOL)


# -------------------------------------------------------------------- lr


@pytest.mark.parametrize("kind", ["DenseVecMatrix", "BlockMatrix"])
def test_lr_matches_jax(mesh, row_mesh, kind):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 9)).astype(np.float32)
    y = (x @ rng.standard_normal(9) > 0).astype(np.float32)
    data = np.concatenate([y[:, None], x], axis=1)
    jmat, tmat = _pair(data, row_mesh if kind == "DenseVecMatrix" else mesh,
                       kind)
    want = jmat.lr(1.0, 50)
    got = tmat.lr(1.0, 50)
    assert isinstance(got, np.ndarray) and got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL)
    model = tm.ml.logistic_regression(data, step_size=0.5, iterations=20)
    ref = jm.ml.logistic_regression(data, step_size=0.5, iterations=20)
    np.testing.assert_allclose(model.weights, ref.weights, rtol=0, atol=LR_TOL)
    np.testing.assert_array_equal(model.predict(x), ref.predict(x))


# ----------------------------------------------- rules, names and errors


@pytest.mark.parametrize("nb", [1, 16, 64, 65, 100])
@pytest.mark.parametrize("schedule", ["auto", "masked", "shrinking"])
@pytest.mark.parametrize("op,pivot", [("lu", "block"), ("lu", "panel"),
                                      ("cholesky", "block")])
def test_schedule_rule_matches_jax(nb, schedule, op, pivot):
    def outcome(fn):
        try:
            return fn(schedule, nb, pivot=pivot, op=op)
        except ValueError as exc:
            return type(exc)
    assert outcome(tfac._resolve_schedule) == outcome(jfac._resolve_schedule)


def test_padding_and_names(mesh):
    """The padded size is a multiple of lcm(block, row shards) (one shard
    on the port's mesh); the exports and DenseMatrix methods are the JAX
    package's."""
    tmat = tm.BlockMatrix.from_array(_well_conditioned(21, 11))
    assert tfac._padded_size(tmat, 21, 7) == 21
    assert tfac._padded_size(tmat, 21, 8) == 24
    pad = tfac._pad_with_identity(torch.ones((3, 3)), 5)
    np.testing.assert_array_equal(pad.numpy()[3:, 3:], np.eye(2))
    assert not pad[:3, 3:].any() and not pad[3:, :3].any()
    public = sorted(n for n in dir(jm.linalg) if not n.startswith("_"))
    assert sorted(n for n in dir(tm.linalg) if not n.startswith("_")) == public
    for name in ("lu_decompose", "cholesky_decompose", "inverse",
                 "compute_svd", "lanczos"):
        assert getattr(tm, name) is getattr(tm.linalg, name)
    for kind in ("DenseVecMatrix", "BlockMatrix"):
        for meth in ("lu_decompose", "cholesky_decompose", "inverse",
                     "compute_svd", "solve", "lr"):
            assert callable(getattr(getattr(tm, kind), meth))


def _raises_like_jax(jfn, tfn, match):
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_errors_match_jax(mesh):
    a = _well_conditioned(16, 7)
    jmat, tmat = _pair(a, mesh)
    jr, tr = _pair(np.ones((6, 4), np.float32), mesh)
    cases = [
        (lambda L, M: L.lu_decompose(M, mode="dist", block_size=4,
                                     pivot="bogus"), "pivot strategy"),
        (lambda L, M: L.lu_decompose(M, mode="dist", block_size=8,
                                     pivot="panel", schedule="shrinking"),
         "shrinking"),
        (lambda L, M: L.lu_decompose(M, mode="local", schedule="eager"),
         "schedule"),
        (lambda L, M: L.cholesky_decompose(M, mode="local", schedule="eager"),
         "schedule"),
        (lambda L, M: L.inverse(M, mode="local", schedule="eager"),
         "schedule"),
        (lambda L, M: L.inverse(M, mode="local", pivot="bogus"),
         "pivot strategy"),
        (lambda L, M: L.lu_decompose(M, mode="spark"), "mode"),
        (lambda L, M: L.inverse(M, mode="spark"), "mode"),
        (lambda L, M: L.solve(M, np.ones(16, np.float32), mode="local",
                              pivot="bogus"), "pivot strategy"),
        (lambda L, M: L.solve(M, np.ones(5, np.float32)), "rhs"),
        (lambda L, M: L.compute_svd(M, 0), "k=0"),
        (lambda L, M: L.compute_svd(M, 17), "k=17"),
        (lambda L, M: L.compute_svd(M, 3, mode="dense"), "SVD mode"),
    ]
    for call, match in cases:
        _raises_like_jax(lambda: call(jm.linalg, jmat),
                         lambda: call(tm.linalg, tmat), match)
    for fn in ("lu_decompose", "cholesky_decompose", "inverse"):
        _raises_like_jax(lambda: getattr(jm.linalg, fn)(jr),
                         lambda: getattr(tm.linalg, fn)(tr), "square")
    _raises_like_jax(lambda: jm.linalg.solve(jr, np.ones(6, np.float32)),
                     lambda: tm.linalg.solve(tr, np.ones(6, np.float32)),
                     "square")
    jf = jm.linalg.lu_decompose(jmat, mode="dist", block_size=8)
    tf = tm.linalg.lu_decompose(tmat, mode="dist", block_size=8)
    _raises_like_jax(lambda: jm.linalg.lu_solve(*jf, np.ones(5, np.float32)),
                     lambda: tm.linalg.lu_solve(*tf, np.ones(5, np.float32)),
                     "rhs")
    _raises_like_jax(
        lambda: jm.linalg.cholesky_solve(jf[0], np.ones(3, np.float32)),
        lambda: tm.linalg.cholesky_solve(tf[0], np.ones(3, np.float32)),
        "rhs")


# ------------------------------------------------------- threefry.normal


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("dtype,jdtype,rtol", [
    (torch.float32, jnp.float32, NORMAL_F32_RTOL),
    (torch.bfloat16, jnp.bfloat16, NORMAL_BF16_RTOL)])
def test_normal_matches_jax(seed, dtype, jdtype, rtol):
    want = np.asarray(jax.random.normal(jax.random.key(seed), (3, 1000),
                                        jdtype)).astype(np.float32)
    got = threefry.normal(threefry.prng_key(seed), (3, 1000), dtype)
    assert got.dtype == dtype and tuple(got.shape) == (3, 1000)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        threefry.normal(threefry.prng_key(seed), (3,), torch.float64)


# -------------------------------------------------------------- the card


def _cpu_and_card(fn, a, cuda):
    """``fn`` of the matrix of ``a`` on the CPU, then on the card."""
    outs = []
    for dev in ("cpu", cuda):
        with tm.config_context(device=str(dev)):
            outs.append(fn(tm.BlockMatrix.from_array(a)))
    return outs


# On the card the inputs with swaps are rows shuffled inside the blocks of
# 64: with _swaps_in_blocks' near-singular pivot blocks at n = 256, the
# card's L differed from the CPU's by 1.05e-4 of max |A| in one element (an
# H100): block-local pivoting amplifies the two summation orders' rounding
# there, as the JAX package's docstring warns.
@pytest.mark.cuda
@pytest.mark.parametrize("inp,schedule,pivot", [
    ("well", "masked", "block"), ("well", "shrinking", "block"),
    ("well", "masked", "panel"), ("shuffled", "shrinking", "block"),
    ("shuffled", "masked", "block"), ("shuffled", "masked", "panel")])
def test_lu_on_card_matches_cpu(cuda, inp, schedule, pivot):
    a = INPUTS[inp](256, 12)
    (cl, cu, cp), (gl, gu, gp) = _cpu_and_card(
        lambda m: tm.linalg.lu_decompose(m, mode="dist", block_size=64,
                                         schedule=schedule, pivot=pivot),
        a, cuda)
    assert gp.device.type == "cuda"
    np.testing.assert_array_equal(_perm(gp), _perm(cp))
    if inp == "shuffled":
        assert not np.array_equal(_perm(gp), np.arange(256))
    _close(gl, cl, scale=np.abs(a).max())
    _close(gu, cu, scale=np.abs(a).max())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["masked", "shrinking"])
def test_cholesky_inverse_solve_on_card_match_cpu(cuda, schedule):
    s, a = _spd(200, 3), _well_conditioned(200, 5)
    b = np.random.default_rng(1).standard_normal((200, 4)).astype(np.float32)
    kw = dict(mode="dist", block_size=64, schedule=schedule)
    c, g = _cpu_and_card(lambda m: tm.linalg.cholesky_decompose(m, **kw), s,
                         cuda)
    _close(g, c)
    c, g = _cpu_and_card(lambda m: tm.linalg.inverse(m, **kw), a, cuda)
    _close(g, c)
    c, g = _cpu_and_card(lambda m: m.solve(b, mode="dist", block_size=64),
                         a, cuda)
    _close(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local-svd", "local-eigs", "dist-eigs"])
def test_svd_and_lr_on_card_match_cpu(cuda, mode):
    a = _svd_input()
    c, g = _cpu_and_card(lambda m: m.compute_svd(4, mode=mode), a, cuda)
    np.testing.assert_allclose(g.s, c.s, rtol=SVD_S_RTOL)
    np.testing.assert_allclose(_align_signs(g.v, c.v), c.v, rtol=0,
                               atol=SVD_VEC_TOL)
    rng = np.random.default_rng(2)
    data = np.concatenate([(rng.random((500, 1)) > 0.5).astype(np.float32),
                           rng.standard_normal((500, 20)).astype(np.float32)],
                          axis=1)
    c, g = _cpu_and_card(lambda m: m.lr(1.0, 30), data, cuda)
    np.testing.assert_allclose(g, c, rtol=0, atol=LR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("pivot,schedule", [("block", "masked"),
                                            ("block", "shrinking"),
                                            ("panel", "masked")])
def test_dist_loops_make_no_host_sync(cuda, pivot, schedule):
    """The dist-mode LU, Cholesky and inverse issue their loops without a
    host sync: under set_sync_debug_mode("error") a sync would raise."""
    with tm.config_context(device="cuda"):
        a = tm.BlockMatrix.from_array(_well_conditioned(192, 8))
        s = tm.BlockMatrix.from_array(_spd(192, 9))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tm.linalg.lu_decompose(a, mode="dist", block_size=64,
                                   pivot=pivot, schedule=schedule)
            tm.linalg.inverse(a, mode="dist", block_size=64, pivot=pivot,
                              schedule=schedule)
            if pivot == "block":
                tm.linalg.cholesky_decompose(s, mode="dist", block_size=64,
                                             schedule=schedule)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
