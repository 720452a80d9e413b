"""The BSR half of the sparse slice of marlin_tpu_torch against the JAX package.

The same numpy inputs (made from a seed) go through ``marlin_tpu.ops.sparse_bsr``
and ``marlin_tpu_torch.ops.sparse_bsr`` on the CPU, where the port's kernel
wrapper ``bsr_spmm_pallas`` runs its plain version. The JAX package's Pallas
kernel cannot run on this tree (it calls ``pltpu.TPUCompilerParams``, which
jax 0.9.0 no longer has), so its chunked ``bsr_spmm`` and numpy in f64 are the
oracles of the products.

Tolerances: factories are exact (the same host arithmetic). f32 products:
rtol/atol 2e-4 against the JAX package and against f64, as in
tests/test_bsr.py. bf16 products: both sides accumulate in f32 and round once
to bf16, so they may differ by a rounding step of the output: rtol/atol 2^-7.

The ``cuda``-marked tests hold the CUDA kernel against its plain version on
the card and skip where there is none.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.ops import sparse_bsr as jbsr
from marlin_tpu.ops import tile_family as jtf
from marlin_tpu_torch import config_context, interop, ops
from marlin_tpu_torch.ops import sparse_bsr as tbsr
from marlin_tpu_torch.ops import tile_family as ttf
from marlin_tpu_torch.parallel import autotune

F32_TOL = 2e-4
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _block_sparse(m, n, bs, keep_prob, seed, empty_rows=(), hot_col=None):
    """A dense (m, n) f32 matrix whose bs×bs blocks are kept with
    ``keep_prob``; block rows in ``empty_rows`` hold nothing, and block column
    ``hot_col`` is kept in every other block row."""
    rng = np.random.default_rng(seed)
    nbr, nbc = -(-m // bs), -(-n // bs)
    mask = rng.random((nbr, nbc)) < keep_prob
    if hot_col is not None:
        mask[:, hot_col] = True
    mask[list(empty_rows)] = False
    full = rng.standard_normal((nbr * bs, nbc * bs)).astype(np.float32)
    grid = full.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    grid[~mask] = 0.0
    return grid.transpose(0, 2, 1, 3).reshape(full.shape)[:m, :n].copy()


def _same_bsr(port, jax_bsr):
    np.testing.assert_array_equal(
        port.blocks.float().numpy(),
        np.asarray(jax_bsr.blocks).astype(np.float32))
    np.testing.assert_array_equal(port.block_rows.numpy(),
                                  np.asarray(jax_bsr.block_rows))
    np.testing.assert_array_equal(port.block_cols.numpy(),
                                  np.asarray(jax_bsr.block_cols))
    assert port.blocks.dtype == torch.float32 or \
        np.asarray(jax_bsr.blocks).dtype == ml_dtypes.bfloat16
    assert port.shape == jax_bsr.shape and port.nnzb == jax_bsr.nnzb
    assert port.block_size == jax_bsr.block_size


# ------------------------------------------------------------- factories

@pytest.mark.parametrize("m,n,bs,keep,tol", [
    (100, 80, 16, 0.3, 0.0),
    (50, 37, 16, 0.6, 0.0),
    (64, 64, 8, 0.5, 0.0),
    (130, 260, 64, 0.4, 0.5),
    (256, 256, 128, 0.0, 0.0),
])
def test_bsr_from_dense_matches_jax(m, n, bs, keep, tol):
    a = _block_sparse(m, n, bs, keep, m + n)
    want = jbsr.bsr_from_dense(a, block_size=bs, tol=tol)
    got = tbsr.bsr_from_dense(a, block_size=bs, tol=tol)
    _same_bsr(got, want)
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


def test_bsr_from_dense_tol_drop_matches_jax():
    a = np.zeros((32, 32), np.float32)
    a[:16, :16] = 1e-9
    a[16:, 16:] = 1.0
    got = tbsr.bsr_from_dense(a, block_size=16, tol=1e-6)
    _same_bsr(got, jbsr.bsr_from_dense(a, block_size=16, tol=1e-6))
    assert got.nnzb == 1


@pytest.mark.parametrize("seed,shape,bs", [(9, (96, 64), 16), (3, (50, 37), 8),
                                           (4, (300, 260), 64)])
def test_bsr_from_coo_matches_jax(seed, shape, bs):
    a = _block_sparse(*shape, bs, 0.3, seed)
    rows, cols = np.nonzero(a)
    # duplicates: a repeated entry is summed
    rows, cols = np.r_[rows, rows[:5]], np.r_[cols, cols[:5]]
    vals = a[rows, cols]
    want = jbsr.bsr_from_coo(rows, cols, vals, shape, block_size=bs)
    got = tbsr.bsr_from_coo(rows, cols, vals, shape, block_size=bs)
    _same_bsr(got, want)


def test_bsr_from_coo_empty_matches_jax():
    want = jbsr.bsr_from_coo([], [], np.array([], np.float32), (64, 64), 16)
    got = tbsr.bsr_from_coo([], [], np.array([], np.float32), (64, 64), 16)
    _same_bsr(got, want)
    out = got.multiply(torch.ones((64, 3)))
    assert tuple(out.shape) == (64, 3) and float(out.abs().max()) == 0.0


def test_unsorted_construction_sorts_as_jax():
    rng = np.random.default_rng(5)
    bs = 8
    blocks = rng.standard_normal((4, bs, bs)).astype(np.float32)
    br, bc = [2, 0, 2, 1], [1, 0, 0, 1]
    want = jbsr.BsrMatrix(jnp.asarray(blocks), jnp.asarray(br, jnp.int32),
                          jnp.asarray(bc, jnp.int32), (24, 16), bs)
    got = tbsr.BsrMatrix(torch.from_numpy(blocks), torch.tensor(br),
                         torch.tensor(bc), (24, 16), bs)
    _same_bsr(got, want)
    b = rng.standard_normal((16, 9)).astype(np.float32)
    dense = np.asarray(want.to_dense())
    for out in (tbsr.bsr_spmm(got, torch.from_numpy(b)),
                tbsr.bsr_spmm_pallas(got, torch.from_numpy(b))):
        np.testing.assert_allclose(out.numpy(), dense @ b, rtol=F32_TOL,
                                   atol=F32_TOL)


def test_bsr_from_dense_bf16_matches_jax():
    a = _block_sparse(40, 48, 8, 0.5, 1).astype(ml_dtypes.bfloat16)
    want = jbsr.bsr_from_dense(a, block_size=8)
    got = tbsr.bsr_from_dense(a, block_size=8)
    assert got.blocks.dtype == torch.bfloat16
    _same_bsr(got, want)
    # a bf16 tensor goes the same way
    t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    _same_bsr(tbsr.bsr_from_dense(t, block_size=8), want)


# -------------------------------------------------------------- products

# (label, m, n, p, bs, keep, kwargs of _block_sparse)
PRODUCT_CASES = [
    ("empty block rows", 300, 260, 50, 64, 0.5, dict(empty_rows=(1, 3))),
    ("hot column", 40, 24, 11, 8, 0.3, dict(hot_col=1)),
    ("ragged m n p", 50, 37, 5, 16, 0.6, {}),
    ("bs 4", 30, 26, 7, 4, 0.3, {}),
    ("bs 32", 96, 130, 33, 32, 0.4, dict(empty_rows=(0,))),
    ("bs 64", 192, 200, 70, 64, 0.5, {}),
    ("bs 128", 300, 256, 129, 128, 0.5, dict(hot_col=0)),
]


def _case(label, m, n, p, bs, keep, kw):
    seed = sum(map(ord, label))
    a = _block_sparse(m, n, bs, keep, seed, **kw)
    b = np.random.default_rng(seed + 1).standard_normal((n, p)).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("case", PRODUCT_CASES, ids=[c[0] for c in PRODUCT_CASES])
def test_products_match_jax_and_f64(case):
    a, b = _case(*case)
    bs = case[4]
    jb = jbsr.bsr_from_dense(a, block_size=bs)
    tb = tbsr.bsr_from_dense(a, block_size=bs)
    want = np.asarray(jbsr.bsr_spmm(jb, jnp.asarray(b)))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    tb_ = torch.from_numpy(b)
    outs = {"pallas": tbsr.bsr_spmm_pallas(tb, tb_),
            "plain": tbsr.bsr_spmm_pallas_plain(tb, tb_),
            "multiply pallas": tb.multiply(tb_, backend="pallas")}
    for cb in (None, 1, 3, tb.nnzb + 5):  # 3: the last chunk is short
        outs[f"chunked {cb}"] = tbsr.bsr_spmm(tb, tb_, chunk_blocks=cb)
    for label, out in outs.items():
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape, \
            label
        np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=label)
        np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=label)


@pytest.mark.parametrize("case", PRODUCT_CASES[:3], ids=[c[0] for c in PRODUCT_CASES[:3]])
def test_bf16_products_match_jax(case):
    a, b = _case(*case)
    bs = case[4]
    a16, b16 = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    jb = jbsr.bsr_from_dense(a16, block_size=bs)
    want = np.asarray(jbsr.bsr_spmm(jb, jnp.asarray(b16))).astype(np.float32)
    tb = tbsr.bsr_from_dense(a16, block_size=bs)
    tb16 = interop.to_tensor(b16, device="cpu")
    for out in (tbsr.bsr_spmm_pallas(tb, tb16), tbsr.bsr_spmm(tb, tb16)):
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_TOL,
                                   atol=BF16_TOL)
    # mixed: bf16 blocks times f32 B promote to f32, as in the JAX package
    mixed = tbsr.bsr_spmm_pallas(tb, torch.from_numpy(b))
    want_mixed = np.asarray(jbsr.bsr_spmm(jb, jnp.asarray(b)))
    assert mixed.dtype == torch.float32 and want_mixed.dtype == np.float32
    np.testing.assert_allclose(mixed.numpy(), want_mixed, rtol=F32_TOL,
                               atol=F32_TOL)


def test_f64_routes_to_chunked_in_both_packages():
    rng = np.random.default_rng(6)
    a = np.zeros((64, 64), np.float64)
    a[:32, :32] = rng.standard_normal((32, 32))
    b = rng.standard_normal((64, 8))
    with jax.enable_x64(True):
        jb = jbsr.bsr_from_dense(a, block_size=32)
        want = jbsr.bsr_spmm_pallas(jb, jnp.asarray(b))
        assert want.dtype == jnp.float64
        want = np.asarray(want)
    tb = tbsr.bsr_from_dense(a, block_size=32)
    ops.reset_launch_counts()
    got = tbsr.bsr_spmm_pallas(tb, torch.from_numpy(b))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-12, atol=1e-12)
    assert ops.launch_counts()["bsr_spmm_pallas"] == 0


def test_empty_and_errors_match_jax():
    tb = tbsr.bsr_from_dense(np.zeros((256, 256), np.float32), block_size=128)
    jb = jbsr.bsr_from_dense(np.zeros((256, 256), np.float32), block_size=128)
    assert tb.nnzb == jb.nnzb == 0
    for out in (tbsr.bsr_spmm(tb, torch.ones((256, 4))),
                tbsr.bsr_spmm_pallas(tb, torch.ones((256, 4)))):
        assert tuple(out.shape) == (256, 4) and float(out.abs().max()) == 0.0
    eye = tbsr.bsr_from_dense(np.eye(32, dtype=np.float32), block_size=16)
    with pytest.raises(ValueError):
        tbsr.bsr_spmm(eye, torch.ones((8, 4)))
    with pytest.raises(ValueError):
        tbsr.bsr_spmm_pallas(eye, torch.ones((8, 4)))
    with pytest.raises(ValueError, match="unknown BSR backend"):
        eye.multiply(torch.ones((32, 4)), backend="cuda")
    for backend in ("pallas", "auto"):
        with pytest.raises(ValueError, match="chunk_blocks"):
            eye.multiply(torch.ones((32, 4)), chunk_blocks=2, backend=backend)


def test_density_and_repr_match_jax():
    a = _block_sparse(100, 80, 16, 0.3, 0)
    jb, tb = jbsr.bsr_from_dense(a, 16), tbsr.bsr_from_dense(a, 16)
    assert tb.density == jb.density
    assert repr(tb) == repr(jb)


# ------------------------------------------------------- family and tuner

@pytest.mark.parametrize("bs", [4, 16, 64, 128, 256])
@pytest.mark.parametrize("nnzb", [1, 3, 100, 3276, 10 ** 6])
@pytest.mark.parametrize("p", [1, 5, 256, 4096])
def test_bsr_candidates_match_jax(bs, nnzb, p):
    want = jtf.bsr_candidates(bs, nnzb, p)
    assert ttf.bsr_candidates(bs, nnzb, p) == want
    assert [ttf.parse_bsr_candidate(c) for c in want] == \
        [jtf.parse_bsr_candidate(c) for c in want]


def test_bsr_candidate_errors_match_jax():
    for bad in ("chunk:4", "xla", None, 3):
        for fn in (ttf.parse_bsr_candidate, jtf.parse_bsr_candidate):
            with pytest.raises((ValueError, TypeError)):
                fn(bad)
    for args in ((0, 3, 4), (8, 0, 4), (8, 3, 0)):
        with pytest.raises(ValueError):
            ttf.bsr_candidates(*args)


def test_tune_bsr_times_every_candidate_and_caches(tmp_path, monkeypatch):
    a = _block_sparse(96, 64, 16, 0.4, 1)
    b = torch.from_numpy(
        np.random.default_rng(2).standard_normal((64, 24)).astype(np.float32))
    tb = tbsr.bsr_from_dense(a, block_size=16)
    calls = []
    plain = tbsr.bsr_spmm_pallas_plain
    monkeypatch.setattr(tbsr, "bsr_spmm_pallas_plain",
                        lambda *args: calls.append(1) or plain(*args))
    with config_context(autotune_cache_path=str(tmp_path / "tune.json")):
        autotune.clear_cache()
        ranking = autotune.tune_bsr(tb, b)
        names = [nm for nm, _ in ranking]
        assert sorted(names) == sorted(ttf.bsr_candidates(16, tb.nnzb, 24))
        assert "pallas" in names and calls
        winner = autotune.best_bsr_strategy(tb, b)
        assert winner == ranking[0][0]
        before = len(calls)
        assert autotune.best_bsr_strategy(tb, b) == winner
        assert len(calls) == before  # read from the cache, not timed again
        out = tb.multiply(b, backend="auto")
        np.testing.assert_allclose(out.numpy(), a @ b.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)
        # a fresh process reads the winner from disk
        autotune._CACHE.clear()
        assert autotune.best_bsr_strategy(tb, b) == winner
        assert len(calls) == before + (winner == "pallas")
        autotune.clear_cache()


@pytest.mark.parametrize("samples,want", [
    # the kernel's quickest round within the fastest's rounds: a tie, which
    # the kernel takes
    ({"chunked:512": [1.80, 1.83], "pallas": [1.82, 1.86]}, "pallas"),
    ({"chunked:256": [1.9, 1.9], "pallas": [1.9, 2.0]}, "pallas"),
    # apart by more than the rounds spread: the fastest by median
    ({"chunked:512": [1.80, 1.81], "pallas": [1.84, 1.85]}, "chunked:512"),
    ({"chunked:512": [1.90], "pallas": [1.80]}, "pallas"),
    ({"chunked:64": [3.0, 3.1, 2.9], "chunked:128": [2.0, 2.2, 2.1]},
     "chunked:128"),
])
def test_bsr_winner_gives_ties_to_the_kernel(samples, want):
    assert autotune._bsr_winner(samples) == want


@pytest.mark.parametrize("reps,calls_per_candidate", [
    (None, 3),  # CPU default: one warm-up call, one round of 2
    (4, 5),
])
def test_tune_bsr_rounds_on_the_cpu(reps, calls_per_candidate, tmp_path,
                                    monkeypatch):
    a = _block_sparse(64, 64, 16, 0.5, 3)
    b = torch.ones((64, 8))
    tb = tbsr.bsr_from_dense(a, block_size=16)
    calls = []
    plain = tbsr.bsr_spmm_pallas_plain
    monkeypatch.setattr(tbsr, "bsr_spmm_pallas_plain",
                        lambda *args: calls.append(1) or plain(*args))
    with config_context(autotune_cache_path=str(tmp_path / "tune.json")):
        autotune.clear_cache()
        ranking = autotune.tune_bsr(tb, b, candidates=["pallas"], reps=reps)
        assert [nm for nm, _ in ranking] == ["pallas"]
        assert len(calls) == calls_per_candidate
        assert not autotune._CACHE  # an explicit subset leaves the cache


# ---------------------------------------------------------------- interop

def test_bsr_from_numpy_round_trips_jax():
    a = _block_sparse(300, 260, 64, 0.5, 4, empty_rows=(1,))
    jb = jbsr.bsr_from_dense(a, block_size=64)
    tb = interop.bsr_from_numpy(np.asarray(jb.blocks),
                                np.asarray(jb.block_rows),
                                np.asarray(jb.block_cols), jb.shape,
                                jb.block_size, device="cpu")
    _same_bsr(tb, jb)
    np.testing.assert_array_equal(tb.to_dense().numpy(), a)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    for case in PRODUCT_CASES:
        a, b = _case(*case)
        bs = case[4]
        tb = tbsr.bsr_from_dense(a, block_size=bs, device=cuda)
        tb.blocks = tb.blocks.to(dt)
        bb = torch.from_numpy(b).to(cuda, dt)
        before = tbsr.bsr_spmm_pallas.launches
        got = tbsr.bsr_spmm_pallas(tb, bb)
        want = tbsr.bsr_spmm_pallas_plain(tb, bb)
        torch.cuda.synchronize()
        assert tbsr.bsr_spmm_pallas.launches == before + 1
        assert got.dtype == dt and got.shape == want.shape
        scale = float(want.float().abs().max())
        tol = (1e-5 if dt == torch.float32 else BF16_TOL) * scale
        assert float((got.float() - want.float()).abs().max()) <= tol, case[0]


@pytest.mark.cuda
def test_launch_counts_list_every_kernel(cuda):
    assert tbsr.bsr_spmm_pallas in ops.KERNEL_WRAPPERS
    a = _block_sparse(64, 64, 16, 0.5, 0)
    tb = tbsr.bsr_from_dense(a, block_size=16, device=cuda)
    ops.reset_launch_counts()
    tb.multiply(torch.ones((64, 8), device=cuda), backend="pallas")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert set(counts) == {
        "pallas_matmul", "masked_fill", "paged_decode_attention",
        "flash_attention_panel", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq", "bsr_spmm_pallas"}
    assert counts["bsr_spmm_pallas"] == 1
