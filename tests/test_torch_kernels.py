"""Kernel layer of marlin_tpu_torch against the JAX package's Pallas kernels.

The same numpy inputs (made from a seed) go through the JAX kernels, run in
interpret mode on the CPU as tests/test_pallas.py runs them, and through the
port's wrappers, which on CPU tensors run their plain PyTorch versions.

Tolerances: f32 rtol/atol 1e-4, as in tests/test_pallas.py. bf16 rtol/atol
2^-7 (= 7.8e-3): both sides accumulate in f32 and round once to bf16, so they
may differ by a rounding step of the output. ``masked_fill`` is bit-exact.

The ``cuda``-marked tests hold the CUDA kernels against the plain versions on
the card and skip where there is none.
"""

import ctypes
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marlin_tpu.ops.local import gemm as jax_gemm
from marlin_tpu.ops.pallas_kernels import masked_fill as jax_masked_fill
from marlin_tpu.ops.pallas_kernels import pallas_matmul as jax_pallas_matmul
from marlin_tpu_torch import ops
from marlin_tpu_torch.ops import _build
from marlin_tpu_torch.ops import pallas_kernels as pk
from marlin_tpu_torch.ops.local import gemm
from marlin_tpu_torch.ops.tile_family import BK_AXIS, BM_AXIS, BN_AXIS

F32_TOL = 1e-4
BF16_TOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _operands(seed, m, k, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32).astype(dtype)
    b = rng.standard_normal((k, n)).astype(np.float32).astype(dtype)
    return a, b


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


# (m, k, n, tile): the shapes of tests/test_pallas.py, then problems smaller
# than the tile (the clamp of tile_family._clamp), and ragged multi-tile ones
MATMUL_CASES = [
    (130, 70, 50, (64, 128, 128)),
    (64, 300, 64, (64, 128, 128)),
    (32, 48, 16, (256, 256, 512)),
    (16, 64, 64, (128, 128, 128)),
    (8, 8, 8, (128, 128, 128)),
    (1, 129, 3, (256, 256, 512)),
    (200, 160, 260, (128, 128, 256)),
    (257, 300, 199, (128, 256, 128)),
]


@pytest.mark.parametrize("m,k,n,tile", MATMUL_CASES)
def test_pallas_matmul_matches_jax_f32(m, k, n, tile):
    a, b = _operands(m + k + n, m, k, n)
    want = np.asarray(jax_pallas_matmul(jnp.asarray(a), jnp.asarray(b), *tile))
    got = pk.pallas_matmul(_t(a), _t(b), *tile)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("m,k,n,tile", [MATMUL_CASES[0], MATMUL_CASES[1],
                                        MATMUL_CASES[7]])
def test_pallas_matmul_matches_jax_bf16(m, k, n, tile):
    a, b = _operands(m * k, m, k, n, ml_dtypes.bfloat16)
    want = np.asarray(jax_pallas_matmul(jnp.asarray(a), jnp.asarray(b), *tile))
    got = pk.pallas_matmul(_t(a), _t(b), *tile)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_every_instantiated_tile_matches_jax():
    """Each tile the CUDA library is built for computes the same product on
    the CPU path (the plain version pads to that tile's grid)."""
    a, b = _operands(5, 150, 90, 140)
    want = np.asarray(jax_gemm(jnp.asarray(a), jnp.asarray(b)))
    for bm in BM_AXIS:
        for bn in BN_AXIS:
            for bk in BK_AXIS:
                got = pk.pallas_matmul(_t(a), _t(b), bm, bn, bk).numpy()
                np.testing.assert_allclose(got, want, rtol=F32_TOL,
                                           atol=F32_TOL)


def test_gemm_backends_match_jax():
    a, b = _operands(2, 32, 48, 16)
    want = np.asarray(jax_gemm(jnp.asarray(a), jnp.asarray(b)))
    for backend in ("xla", "pallas"):
        got = gemm(_t(a), _t(b), backend=backend).numpy()
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape,rows,cols", [
    ((16, 16), 10, 3),
    ((37, 29), 37, 29),
    ((37, 29), 0, 5),
    ((33, 40), 50, 17),
    ((8, 130), 7, 128),
])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_masked_fill_bit_exact_vs_jax(shape, rows, cols, dtype):
    rng = np.random.default_rng(shape[0] * shape[1])
    x = rng.standard_normal(shape).astype(np.float32).astype(dtype)
    x[0, 0] = -0.0  # a signed zero inside the region keeps its sign bit
    want = np.asarray(jax_masked_fill(jnp.asarray(x), rows, cols))
    got = pk.masked_fill(_t(x), rows, cols)
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(got.view(torch.int16 if dtype != np.float32
                                           else torch.int32).numpy(),
                                  want.view(np.int16 if dtype != np.float32
                                            else np.int32))


def test_matmul_error_cases_match_jax():
    with pytest.raises(ValueError):
        jax_pallas_matmul(jnp.ones((4, 5)), jnp.ones((6, 7)))
    with pytest.raises(ValueError, match="inner dimensions mismatch"):
        pk.pallas_matmul(torch.ones(4, 5), torch.ones(6, 7))
    with pytest.raises(ValueError, match="inner dimensions mismatch"):
        gemm(torch.ones(4, 5), torch.ones(6, 7), backend="pallas")
    with pytest.raises(ValueError):
        jax_gemm(jnp.ones((4, 4)), jnp.ones((4, 4)), precision="highest",
                 backend="pallas")
    with pytest.raises(ValueError, match="precision"):
        gemm(torch.ones(4, 4), torch.ones(4, 4), precision="highest",
             backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        gemm(torch.ones(4, 4), torch.ones(4, 4), backend="cublas")
    with pytest.raises(TypeError):
        pk.pallas_matmul(torch.ones(4, 4), torch.ones(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        pk.masked_fill(torch.ones(4), 2, 2)


def test_unsupported_device_raises_instead_of_falling_back():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.pallas_matmul(a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        pk.masked_fill(a, 2, 2)


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    pk.pallas_matmul(torch.ones(8, 8), torch.ones(8, 8))
    pk.masked_fill(torch.ones(8, 8), 4, 4)
    assert ops.launch_counts() == {
        "pallas_matmul": 0, "masked_fill": 0, "paged_decode_attention": 0,
        "flash_attention_panel": 0, "flash_attention_bwd_dkv": 0,
        "flash_attention_bwd_dq": 0, "bsr_spmm_pallas": 0}


def test_ctypes_binding_passes_pointers_as_void_p():
    """A pointer or stream left to ctypes' default int conversion is cut to
    32 bits; every one must be declared c_void_p."""
    lib = types.SimpleNamespace(**{f: types.SimpleNamespace() for f in (
        "marlin_gemm_prep", "marlin_gemm", "marlin_masked_fill",
        "marlin_paged_attention", "marlin_flash_fwd", "marlin_flash_bwd_dkv",
        "marlin_flash_bwd_dq", "marlin_bsr_spmm", "marlin_bsr_spmm_tc",
        "marlin_error_string")})
    _build._bind(lib)
    g = lib.marlin_gemm.argtypes
    assert g[4:7] == [ctypes.c_void_p] * 3 and g[-2:] == [ctypes.c_void_p] * 2
    assert g[7:11] == [ctypes.c_longlong] * 4 and len(g) == 13
    g = lib.marlin_gemm_prep.argtypes
    assert g[0] is ctypes.c_int and g[1:5] == [ctypes.c_void_p] * 4
    assert g[5:9] == [ctypes.c_longlong] * 4 and g[-1] is ctypes.c_void_p
    f = lib.marlin_masked_fill.argtypes
    assert f[:2] == [ctypes.c_void_p] * 2 and f[-1] is ctypes.c_void_p
    p = lib.marlin_paged_attention.argtypes
    assert p[1:8] == [ctypes.c_void_p] * 7 and p[-1] is ctypes.c_void_p
    assert p[8:19] == [ctypes.c_int] * 11 and len(p) == 21
    assert p[-2] is ctypes.c_float
    fl = lib.marlin_flash_fwd.argtypes
    assert fl[1:10] == [ctypes.c_void_p] * 9 and fl[-1] is ctypes.c_void_p
    assert fl[14:20] == [ctypes.c_longlong] * 6 and fl[-2] is ctypes.c_float
    for fn, n_ptr in (("marlin_flash_bwd_dkv", 8), ("marlin_flash_bwd_dq", 7)):
        b = getattr(lib, fn).argtypes
        assert b[0] is ctypes.c_int and b[-1] is ctypes.c_void_p
        assert b[1:1 + n_ptr] == [ctypes.c_void_p] * n_ptr
        assert b[5 + n_ptr:13 + n_ptr] == [ctypes.c_longlong] * 8
        assert b[-2] is ctypes.c_float and len(b) == n_ptr + 19
    s = lib.marlin_bsr_spmm.argtypes
    assert s[0] is ctypes.c_int and s[1:6] == [ctypes.c_void_p] * 5
    assert s[6:9] == [ctypes.c_longlong] * 3 and s[9] is ctypes.c_int
    assert s[10] is ctypes.c_longlong and s[-1] is ctypes.c_void_p
    t = lib.marlin_bsr_spmm_tc.argtypes
    assert t[:3] == [ctypes.c_int] * 3 and t[3:8] == [ctypes.c_void_p] * 5
    assert t[8:11] == [ctypes.c_longlong] * 3 and t[11] is ctypes.c_int
    assert t[12:14] == [ctypes.c_longlong] * 2 and t[-1] is ctypes.c_void_p
    for fn in ("marlin_gemm_prep", "marlin_gemm", "marlin_masked_fill",
               "marlin_paged_attention", "marlin_flash_fwd",
               "marlin_flash_bwd_dkv", "marlin_flash_bwd_dq",
               "marlin_bsr_spmm", "marlin_bsr_spmm_tc"):
        assert getattr(lib, fn).restype is ctypes.c_int


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library()


def test_build_dir_is_keyed_by_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert {p.name for p in _build._sources()} == {
        "gemm.cu", "masked_fill.cu", "paged_attention.cu", "flash_attention.cu",
        "flash_attention_wide.cu", "flash_attention_bwd.cu", "bsr_spmm.cu"}
    assert d == _build.build_dir()


def test_build_dir_is_keyed_by_headers(monkeypatch, tmp_path):
    """An edited ``*.cuh`` header moves the build directory, as an edited
    source does, so the kernels that include it rebuild."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    before = _build.build_dir()
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert _build.build_dir() != before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    for m, k, n, tile in MATMUL_CASES:
        a = torch.randn((m, k), generator=gen, device=cuda).to(dt)
        b = torch.randn((k, n), generator=gen, device=cuda).to(dt)
        before = pk.pallas_matmul.launches
        got = pk.pallas_matmul(a, b, *tile)
        want = pk.pallas_matmul_plain(a, b, *tile)
        torch.cuda.synchronize()
        assert pk.pallas_matmul.launches == before + 1
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
    x = torch.randn((301, 517), generator=gen, device=cuda).to(dt)
    for rows, cols in ((300, 516), (0, 3), (400, 600)):
        got = pk.masked_fill(x, rows, cols)
        want = pk.masked_fill_plain(x, rows, cols)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32))
