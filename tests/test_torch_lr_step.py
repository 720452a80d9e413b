"""The fused logistic-gradient step of marlin_tpu_torch
(``ops/lr_gradient.py``, kernel ``csrc/lr_gradient.cuh``) on the CPU.

Its plain version, ``lr_step_plain``, steps on the stored rows of (label,
features) in place, the label column standing for the intercept; here it
is held against steps of the JAX package's ``_lr_fori`` on the copy with
the intercept in place of the label (1e-6 of max |w|: both sum in float32,
in other orders). The wrapper refuses what the kernel does not take, a
CPU tensor among them; on the CPU ``logistic_regression`` keeps its plain
loop (in float32 for bfloat16 rows). The kernel's cut of the rows
(``lr_plan``) is checked against what the kernel accepts, and its library
is built apart from the other kernels. The kernel itself runs in
``test_torch_lr_kernel.py``, on the card.
"""

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marlin_tpu_torch as tm
from marlin_tpu_torch import ops
from marlin_tpu_torch.ops import _build
from marlin_tpu_torch.ops import lr_gradient as lg

jlr = importlib.import_module("marlin_tpu.ml.logistic_regression")
tlr = importlib.import_module("marlin_tpu_torch.ml.logistic_regression")

STEP_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


def _rows(m, d, seed=0):
    """(label, features) rows whose labels follow a linear rule."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    y = (x @ rng.standard_normal(d) > 0).astype(np.float32)
    return np.concatenate([y[:, None], x], axis=1)


def _jax_steps(data, step_size, iters):
    m = data.shape[0]
    feats = np.concatenate([np.ones((m, 1), np.float32), data[:, 1:]], 1)
    return np.asarray(jlr._lr_fori(jnp.asarray(feats), jnp.asarray(data[:, 0]),
                                   jnp.float32(step_size), iters))


def _plain_steps(data, step_size, iters, valid_rows=None):
    arr = torch.from_numpy(data)
    m = arr.shape[0] if valid_rows is None else valid_rows
    scales = tlr._step_sizes(step_size, m, iters, torch.float32, "cpu")
    w = torch.zeros(arr.shape[1])
    for it in range(iters):
        w = lg.lr_step_plain(arr, w, scales[it:it + 1], m)
    return w.numpy()


@pytest.mark.parametrize("d", [1, 20, 512])
@pytest.mark.parametrize("iters", [1, 3])
def test_plain_step_matches_jax_fori(d, iters):
    data = _rows(300, d, seed=d)
    want = _jax_steps(data, 1.0, iters)
    got = _plain_steps(data, 1.0, iters)
    assert got.shape == (d + 1,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STEP_TOL * np.abs(want).max())


def test_valid_rows_leave_the_rest_out():
    """Rows at or past ``valid_rows`` contribute nothing, whatever they
    hold: the steps equal JAX's on the valid rows alone."""
    data = _rows(300, 20, seed=3)
    junk = data.copy()
    junk[200:] = np.float32(1e30)
    want = _jax_steps(data[:200], 0.5, 3)
    got = _plain_steps(junk, 0.5, 3, valid_rows=200)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STEP_TOL * np.abs(want).max())
    w = torch.ones(21)
    none = lg.lr_step_plain(torch.from_numpy(junk), w, torch.ones(1), 0)
    assert torch.equal(none, w)


def test_wrapper_on_cpu_is_the_plain_step():
    """On the CPU the step is ``lr_step_plain``, reduce hook included:
    ``lr_step`` is the card's alone and refuses a CPU tensor, launching
    nothing."""
    arr = torch.from_numpy(_rows(100, 7, seed=5))
    w = torch.linspace(-0.5, 0.5, 8)
    scale = torch.tensor([0.01])
    ops.reset_launch_counts()
    got = lg.lr_step_plain(arr, w, scale, 60)
    doubled = lg.lr_step_plain(arr, w, scale, 60, reduce=lambda g: 2 * g)
    torch.testing.assert_close(doubled, 2 * got - w, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="device cpu"):
        lg.lr_step(arr, w, scale, 60)
    assert ops.launch_counts()["lr_step"] == 0


def _refusal(t):
    return lg.lr_step_refusal(t) or ""


def test_refusals():
    """What the kernel does not take, each for its own reason; the device
    is the last check, so a CPU tensor of the kernel's layout (float32,
    bfloat16 or float64, up to the widest row) is refused for its device
    alone."""
    base = torch.zeros((6, 9))
    assert "device cpu" in _refusal(base)
    assert "device cpu" in _refusal(torch.zeros((64, 16))[:, :9])  # padded
    assert "device cpu" in _refusal(base.double())
    assert "device cpu" in _refusal(base.bfloat16())
    assert "device cpu" in _refusal(torch.zeros((2, lg.MAX_COLS)))
    assert "device cpu" in _refusal(torch.zeros((2, 4348), dtype=torch.float64))
    assert "float32, bfloat16 and float64" in _refusal(base.half())
    assert "float32, bfloat16 and float64" in _refusal(base.long())
    assert "column stride" in _refusal(torch.zeros((9, 6)).T)
    assert "row stride" in _refusal(torch.zeros((1, 9)).expand(6, 9))
    assert "2-D" in _refusal(torch.zeros(9))
    assert "columns" in _refusal(torch.zeros((2, lg.MAX_COLS + 1)))
    assert "columns" in _refusal(torch.zeros((2, 4349), dtype=torch.float64))
    assert "columns" in _refusal(torch.zeros((2, 0)))
    meta = torch.empty((6, 9), device="meta")
    assert "device meta" in _refusal(meta)
    with pytest.raises(ValueError, match="device meta"):
        lg.lr_step(meta, torch.empty(9, device="meta"),
                   torch.empty(1, device="meta"), 6)


@pytest.mark.parametrize("layout",
                         ["contiguous", "float64", "strided", "bfloat16"])
def test_fit_keeps_the_plain_loop_off_the_kernel(layout):
    """On the CPU the fit runs the plain loop, whatever the layout, and
    equals the JAX package's (bfloat16 rows in float32, against the JAX
    package's float32 fit of the same values); no kernel launches."""
    data = _rows(200, 9, seed=11)
    arr = torch.from_numpy(data)
    if layout == "float64":
        arr = arr.double()
    elif layout == "strided":
        arr = torch.from_numpy(np.asfortranarray(data))
        assert arr.stride(1) != 1
    elif layout == "bfloat16":
        arr = arr.bfloat16()
        data = arr.float().numpy()
    want = jlr.logistic_regression(data, step_size=0.5, iterations=20)
    ops.reset_launch_counts()
    got = tm.ml.logistic_regression(arr, step_size=0.5, iterations=20)
    assert ops.launch_counts()["lr_step"] == 0
    np.testing.assert_allclose(got.weights, want.weights, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_plan_is_what_the_kernel_accepts(dtype):
    """The plan meets ``marlin_lr_grad``'s checks: a slab's aligned byte
    range fits a stage, a chunk is whole slabs, the chunks cover the rows;
    where a warp takes a row, slabs are a multiple of the warps where a
    stage holds that many rows and a chunk about RUN_ROWS a warp, and where
    the block splits the columns, a chunk is about RUN_ROWS."""
    size = torch.empty((), dtype=dtype).element_size()
    widest = lg.max_cols(dtype)
    for n in (1, 2, 21, 513, 1024, 1025, 4000, widest):
        wide = n > (512 if dtype == torch.float64 else 1024)
        for stride in (n, n + 3, n + 700, 12_000):
            stride = max(stride, n)
            for rows in (0, 1, 2047, 10_000_000):
                slab, chunk, chunks = lg.lr_plan(rows, n, stride, dtype)
                assert slab >= 1 and chunk % slab == 0
                assert ((slab - 1) * stride * size + n * size + 32
                        <= lg.STAGE_BYTES)
                assert chunks == -(-rows // chunk)
                run = lg.RUN_ROWS * (1 if wide else lg.WARPS)
                assert chunk < run + slab
                fit = (lg.STAGE_BYTES - 32 - size * n) // (size * stride) + 1
                if not wide and fit >= lg.WARPS:
                    assert slab % lg.WARPS == 0


def test_main_shape_plan():
    """10^7 rows of 513 floats: 16-row slabs (32,832 bytes a stage), 2048-row
    chunks, 4883 partial rows of the gradient (10.0 MB) an iteration."""
    assert lg.lr_plan(10_000_000, 513, 513) == (16, 2048, 4883)


def test_wide_rows_plan():
    """Rows past a warp's 32 columns a lane (1024 float32, 512 float64): the
    block splits the columns, and a chunk is 256 rows of whole slabs."""
    assert lg.lr_plan(10_000_000, 2048, 2048) == (4, 256, 39063)
    assert lg.lr_plan(1000, 513, 513, torch.float64) == (8, 256, 4)
    assert lg.lr_plan(1000, 512, 512, torch.float64) == (8, 2048, 1)
    assert lg.lr_plan(1000, 8192, 8192, torch.bfloat16) == (2, 256, 4)


def test_step_dtype_and_widest_rows():
    """The weights and the arithmetic are float64 for float64 rows, float32
    for float32 and bfloat16; the widest row is 8192 columns, or what a
    stage holds."""
    assert lg.step_dtype(torch.float64) == torch.float64
    assert lg.step_dtype(torch.float32) == torch.float32
    assert lg.step_dtype(torch.bfloat16) == torch.float32
    assert lg.max_cols(torch.float32) == lg.MAX_COLS == 8192
    assert lg.max_cols(torch.bfloat16) == 8192
    assert lg.max_cols(torch.float64) == (lg.STAGE_BYTES - 32) // 8 == 4348


def test_lr_library_is_built_apart():
    """The lr kernel is a library of its own: its sources alone (one a
    dtype, which compile at once), its own build directory; the other
    kernels' library leaves them out."""
    assert [p.name for p in _build._sources("lr")] == [
        "lr_gradient.cu", "lr_gradient_bf16.cu", "lr_gradient_f64.cu"]
    assert not {p.name for p in _build._sources()} & set(_build.LR_SOURCES)
    assert _build.build_dir("lr") != _build.build_dir()
    assert _build.build_dir("lr").parent == _build.BUILD_ROOT
    assert _build.LIB_NAMES["lr"] != _build.LIB_NAMES["kernels"]
    with pytest.raises(ValueError, match="no kernel library"):
        _build._sources("gemm")


def test_lr_binding_passes_pointers_as_void_p():
    """The lr library's entry points take the dtype code, pointers as
    c_void_p (never cut to 32-bit ints) and sizes as long long."""
    lib = type("Lib", (), {fn: type("Fn", (), {})() for fn in (
        "marlin_lr_grad", "marlin_lr_reduce", "marlin_error_string")})
    _build._bind_lr(lib)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert lib.marlin_lr_grad.argtypes == [i, p, ll, ll, ll, p, p, i, ll, ll,
                                           i, p]
    assert lib.marlin_lr_reduce.argtypes == [i, p, ll, ll, p, p, p, p]
    assert lib.marlin_lr_grad.restype is i
    assert lib.marlin_lr_reduce.restype is i
    assert lib.marlin_error_string.restype is ctypes.c_char_p
