"""The tensor-core instance of the BSR SpMM kernel (``csrc/bsr_spmm.cu``).

On the CPU: a torch emulation of the instance's schedule for f32 — B through
the GEMM's pre-pass (TF32 halves, ``hi = tf32_rna(x)``, ``lo = tf32_rna(x -
hi)``, as ``tests/test_torch_gemm.py`` checks bit for bit), each block's A
slice split into the same halves as the consumers split it in registers,
three TF32 products a k slice in the kernel's order (lo.hi, hi.lo, hi.hi),
summed in a fresh accumulator that is added into the f32 one every kFlush
stages. It is held against f64 and against the JAX package's chunked
``bsr_spmm`` (its Pallas kernel cannot run on this tree) at small sizes,
within the card checks' bound: 1e-5 of max |ref| plus 1e-5 of |ref| per
element (``chip_smoke.py``: ``BSR_F32_ATOL``, ``BSR_F32_RTOL``). One TF32
product alone misses that bound, so the test tells the three-pass sum from a
one-pass one. And the rule that picks the instance by block size.

The ``cuda``-marked tests hold the kernel against its plain version on the
card and skip where there is none: f32 per element within the bound above,
bf16 within two bf16 ulps of the element plus 1e-5 of max |plain|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marlin_tpu.ops import sparse_bsr as jbsr
from marlin_tpu_torch import config_context
from marlin_tpu_torch.ops import sparse_bsr as tbsr

ATOL, RTOL = 1e-5, 1e-5     # BSR_F32_ATOL * max|ref| + BSR_F32_RTOL * |ref|
BF16_ATOL = 1e-5            # BSR_BF16_ATOL
K_STAGE, K_FLUSH = 32, 4    # csrc/bsr_spmm.cu TcCfg<float>: kK, kFlush


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The kernel's rounding of f32 to TF32 (tests/test_torch_gemm.py)."""
    bits = ((x.view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulate_tc(bsr: "tbsr.BsrMatrix", b: torch.Tensor, passes: int = 3):
    """The f32 instance's arithmetic: per block row, per stored block, per
    32-value k stage, per 8-value slice, ``passes`` TF32 products (3: lo.hi,
    hi.lo, hi.hi; 1: hi.hi) into an accumulator restarted every K_FLUSH
    stages and added into the f32 one."""
    m, n = bsr.shape
    bs, p = bsr.block_size, b.shape[1]
    nbr, nbc = -(-m // bs), -(-n // bs)
    bp = torch.zeros((nbc * bs, p))
    bp[:n] = b
    b_hi, b_lo = split(bp)
    out = torch.zeros((nbr * bs, p))
    rows = bsr.block_rows.tolist()
    for r in range(nbr):
        acc = torch.zeros((bs, p))
        d, stage = None, 0
        for blk in [i for i, br in enumerate(rows) if br == r]:
            c = int(bsr.block_cols[blk])
            for k0 in range(0, bs, K_STAGE):
                a_hi, a_lo = split(bsr.blocks[blk, :, k0:k0 + K_STAGE].float())
                kb = c * bs + k0
                for j in range(0, K_STAGE, 8):
                    ah, al = a_hi[:, j:j + 8], a_lo[:, j:j + 8]
                    bh, bl = b_hi[kb + j:kb + j + 8], b_lo[kb + j:kb + j + 8]
                    terms = ([al @ bh, ah @ bl] if passes == 3 else []) \
                        + [ah @ bh]
                    for t in terms:
                        d = t if d is None else d + t
                stage += 1
                if stage % K_FLUSH == 0:
                    acc, d = acc + d, None
        if d is not None:
            acc = acc + d
        out[r * bs:(r + 1) * bs] = acc
    return out[:m]


def _block_sparse(rng, m, n, bs, keep, empty_rows=(), hot_col=None):
    nbr, nbc = -(-m // bs), -(-n // bs)
    mask = rng.random((nbr, nbc)) < keep
    if hot_col is not None:
        mask[:, hot_col] = True
    mask[list(empty_rows)] = False
    full = rng.standard_normal((nbr * bs, nbc * bs)).astype(np.float32)
    grid = full.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    grid[~mask] = 0.0
    return grid.transpose(0, 2, 1, 3).reshape(full.shape)[:m, :n].copy()


EMU_CASES = [  # (label, m, n, p, bs, keep, empty block rows, hot column)
    ("bs=64 ragged", 64 * 3 + 5, 64 * 4 + 3, 37, 64, 0.5, (1,), 2),
    ("bs=128 long rows", 128 * 2, 128 * 6, 24, 128, 0.9, (), None),
    ("bs=128 ragged, empty row", 128 * 2 + 50, 128 * 3 + 1, 19, 128, 0.6,
     (0,), 1),
]


def _emu_case(label, m, n, p, bs, keep, empty, hot):
    rng = np.random.default_rng(sum(map(ord, label)))
    a = _block_sparse(rng, m, n, bs, keep, empty, hot)
    b = rng.standard_normal((n, p)).astype(np.float32)
    return a, b


def _within(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bound = ATOL * np.abs(ref).max() + RTOL * np.abs(ref)
    return float((np.abs(got - ref) / bound).max())


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_emulated_3xtf32_matches_f64_and_jax_chunked(case):
    a, b = _emu_case(*case)
    bs = case[4]
    tb = tbsr.bsr_from_dense(a, block_size=bs)
    got = emulate_tc(tb, torch.from_numpy(b)).numpy()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    jb = jbsr.bsr_from_dense(a, block_size=bs)
    jax_chunked = np.asarray(jbsr.bsr_spmm(jb, jnp.asarray(b)))
    assert got.shape == ref.shape
    assert _within(got, ref) <= 1.0
    assert _within(got, jax_chunked) <= 1.0
    # the plain version, which the card checks hold the kernel against
    plain = tbsr.bsr_spmm_pallas_plain(tb, torch.from_numpy(b)).numpy()
    assert _within(got, plain) <= 1.0


def test_one_tf32_pass_misses_the_bound():
    """The bound tells 3xTF32 from one TF32 product: a single pass errs by
    about 2^-11 relative, two orders above it."""
    a, b = _emu_case(*EMU_CASES[1])
    tb = tbsr.bsr_from_dense(a, block_size=128)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert _within(emulate_tc(tb, torch.from_numpy(b), passes=1).numpy(),
                   ref) > 10.0


@pytest.mark.parametrize("bs,p,nbr,sms,itemsize,want", [
    (128, 256, 256, 132, 2, (128, 128)),   # config_bsr in bf16: 512 tiles
    (128, 256, 256, 132, 4, (128, 64)),    # f32 at 128 rows: 64 columns
    (128, 256, 64, 132, 2, (128, 64)),     # 8192²: 128 tiles of 128 < 132
    (128, 69, 6, 132, 2, (128, 64)),
    (64, 259, 10, 132, 4, (64, 64)),
    (64, 1024, 200, 132, 4, (64, 128)),
    (192, 512, 100, 132, 4, (64, 128)),    # 192 = 3 x 64 rows
    (256, 40, 1000, 132, 2, (128, 64)),    # p within 64 columns
    (32, 256, 1000, 132, 4, None),         # the CUDA-core instance
    (8, 5, 65538, 132, 2, None),
    (100, 256, 1000, 132, 4, None),
])
def test_bsr_tile_picks_the_instance_by_block_size(bs, p, nbr, sms, itemsize,
                                                   want):
    assert tbsr.bsr_tile(bs, p, nbr, sms, itemsize) == want


# ------------------------------------------------------------- on the card


CARD_CASES = [  # (label, m, n, p, bs, keep, empty block rows, hot column)
    ("bs=8 ragged", 8 * 37 + 5, 8 * 21 + 3, 77, 8, 0.3, (2, 5), 3),
    ("bs=32 ragged", 32 * 13 + 7, 32 * 9 + 31, 129, 32, 0.3, (0,), 0),
    ("bs=64 ragged", 64 * 9 + 1, 64 * 7 + 5, 259, 64, 0.4, (4,), 2),
    ("bs=128 ragged", 128 * 5 + 100, 128 * 6 + 1, 69, 128, 0.5, (1,), 5),
    ("bs=128 p=256", 128 * 8, 128 * 8, 256, 128, 0.3, (3,), 0),
    ("bs=192", 192 * 4 + 7, 192 * 3, 130, 192, 0.5, (), 1),
    ("bs=64, 65538 block rows", 65537 * 64 + 13, 64, 5, 64, 5e-4, (), None),
    ("8192^2 nnzb 204", 8192, 8192, 256, 128, 0.05, (), None),
]


def _card_bsr(dev, dtype, label, m, n, p, bs, keep, empty, hot):
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(map(ord, label)))
    nbr, nbc = -(-m // bs), -(-n // bs)
    mask = torch.rand((nbr, nbc), generator=gen, device=dev) < keep
    if hot is not None:
        mask[:, hot] = True
    mask[list(empty)] = False
    rows, cols = mask.nonzero(as_tuple=True)
    blocks = torch.randn((len(rows), bs, bs), generator=gen,
                         device=dev).to(dtype)
    b = torch.randn((n, p), generator=gen, device=dev).to(dtype)
    return tbsr.BsrMatrix(blocks, rows.int(), cols.int(), (m, n), bs), b


def _card_close(got, want, dtype):
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    scale = float(want.abs().max())
    if dtype == torch.float32:
        bound = ATOL * scale + RTOL * want.abs()
    else:
        _, e = torch.frexp(want)
        bound = torch.where(want != 0, torch.exp2((e - 7).double()), 0.0) \
            + BF16_ATOL * scale
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= bound).all()), float((diff / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_cuda_kernel_matches_plain_every_instance(cuda, dtype, case):
    bsr, b = _card_bsr(cuda, dtype, *case)
    before = tbsr.bsr_spmm_pallas.launches
    got = tbsr.bsr_spmm_pallas(bsr, b)
    want = tbsr.bsr_spmm_pallas_plain(bsr, b)
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm_pallas.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    _card_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_runs_are_bit_identical(cuda, dtype):
    for case in (CARD_CASES[3], CARD_CASES[7]):
        bsr, b = _card_bsr(cuda, dtype, *case)
        assert torch.equal(tbsr.bsr_spmm_pallas(bsr, b),
                           tbsr.bsr_spmm_pallas(bsr, b))
