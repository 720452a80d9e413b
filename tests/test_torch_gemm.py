"""The tensor-core GEMM of marlin_tpu_torch (``csrc/gemm.cu``).

On the CPU: a torch mirror of the kernel's arithmetic. Its pre-pass splits
every f32 operand into TF32 halves, ``hi = tf32_rna(x)`` and ``lo =
tf32_rna(x - hi)`` (``tensor_core.cuh``: add half of the last kept bit to the
pattern, clear the 13 low bits), stored side by side in blocks of 16 values
of k, and the main loop sums the three products ``lo.hi + hi.lo + hi.hi``
(3xTF32). The tests check the rounding bit for bit
against an independent rounding to 10 mantissa bits, and that the three
products reach f32 accuracy over a long k where one TF32 product does not.

The ``cuda``-marked tests hold the kernel against its plain version and f64
on the card and skip where there is none. Tolerances as in
``tests/test_torch_kernels.py``: f32 1e-4 of max |plain|, bf16 2^-7 (both
sides accumulate in f32 and round once to bf16); against f64, 1e-4 of
max |ref|, the dense multiply's bound.
"""

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import pallas_kernels as pk
from marlin_tpu_torch.ops.tile_family import BK_AXIS, BM_AXIS, BN_AXIS

F32_TOL = 1e-4
BF16_TOL = 2.0 ** -7
F64_TOL = 1e-4
TILES = [(bm, bn, bk) for bm in BM_AXIS for bn in BN_AXIS for bk in BK_AXIS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The kernel's rounding of f32 to TF32, by the same integer operations
    on the bit pattern (taken modulo 2^32 in int64)."""
    bits = ((x.view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass's halves of an f32 tensor."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _round_10_bits_away(x: np.ndarray) -> np.ndarray:
    """Round f32 values to 10 mantissa bits, ties away from zero, in f64
    arithmetic (exact for these magnitudes): an independent oracle."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)  # |x| = f * 2^e, f in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)  # 11 significant bits: 1 implicit + 10
    r = np.copysign(np.floor(np.abs(x64) / ulp + 0.5) * ulp, x64)
    return r.astype(np.float32)


def test_tf32_rna_rounds_to_10_bits_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.integers(-6, 6, 200_000)
         ).astype(np.float32)
    # exact ties: 11 significant bits and a half, both signs
    ties = ((rng.integers(1 << 10, 1 << 11, 1000) * 2 + 1).astype(np.float64)
            * 2.0 ** rng.integers(-20, 20, 1000)).astype(np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, -1.5, 65504.0]]
                       ).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    want = _round_10_bits_away(x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a tie rounds away from zero, not to even
    t = np.float32(1.0 + 2.0 ** -11)
    assert tf32_rna(torch.tensor([t, -t])).tolist() == [1.0 + 2.0 ** -10,
                                                        -(1.0 + 2.0 ** -10)]


def test_split_halves_are_tf32_and_sum_to_x():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    hi, lo = split(x)
    for h in (hi, lo):
        assert int((h.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # what is dropped is lo's rounding: about 2^-22 of |x|
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def test_three_tf32_products_reach_f32_accuracy_over_long_k():
    """hi.hi + hi.lo + lo.hi, summed in f64 over k = 20000 for an 8 x 8
    output, lies within 1e-5 of max |ref| of the f64 product; one TF32
    product (hi.hi) does not."""
    rng = np.random.default_rng(2)
    k = 20000
    a = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 8)).astype(np.float32))
    ref = a.double() @ b.double()
    (ah, al), (bh, bl) = split(a), split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    three = al @ bh + ah @ bl + ah @ bh
    one = ah @ bh
    scale = float(ref.abs().max())
    assert float((three - ref).abs().max()) <= 1e-5 * scale
    assert float((one - ref).abs().max()) > 1e-5 * scale


def pack(x: torch.Tensor, ks: int) -> torch.Tensor:
    """The pre-pass's f32 rows: x (rows, k) zero-padded to ks values, each
    block of 16 values as its 16 hi halves then its 16 lo halves."""
    x = torch.nn.functional.pad(x, (0, ks - x.shape[1]))
    hi, lo = split(x)
    return torch.stack([hi.view(-1, ks // 16, 16), lo.view(-1, ks // 16, 16)],
                       dim=2).reshape(x.shape[0], 2 * ks)


def test_k_stride_pads_rows():
    # f32: whole blocks of 16 values; bf16: 16 bytes, TMA's stride step
    assert [pk._k_stride(k, 4) for k in (1, 16, 17, 129, 20000)] == \
        [16, 16, 32, 144, 20000]
    assert [pk._k_stride(k, 2) for k in (1, 8, 9, 129)] == [8, 8, 16, 136]


def test_pack_keeps_each_blocks_halves_side_by_side():
    x = torch.arange(1, 40, dtype=torch.float32).view(1, 39) + 1e-3
    p = pack(x, 48)
    hi, lo = split(x)
    assert p.shape == (1, 96)
    assert torch.equal(p[0, :16], hi[0, :16])
    assert torch.equal(p[0, 16:32], lo[0, :16])
    assert torch.equal(p[0, 64:71], hi[0, 32:39])
    assert not p[0, 71:80].any() and not p[0, 87:].any()


# --------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_tile_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    for tile in TILES:
        for m, k, n in ((257, 300, 199), (130, 70, 50), (300, 1000, 400)):
            a = torch.randn((m, k), generator=gen, device=cuda).to(dt)
            b = torch.randn((k, n), generator=gen, device=cuda).to(dt)
            got = pk.pallas_matmul(a, b, *tile)
            want = pk.pallas_matmul_plain(a, b, *tile)
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == (m, n)
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            assert err <= tol * scale, (tile, m, k, n, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
def test_long_k_against_f64(cuda, tile):
    """256 x 65536 x 256: a long k in one tensor-core accumulator would drift
    (its sums are not rounded to nearest); the kernel restarts it every few
    stages."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    a = torch.randn((256, 65536), generator=gen, device=cuda)
    b = torch.randn((65536, 256), generator=gen, device=cuda)
    ref = a.double() @ b.double()
    got = pk.pallas_matmul(a, b, *tile)
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    assert rel <= F64_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 129, 3), (3, 129, 1), (70, 5, 3),
                                   (129, 33, 127)])
def test_unaligned_strides(cuda, dtype, m, k, n):
    """Rows whose bytes are no multiple of 16: the pre-pass pads them."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dt)
    b = torch.randn((k, n), generator=gen, device=cuda).to(dt)
    got = pk.pallas_matmul(a, b)
    want = pk.pallas_matmul_plain(a, b)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_prepass_matches_the_mirror(cuda):
    """The pre-pass's rows are the torch mirror's, bit for bit, padding
    included; bf16 only transposes B (and pads it)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    a = torch.randn((37, 131), generator=gen, device=cuda)
    b = torch.randn((131, 29), generator=gen, device=cuda)
    ks, a_k, bt_k = pk.gemm_prepare(a, b)
    torch.cuda.synchronize()
    assert ks == 144 and a_k.shape == (37, 288) and bt_k.shape == (29, 288)
    for got, x in ((a_k, a), (bt_k, b.t())):
        want = pack(x.cpu().contiguous(), ks)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    ab, bb = a.bfloat16(), b.bfloat16()
    ks, a_k, bt_k = pk.gemm_prepare(ab, bb)
    assert ks == 136 and bt_k.shape == (29, 136)
    assert torch.equal(bt_k[:, :131], bb.t()) and not bt_k[:, 131:].any()
    assert torch.equal(a_k[:, :131], ab) and not a_k[:, 131:].any()
    aligned = ab[:, :128].contiguous()
    assert pk.gemm_prepare(aligned, bb[:128])[1] is aligned


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runs_are_bit_identical(cuda, dtype):
    """No atomics: the same inputs give the same bits every run."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    a = torch.randn((1000, 3000), generator=gen, device=cuda).to(dt)
    b = torch.randn((3000, 700), generator=gen, device=cuda).to(dt)
    first = pk.pallas_matmul(a, b)
    for _ in range(3):
        assert torch.equal(pk.pallas_matmul(a, b), first)


@pytest.mark.cuda
def test_more_tile_rows_than_a_grid_axis(cuda):
    """(65535 * 128 + 77) rows: the persistent grid walks any tile count."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    a = torch.randn((65535 * 128 + 77, 24), generator=gen, device=cuda)
    b = torch.randn((24, 40), generator=gen, device=cuda)
    got = pk.pallas_matmul(a, b)
    want = pk.pallas_matmul_plain(a, b)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= F32_TOL * scale
