"""The port's two attention kernels against the JAX package's oracles.

- Paged decode attention: the JAX Pallas kernel cannot run on this tree
  (``pltpu.TPUCompilerParams`` is gone from the installed jax), so the oracle
  is the numpy reference of tests/test_paged_attention.py, copied below, and
  the JAX ``lm_decode_paged(kernel="gather")`` at model level
  (tests/test_torch_lm.py).
- Flash panel: the JAX ``flash_attention_panel`` in interpret mode.

On the CPU the port's wrappers run their plain versions. Tolerances: f32
1e-5 (rtol and atol; both sides are f32 with another summation order); bf16
per element, two bf16 ulps of the reference element plus 2^-8 (p and the
output are rounded to bf16 once on each side, at points that may differ by
a rounding step, so an output near 0 may differ by a few p roundings).

The ``cuda``-marked tests hold the CUDA kernels against the plain versions on
the card and skip where there is none.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marlin_tpu.ops import flash_attention as jfa
from marlin_tpu.ops import paged_attention as jpa
from marlin_tpu_torch.ops import flash_attention as fa
from marlin_tpu_torch.ops import paged_attention as pa

F32_TOL = 1e-5
PAGE_LEN = 8


BF16_ATOL = 2.0 ** -8


def assert_bf16_close(got, want):
    """Every element of ``got`` within two bf16 ulps of the same element of
    ``want`` plus BF16_ATOL."""
    got, want = (np.asarray(t.float().cpu() if isinstance(t, torch.Tensor)
                            else t, np.float32) for t in (got, want))
    _, e = np.frexp(want)  # |want| = m * 2^e, m in [0.5, 1): ulp 2^(e - 8)
    tol = np.where(want != 0, np.ldexp(2.0, e - 8), 0.0) + BF16_ATOL
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} elements off, max |err| "
                           f"{float(np.abs(got - want).max())}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# ------------------------------------------------------- numpy reference


def _ref_attention(q, k_pages, v_pages, tables, lengths):
    """Straight-line numpy decode attention: gather each row's context by
    block table, mask past its length, softmax, weigh V (copied from
    tests/test_paged_attention.py)."""
    q = np.asarray(q, np.float32)
    kp = np.asarray(k_pages, np.float32)
    vp = np.asarray(v_pages, np.float32)
    B, kvh, group, dh = q.shape
    W = tables.shape[1]
    page_len = kp.shape[1]
    out = np.zeros_like(q)
    for b in range(B):
        k = kp[tables[b]].reshape(W * page_len, kvh, dh)
        v = vp[tables[b]].reshape(W * page_len, kvh, dh)
        n = int(np.clip(lengths[b], 1, W * page_len))
        s = np.einsum("kgd,tkd->kgt", q[b], k[:n]) / np.sqrt(dh)
        s = s - s.max(axis=2, keepdims=True)
        p = np.exp(s)
        p = p / p.sum(axis=2, keepdims=True)
        out[b] = np.einsum("kgt,tkd->kgd", p, v[:n])
    return out


def _random_case(rng, B=4, kvh=2, group=2, dh=8, W=3, num_pages=16,
                 dtype=np.float32):
    q = rng.standard_normal((B, kvh, group, dh)).astype(dtype)
    kp = rng.standard_normal((num_pages, PAGE_LEN, kvh, dh)).astype(dtype)
    vp = rng.standard_normal((num_pages, PAGE_LEN, kvh, dh)).astype(dtype)
    tables = (1 + rng.permutation(num_pages - 1)[:B * W]).reshape(B, W)
    return q, kp, vp, tables.astype(np.int32)


def _paged(q, kp, vp, tables, lengths, dtype=torch.float32):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
         for a in (q, kp, vp)]
    return pa.paged_decode_attention(*t, torch.from_numpy(tables),
                                     torch.from_numpy(lengths))


@pytest.mark.parametrize("lengths", [[1, 9, 17, 24], [7, 8, 9, 16],
                                     [16, 24, 1, 23]])
def test_paged_plain_matches_reference_gqa_ragged(lengths):
    """GQA (kv_heads 2, group 2) with ragged lengths, mid-page and on page
    edges, up to the full table: the plain version matches the gathered
    reference."""
    rng = np.random.default_rng(0)
    q, kp, vp, tables = _random_case(rng)
    lengths = np.array(lengths, np.int32)
    got = _paged(q, kp, vp, tables, lengths)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _ref_attention(q, kp, vp, tables,
                                                           lengths),
                               rtol=F32_TOL, atol=F32_TOL)


def test_paged_plain_page_boundary_lengths():
    rng = np.random.default_rng(1)
    q, kp, vp, tables = _random_case(rng)
    for n in (PAGE_LEN - 1, PAGE_LEN, PAGE_LEN + 1, 2 * PAGE_LEN,
              3 * PAGE_LEN):
        lengths = np.full(4, n, np.int32)
        np.testing.assert_allclose(
            _paged(q, kp, vp, tables, lengths).numpy(),
            _ref_attention(q, kp, vp, tables, lengths),
            rtol=F32_TOL, atol=F32_TOL)


def test_paged_plain_dummy_rows_are_harmless():
    """Rows with all-zero tables (free or prefilling slots) read page 0:
    finite outputs, and live rows are unaffected."""
    rng = np.random.default_rng(2)
    q, kp, vp, tables = _random_case(rng)
    lengths = np.array([12, 1, 20, 1], np.int32)
    tables[[1, 3]] = 0
    got = _paged(q, kp, vp, tables, lengths).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ref_attention(q, kp, vp, tables, lengths),
                               rtol=F32_TOL, atol=F32_TOL)


def test_paged_plain_length_clamping():
    rng = np.random.default_rng(4)
    q, kp, vp, tables = _random_case(rng)
    wild = np.array([0, -3, 999, 24], np.int32)
    clamped = np.array([1, 1, 24, 24], np.int32)
    np.testing.assert_allclose(_paged(q, kp, vp, tables, wild).numpy(),
                               _ref_attention(q, kp, vp, tables, clamped),
                               rtol=F32_TOL, atol=F32_TOL)


def test_paged_plain_bf16():
    """bf16 q and slab: f32 scores and accumulator, p rounded to bf16 before
    P·V, output in bf16 — within two bf16 ulps of the f32 reference on the
    same (bf16-rounded) inputs."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables = _random_case(rng)
    q, kp, vp = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                 for a in (q, kp, vp))
    lengths = np.array([5, 11, 24, 16], np.int32)
    got = _paged(q, kp, vp, tables, lengths, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _ref_attention(q, kp, vp, tables, lengths)
    assert_bf16_close(got, want)


def test_page_rules_and_cost_model_match_the_reference():
    """align_page_len applies the Hopper rule (any length >= 1); the cost
    model is the JAX package's."""
    assert pa.PAGE_MULTIPLE == 1
    for n in (1, 5, 8, 9, 16):
        assert pa.align_page_len(n) == n
    with pytest.raises(ValueError):
        pa.align_page_len(0)
    for args in ((4, 3, 8, 2, 2, 16), (8, 36, 16, 8, 1, 64, 2)):
        assert pa.paged_attention_cost(*args) == jpa.paged_attention_cost(*args)


def test_paged_shape_checks():
    q = torch.zeros((2, 2, 1, 8))
    slab = torch.zeros((4, PAGE_LEN, 2, 8))
    with pytest.raises(ValueError, match="tables"):
        pa.paged_decode_attention(q, slab, slab, torch.zeros((3, 2)),
                                  torch.ones(2))
    with pytest.raises(ValueError, match="does not match"):
        pa.paged_decode_attention(q, torch.zeros((4, PAGE_LEN, 1, 8)),
                                  torch.zeros((4, PAGE_LEN, 1, 8)),
                                  torch.zeros((2, 2)), torch.ones(2))


# ------------------------------------------------------------- flash panel


def _flash_inputs(rng, sq, skv, d, heads=1):
    q = rng.standard_normal((heads, sq, d)).astype(np.float32)
    k = rng.standard_normal((heads, skv, d)).astype(np.float32)
    v = rng.standard_normal((heads, skv, d)).astype(np.float32)
    return q, k, v


def _jax_panel(q, k, v, m, l, acc, qo, ko, valid, causal, scale, bq, bkv):
    out = jfa.flash_attention_panel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        jnp.asarray(l), jnp.asarray(acc), qo, ko, valid, causal=causal,
        scale=scale, bq=bq, bkv=bkv, interpret=True)
    return [np.asarray(t) for t in out]


def _init_state(sq, d, heads=None):
    lead = (sq,) if heads is None else (heads, sq)
    return (np.full(lead, -1e30, np.float32), np.zeros(lead, np.float32),
            np.zeros(lead + (d,), np.float32))


@pytest.mark.parametrize("causal,valid,qo,ko", [
    (True, 256, 0, 0), (True, 200, 0, 0), (False, 256, 0, 0),
    (False, 150, 0, 0), (True, 500, 300, 37)])
def test_flash_plain_matches_jax_panel(causal, valid, qo, ko):
    """One panel, fresh state: causal and not, valid_len below the panel,
    global offsets that are no multiple of the tile."""
    rng = np.random.default_rng(7)
    sq, skv, d = 256, 256, 16
    q, k, v = _flash_inputs(rng, sq, skv, d)
    m, l, acc = _init_state(sq, d)
    scale = 1.0 / math.sqrt(d)
    want = _jax_panel(q[0], k[0], v[0], m, l, acc, qo, ko, valid, causal,
                      scale, 128, 128)
    got = fa.flash_attention_panel(
        *(torch.from_numpy(t[0]) for t in (q, k, v)),
        *(torch.from_numpy(t) for t in (m, l, acc)), qo, ko, valid,
        causal=causal, scale=scale, bq=128, bkv=128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL)


def test_flash_plain_two_panels_carried_state_all_heads():
    """Two panels with carried (m, l, acc) and a nonzero key offset, three
    heads in one call (the JAX panel per head), then normalised."""
    rng = np.random.default_rng(8)
    H, sq, skv, d = 3, 256, 128, 16
    q, k1, v1 = _flash_inputs(rng, sq, skv, d, H)
    _, k2, v2 = _flash_inputs(rng, sq, skv, d, H)
    scale = 1.0 / math.sqrt(d)
    valid = 240
    m, l, acc = _init_state(sq, d, H)
    want = []
    for h in range(H):
        s = _jax_panel(q[h], k1[h], v1[h], m[h], l[h], acc[h], 0, 0, valid,
                       True, scale, 128, 128)
        s = _jax_panel(q[h], k2[h], v2[h], *s, 0, skv, valid, True, scale,
                       128, 128)
        want.append(s[2] / np.maximum(s[1], 1e-30)[:, None])
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    st = fa.flash_attention_panel(t(q), t(k1), t(v1), t(m), t(l), t(acc), 0,
                                  0, valid, causal=True, scale=scale, bq=128,
                                  bkv=128)
    st = fa.flash_attention_panel(t(q), t(k2), t(v2), *st, 0, skv, valid,
                                  causal=True, scale=scale, bq=128, bkv=128)
    got = (st[2] / torch.clamp(st[1], min=1e-30)[..., None]).numpy()
    np.testing.assert_allclose(got, np.stack(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_single_panel_matches_jax():
    """The single-panel wrapper: same state init, the 1e-30 floor on l, and
    lse = m + log l, for a padded sequence (valid_len below it)."""
    rng = np.random.default_rng(9)
    seq, d = 384, 16
    q, k, v = (a[0] for a in _flash_inputs(rng, seq, seq, d))
    scale = 1.0 / math.sqrt(d)
    out_w, lse_w = jfa.flash_attention_single_panel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 300, causal=True,
        scale=scale)
    out, lse = fa.flash_attention_single_panel(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 300,
        causal=True, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_w), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_plain_bf16_matches_jax():
    """bf16 q/k/v: f32 scores, p rounded to bf16 before P·V, f32 state —
    against the JAX panel at the same tiles, within two bf16 ulps."""
    rng = np.random.default_rng(10)
    sq, d = 256, 16
    q, k, v = (a[0].astype(ml_dtypes.bfloat16) for a in
               _flash_inputs(rng, sq, sq, d))
    m, l, acc = _init_state(sq, d)
    scale = 1.0 / math.sqrt(d)
    want = _jax_panel(q, k, v, m, l, acc, 0, 0, 230, True, scale, 128, 128)
    tb = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()  # noqa: E731
    got = fa.flash_attention_panel(tb(q), tb(k), tb(v), torch.from_numpy(m),
                                   torch.from_numpy(l), torch.from_numpy(acc),
                                   0, 0, 230, causal=True, scale=scale,
                                   bq=128, bkv=128)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=F32_TOL,
                               atol=F32_TOL)
    assert_bf16_close(got[2], want[2])


def test_flash_fully_masked_rows_stay_zero():
    """Rows whose keys all lie past valid_len (or above the diagonal) keep
    the fresh state exactly: l = 0, acc = 0."""
    q, k, v = (torch.ones((128, 8)) for _ in range(3))
    m, l, acc = (torch.from_numpy(t) for t in _init_state(128, 8))
    m2, l2, a2 = fa.flash_attention_panel(q, k, v, m, l, acc, 0, 500, 1000,
                                          causal=True, scale=1.0)
    assert torch.equal(l2, l) and torch.equal(a2, acc) and torch.equal(m2, m)


def test_block_divisor_matches_reference():
    for n in (128, 256, 384, 1024, 2048, 3072, 4096, 1000, 96, 7):
        assert fa.block_divisor(n) == jfa.block_divisor(n)
        assert fa.block_divisor(n, 64) == jfa.block_divisor(n, 64)


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for B, kvh, group, dh, page_len, W in ((8, 8, 1, 64, 16, 36),
                                           (5, 2, 4, 40, 5, 7)):
        n_pages = B * W + 1
        q = torch.randn((B, kvh, group, dh), generator=gen, device=cuda).to(dtype)
        kp = torch.randn((n_pages, page_len, kvh, dh), generator=gen,
                         device=cuda).to(dtype)
        vp = torch.randn_like(kp)
        tables = (1 + torch.arange(B * W, device=cuda)).reshape(B, W).int()
        tables[1] = 0
        lengths = torch.randint(1, W * page_len + 1, (B,), generator=gen,
                                device=cuda).int()
        lengths[0] = W * page_len
        got = pa.paged_decode_attention(q, kp, vp, tables, lengths)
        want = pa.paged_decode_attention_plain(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= F32_TOL
        else:
            assert_bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    H, sq, skv, d = 3, 200, 130, 40
    q, k, v = (torch.randn((H, n, d), generator=gen, device=cuda).to(dtype)
               for n in (sq, skv, skv))
    m = torch.full((H, sq), -1e30, device=cuda)
    l = torch.zeros((H, sq), device=cuda)
    acc = torch.zeros((H, sq, d), device=cuda)
    kw = dict(causal=True, scale=1.0 / math.sqrt(d))
    got = fa.flash_attention_panel(q, k, v, m, l, acc, 37, 5, 150, **kw)
    want = fa.flash_attention_panel_plain(q, k, v, m, l, acc, 37, 5, 150,
                                          bq=64, bkv=64, **kw)
    torch.cuda.synchronize()
    out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
    out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
    if dtype == torch.float32:
        assert float((out_g - out_w).abs().max()) <= F32_TOL
    else:
        assert_bf16_close(out_g, out_w)
    assert float((got[0] - want[0]).abs().max()) <= F32_TOL
