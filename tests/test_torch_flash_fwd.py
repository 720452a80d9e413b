"""The flash forward at wide heads and on the tensor cores, and the repairs
that let the card take head dims above 128 and wide decode groups.

- A TF32 emulation of the forward kernel's schedule (S = Q·Kᵀ and P·V per
  key tile, a fresh P·V sum per tile folded into the carried state in
  IEEE f32) against float64: three TF32 passes hold within ``chip_smoke.py``'s
  f32 attention tolerances, one pass does not.
- ``flash_attention_panel_plain`` / ``flash_attention_single_panel`` at
  d = 192 and 256 against the JAX panel in interpret mode.
- A ``TransformerLM`` with dh = 256 whose prefill takes the flash path,
  against the JAX model (weights carried by ``interop.lm_params_from_numpy``).
- Paged decode at group·dh > 2048: the chunk plan, and the result against
  the numpy reference of ``tests/test_paged_attention.py``.
- ``resolve_attention_backend`` by head dim.

On the CPU the wrappers run their plain versions. Tolerances: f32 rtol and
atol 1e-5 against the JAX package (both sides f32, another summation order);
logits 1e-4 of their largest magnitude, as ``tests/test_torch_lm.py``. The
``cuda``-marked tests hold the forward kernel against its plain version on
the card (f32 within 1e-5; bf16 within two bf16 ulps of the element plus
2^-8, p being rounded to bf16 at each side's own running maximum) and skip
where there is none.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.ops import flash_attention as jfa
from marlin_tpu_torch import interop, ops
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.ops import flash_attention as fa
from marlin_tpu_torch.ops import paged_attention as pa

# the modules (``parallel`` exports functions of these names)
tra = importlib.import_module("marlin_tpu_torch.parallel.ring_attention")
tul = importlib.import_module("marlin_tpu_torch.parallel.ulysses")

F32_TOL = 1e-5
BF16_ATOL = 2.0 ** -8
LOGIT_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def assert_bf16_close(got, want):
    """Every element within two bf16 ulps of ``want`` plus BF16_ATOL."""
    got, want = _np(got), _np(want)
    _, e = np.frexp(want)  # |want| = m * 2^e, m in [0.5, 1): ulp 2^(e - 8)
    tol = np.where(want != 0, np.ldexp(2.0, e - 8), 0.0) + BF16_ATOL
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} elements off, max |err| "
                           f"{float(np.abs(got - want).max())}")


# ------------------------------------------- the kernel's TF32 arithmetic


def _tf32(x):
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does (and as the
    kernels' integer rounding does): 10 explicit mantissa bits, ties away
    from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """``a @ b`` as the tensor cores form it: one pass big·big, three add
    small·big and big·small (``small = tf32(x - big)``)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def _forward_schedule(q, k, v, valid, causal, scale, tile, mm):
    """The kernel's online softmax over ``tile``-key tiles with both
    products through ``mm``: each tile's P·V summed fresh, then
    ``acc = acc·alpha + pv`` in f32. Returns (out, lse)."""
    sq, d = q.shape
    m = torch.full((sq,), -1e30)
    l = torch.zeros(sq)
    acc = torch.zeros((sq, d))
    qpos = torch.arange(sq)
    for c0 in range(0, k.shape[0], tile):
        kpos = c0 + torch.arange(min(tile, k.shape[0] - c0))
        live = (kpos[None, :] < valid).expand(sq, -1)
        if causal:
            live = live & (qpos[:, None] >= kpos[None, :])
        s = torch.where(live, mm(q, k[kpos].T) * scale, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new[:, None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + mm(p, v[kpos])
        m = m_new
    return acc / l[:, None], m + torch.log(l)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("d,tile,causal,valid", [(128, 32, True, 256),
                                                 (64, 64, False, 200),
                                                 (256, 16, True, 250)])
def test_forward_tf32_passes_against_f64(passes, d, tile, causal, valid):
    """Why the f32 forward multiplies in three TF32 passes: with an emulation
    of the tensor cores' TF32 products in the kernel's schedule (its tiles at
    each width), three passes keep the output within ``chip_smoke.py``'s
    ATTN_F32_TOL of float64 and lse within its LSE_TOL; one pass does
    not."""
    from chip_smoke import ATTN_F32_TOL, LSE_TOL

    rng = np.random.default_rng(d + valid + passes)
    sq = skv = 256
    scale = 1.0 / math.sqrt(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)) for n in (sq, skv, skv))
    pos = torch.arange(sq)
    live = (pos[None, :] < valid).expand(sq, skv)
    if causal:
        live = live & (pos[:, None] >= pos[None, :])
    s64 = torch.where(live, q.double() @ k.double().T * scale, -torch.inf)
    want = torch.softmax(s64, -1) @ v.double()
    want_lse = torch.logsumexp(s64, -1)
    out, lse = _forward_schedule(q, k, v, valid, causal, scale, tile,
                                 lambda a, b: _mm_tf32(a, b, passes))
    err = float((out.double() - want).abs().max())
    lse_err = float((lse.double() - want_lse).abs().max())
    if passes == 3:
        assert err <= ATTN_F32_TOL and lse_err <= LSE_TOL, (err, lse_err)
    else:
        assert err > ATTN_F32_TOL and lse_err > LSE_TOL, (err, lse_err)


# ------------------------------------------------- wide heads against JAX


def _jax_panel(q, k, v, m, l, acc, qo, ko, valid, causal, scale):
    out = jfa.flash_attention_panel(
        *(jnp.asarray(a) for a in (q, k, v, m, l, acc)), qo, ko, valid,
        causal=causal, scale=scale, bq=128, bkv=128, interpret=True)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal,valid,qo,ko,carry", [
    (True, 250, 0, 0, False), (False, 200, 0, 0, False),
    (True, 500, 300, 37, True)])
def test_wide_head_panel_matches_jax(d, causal, valid, qo, ko, carry):
    """The plain panel at the forward kernel's widest instances: fresh and
    carried state, offsets that are no multiple of a tile."""
    rng = np.random.default_rng(d + valid)
    sq = skv = 256
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32)
               for n in (sq, skv, skv))
    if carry:
        m = rng.standard_normal(sq).astype(np.float32)
        l = rng.uniform(0.5, 3.0, sq).astype(np.float32)
        acc = rng.standard_normal((sq, d)).astype(np.float32)
    else:
        m = np.full(sq, -1e30, np.float32)
        l = np.zeros(sq, np.float32)
        acc = np.zeros((sq, d), np.float32)
    scale = 1.0 / math.sqrt(d)
    want = _jax_panel(q, k, v, m, l, acc, qo, ko, valid, causal, scale)
    got = fa.flash_attention_panel(
        *(torch.from_numpy(a) for a in (q, k, v, m, l, acc)), qo, ko, valid,
        causal=causal, scale=scale, bq=128, bkv=128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_head_single_panel_matches_jax(d):
    """``flash_attention_single_panel`` (the prefill's call) at d = 192 and
    256 on a padded sequence: output and lse."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((256, d)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    out_w, lse_w = jfa.flash_attention_single_panel(
        *(jnp.asarray(a) for a in (q, k, v)), 230, causal=True, scale=scale)
    out, lse = fa.flash_attention_single_panel(
        *(torch.from_numpy(a) for a in (q, k, v)), 230, causal=True,
        scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_w), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w), rtol=F32_TOL,
                               atol=F32_TOL)


WIDE = dict(vocab=64, d_model=512, heads=2, layers=1, seed=5)  # dh 256


@pytest.fixture(scope="module")
def wide_params():
    jparams = JaxLM(**WIDE).init_params()
    return jparams, interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_wide_head_flash_prefill_matches_jax(wide_params, monkeypatch):
    """dh = 256: with _PREFILL_FLASH_MIN lowered on both sides, the prompt
    goes through the flash panel (padded to 128, the pad masked by
    valid_len); logits within 1e-4 of their largest magnitude and greedy
    tokens equal."""
    jparams, tparams = wide_params
    monkeypatch.setattr(jt, "_PREFILL_FLASH_MIN", 16)
    monkeypatch.setattr(tt, "_PREFILL_FLASH_MIN", 16)
    prompt = (np.arange(100) * 7) % WIDE["vocab"]
    lj, _ = jt._prefill(jparams, jnp.asarray(prompt, jnp.int32),
                        WIDE["heads"], 104, jnp.float32)
    lt, _ = tt._prefill(tparams, torch.from_numpy(prompt).long(),
                        WIDE["heads"], 104, torch.float32)
    lj = np.asarray(lj)
    np.testing.assert_allclose(_np(lt), lj, rtol=0,
                               atol=LOGIT_RTOL * float(np.abs(lj).max()))
    want = np.asarray(jt.lm_generate(jparams, jnp.asarray(prompt, jnp.int32),
                                     jax.random.key(0), heads=WIDE["heads"],
                                     max_len=104, steps=4))
    got = tt.lm_generate(tparams, prompt, 0, heads=WIDE["heads"], max_len=104,
                         steps=4)
    assert got.tolist() == want.tolist()


# ---------------------------------------------- paged decode, wide groups


def _ref_attention(q, k_pages, v_pages, tables, lengths):
    """Straight-line numpy decode attention (tests/test_paged_attention.py's
    reference): gather each row's context by block table, mask past its
    length, softmax, weigh V."""
    B, kvh, group, dh = q.shape
    W = tables.shape[1]
    page_len = k_pages.shape[1]
    out = np.zeros_like(q)
    for b in range(B):
        k = k_pages[tables[b]].reshape(W * page_len, kvh, dh)
        v = v_pages[tables[b]].reshape(W * page_len, kvh, dh)
        n = int(np.clip(lengths[b], 1, W * page_len))
        s = np.einsum("kgd,tkd->kgt", q[b], k[:n]) / np.sqrt(dh)
        p = np.exp(s - s.max(axis=2, keepdims=True))
        out[b] = np.einsum("kgt,tkd->kgd", p / p.sum(axis=2, keepdims=True),
                           v[:n])
    return out


def _wide_group_case(rng, B, kvh, group, dh, page_len, W):
    n_pages = B * W + 1
    q = rng.standard_normal((B, kvh, group, dh)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, page_len, kvh, dh))
              .astype(np.float32) for _ in range(2))
    tables = (1 + rng.permutation(n_pages - 1)[:B * W]).reshape(B, W)
    lengths = rng.integers(1, W * page_len + 1, B)
    lengths[0] = W * page_len
    return q, kp, vp, tables.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("group,dh,want_chunks", [
    (1, 64, 1), (32, 64, 2), (16, 256, 2), (9, 256, 2), (5, 2048, 5),
    (3, 1000, 2)])
def test_paged_group_chunks(group, dh, want_chunks):
    """The chunk plan covers the group exactly once, each chunk within the
    kernel's group·dh and its 16 query heads."""
    chunks = pa.group_chunks(group, dh)
    assert len(chunks) == want_chunks
    covered = [g for sl in chunks for g in range(group)[sl]]
    assert covered == list(range(group))
    assert all((sl.stop - sl.start) * dh <= pa.KERNEL_GROUP_DH
               and sl.stop - sl.start <= pa.KERNEL_GROUP_HEADS
               for sl in chunks)


def test_paged_group_chunks_refuse_a_head_wider_than_the_kernel():
    with pytest.raises(ValueError, match="exceeds the kernel's 2048"):
        pa.group_chunks(1, 4096)


@pytest.mark.parametrize("group,dh", [(16, 256), (9, 256), (32, 128)])
def test_paged_wide_group_matches_reference(group, dh):
    """group·dh above 2048 (the kernel's launches are split into chunks of
    query heads): the whole group against the numpy reference, and the plain
    version over the chunk plan against the whole call (every query head
    attends on its own; the CPU's einsum may sum in another order for
    another group size, so within 1e-5, not bit for bit)."""
    rng = np.random.default_rng(group + dh)
    q, kp, vp, tables, lengths = _wide_group_case(rng, 3, 2, group, dh, 8, 3)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    got = pa.paged_decode_attention(*t)
    np.testing.assert_allclose(got.numpy(), _ref_attention(
        q, kp, vp, tables, lengths), rtol=F32_TOL, atol=F32_TOL)
    parts = [pa.paged_decode_attention_plain(t[0][:, :, sl], *t[1:])
             for sl in pa.group_chunks(group, dh)]
    np.testing.assert_allclose(torch.cat(parts, dim=2).numpy(), got.numpy(),
                               rtol=F32_TOL, atol=F32_TOL)


# --------------------------------------------------------- backend rule


@pytest.mark.parametrize("head_dim,on_card", [(64, "flash"), (128, "flash"),
                                              (192, "flash"), (256, "flash"),
                                              (257, "xla"), (320, "xla")])
def test_attention_backend_by_head_dim(head_dim, on_card):
    """"auto" takes the kernels on the card up to the flash kernels' head
    dim (256, forward and backward) and the tiled path above it; explicit
    "flash" above it raises on the card (the kernels could not run) and
    stays the plain flash path on the CPU."""
    res = tra.resolve_attention_backend
    assert res("auto", "cuda", head_dim) == on_card
    assert res("auto", "cpu", head_dim) == "xla"
    assert res("xla", "cuda", head_dim) == "xla"
    assert res("flash", "cpu", head_dim) == "flash"
    if on_card == "flash":
        assert res("flash", "cuda", head_dim) == "flash"
    else:
        with pytest.raises(ValueError, match="exceeds the flash kernels"):
            res("flash", "cuda", head_dim)


def test_kernel_reach_constants():
    """The forward kernel and the backward kernels are compiled up to
    d = 256; the rule above reads both."""
    assert (fa.FWD_MAX_D, fa.BWD_MAX_D) == (256, 256)


# ----------------------------------------------------- the card's kernel


def _fwd_case(cuda, H, sq, skv, d, dtype, strided, carry, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def make(n):
        if strided:  # (seq, heads, d) activations viewed as (heads, seq, d)
            return torch.randn((n, H, d), generator=gen,
                               device=cuda).to(dtype).permute(1, 0, 2)
        return torch.randn((H, n, d), generator=gen, device=cuda).to(dtype)

    q, k, v = make(sq), make(skv), make(skv)
    if carry:
        m = torch.randn((H, sq), generator=gen, device=cuda)
        l = torch.rand((H, sq), generator=gen, device=cuda) * 3 + 0.5
        acc = torch.randn((H, sq, d), generator=gen, device=cuda)
    else:
        m = torch.full((H, sq), -1e30, device=cuda)
        l = torch.zeros((H, sq), device=cuda)
        acc = torch.zeros((H, sq, d), device=cuda)
    return q, k, v, m, l, acc


# The f32 d <= 128 instances keep 128 query rows resident and stream 32- or
# 64-key tiles; d <= 256 takes 64 x 16. d = 40 takes the 16-byte copies,
# d = 41 (odd rows) the element-wise variant.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,sq,skv,qo,ko,valid,causal,strided,carry", [
    (128, 1, 1, 0, 0, 1, True, False, False),        # sq = skv = 1
    (64, 161, 90, 0, 0, 90, True, False, False),     # ragged sq, skv
    (128, 300, 300, 0, 0, 77, True, False, False),   # valid_len in a tile
    (128, 200, 333, 1000, 700, 1500, True, False, True),  # carried, offsets
    (64, 333, 200, 37, 5, 180, True, False, True),
    (128, 200, 150, 0, 0, 150, False, False, False),  # non-causal sq != skv
    (40, 300, 300, 0, 0, 299, True, False, False),
    (41, 300, 300, 0, 0, 299, True, False, False),   # unaligned rows
    (64, 300, 300, 0, 0, 299, True, True, False),    # strided views
    (128, 300, 300, 0, 0, 299, True, True, False),
    (192, 300, 300, 0, 0, 299, True, False, False),
    (256, 300, 300, 0, 0, 299, True, False, False),
    (256, 300, 300, 0, 0, 299, True, True, False),
    (256, 200, 333, 500, 131, 800, False, False, True),
])
def test_forward_kernel_matches_plain(cuda, dtype, d, sq, skv, qo, ko, valid,
                                      causal, strided, carry):
    q, k, v, m, l, acc = _fwd_case(cuda, 2, sq, skv, d, dtype, strided,
                                   carry, d + sq + skv)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
    before = ops.launch_counts()["flash_attention_panel"]
    got = fa.flash_attention_panel(q, k, v, m, l, acc, qo, ko, valid, **kw)
    assert ops.launch_counts()["flash_attention_panel"] == before + 1
    want = fa.flash_attention_panel_plain(q, k, v, m, l, acc, qo, ko, valid,
                                          **kw)
    torch.cuda.synchronize()
    out_g, out_w = (st[2] / st[1].clamp(min=1e-30)[..., None]
                    for st in (got, want))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0,
                               atol=F32_TOL)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(out_g), _np(out_w), rtol=0,
                                   atol=F32_TOL)
    else:
        assert_bf16_close(out_g, out_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 256])
def test_forward_kernel_fully_masked_rows_stay_exact(cuda, dtype, d):
    """Rows whose keys all lie above the diagonal keep their state bit for
    bit, fresh (l = 0, acc = 0) or carried: every row when the whole panel
    is past them (k_offset 500, no tile runs), and rows 0-49 when k_offset
    is 50 (their tiles run for the rows below them)."""
    for carry in (False, True):
        q, k, v, m, l, acc = _fwd_case(cuda, 2, 130, 100, d, dtype, False,
                                       carry, d)
        for k_offset, rows in ((500, 130), (50, 50)):
            got = fa.flash_attention_panel(q, k, v, m, l, acc, 0, k_offset,
                                           1000, causal=True, scale=0.1)
            torch.cuda.synchronize()
            for g, w in zip(got, (m, l, acc)):
                assert torch.equal(g[:, :rows], w[:, :rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_bit_identical_across_launches(cuda, dtype):
    q, k, v, m, l, acc = _fwd_case(cuda, 3, 1000, 1000, 128, dtype, False,
                                   False, 1)
    kw = dict(causal=True, scale=1.0 / math.sqrt(128))
    first = fa.flash_attention_panel(q, k, v, m, l, acc, 0, 0, 999, **kw)
    second = fa.flash_attention_panel(q, k, v, m, l, acc, 0, 0, 999, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernels_name_their_head_dim_limit(cuda):
    """An explicit call past a kernel's reach raises, naming the kernel and
    its limit: the forward and the backward kernels at 257."""
    x = torch.zeros((1, 8, 257), device=cuda)
    st = (torch.zeros((1, 8), device=cuda), torch.zeros((1, 8), device=cuda),
          torch.zeros((1, 8, 257), device=cuda))
    with pytest.raises(ValueError, match="flash_attention_panel: head dim "
                                         "257 exceeds the kernel's 256"):
        fa.flash_attention_panel(x, x, x, *st, 0, 0, 8, causal=True,
                                 scale=1.0)
    rows = torch.zeros((1, 8), device=cuda)
    for wrapper in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="head dim 257 exceeds the "
                                             "kernel's 256"):
            wrapper(x, x, x, x, rows, rows, 0, 0, 8, causal=True, scale=1.0)


@pytest.mark.cuda
def test_wide_head_ring_and_ulysses_step_on_card_match_cpu(cuda):
    """dh = 256: ring attention ("auto") and Ulysses train on the card
    through the flash kernels (forward, dK/dV and dQ, one launch each),
    forward and grads against the CPU's plain versions."""
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.standard_normal((2, 300, 256)).astype(np.float32)
                  for _ in range(4))
    for fn in (lambda q, k, v: tra.ring_attention(q, k, v, causal=True),
               lambda q, k, v: tul.ulysses_attention(q, k, v, causal=True)):
        outs = []
        for dev in ("cpu", cuda):
            ts = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in (q, k, v)]
            ops.reset_launch_counts()
            out = fn(*ts)
            grads = torch.autograd.grad(
                (out * torch.from_numpy(w).to(dev)).sum(), ts)
            counts = ops.launch_counts()
            for name in ("flash_attention_panel", "flash_attention_bwd_dkv",
                         "flash_attention_bwd_dq"):
                assert counts[name] == (0 if dev == "cpu" else 1), counts
            outs.append([out, *grads])
        for g, r in zip(outs[1], outs[0]):
            np.testing.assert_allclose(_np(g), _np(r), rtol=F32_TOL,
                                       atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_wide_group_matches_gather(cuda, dtype):
    """group·dh = 4096 (16 query heads of 256): two chunks of query heads,
    blocks of one split-kernel launch, against the plain version (f32 1e-5,
    bf16 two ulps + 2^-8)."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables, lengths = _wide_group_case(rng, 4, 2, 16, 256, 16, 5)
    t = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp)]
    t = [a.to(dtype) for a in t]
    tb, ln = (torch.from_numpy(a).to(cuda) for a in (tables, lengths))
    before = ops.launch_counts()["paged_decode_attention"]
    got = pa.paged_decode_attention(*t, tb, ln)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = pa.paged_decode_attention_plain(*t, tb, ln)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_TOL)
    else:
        assert_bf16_close(got, want)
