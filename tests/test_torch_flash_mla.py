"""Flash attention with v narrower than q and k: latent attention's heads,
q/k 192 wide (128 positional-free and 64 rotary dims) against v 128 wide.

On the CPU the plain panel, its backward and the autograd function are held
against float64 attention written out here, at small sizes and at the
unequal widths (the plain versions are the references the kernels are held
to). The ``cuda``-marked tests hold the forward, dK/dV and dQ kernels at
(192, 128) against those plain versions on the card, in bf16 and f32,
causal, at 2 heads x 4096 and one head of 32768, with the tolerances of
``tests/test_torch_flash_fwd.py`` (f32 1e-5; bf16 two ulps of the element
plus 2^-8): the kernel and the plain version round p and ds alike and
differ only in the order of their f32 sums. This file imports no JAX, so
the card's machine runs it as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_mla.py
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import pytest
import torch

from marlin_tpu_torch import ops
from marlin_tpu_torch.ops import flash_attention as fa

# the package exports the function under the module's name
ra = importlib.import_module("marlin_tpu_torch.parallel.ring_attention")

F32_TOL = 1e-5
BF16_ATOL = 2.0 ** -8
DQK, DV = 192, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _np(t):
    return t.detach().float().cpu().numpy()


def assert_bf16_close(got, want):
    """Every element within two bf16 ulps of ``want`` plus BF16_ATOL."""
    got, want = _np(got), _np(want)
    _, e = np.frexp(want)
    tol = np.where(want != 0, np.ldexp(2.0, e - 8), 0.0) + BF16_ATOL
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} elements off, max |err| "
                           f"{float(np.abs(got - want).max())}")


def _attention64(q, k, v, q_off, k_off, valid, causal, scale):
    """softmax(q k^T scale) v in float64 with the panel's masks; a row with
    no live key is 0. Returns (out, lse)."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    qpos = q_off + torch.arange(q.shape[-2])
    kpos = k_off + torch.arange(k.shape[-2])
    keep = (kpos < valid)[None, :]
    if causal:
        keep = keep & (qpos[:, None] >= kpos[None, :])
    s = torch.where(keep, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    return p @ v, lse


def _inputs(H, sq, skv, dqk, dv, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return r(H, sq, dqk), r(H, skv, dqk), r(H, skv, dv), r(H, sq, dv)


@pytest.mark.parametrize("sq,skv,q_off,k_off,valid,causal,dqk,dv", [
    (40, 40, 0, 0, 40, True, 48, 32),
    (33, 57, 60, 10, 70, True, 48, 32),     # offsets, valid_len in the panel
    (24, 24, 0, 0, 17, False, 32, 48),      # v wider than q, k
    (20, 20, 0, 0, 20, True, DQK, DV),
])
def test_plain_panel_unequal_widths(sq, skv, q_off, k_off, valid, causal, dqk,
                                    dv):
    q, k, v, _ = _inputs(2, sq, skv, dqk, dv, sq + dqk)
    scale = 1.0 / math.sqrt(dqk)
    m0 = torch.full((2, sq), -1e30)
    m, l, acc = fa.flash_attention_panel_plain(
        q, k, v, m0, torch.zeros(2, sq), torch.zeros(2, sq, dv), q_off,
        k_off, valid, causal=causal, scale=scale, bq=8, bkv=16)
    assert acc.shape == (2, sq, dv)
    want, lse = _attention64(q, k, v, q_off, k_off, valid, causal, scale)
    live = l > 0
    out = acc / l.clamp(min=1e-30)[..., None]
    np.testing.assert_allclose(out[live].numpy(), want[live].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose((m + torch.log(l))[live].numpy(),
                               lse[live].numpy(), rtol=0, atol=1e-5)
    assert (acc[~live] == 0).all()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_unequal_widths(causal):
    """The plain recompute backward against float64 autograd: every
    gradient in its own width."""
    sq = skv = 36
    q, k, v, do = _inputs(2, sq, skv, 48, 32, 5)
    scale = 1.0 / math.sqrt(48)
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    out, lse = _attention64(q64, k64, v64, 0, 0, skv, causal, scale)
    gq, gk, gv = torch.autograd.grad(out, (q64, k64, v64), do.double())
    delta = (do.double() * out).sum(-1).float()
    dq, dk, dv = fa.flash_attention_panel_bwd_plain(
        q, k, v, do, lse.detach().float(), delta.detach(), 0, 0, skv,
        causal=causal, scale=scale, bq=16, bkv=8)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    for got, want in ((dq, gq), (dk, gk), (dv, gv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2e-5)


def test_autograd_and_ring_attention_unequal_widths():
    """:class:`FlashAttention` (the plain panels on the CPU) and
    ``ring_attention`` in a world of one take v narrower than q and k; out
    and gradients against float64 autograd."""
    q, k, v, do = _inputs(3, 50, 50, 48, 32, 11)
    scale = 1.0 / math.sqrt(48)
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    want, _ = _attention64(q64, k64, v64, 0, 0, 50, True, scale)
    grads64 = torch.autograd.grad(want, (q64, k64, v64), do.double())
    for run in (lambda a, b, c: fa.FlashAttention.apply(a, b, c, 50, True,
                                                        scale),
                lambda a, b, c: ra.ring_attention(a, b, c, causal=True,
                                                  scale=scale,
                                                  backend="xla")):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = run(*leaves)
        assert out.shape == (3, 50, 32)
        np.testing.assert_allclose(out.detach().numpy(),
                                   want.detach().numpy(), rtol=0, atol=1e-5)
        for got, w in zip(torch.autograd.grad(out, leaves, do), grads64):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                       atol=2e-5)


def test_shapes_are_checked():
    q, k, v, _ = _inputs(2, 8, 8, 48, 32, 1)
    st = (torch.zeros(2, 8), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="acc"):
        fa.flash_attention_panel_plain(q, k, v, *st, torch.zeros(2, 8, 48),
                                       0, 0, 8, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="expected q"):
        fa.flash_attention_panel_plain(q, k, v[:, :5], *st,
                                       torch.zeros(2, 8, 32), 0, 0, 8,
                                       causal=True, scale=1.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ra.ring_attention(q, k, v[:, :5], causal=True)


# ----------------------------------------------------- the card's kernels


def _card_case(cuda, H, seq, dtype, seed):
    q, k, v, do = _inputs(H, seq, seq, DQK, DV, seed, dtype, cuda)
    return q, k, v, do


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,seq", [(2, 4096), (1, 32768)])
def test_mla_kernels_match_plain_on_card(cuda, dtype, H, seq):
    q, k, v, do = _card_case(cuda, H, seq, dtype, seq + H)
    scale = 1.0 / math.sqrt(DQK)
    kw = dict(causal=True, scale=scale)
    m0 = torch.full((H, seq), -1e30, device=cuda)
    st = (m0, torch.zeros_like(m0), torch.zeros((H, seq, DV), device=cuda))
    before = ops.launch_counts()
    got = fa.flash_attention_panel(q, k, v, *st, 0, 0, seq, **kw)
    want = fa.flash_attention_panel_plain(q, k, v, *st, 0, 0, seq, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0,
                               atol=F32_TOL)
    out_g, out_w = (s[2] / s[1].clamp(min=1e-30)[..., None]
                    for s in (got, want))
    _close(out_g, out_w, dtype)
    del got, out_g
    lse = want[0] + torch.log(want[1])
    delta = (do.float() * out_w.to(dtype).float()).sum(-1)
    args = (q, k, v, do, lse, delta, 0, 0, seq)
    dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
    dq = fa.flash_attention_bwd_dq(*args, **kw)
    after = ops.launch_counts()
    for name in ("flash_attention_panel", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    plain = fa.flash_attention_panel_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv), plain):
        _close(g, w, dtype)


# ------------------------------------------- the forward's two designs


def _wgmma_counts():
    return (fa.flash_attention_panel.launches,
            fa.flash_attention_panel.launches_wgmma)


def _fresh_state(H, sq, dv, device):
    m0 = torch.full((H, sq), -1e30, device=device)
    return m0, torch.zeros_like(m0), torch.zeros((H, sq, dv), device=device)


def _fwd_both(q, k, v, st, q_off, k_off, valid, causal, scale):
    """The kernel's and the plain version's (m, l, acc) of one panel; checks
    that the panel went to the wgmma design."""
    n, w = _wgmma_counts()
    got = fa.flash_attention_panel(q, k, v, *st[0], q_off, k_off, valid,
                                   causal=causal, scale=scale)
    want = fa.flash_attention_panel_plain(q, k, v, *st[1], q_off, k_off,
                                          valid, causal=causal, scale=scale)
    assert _wgmma_counts() == (n + 1, w + 1), "not the wgmma design"
    return got, want


def _state_close(got, want):
    """m within F32_TOL, out = acc / l within bf16's bound, and the rows
    with no live key exactly as the plain version leaves them."""
    torch.cuda.synchronize()
    live = want[1] > 0
    np.testing.assert_allclose(_np(got[0][live]), _np(want[0][live]), rtol=0,
                               atol=F32_TOL)
    out_g, out_w = (s[2][live] / s[1][live][..., None] for s in (got, want))
    assert_bf16_close(out_g, out_w)
    dead = ~live
    assert torch.equal(got[1][dead], want[1][dead])
    assert torch.equal(got[2][dead], want[2][dead])
    assert torch.equal(got[0][dead], want[0][dead])


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(DQK, DV), (128, 128), (64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_forward_matches_plain_on_card(cuda, dqk, dv, causal):
    """The wgmma design against the plain panel in bf16: ragged sq and skv
    (no tile multiples), valid_len inside a tile, then two panels with
    carried state at offsets that are no tile multiple (ring attention's
    panels), and rows with no live key (k_offset past them, causal) left
    exactly as the plain version leaves them."""
    H, sq, skv = 3, 1000, 1100
    q, k, v, _ = _inputs(H, sq, skv, dqk, dv, dqk + dv + causal,
                         torch.bfloat16, cuda)
    scale = 1.0 / math.sqrt(dqk)
    st = _fresh_state(H, sq, dv, cuda)
    # one panel, valid_len inside a tile
    _state_close(*_fwd_both(q, k, v, (st, st), 0, 0, 1037, causal, scale))
    # two panels with carried state, offsets off the tiles
    half = skv // 2
    sg = sw = st
    for kk, vv, off in ((k[:, :half], v[:, :half], 131),
                        (k[:, half:], v[:, half:], 131 + half)):
        sg, sw = _fwd_both(q, kk, vv, (sg, sw), 777, off, 1500, causal,
                           scale)
    _state_close(sg, sw)
    # k_offset past the first rows: with causal, rows 0..99 see no key
    got, want = _fwd_both(q, k, v, (st, st), 0, 100, skv + 100, causal,
                          scale)
    _state_close(got, want)
    if causal:
        assert bool((got[1][:, :100] == 0).all())
        assert bool((got[2][:, :100] == 0).all())
        assert bool((got[0][:, :100] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(DQK, DV), (128, 128)])
def test_wgmma_forward_strided_views_on_card(cuda, dqk, dv):
    """(seq, heads, d) activations viewed as (heads, seq, d), as the models
    pass them: the tensor maps take the strides, no copy; the single panel
    through the wgmma design against the plain one."""
    H, seq, valid = 4, 2500, 2431
    g = torch.Generator(device=cuda).manual_seed(dqk)
    q, k, v = (torch.randn((seq, H, w), generator=g, device=cuda)
               .to(torch.bfloat16).transpose(0, 1) for w in (dqk, dqk, dv))
    assert q.stride() == (dqk, H * dqk, 1)
    scale = 1.0 / math.sqrt(dqk)
    n, w = _wgmma_counts()
    got, lse_g = fa.flash_attention_single_panel(q, k, v, valid, causal=True,
                                                 scale=scale)
    assert _wgmma_counts() == (n + 1, w + 1)
    want, lse_w = fa.flash_attention_single_panel_plain(
        q, k, v, valid, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert_bf16_close(got, want)
    np.testing.assert_allclose(_np(lse_g), _np(lse_w), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_forward_design_routing_on_card(cuda):
    """f32, an unaligned view and d = 16 go to the mma.sync design (and
    still match the plain version); the launch counts say which ran."""
    H, sq = 2, 300
    scale = 0.125
    g = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn(H * sq * DQK + 8, generator=g, device=cuda).to(
        torch.bfloat16)
    unaligned = buf[1:1 + H * sq * DQK].view(H, sq, DQK)
    assert unaligned.data_ptr() % 16
    cases = [
        ("f32", *_inputs(H, sq, sq, DQK, DV, 1, torch.float32, cuda)[:3]),
        ("unaligned", unaligned, unaligned,
         _inputs(H, sq, sq, DQK, DV, 2, torch.bfloat16, cuda)[2]),
        ("d16", *_inputs(H, sq, sq, 16, 16, 3, torch.bfloat16, cuda)[:3]),
    ]
    for name, q, k, v in cases:
        st = _fresh_state(H, sq, v.shape[-1], cuda)
        n, w = _wgmma_counts()
        got = fa.flash_attention_panel(q, k, v, *st, 0, 0, sq, causal=True,
                                       scale=scale)
        assert _wgmma_counts() == (n + 1, w), name
        want = fa.flash_attention_panel_plain(q, k, v, *st, 0, 0, sq,
                                              causal=True, scale=scale)
        torch.cuda.synchronize()
        out_g, out_w = (s[2] / s[1][..., None] for s in (got, want))
        _close(out_g, out_w, q.dtype)
