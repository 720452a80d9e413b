"""The flash backward, and ring and Ulysses attention, against the JAX package.

- ``flash_attention_panel_bwd_plain`` against the JAX
  ``flash_attention_panel_bwd`` (Pallas in interpret mode), with ``lse`` and
  ``delta`` from the JAX forward panel.
- :class:`FlashAttention` (the autograd function ring and Ulysses attention
  train through) against autograd through ``attention_reference``.
- ``ring_attention`` (every backend) and ``ulysses_attention``, forward and
  gradients, against the JAX functions on a one-device mesh, at 249 tokens:
  no multiple of 128, so the pad and ``valid_len`` masking run.

On the CPU the port's wrappers run their plain versions. Tolerances: f32
rtol and atol 1e-5 against the JAX package (both sides f32, another
summation order); bf16 inputs per element, two bf16 ulps of the reference
plus 2^-8 · max |reference| (p and ds are rounded to bf16 on both sides at
points where their f32 scores differ by a few ulps, so a rounding may land
one step apart). An emulation of TF32 rounding shows on the CPU why the f32
kernels multiply in three TF32 passes. The ``cuda``-marked tests hold the
CUDA kernels against the plain versions on the card and skip where there is
none.
"""

import importlib
import math
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.mesh import create_mesh
from marlin_tpu.ops import flash_attention as jfa
from marlin_tpu_torch import config_context
from marlin_tpu_torch import ops
from marlin_tpu_torch.ops import flash_attention as fa

# the modules (both packages' ``parallel`` export functions of these names)
jra = importlib.import_module("marlin_tpu.parallel.ring_attention")
jul = importlib.import_module("marlin_tpu.parallel.ulysses")
tra = importlib.import_module("marlin_tpu_torch.parallel.ring_attention")
tul = importlib.import_module("marlin_tpu_torch.parallel.ulysses")

F32_TOL = 1e-5
BF16_ATOL = 2.0 ** -8
SEQ = 249


@pytest.fixture(scope="module")
def jmesh():
    return create_mesh((1, 1))


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
    """Every element within two bf16 ulps of ``want`` plus BF16_ATOL times
    max |want|."""
    got, want = _np(got), _np(want)
    _, e = np.frexp(want)  # |want| = m * 2^e, m in [0.5, 1): ulp 2^(e - 8)
    tol = (np.where(want != 0, np.ldexp(2.0, e - 8), 0.0)
           + BF16_ATOL * np.abs(want).max())
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} elements off, max |err| "
                           f"{float(np.abs(got - want).max())}")


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


# ------------------------------------------------- plain backward vs JAX


def _jax_panel_bwd(rng, sq, skv, d, q_off, k_off, valid, causal, bf16):
    """Random q, k, v, dO; lse and delta from the JAX forward panel; the JAX
    backward's (dq, dk, dv). Returns the inputs as numpy f32 (rounded to
    bf16 when ``bf16``) and the JAX grads."""
    scale = 1.0 / math.sqrt(d)
    ins = [rng.standard_normal((n, d)).astype(np.float32)
           for n in (sq, skv, skv, sq)]
    if bf16:
        ins = [a.astype(ml_dtypes.bfloat16) for a in ins]
    q, k, v, do = (jnp.asarray(a) for a in ins)
    m, l, acc = jfa.flash_attention_panel(
        q, k, v, jnp.full((sq,), -1e30, jnp.float32),
        jnp.zeros((sq,), jnp.float32), jnp.zeros((sq, d), jnp.float32),
        q_off, k_off, valid, causal=causal, scale=scale, bq=128, bkv=128,
        interpret=True)
    lf = jnp.maximum(l, 1e-30)
    lse = m + jnp.log(lf)
    out = (acc / lf[:, None]).astype(q.dtype)
    delta = jnp.sum(do.astype(jnp.float32) * out.astype(jnp.float32), -1)
    want = jfa.flash_attention_panel_bwd(
        q, k, v, do, lse, delta, q_off, k_off, valid, causal=causal,
        scale=scale, bq=128, bkv=128, interpret=True)
    return ([np.asarray(a, np.float32) for a in ins]
            + [np.asarray(lse), np.asarray(delta)], want)


@pytest.mark.parametrize("sq,skv,q_off,k_off,valid,causal,bf16", [
    (256, 256, 0, 0, 256, True, False),
    (256, 256, 0, 0, 200, False, False),
    (256, 256, 0, 0, 231, True, False),
    (256, 256, 300, 37, 500, True, False),   # a later panel of a ring
    (256, 128, 128, 256, 384, True, False),  # rows all past the panel
    (256, 256, 0, 0, 230, True, True),
    (256, 256, 128, 0, 250, False, True),
])
def test_panel_bwd_plain_matches_jax(sq, skv, q_off, k_off, valid, causal,
                                     bf16):
    rng = np.random.default_rng(sq + skv + q_off + valid)
    (q, k, v, do, lse, delta), want = _jax_panel_bwd(
        rng, sq, skv, 64, q_off, k_off, valid, causal, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    got = fa.flash_attention_panel_bwd_plain(
        *(_torch(a, dt) for a in (q, k, v, do)), _torch(lse), _torch(delta),
        q_off, k_off, valid, causal=causal, scale=1.0 / 8.0, bq=128, bkv=128)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if bf16:
            assert_bf16_close(g, w)
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)


# head dims past 128, which the card's d <= 256 instances take (d = 192 pads
# to 256 there); the plain version is the kernels' CPU side
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal,valid,q_off", [(True, 231, 0),
                                                (False, 200, 0),
                                                (True, 250, 40)])
def test_panel_bwd_plain_wide_head_matches_jax(d, causal, valid, q_off):
    rng = np.random.default_rng(d + valid + q_off)
    (q, k, v, do, lse, delta), want = _jax_panel_bwd(
        rng, 256, 256, d, q_off, 0, valid, causal, False)
    got = fa.flash_attention_panel_bwd_plain(
        *(_torch(a) for a in (q, k, v, do)), _torch(lse), _torch(delta),
        q_off, 0, valid, causal=causal, scale=1.0 / math.sqrt(d), bq=128,
        bkv=128)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (256, d), name
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)


def _tf32(x):
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to 10 explicit
    mantissa bits, ties away from zero. Adding half of the last kept bit to
    the bit pattern and clearing the 13 low bits rounds the magnitude and
    leaves the sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """``a @ b`` of f32 matrices as the backward kernel's tensor cores form
    it: each operand split into TF32 ``big`` and ``small = tf32(x - big)``;
    one pass is big·big, three add small·big and big·small. Every product of
    two TF32 values is exact in the f32 sum."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def _bwd_products(q, k, v, do, lse, delta, live, scale, mm):
    """The backward's five products through ``mm`` in the inputs' dtype:
    S = Q·Kᵀ, dP = dO·Vᵀ, dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K."""
    s = mm(q, k.T) * scale
    p = torch.where(live, torch.exp(s - lse[:, None]), 0.0)
    ds = p * (mm(do, v.T) - delta[:, None])
    return mm(ds, k) * scale, mm(ds.T, q) * scale, mm(p.T, do)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("causal,valid", [(True, 256), (False, 200)])
def test_tf32_passes_against_f64(passes, causal, valid):
    """Why the f32 kernels take three TF32 passes: with an emulation of the
    tensor cores' TF32 products, three passes keep (dq, dk, dv) within
    ``chip_smoke.py``'s f32 backward bound of float64, at the order of the
    f32 plain version's own error; one pass does not."""
    from chip_smoke import BWD_F32_ATOL, BWD_F32_RTOL

    rng = np.random.default_rng(valid + passes)
    sq = skv = 256
    d, scale = 64, 1.0 / 8.0
    q, k, v, do = (torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)) for n in (sq, skv, skv, sq))
    pos = torch.arange(sq)
    live = (pos[None, :] < valid).expand(sq, skv)
    if causal:
        live = live & (pos[:, None] >= pos[None, :])
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s64 = torch.where(live, q64 @ k64.T * scale, -torch.inf)
    lse64 = torch.logsumexp(s64, -1)
    delta64 = (do64 * (torch.softmax(s64, -1) @ v64)).sum(-1)
    want = _bwd_products(q64, k64, v64, do64, lse64, delta64, live, scale,
                         torch.matmul)
    lse, delta = lse64.float(), delta64.float()
    got = _bwd_products(q, k, v, do, lse, delta, live, scale,
                        lambda a, b: _mm_tf32(a, b, passes))
    plain = fa.flash_attention_panel_bwd_plain(
        q, k, v, do, lse, delta, 0, 0, valid, causal=causal, scale=scale,
        bq=128, bkv=128)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        bound = BWD_F32_ATOL * w.abs().max() + BWD_F32_RTOL * w.abs()
        worst = float(((g.double() - w).abs() / bound).max())
        err, err_plain = (float((t.double() - w).abs().max()) for t in (g, p))
        if passes == 3:
            assert worst <= 1.0, (name, worst)
            assert err <= 10 * err_plain, (name, err, err_plain)
        else:
            assert worst > 1.0, (name, worst)


def test_panel_bwd_heads_axis_and_wrapper():
    """A leading heads axis gives each head's single-panel result, the
    wrapper runs the plain version for CPU tensors, and the kernel wrappers
    refuse CPU tensors (no fallback) without counting a launch."""
    gen = torch.Generator().manual_seed(3)
    H, sq, skv, d = 3, 160, 96, 16
    q, do = (torch.randn((H, sq, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((H, skv, d), generator=gen) for _ in range(2))
    lse = torch.randn((H, sq), generator=gen) + 3.0
    delta = torch.randn((H, sq), generator=gen)
    kw = dict(causal=True, scale=0.3)
    args = (q, k, v, do, lse, delta, 40, 10, 150)
    ops.reset_launch_counts()
    dq, dk, dv = fa.flash_attention_panel_bwd(*args, **kw)
    for h in range(H):
        one = fa.flash_attention_panel_bwd_plain(
            q[h], k[h], v[h], do[h], lse[h], delta[h], 40, 10, 150, **kw)
        for a, b in zip((dq[h], dk[h], dv[h]), one):
            np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL,
                                       atol=F32_TOL)
    for wrapper in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(*args, **kw)
    assert ops.launch_counts()["flash_attention_bwd_dkv"] == 0
    assert ops.launch_counts()["flash_attention_bwd_dq"] == 0
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_panel_bwd(q, k, v, do, lse[:, 1:], delta, 0, 0,
                                     sq, **kw)
    with pytest.raises(ValueError, match="do"):
        fa.flash_attention_panel_bwd(q, k, v, do[:, 1:], lse, delta, 0, 0,
                                     sq, **kw)
    with pytest.raises(TypeError, match="do"):
        fa.flash_attention_panel_bwd(q, k, v, do.double(), lse, delta, 0, 0,
                                     sq, **kw)


@pytest.mark.parametrize("causal,valid", [(True, 200), (False, 200),
                                          (True, 170)])
def test_flash_autograd_matches_reference(causal, valid):
    """FlashAttention's output and grads against autograd through
    attention_reference on the first ``valid`` positions; rows and keys past
    ``valid_len`` (the pad, whose output the callers slice off) get no
    gradient."""
    gen = torch.Generator().manual_seed(valid)
    H, S, d = 2, 200, 16
    q, k, v = (torch.randn((H, S, d), generator=gen).requires_grad_()
               for _ in range(3))
    w = torch.randn((H, S, d), generator=gen)
    w[:, valid:] = 0.0
    out = fa.FlashAttention.apply(q, k, v, valid, causal, 0.25)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    qr, kr, vr = (t.detach()[:, :valid].requires_grad_() for t in (q, k, v))
    ref = tra.attention_reference(qr, kr, vr, causal=causal, scale=0.25)
    want = torch.autograd.grad((ref * w[:, :valid]).sum(), (qr, kr, vr))
    np.testing.assert_allclose(_np(out[:, :valid]), _np(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g[:, :valid]), _np(r), rtol=F32_TOL,
                                   atol=F32_TOL)
    for g in got:
        assert not bool(g[:, valid:].any())


# ------------------------------------------- ring and Ulysses vs the JAX ones


def _qkvw(seed, heads=2, seq=SEQ, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((heads, seq, d)).astype(np.float32)
            for _ in range(4)]


def _jax_fwd_grads(fn, q, k, v, w):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    out = fn(*(jnp.asarray(a) for a in (q, k, v)))
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out, np.float32), [np.asarray(g) for g in grads]


def _torch_fwd_grads(fn, q, k, v, w):
    ts = [_torch(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad((out.float() * _torch(w)).sum(), ts)
    return out, grads


@pytest.mark.parametrize("backend,causal", [("xla", True), ("xla", False),
                                            ("flash", True), ("flash", False),
                                            ("auto", True)])
def test_ring_attention_matches_jax(jmesh, backend, causal):
    q, k, v, w = _qkvw(1)
    want, wgrads = _jax_fwd_grads(
        lambda q, k, v: jra.ring_attention(q, k, v, jmesh, causal=causal,
                                           backend=backend), q, k, v, w)
    with config_context(device="cpu"):
        got, grads = _torch_fwd_grads(
            lambda q, k, v: tra.ring_attention(q, k, v, causal=causal,
                                               backend=backend), q, k, v, w)
    assert got.shape == (2, SEQ, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=F32_TOL, atol=F32_TOL)
    for g, r in zip(grads, wgrads):
        np.testing.assert_allclose(_np(g), r, rtol=F32_TOL, atol=F32_TOL)


def test_ring_attention_2d_and_batch_dims(jmesh):
    """(seq, d) and (batch, heads, seq, d) inputs fold like the JAX one's."""
    q, k, v, _ = _qkvw(2, heads=4)
    want = np.asarray(jra.ring_attention(
        *(jnp.asarray(a.reshape(2, 2, SEQ, 16)) for a in (q, k, v)), jmesh,
        causal=True, backend="xla"))
    with config_context(device="cpu"):
        got = tra.ring_attention(*(_torch(a.reshape(2, 2, SEQ, 16))
                                   for a in (q, k, v)), causal=True)
        one = tra.ring_attention(*(_torch(a[0]) for a in (q, k, v)),
                                 causal=True, backend="flash")
    np.testing.assert_allclose(_np(got), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(one), want[0, 0], rtol=F32_TOL,
                               atol=F32_TOL)


def test_ring_attention_long_sequence_pads_to_tiles(jmesh):
    """Past _KV_TILE tokens the panel pads to tile multiples and the XLA path
    folds several tiles; flash and xla agree with the JAX function."""
    q, k, v, _ = _qkvw(3, heads=1, seq=2100, d=8)
    want = np.asarray(jra.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         jmesh, causal=True, backend="xla"))
    for backend in ("xla", "flash"):
        got = tra.ring_attention(*(_torch(a) for a in (q, k, v)), causal=True,
                                 backend=backend)
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=backend)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_attention_matches_jax(jmesh, causal):
    q, k, v, w = _qkvw(4)
    want, wgrads = _jax_fwd_grads(
        lambda q, k, v: jul.ulysses_attention(q, k, v, jmesh, causal=causal),
        q, k, v, w)
    got, grads = _torch_fwd_grads(
        lambda q, k, v: tul.ulysses_attention(q, k, v, causal=causal),
        q, k, v, w)
    np.testing.assert_allclose(_np(got), want, rtol=F32_TOL, atol=F32_TOL)
    for g, r in zip(grads, wgrads):
        np.testing.assert_allclose(_np(g), r, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("which", ["ring_xla", "ring_flash", "ulysses"])
def test_bf16_precision_matches_jax(jmesh, which):
    """precision="default" casts q/k/v to bf16 for the products; the output
    keeps the f32 input dtype."""
    q, k, v, w = _qkvw(5)
    if which == "ulysses":
        jf = lambda q, k, v: jul.ulysses_attention(  # noqa: E731
            q, k, v, jmesh, causal=True, precision="default")
        tf = lambda q, k, v: tul.ulysses_attention(  # noqa: E731
            q, k, v, causal=True, precision="default")
    else:
        b = which[5:]
        jf = lambda q, k, v: jra.ring_attention(  # noqa: E731
            q, k, v, jmesh, causal=True, backend=b, precision="default")
        tf = lambda q, k, v: tra.ring_attention(  # noqa: E731
            q, k, v, causal=True, backend=b, precision="default")
    want, wgrads = _jax_fwd_grads(jf, q, k, v, w)
    got, grads = _torch_fwd_grads(tf, q, k, v, w)
    assert got.dtype == torch.float32
    assert_bf16_close(got, want)
    for g, r in zip(grads, wgrads):
        assert_bf16_close(g, r)


def test_attention_reference_matches_jax():
    q, k, v, _ = _qkvw(6, heads=3, seq=40)
    for causal in (True, False):
        want = np.asarray(jra.attention_reference(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
        got = tra.attention_reference(*(_torch(a) for a in (q, k, v)),
                                      causal=causal)
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL,
                                   atol=F32_TOL)


def test_backend_resolution_and_errors():
    """"auto" is the kernel on a CUDA device up to the flash kernels' head
    dim of 256, and the tiled plain path above it and elsewhere; bad knobs
    and meshes wider than one device raise."""
    res = tra.resolve_attention_backend
    assert res("auto", "cuda", 128) == "flash"
    assert res("auto", torch.device("cuda", 0), 64) == "flash"
    assert res("auto", "cuda", 256) == "flash"
    assert res("auto", "cuda", 257) == "xla"
    assert res("auto", "cpu", 64) == "xla"
    assert res("flash", "cpu", 256) == "flash"
    assert res("xla", "cuda", 64) == "xla"
    x = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="backend"):
        tra.ring_attention(x, x, x, backend="dense")
    with pytest.raises(ValueError, match="precision"):
        tra.ring_attention(x, x, x, precision="low")
    with pytest.raises(ValueError, match="precision"):
        tul.ulysses_attention(x, x, x, precision="low")
    with pytest.raises(ValueError, match="mismatch"):
        tra.ring_attention(x, x[:, :4], x)
    with pytest.raises(ValueError, match="heads"):
        tul.ulysses_attention(x[0], x[0], x[0])
    wide = types.SimpleNamespace(shape={"rows": 2, "cols": 1})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        tra.ring_attention(x, x, x, wide)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        tul.ulysses_attention(x, x, x, wide)


# ----------------------------------------------------- the card's kernels


def _cuda_case(H, sq, skv, d, dtype, strided, gen):
    def make(n):
        if strided:  # (seq, heads, d) projections viewed as (heads, seq, d)
            return torch.randn((n, H, d), generator=gen,
                               device="cuda").to(dtype).permute(1, 0, 2)
        return torch.randn((H, n, d), generator=gen, device="cuda").to(dtype)
    return make(sq), make(skv), make(skv), make(sq)


def _bwd_case(dtype, strided, causal, d, sq, skv, q_off, k_off, valid):
    """The backward's inputs for 2 heads: q, k, v, dO and lse, delta from the
    plain forward panel; returns the positional args and the scale."""
    gen = torch.Generator(device="cuda").manual_seed(d + sq + skv + valid)
    q, k, v, do = _cuda_case(2, sq, skv, d, dtype, strided, gen)
    scale = 1.0 / math.sqrt(d)
    m, l, acc = fa.flash_attention_panel_plain(
        q, k, v, torch.full((2, sq), -1e30, device="cuda"),
        torch.zeros((2, sq), device="cuda"),
        torch.zeros((2, sq, d), device="cuda"), q_off, k_off, valid,
        causal=causal, scale=scale)
    lf = l.clamp(min=1e-30)
    lse = m + torch.log(lf)
    delta = (do.float() * (acc / lf[..., None]).to(dtype).float()).sum(-1)
    if sq == skv == 1:
        # with one key the forward's delta makes ds exactly 0, and dq and dk
        # would hold rounding noise alone; a shifted delta gives them values
        delta = delta + 1.0
    return (q, k, v, do, lse, delta, q_off, k_off, valid), scale


# The kernels keep 128 rows resident and stream 32-row tiles up to d = 128,
# and 64 rows against 16-row (f32) or 32-row (bf16) tiles up to d = 256.
# d = 40 takes the 16-byte copies (40 elements are 160 or 80 bytes); d = 41
# and d = 201 (odd row strides) the element-wise variant.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided,causal,d,sq,skv,q_off,k_off,valid", [
    (False, True, 128, 300, 300, 0, 0, 300),
    (True, True, 128, 300, 300, 0, 0, 299),
    (False, False, 64, 300, 300, 0, 0, 250),
    (False, True, 96, 300, 257, 777, 131, 1500),
    (False, True, 128, 1, 1, 0, 0, 1),           # sq = skv = 1
    (False, True, 128, 161, 161, 0, 0, 161),     # 128 + 33 rows
    (False, True, 128, 300, 20, 0, 0, 20),       # skv inside one tile
    (False, True, 64, 300, 300, 0, 0, 5),        # valid_len in the first tile
    (False, True, 40, 300, 300, 0, 0, 299),
    (True, True, 40, 300, 300, 0, 0, 299),
    (False, True, 41, 300, 300, 0, 0, 299),
    (True, False, 41, 200, 150, 0, 0, 150),
    (False, True, 128, 200, 333, 1000, 700, 1500),  # sq != skv, offsets
    (False, False, 128, 333, 200, 64, 0, 180),
    (False, True, 160, 300, 300, 0, 0, 299),
    (False, True, 192, 300, 300, 0, 0, 299),
    (False, True, 256, 300, 300, 0, 0, 299),
    (True, True, 256, 300, 300, 0, 0, 281),
    (False, False, 256, 200, 333, 64, 0, 300),
    (False, True, 256, 200, 333, 1000, 700, 1500),
    (False, True, 256, 70, 17, 0, 0, 17),        # inside one tile each way
    (False, True, 201, 150, 150, 0, 0, 149),
])
def test_bwd_kernels_match_plain_on_card(cuda, dtype, strided, causal, d, sq,
                                         skv, q_off, k_off, valid):
    args, scale = _bwd_case(dtype, strided, causal, d, sq, skv, q_off,
                            k_off, valid)
    before = ops.launch_counts()
    got = fa.flash_attention_panel_bwd(*args, causal=causal, scale=scale)
    after = ops.launch_counts()
    want = fa.flash_attention_panel_bwd_plain(*args, causal=causal,
                                              scale=scale)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    for g, w in zip(got, want):
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            assert_bf16_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256])
def test_bwd_kernels_bit_identical_across_launches(cuda, dtype, d):
    """One writer per output element and no atomics: two launches on the
    same inputs give the same bits."""
    args, scale = _bwd_case(dtype, False, True, d, 1000, 1000, 0, 0, 999)
    kw = dict(causal=True, scale=scale)
    first = fa.flash_attention_panel_bwd(*args, **kw)
    second = fa.flash_attention_panel_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wide_head_raises_on_card(cuda):
    """On the card ring attention "auto" and Ulysses run the flash kernels
    up to head dim 256 and give "xla"'s output; above it they take the tiled
    path (no kernel launched), and an explicit "flash" raises, since the
    kernels could not run."""
    x = torch.randn((2, 256, 256), device=cuda)
    want = tra.ring_attention(x, x, x, causal=True, backend="xla")
    for fn in (lambda: tra.ring_attention(x, x, x, causal=True),
               lambda: tul.ulysses_attention(x, x, x, causal=True)):
        ops.reset_launch_counts()
        out = fn()
        assert ops.launch_counts()["flash_attention_panel"] == 1
        np.testing.assert_allclose(_np(out), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    y = torch.randn((2, 256, 320), device=cuda)
    want = tra.ring_attention(y, y, y, causal=True, backend="xla")
    for fn in (lambda: tra.ring_attention(y, y, y, causal=True),
               lambda: tul.ulysses_attention(y, y, y, causal=True)):
        ops.reset_launch_counts()
        out = fn()
        assert not any(ops.launch_counts().values())
        np.testing.assert_allclose(_np(out), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    with pytest.raises(ValueError, match="exceeds the flash kernels' 256"):
        tra.ring_attention(y, y, y, causal=True, backend="flash")


@pytest.mark.cuda
def test_wide_head_ring_flash_step_on_card_matches_xla(cuda):
    """dh 256: a training step of a one-layer LM through ring attention
    "flash" (the forward, dK/dV and dQ kernels, one launch each) against the
    same step through "xla" on the card: the loss, and every gradient leaf
    within F32_TOL."""
    from marlin_tpu_torch.models import transformer as tt

    toks = np.random.default_rng(5).integers(0, 64, 300).astype(np.int32)
    params = tt.TransformerLM(vocab=64, d_model=512, heads=2, layers=1,
                              seed=5).init_params(device=cuda)
    got = {}
    for attn in ("ring_flash", "ring_xla"):
        ops.reset_launch_counts()
        loss, grads = tt.lm_value_and_grad(params, toks, heads=2, attn=attn)
        _, _, step_loss = tt.lm_train_step(params, tt.adam_init(params),
                                           toks, None, 2, attn, False,
                                           "high", 3e-3)
        counts = ops.launch_counts()
        for name in ("flash_attention_panel", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq"):
            assert counts[name] == (2 if attn == "ring_flash" else 0), counts
        got[attn] = (float(loss), float(step_loss), grads)
    (lf, sf, gf), (lx, sx, gx) = got["ring_flash"], got["ring_xla"]
    np.testing.assert_allclose([lf, sf], [lx, sx], rtol=F32_TOL)
    pairs = []
    tt._tree_map(lambda a, b: pairs.append((a, b)), gf, gx)
    assert pairs
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
def test_ring_and_ulysses_on_card_match_cpu(cuda):
    """Forward and grads on the card (flash kernels) against the CPU's plain
    versions."""
    q, k, v, w = _qkvw(7, seq=1000, d=64)
    for fn in (lambda q, k, v: tra.ring_attention(q, k, v, causal=True),
               lambda q, k, v: tul.ulysses_attention(q, k, v, causal=True)):
        want, wgrads = _torch_fwd_grads(fn, q, k, v, w)
        ts = [_torch(a).to(cuda).requires_grad_() for a in (q, k, v)]
        out = fn(*ts)
        grads = torch.autograd.grad((out * _torch(w).to(cuda)).sum(), ts)
        np.testing.assert_allclose(_np(out), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
        for g, r in zip(grads, wgrads):
            np.testing.assert_allclose(_np(g), _np(r), rtol=F32_TOL,
                                       atol=F32_TOL)
