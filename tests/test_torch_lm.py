"""The port's transformer LM against the JAX package's, on the CPU.

The JAX model's params (numpy) are carried into the port with
``interop.lm_params_from_numpy``; the same prompts and seeds then go through
both packages. Contracts:

- token streams are EQUAL — greedy and sampled (the threefry port gives the
  JAX package's keys and Gumbel noise) — from ``lm_generate`` (dense and
  flash prefill), ``lm_generate_batch`` (ragged), ``lm_prefill_paged`` and
  ``lm_decode_paged`` with both backends;
- logits agree within 1e-4 relative to their largest magnitude (f32 sums in
  torch and XLA may differ in the last ulps);
- KV pages agree within 1e-5 (f32).

The JAX paged decode's Pallas kernel cannot run on this tree, so the JAX
side is always ``kernel="gather"``. The ``cuda``-marked tests hold the card's
kernel paths against the plain ones and skip where there is no card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu import mesh as jax_mesh
from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import planner as jplanner
from marlin_tpu.models import transformer as jt
from marlin_tpu_torch import interop, threefry
from marlin_tpu_torch.models import planner as tplanner
from marlin_tpu_torch.models import transformer as tt

HEADS = 4
KV_HEADS = 2  # GQA: 2 query heads per K/V head
PAGE_LEN = 8
LOGIT_RTOL = 1e-4
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return JaxLM(vocab=64, d_model=32, heads=HEADS, layers=2,
                 kv_heads=KV_HEADS, seed=11).init_params()


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_logits_close(got, want):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)


# ------------------------------------------------------------------ threefry


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2 ** 32 - 1])
def test_threefry_bits_match_jax(seed):
    """Keys, fold_in, split and random bits are bit-exact; uniform too;
    Gumbel noise within an f32 ulp (the two frameworks' log); categorical
    draws equal."""
    k = jax.random.key(seed)
    kt = threefry.prng_key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(k)), kt.numpy())
    for step in (0, 1, 2, 63, 1000, 2 ** 31 + 5):
        want = jax.random.key_data(jax.random.fold_in(k, np.uint32(step)))
        assert np.array_equal(np.asarray(want), threefry.fold_in(kt, step).numpy())
    for num in (2, 5):
        want = jax.random.key_data(jax.random.split(k, num))
        assert np.array_equal(np.asarray(want), threefry.split(kt, num).numpy())
    bits = np.asarray(jax.random.bits(k, (3, 17))).astype(np.int64)
    assert np.array_equal(bits, threefry.random_bits(kt, (3, 17)).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(k, (257,))),
                          threefry.uniform(kt, (257,)).numpy())
    np.testing.assert_allclose(threefry.gumbel(kt, (257,)).numpy(),
                               np.asarray(jax.random.gumbel(k, (257,))),
                               rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(seed % 1000).standard_normal(
        (4, 50)).astype(np.float32)
    assert np.array_equal(
        np.asarray(jax.random.categorical(k, logits)),
        threefry.categorical(kt, torch.from_numpy(logits)).numpy())


def test_threefry_row_streams_match_jax():
    """The per-row streams fold_in(key(seed), step) of the paged decode,
    batched, for a grid of (seed, step)."""
    seeds = np.array([0, 1, 5, 99, 2 ** 31, 2 ** 32 - 1], np.uint32)
    steps = np.array([0, 1, 2, 3, 64, 1000], np.int32)
    want = np.stack([np.asarray(jax.random.key_data(jt._row_key(s, t)))
                     for s, t in zip(seeds, steps)])
    assert np.array_equal(want, tt._row_keys(seeds, steps, "cpu").numpy())


# ------------------------------------------------------- params and layers


def test_params_interop_and_init(jparams, tparams):
    assert set(tparams) == set(jparams)
    for name in jparams:
        if isinstance(jparams[name], dict):
            for k, v in jparams[name].items():
                assert tparams[name][k].shape == v.shape
                assert np.array_equal(tparams[name][k].numpy(), np.asarray(v))
        else:
            assert np.array_equal(tparams[name].numpy(), np.asarray(jparams[name]))
    own = tt.init_transformer(0, 64, 32, HEADS, 2, kv_heads=KV_HEADS,
                              device="cpu")
    for name in jparams:
        if isinstance(jparams[name], dict):
            for k, v in jparams[name].items():
                assert own[name][k].shape == v.shape
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_transformer(0, 64, 32, HEADS, 2, n_experts=4, device="cpu")
    with pytest.raises(ValueError, match="kv_heads"):
        tt.init_transformer(0, 64, 32, 4, 2, kv_heads=3, device="cpu")
    moe = {"l0": {"moe": {}, "wq": np.zeros((2, 2))}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        interop.lm_params_from_numpy(moe, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_head_logits_match(jparams, tparams, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    g = np.array(jparams["ln_f"])
    np.testing.assert_allclose(
        tt._rmsnorm(xt, torch.from_numpy(g)).float().numpy(),
        np.asarray(jt._rmsnorm(xj, jparams["ln_f"]), np.float32),
        rtol=1e-5 if dtype == "float32" else 2 ** -7, atol=1e-6)
    got = tt._head_logits(xt, tparams["emb"])
    assert got.dtype == torch.float32
    _assert_logits_close(got, jt._head_logits(xj, jparams["emb"]))


# ----------------------------------------------------------------- generate


def _jax_generate(jparams, prompt, seed, steps, **kw):
    return np.asarray(jt.lm_generate(
        jparams, np.asarray(prompt, np.int32), jax.random.key(seed),
        heads=HEADS, max_len=len(prompt) + steps, steps=steps, **kw))


SAMPLING = [dict(), dict(temperature=0.8), dict(temperature=1.0, top_p=0.9),
            dict(temperature=0.7, top_k=5)]


@pytest.mark.parametrize("kw", SAMPLING)
def test_lm_generate_matches_jax(jparams, tparams, kw):
    """Dense prefill (prompt below _PREFILL_FLASH_MIN): greedy and sampled
    streams equal the JAX package's."""
    prompt = (np.arange(13) * 5) % 64
    want = _jax_generate(jparams, prompt, 5, 10, **kw)
    got = tt.lm_generate(tparams, prompt, 5, heads=HEADS,
                         max_len=len(prompt) + 10, steps=10, **kw)
    assert got.tolist() == want.tolist()


def test_prefill_and_decode_logits_match(jparams, tparams):
    """The logits behind the streams: prefill and one cached decode step
    agree within the stated tolerance, and so do the caches."""
    prompt = (np.arange(13) * 5) % 64
    lj, cj = jt._prefill(jparams, jnp.asarray(prompt, jnp.int32), HEADS, 16,
                         jnp.float32)
    lt, ct = tt._prefill(tparams, torch.from_numpy(prompt).long(), HEADS, 16,
                         torch.float32)
    _assert_logits_close(lt, lj)
    for name in cj:
        for a, b in zip(cj[name], ct[name]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=KV_TOL,
                                       atol=KV_TOL)
    x = np.array(jparams["emb"])[7]
    lj, _ = jt._decode_step(jparams, jnp.asarray(x), cj, 13, HEADS)
    lt, _ = tt._decode_step(tparams, torch.from_numpy(x), ct, 13, HEADS)
    _assert_logits_close(lt, lj)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.9)])
def test_lm_generate_flash_prefill_matches_jax(jparams, tparams, monkeypatch,
                                               kw):
    """With _PREFILL_FLASH_MIN lowered (as tests/test_transformer.py does),
    the prompt goes through the flash panel on both sides — padded to 128
    with valid_len masking the pad — and the streams still agree."""
    monkeypatch.setattr(jt, "_PREFILL_FLASH_MIN", 16)
    monkeypatch.setattr(tt, "_PREFILL_FLASH_MIN", 16)
    prompt = (np.arange(100) * 7) % 64
    want = _jax_generate(jparams, prompt, 3, 6, **kw)
    got = tt.lm_generate(tparams, prompt, 3, heads=HEADS, max_len=106,
                         steps=6, **kw)
    assert got.tolist() == want.tolist()
    lj, _ = jt._prefill(jparams, jnp.asarray(prompt, jnp.int32), HEADS, 106,
                        jnp.float32)
    lt, _ = tt._prefill(tparams, torch.from_numpy(prompt).long(), HEADS, 106,
                        torch.float32)
    _assert_logits_close(lt, lj)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_k=8)])
def test_lm_generate_batch_ragged_matches_jax(jparams, tparams, kw):
    prompts = [(np.arange(n) * 3 + n) % 64 for n in (5, 12, 9)]
    lengths = np.array([len(p) for p in prompts], np.int32)
    padded = np.zeros((3, 12), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    want = np.asarray(jt.lm_generate_batch(
        jparams, padded, lengths, jax.random.key(2), heads=HEADS, max_len=20,
        steps=7, **kw))
    got = tt.lm_generate_batch(tparams, padded, lengths, 2, heads=HEADS,
                               max_len=20, steps=7, **kw)
    for b in range(3):
        n = lengths[b]
        assert got[b, :n + 7].tolist() == want[b, :n + 7].tolist()


def test_facade_matches_jax(jparams, tparams):
    jlm = JaxLM(vocab=64, d_model=32, heads=HEADS, layers=2,
                kv_heads=KV_HEADS, seed=11)
    tlm = tt.TransformerLM(vocab=64, d_model=32, heads=HEADS, layers=2,
                           kv_heads=KV_HEADS, seed=11)
    prompt = np.arange(6) % 64
    assert tlm.generate(tparams, prompt, steps=5, temperature=0.6).tolist() \
        == np.asarray(jlm.generate(jparams, prompt, steps=5,
                                   temperature=0.6)).tolist()
    prompts = [np.arange(4) % 64, np.arange(9) % 64]
    for a, b in zip(tlm.generate_batch(tparams, prompts, steps=4),
                    jlm.generate_batch(jparams, prompts, steps=4)):
        assert a.tolist() == np.asarray(b).tolist()
    # train: the first step's loss is the JAX package's lm_loss (training is
    # held against JAX in tests/test_torch_train.py); checkpoints wait
    toks = np.arange(10) % 64
    _, losses = tlm.train(toks, steps=1, params=tparams)
    want = jt.lm_loss(jparams, toks, jax_mesh.create_mesh((1, 1)),
                      heads=HEADS)
    np.testing.assert_allclose(losses[0], float(want), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.train(toks, checkpoint_dir="ckpt")
    assert tlm.init_params(device="cpu")["l1"]["wk"].shape == (32, 16)


# -------------------------------------------------------------------- paged


def _prefill_row(T, params, pages, table, prompt, chunk, **kw):
    """Chunked prefill of ``prompt`` into ``table``'s pages; returns
    ``(pages, first_token)``."""
    n = len(prompt)
    padded = np.zeros(-(-n // chunk) * chunk, np.int32)
    padded[:n] = prompt
    first = None
    for cs in range(0, n, chunk):
        pages, first = T.lm_prefill_paged(
            params, pages, table, padded[cs:cs + chunk], cs, n, heads=HEADS,
            page_len=PAGE_LEN, **kw)
    return pages, int(first)


def _decode_streams(T, params, prompts, steps, kernel, sampled=False,
                    compute_dtype=None, dummy_row=False):
    """Prefill each prompt into its own pages (chunk 8), then ``steps - 1``
    decode steps through ``lm_decode_paged``; with ``dummy_row`` a free slot
    (all-zero table) rides the batch. Returns the per-row streams and the
    final slab."""
    B = len(prompts) + int(dummy_row)
    W = max(-(-(len(p) + steps) // PAGE_LEN) for p in prompts)
    pages = T.init_kv_pages(params, 40, PAGE_LEN, HEADS, compute_dtype)
    tables = np.zeros((B, W + 1), np.int32)
    seeds = np.arange(B, dtype=np.uint32) + 3
    temp = np.full(B, 0.9 if sampled else 0.0, np.float32)
    first = np.zeros(B, np.int32)
    nxt_page = 1
    for b, prompt in enumerate(prompts):
        need = -(-(len(prompt) + steps) // PAGE_LEN)
        tables[b, :need] = range(nxt_page, nxt_page + need)
        nxt_page += need
        pages, first[b] = _prefill_row(
            T, params, pages, tables[b], prompt, 8, seed=int(seeds[b]),
            temperature=float(temp[b]), compute_dtype=compute_dtype)
    streams = [[int(first[b])] for b in range(len(prompts))]
    positions = np.array([len(p) for p in prompts] + [0] * dummy_row,
                         np.int32)
    cur = first.copy()
    done = np.ones(B, np.int32)
    for _ in range(steps - 1):
        pages, nxt = T.lm_decode_paged(
            params, pages, tables[:, :W], positions, cur, done, seeds, temp,
            np.full(B, 0.95, np.float32), np.zeros(B, np.int32), heads=HEADS,
            page_len=PAGE_LEN, compute_dtype=compute_dtype, kernel=kernel)
        nxt = _np(nxt)
        for b in range(len(prompts)):
            streams[b].append(int(nxt[b]))
        positions[:len(prompts)] += 1
        done += 1
        cur = nxt.astype(np.int32)
    return streams, pages


PROMPTS = [np.arange(5) % 64, (np.arange(9) * 3) % 64, (np.arange(14) * 5) % 64,
           np.arange(7)[::-1] % 64]


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_paged_both_backends_match_jax(jparams, tparams, sampled):
    """GQA model, ragged prompts crossing page boundaries on different steps,
    a dummy slot riding the batch: the port's gather and kernel (plain on
    the CPU) backends give the JAX gather path's streams and pages; greedy
    streams also equal lm_generate's."""
    want, jpages = _decode_streams(jt, jparams, PROMPTS, 8, "gather", sampled,
                                   dummy_row=True)
    for kernel in ("gather", "pallas"):
        got, tpages = _decode_streams(tt, tparams, PROMPTS, 8, kernel,
                                      sampled, dummy_row=True)
        assert got == want, kernel
        for name in jpages:
            for a, b in zip(jpages[name], tpages[name]):
                # page 0 holds the dummy rows' last-writer garbage
                np.testing.assert_allclose(b[1:].numpy(), np.asarray(a)[1:],
                                           rtol=KV_TOL, atol=KV_TOL)
    if not sampled:
        for b, prompt in enumerate(PROMPTS):
            assert want[b] == _jax_generate(jparams, prompt, 0,
                                            8)[len(prompt):].tolist()


def test_decode_paged_bf16_backends_agree(jparams, tparams):
    """bf16 slab and residual stream: the kernel path casts p to bf16 before
    P·V as the gather path's einsum does, so the port's two backends give
    the same greedy streams. Against JAX the bf16 logits agree within two
    bf16 ulps of their largest magnitude; tokens are not compared across
    frameworks in bf16, because bf16 rounds at other points in XLA and torch
    and this model's logits hold near-ties at that resolution (row 1 below:
    JAX's own dense and paged bf16 prefills pick different first tokens;
    ROADMAP queue 3)."""
    streams = []
    for kernel in ("gather", "pallas"):
        got, pages = _decode_streams(tt, tparams, PROMPTS[:3], 6, kernel,
                                     compute_dtype="bfloat16")
        assert pages["l0"][0].dtype == torch.bfloat16
        streams.append(got)
    assert streams[0] == streams[1]
    for prompt in PROMPTS[:3]:
        lj, _ = jt._prefill(jparams, jnp.asarray(prompt, jnp.int32), HEADS,
                            16, jnp.bfloat16)
        lt, _ = tt._prefill(tparams, torch.from_numpy(prompt).long(), HEADS,
                            16, torch.bfloat16)
        top = float(np.abs(np.asarray(lj)).max())
        tol = 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=tol)


def test_chunked_prefill_matches_one_shot_and_jax(jparams, tparams):
    """Page-aligned chunks write the same pages and yield the same first
    token as one chunk covering everything, and as the JAX program."""
    prompt = (np.arange(21) * 3) % 64
    table = np.zeros(6, np.int32)
    table[:3] = [4, 2, 7]
    jpages = jt.init_kv_pages(jparams, 10, PAGE_LEN, HEADS)
    jpages, jfirst = _prefill_row(jt, jparams, jpages, table, prompt, 24)
    for chunk in (8, 16, 24):
        tpages = tt.init_kv_pages(tparams, 10, PAGE_LEN, HEADS)
        tpages, first = _prefill_row(tt, tparams, tpages, table, prompt, chunk)
        assert first == jfirst == _jax_generate(jparams, prompt, 0, 2)[21]
        for name in jpages:
            for a, b in zip(jpages[name], tpages[name]):
                np.testing.assert_allclose(b.numpy()[1:], np.asarray(a)[1:],
                                           rtol=KV_TOL, atol=KV_TOL)
    with pytest.raises(ValueError, match="multiple of"):
        tt.lm_prefill_paged(tparams, tpages, table, np.zeros(5, np.int32), 0,
                            5, heads=HEADS, page_len=PAGE_LEN)


def test_paged_helpers(tparams):
    pages = tt.init_kv_pages(tparams, 4, PAGE_LEN, HEADS)
    assert pages["l1"][0].shape == (4, PAGE_LEN, KV_HEADS, 8)
    pages["l0"][0][2] = 5.0
    tt.kv_page_copy(pages, 2, 3)
    assert bool((pages["l0"][0][3] == 5.0).all())
    assert bool((pages["l1"][1][3] == 0.0).all())
    with pytest.raises(ValueError, match="num_pages"):
        tt.init_kv_pages(tparams, 1, PAGE_LEN, HEADS)
    z = np.zeros(2, np.int32)
    for bad in ([[0, 4]], [[-1, 0]]):  # ids outside the 4-page slab
        with pytest.raises(ValueError, match="page ids"):
            tt.lm_decode_paged(tparams, pages, np.array(bad * 2, np.int32), z,
                               z, z, z.astype(np.uint32), z.astype(np.float32),
                               np.ones(2, np.float32), z, heads=HEADS,
                               page_len=PAGE_LEN, kernel="pallas")
        with pytest.raises(ValueError, match="page ids"):
            tt.lm_prefill_paged(tparams, pages, np.array(bad[0], np.int32),
                                np.zeros(PAGE_LEN, np.int32), 0, 3,
                                heads=HEADS, page_len=PAGE_LEN)
    assert tt.resolve_decode_kernel("gather") == "gather"
    assert tt.resolve_decode_kernel("pallas") == "pallas"
    assert tt.resolve_decode_kernel("auto", "cpu") == "gather"
    assert tt.resolve_decode_kernel("auto", "cuda") == "pallas"
    with pytest.raises(ValueError):
        tt.resolve_decode_kernel("fused")


def test_planner_arithmetic_matches_jax(jparams, tparams):
    for page_len in (4, 16):
        for dt in (None, "bfloat16"):
            assert tplanner.kv_page_bytes(tparams, HEADS, page_len, dt) == \
                jplanner.kv_page_bytes(jparams, HEADS, page_len, dt)
    for args in ((1, 1, 4), (4, 2, 4), (512, 65, 16), (10, 4, 4)):
        assert tplanner.request_pages(*args) == jplanner.request_pages(*args)
    with pytest.raises(ValueError):
        tplanner.request_pages(0, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tplanner.usable_hbm_bytes("cpu")


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_cuda_decode_and_flash_prefill_match_plain(cuda, tparams, monkeypatch):
    """On the card: the kernel decode backend gives the gather backend's
    greedy streams, and lm_generate through the flash kernel gives the plain
    flash version's tokens."""
    params = jax.tree.map(lambda t: t.to(cuda), tparams)
    want, _ = _decode_streams(tt, params, PROMPTS, 8, "gather")
    got, _ = _decode_streams(tt, params, PROMPTS, 8, "pallas")
    assert got == want
    monkeypatch.setattr(tt, "_PREFILL_FLASH_MIN", 16)
    prompt = (np.arange(300) * 7) % 64
    kern = tt.lm_generate(params, prompt, 0, heads=HEADS, max_len=306, steps=6)
    monkeypatch.setattr(tt._flash, "flash_attention_single_panel",
                        tt._flash.flash_attention_single_panel_plain)
    plain = tt.lm_generate(params, prompt, 0, heads=HEADS, max_len=306,
                           steps=6)
    assert kern.tolist() == plain.tolist()
