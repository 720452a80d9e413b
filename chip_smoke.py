#!/usr/bin/env python3
"""Smoke run of marlin_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``marlin_tpu_torch/csrc/`` (one ``nvcc``
per source, all at once), holds each against its plain PyTorch version, and
drives the ported paths end to end through the public entry points:

- phases 1-5: the dense 20000² multiply (GEMM and masked-fill kernels);
- phases 6-7: the paged decode-attention and flash-panel kernels against
  their plain versions at the serving shapes (f32 and bf16, GQA, ragged and
  dummy rows, the strided (P, heads, d) views that prefill passes, two
  panels with carried state and offsets), every element within tolerance;
- phase 8: the serving path at full width — ``TransformerLM(vocab=4096,
  d_model=512, heads=8, layers=4)`` (the repo's decode benchmark model,
  ``bench_all.py`` ``config_decode``), 8 requests of 512 tokens through
  ``paged_serve_loop.serve_bucket``: ``PagedKVPool`` (prefix match, insert,
  copy-on-write) → chunked ``lm_prefill_paged`` → 64
  ``lm_decode_paged(kernel="pallas")`` steps → release and audit, then
  ``generate`` on one 16384-token prompt through the flash kernel in every
  layer; greedy tokens held against the gather backend, per-request
  ``lm_generate`` and the plain flash version;
- phase 9: kernel, plain, bound and library times;
- phase 10: the flash forward (output and lse) and backward kernels (dK/dV
  and dQ) against their plain versions, element by element: the training
  shape (2 heads × 32768 × 128, causal, ``valid_len`` 32767) in f32 and
  bf16, on contiguous tensors and the strided (S, heads, d) views ``_block``
  hands ring attention; for the backward also two panels with offsets, a
  non-causal case and d = 64;
- phase 11: the training path at full width — ``bench_all.py``
  ``config_lct``'s ``TransformerLM(vocab=512, d_model=256, heads=2,
  layers=2)``, f32, Adam at 3e-3, ``attn="ring"``: one warm-up step, then 3
  steps of ``TransformerLM.train`` on one 32768-token stream through the
  flash forward, dK/dV and dQ kernels; the first step's gradients and the 3
  steps' losses and params held against the same run with the plain flash
  versions swapped in; one step each with ``attn="ulysses"`` and with
  ``remat=True, loss_chunk=16384`` held against the ring step;
- phase 12: the backward kernels' registers and spills from ptxas (a spill
  fails the run); the flash kernels' times at the training shape in f32,
  and the backward pair's in bf16, each beside SDPA's backward and the
  tensor-core bound (3xTF32 at 495/3 TFLOP/s for f32, 989 for bf16);
- phase 13: the BSR SpMM kernel against its plain version, element by element:
  block sizes 8, 32, 64 and 128 with ragged m, n and p, empty block rows and a
  hot block column, in f32 and bf16; no block at all; more than 65535 block
  rows; the main shape;
- phase 14: the sparse path at full width — ``bench_all.py`` ``config_bsr``
  (32768², bs 128, block density 0.05, p 256): ``BsrMatrix.multiply(
  backend="auto")`` tunes over the chunked formulation and the kernel, a second
  call reads the cache, and every backend is held against f64 on sampled rows;
  then ``SparseVecMatrix.multiply`` from COO triplets at 8192² (format "bsr")
  and on a 100000² matrix at density 1e-4 (formats "ell", "bcoo", "auto");
- phase 15: the BSR kernel's times at the main shape.

It prints the card's name, count and power limit, one ``{"kernels": [...]}``
line (launches on the main path, max error, kernel / plain / bound / library
times), and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line. It also exits non-zero where ``torch.cuda.is_available()`` is false and
where the package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

N = 20000                 # the north-star multiply: 20000 x 20000 x 20000
F32_PEAK = 67e12          # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 495e12        # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_TOL = 1e-4            # f32: max |kernel - plain| <= 1e-4 * max |plain|
# bf16: both sides accumulate in f32 and round once to bf16, so they may
# differ by a rounding step of the output: two bf16 ulps (2^-7) of max |plain|
BF16_TOL = 2.0 ** -7
F64_TOL = 1e-4            # f32 product vs f64 on sampled rows, relative to max |ref|
ATTN_F32_TOL = 1e-5       # attention kernels vs plain, f32, absolute
# attention kernels vs plain, bf16, per element: two bf16 ulps of the plain
# element plus this floor. Each side rounds p to bf16 before P·V at its own
# running maximum, so an output near 0 may still differ by a few p roundings
# times |v|; the floor is about 2.7x the largest such difference measured
# on an H100, and below the typical |output| (0.01-0.05) of these shapes.
BF16_ATTN_ATOL = 2.0 ** -8
# the serving path: bench_all.py config_decode's model, one bucket of 8 rows,
# pages of 16 tokens, 256 prompt tokens per prefill iteration (the JAX
# engine's defaults), the pool sized by kvpool.auto_num_pages
LM = dict(vocab=4096, d_model=512, heads=8, layers=4, seed=0)
PROMPT, SHARED, DECODE_STEPS, ROWS = 512, 256, 64, 8
PAGE_LEN, PREFILL_CHUNK = 16, 256
LONG_PROMPT, LONG_STEPS = 16384, 8
# the training path: bench_all.py config_lct's model and stream
LCT = dict(vocab=512, d_model=256, heads=2, layers=2, seed=0)
TRAIN_SEQ, TRAIN_STEPS = 32768, 3
# flash backward kernels vs plain, per element: f32 |err| <= BWD_F32_ATOL *
# max|plain| + BWD_F32_RTOL * |plain|. Each dk/dv element sums up to 32768
# rows whose terms cancel (each row's ds sums to 0), in 64-row tiles on the
# card and 1024-row products in the plain version; the largest difference
# measured on an H100 was 8.7e-6 of max|plain|, and a typical |plain| is a
# few tenths of the max.
BWD_F32_ATOL, BWD_F32_RTOL = 4e-5, 1e-5
# bf16: two bf16 ulps of the plain element plus BWD_BF16_ATOL * max|plain|:
# p and ds round to bf16 on both sides from f32 scores that differ by a few
# ulps, so a rounding may land one step apart and the sums carry it. With
# 2.5e-4 the largest err/bound measured on an H100 was 0.82 (two panels at
# 4096 rows, where max|plain| is 0.2 and a typical |plain| 0.05); 1e-3 of
# max|plain| is still a 250th of a typical element there.
BWD_BF16_ATOL = 1e-3
# the flash forward at the training shape: lse (= m + log l, which the
# backward reads) per element within LSE_TOL. Both sides sum l from f32 p in
# other orders and rescale at other maxima; |lse| stays below 16 here, where
# an f32 ulp is 1.9e-6, so the bound is about 10 ulps. An H100 read 1.9e-6
# (one ulp) in f32 and bf16, on contiguous tensors and on the views.
LSE_TOL = 2e-5
# training with the kernels vs with the plain versions: the first loss and
# step-1 gradients (per leaf, |err| <= TRAIN_GRAD_TOL * max|grad|) see only
# the kernels' rounding; after that Adam steps every element by about
# lr * g / |g|, so the few elements whose gradient is within rounding of 0
# may step differently. Params after 3 steps: at most TRAIN_OUTLIER_SHARE of
# the elements off by more than lr / 10, and the whole difference below
# TRAIN_DIFF_SHARE of the distance the params moved. An H100 read 1 element
# of 1,705,216 off (17 allowed) and a difference of 8.1e-5 of the distance
# (1e-3 allowed).
TRAIN_LOSS0_RTOL, TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-4
TRAIN_OUTLIER_SHARE, TRAIN_DIFF_SHARE = 1e-5, 1e-3
# the sparse path: bench_all.py config_bsr — a (grid·bs)² matrix holding
# BSR_DENSITY of its bs×bs blocks times a dense (n, p) panel; grid 64 for the
# SparseVecMatrix built from COO triplets; the ELL/BCOO matrix is BASELINE.md
# config 5's density at 10^5 rows (10^6 there) and its 256 columns
BSR_GRID, BSR_BS, BSR_P, BSR_DENSITY = 256, 128, 256, 0.05
SPMV_GRID, ELL_N, ELL_DENSITY = 64, 100_000, 1e-4
# BSR kernel vs plain, per element: f32 |err| <= BSR_F32_ATOL * max|plain| +
# BSR_F32_RTOL * |plain| (both sum the same f32 products of up to a block row's
# blocks, in other orders: the kernel in one FMA chain, the plain version in
# cuBLAS's bmm, then index_add_); bf16 two bf16 ulps of the plain element plus
# BSR_BF16_ATOL * max|plain| (each side rounds its f32 sum once)
BSR_F32_ATOL, BSR_F32_RTOL, BSR_BF16_ATOL = 1e-5, 1e-5, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call, by CUDA events around ``reps`` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_gemm(torch, pk, m, k, n, dtype, gen, tile=(256, 256, 512)) -> float:
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    got = pk.pallas_matmul(a, b, *tile)
    want = pk.pallas_matmul_plain(a, b, *tile)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != (m, n):
        raise AssertionError(f"pallas_matmul {m}x{k}x{n}: got {got.dtype} "
                             f"{tuple(got.shape)}")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
    log(f"  pallas_matmul {m}x{k}x{n} {str(dtype)[6:]} tile {tile}: "
        f"max|err| {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"pallas_matmul {m}x{k}x{n} {dtype}: {err} > {tol}")
    return err


def check_fill(torch, pk, x, rows, cols) -> float:
    got = pk.masked_fill(x, rows, cols)
    want = pk.masked_fill_plain(x, rows, cols)
    torch.cuda.synchronize()
    ibits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    same = torch.equal(got.view(ibits), want.view(ibits))
    log(f"  masked_fill {tuple(x.shape)} {str(x.dtype)[6:]} rows={rows} "
        f"cols={cols}: bit-exact {same}")
    if not same:
        raise AssertionError(f"masked_fill {tuple(x.shape)} {x.dtype} differs")
    return float((got.double() - want.double()).abs().max())


def attn_close(torch, label, got, want, dtype) -> float:
    """Max |got - want|. Raises unless every element of ``got`` is finite and
    within the tolerance of ``dtype``: ATTN_F32_TOL for f32; for bf16, two
    bf16 ulps of the element's |want| plus BF16_ATTN_ATOL."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        tol, desc = torch.full_like(want, ATTN_F32_TOL), f"{ATTN_F32_TOL:g}"
    else:
        # |want| = m * 2^e with m in [0.5, 1): one bf16 ulp is 2^(e - 8)
        _, e = torch.frexp(want)
        ulps2 = torch.where(want != 0, torch.exp2((e - 7).float()), 0.0)
        tol, desc = ulps2 + BF16_ATTN_ATOL, f"2 ulps + {BF16_ATTN_ATOL:g}"
    err = float(diff.max())
    worst = float((diff / tol).max())
    log(f"  {label}: max|err| {err:.3e}, max err/tol {worst:.3f} "
        f"(tol {desc})")
    if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
        raise AssertionError(f"{label}: max|err| {err}, err/tol {worst}")
    return err


def cuda_ms_cold(torch, fn, reps: int) -> float:
    """Milliseconds per call with L2 flushed before each call (a 64 MB write
    exceeds the 50 MB L2), timed by CUDA events around the call alone."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def paged_inputs(torch, gen, B, kvh, group, dh, page_len, W, dtype):
    """A slab with distinct pages per row, ragged lengths (1, a page
    boundary, the full table, random), and an all-dummy row when B > 3."""
    n_pages = B * W + 1
    q = torch.randn((B, kvh, group, dh), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_pages, page_len, kvh, dh), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_pages, page_len, kvh, dh), generator=gen,
                     device="cuda").to(dtype)
    tables = (1 + torch.randperm(n_pages - 1, generator=gen, device="cuda")
              [:B * W]).reshape(B, W).to(torch.int32)
    lengths = torch.randint(1, W * page_len + 1, (B,), generator=gen,
                            device="cuda").to(torch.int32)
    lengths[0], lengths[1], lengths[-1] = 1, page_len, W * page_len
    if B > 3:
        tables[2] = 0
    return q, kp, vp, tables, lengths


def check_paged(torch, pa, gen, B, kvh, group, dh, page_len, W, dtype) -> float:
    q, kp, vp, tables, lengths = paged_inputs(torch, gen, B, kvh, group, dh,
                                              page_len, W, dtype)
    got = pa.paged_decode_attention(q, kp, vp, tables, lengths)
    want = pa.paged_decode_attention_plain(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != q.shape:
        raise AssertionError(f"paged_decode_attention B={B}: got {got.dtype} "
                             f"{tuple(got.shape)}")
    return attn_close(torch, f"paged_decode_attention B={B} kvh={kvh} "
                      f"group={group} dh={dh} page_len={page_len} W={W} "
                      f"{str(dtype)[6:]}", got, want, dtype)


def check_flash(torch, fa, gen, H, P, d, valid, dtype) -> float:
    """One panel at (H, P, d) with valid_len < P; the same through
    ``flash_attention_single_panel`` on the strided views ``_prefill_attn``
    passes (head stride d, row stride H * d); then a two-panel run with
    carried state and nonzero offsets that are no multiple of the tile. The
    plain version tiles by 1024 and the kernel by 64, so in bf16 they round
    p at different running maxima (see BF16_ATTN_ATOL)."""
    import math

    import torch.nn.functional as F
    scale = 1.0 / math.sqrt(d)
    dt = str(dtype)[6:]
    q, k, v = (torch.randn((H, P, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    m = torch.full((H, P), -1e30, device="cuda")
    l = torch.zeros((H, P), device="cuda")
    acc = torch.zeros((H, P, d), device="cuda")
    got = fa.flash_attention_panel(q, k, v, m, l, acc, 0, 0, valid,
                                   causal=True, scale=scale)
    want = fa.flash_attention_panel_plain(q, k, v, m, l, acc, 0, 0, valid,
                                          causal=True, scale=scale)
    outs = [st[2] / st[1].clamp(min=1e-30)[..., None] for st in (got, want)]
    torch.cuda.synchronize()
    m_err = float((got[0] - want[0]).abs().max())
    log(f"  flash_attention_panel H={H} P={P} d={d} valid={valid} {dt} one "
        f"panel: max|err| m {m_err:.3e} (tol {ATTN_F32_TOL:g})")
    if not m_err <= ATTN_F32_TOL:
        raise AssertionError(f"flash one panel P={P} {dtype}: m {m_err}")
    err = attn_close(torch, f"flash_attention_panel H={H} P={P} {dt} one "
                     f"panel out", outs[0], outs[1], dtype)
    del got, want, outs, m, l, acc
    # (valid, H, d) activations padded to P and viewed as (H, P, d)
    qs, ks, vs = (F.pad(torch.randn((valid, H, d), generator=gen,
                                    device="cuda").to(dtype),
                        (0, 0, 0, 0, 0, P - valid)).permute(1, 0, 2)
                  for _ in range(3))
    if qs.stride() != (d, H * d, 1):
        raise AssertionError(f"strided views have strides {qs.stride()}")
    got, _ = fa.flash_attention_single_panel(qs, ks, vs, valid, causal=True,
                                             scale=scale)
    want, _ = fa.flash_attention_single_panel_plain(qs, ks, vs, valid,
                                                    causal=True, scale=scale)
    torch.cuda.synchronize()
    e1 = attn_close(torch, f"flash_attention_single_panel on (P, H, d) "
                    f"views P={P} valid={valid} {dt}", got, want, dtype)
    del qs, ks, vs, got, want
    m = torch.full((H, P), -1e30, device="cuda")
    l = torch.zeros((H, P), device="cuda")
    acc = torch.zeros((H, P, d), device="cuda")
    half = P // 2
    k2 = torch.randn((H, half, d), generator=gen, device="cuda").to(dtype)
    v2 = torch.randn((H, half, d), generator=gen, device="cuda").to(dtype)
    qo, ko = 777, 131
    st_g = st_w = (m, l, acc)
    for kk, vv, off in ((k[:, :half], v[:, :half], ko), (k2, v2, ko + half)):
        st_g = fa.flash_attention_panel(q, kk, vv, *st_g, qo, off, valid,
                                        causal=True, scale=scale)
        st_w = fa.flash_attention_panel_plain(q, kk, vv, *st_w, qo, off, valid,
                                              causal=True, scale=scale)
    outs = [st[2] / st[1].clamp(min=1e-30)[..., None] for st in (st_g, st_w)]
    torch.cuda.synchronize()
    e2 = attn_close(torch, f"flash_attention_panel two panels q_offset={qo} "
                    f"k_offset={ko} {dt}", outs[0], outs[1], dtype)
    return max(err, e1, e2)


def bwd_close(torch, label, got, want, dtype, f32_atol=BWD_F32_ATOL,
              f32_rtol=BWD_F32_RTOL, bf16_atol=BWD_BF16_ATOL
              ) -> tuple[float, float]:
    """Max |got - want| and max err/bound; raises unless every element of
    ``got`` is finite and within the bound of ``dtype``: f32 ``f32_atol *
    max|want| + f32_rtol * |want|``; bf16 two bf16 ulps of the element plus
    ``bf16_atol * max|want|`` (the flash backward's BWD_* by default)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = float(want.abs().max())
    if dtype == torch.float32:
        tol = f32_atol * scale + f32_rtol * want.abs()
        desc = f"{f32_atol:g} max + {f32_rtol:g} |plain|"
    else:
        _, e = torch.frexp(want)
        ulps2 = torch.where(want != 0, torch.exp2((e - 7).float()), 0.0)
        tol = ulps2 + bf16_atol * scale
        desc = f"2 ulps + {bf16_atol:g} max"
    err = float(diff.max())
    worst = float((diff / tol.clamp(min=1e-30)).max())
    log(f"  {label}: max|err| {err:.3e} (max|plain| {scale:.3e}), max "
        f"err/bound {worst:.3f} (bound {desc})")
    if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
        raise AssertionError(f"{label}: max|err| {err}, err/bound {worst}")
    return err, worst


def bwd_inputs(torch, fa, gen, H, sq, skv, d, dtype, strided, panels, q_off,
               valid, causal):
    """q and dO (H, sq, d); K/V panels (H, skv, d) with their key offsets;
    ``lse`` and ``delta`` from the plain forward over all panels. With
    ``strided``, (seq, heads, d) tensors viewed as (heads, seq, d), as
    ``_block`` hands them to ring attention."""
    def make(n):
        if strided:
            t = torch.randn((n, H, d), generator=gen, device="cuda")
            return t.to(dtype).permute(1, 0, 2)
        return torch.randn((H, n, d), generator=gen, device="cuda").to(dtype)

    scale = 1.0 / d ** 0.5
    q, do = make(sq), make(sq)
    kv = [(make(skv), make(skv), off) for off in panels]
    st = (torch.full((H, sq), -1e30, device="cuda"),
          torch.zeros((H, sq), device="cuda"),
          torch.zeros((H, sq, d), device="cuda"))
    for k, v, off in kv:
        st = fa.flash_attention_panel_plain(q, k, v, *st, q_off, off, valid,
                                            causal=causal, scale=scale)
    m, l, acc = st
    lf = l.clamp(min=1e-30)
    lse = m + torch.log(lf)
    delta = (do.float() * (acc / lf[..., None]).to(dtype).float()).sum(-1)
    return q, do, kv, lse, delta, scale


def check_bwd(torch, fa, gen, label, H, sq, d, valid, dtype, causal=True,
              strided=False, panels=(0,), skv=None, q_off=0):
    """The dK/dV and dQ kernels against the plain backward on each K/V
    panel; returns the largest |err| of dq, dk and dv, and the largest
    err/bound."""
    q, do, kv, lse, delta, scale = bwd_inputs(
        torch, fa, gen, H, sq, skv or sq, d, dtype, strided, panels, q_off,
        valid, causal)
    if strided and q.stride()[:2] != (d, H * d):
        raise AssertionError(f"strided views have strides {q.stride()}")
    errs, worst = dict(dq=0.0, dk=0.0, dv=0.0), 0.0
    for k, v, off in kv:
        args = (q, k, v, do, lse, delta, q_off, off, valid)
        got = fa.flash_attention_panel_bwd(*args, causal=causal, scale=scale)
        want = fa.flash_attention_panel_bwd_plain(*args, causal=causal,
                                                  scale=scale)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            e, r = bwd_close(torch, f"{label} k_offset={off} {name}", g, w,
                             dtype)
            errs[name], worst = max(errs[name], e), max(worst, r)
    return errs, worst


def flat(tree, prefix=""):
    """{path: tensor} over a params dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def live_pairs(P: int, valid: int) -> int:
    """Live (query, key) pairs of one causal head over a panel of ``P`` rows
    whose keys past ``valid`` are masked."""
    return valid * (valid + 1) // 2 + (P - valid) * valid


def serve(params, prompts, kernel):
    """Serve ``prompts`` (greedy, request i seeded i) as one bucket of the
    paged pool through ``paged_serve_loop.serve_bucket``: warm-up, admit with
    prefix match, chunked ``lm_prefill_paged``, ``DECODE_STEPS`` steps of
    ``lm_decode_paged(kernel=kernel)``, release. Request 1 forces a
    copy-on-write split of its last shared page. Returns the streams in
    request order, the pool's audit after release, and the decode steps and
    their host-clock seconds."""
    from marlin_tpu_torch.models import transformer as tt
    from marlin_tpu_torch.serving import kvpool
    from paged_serve_loop import serve_bucket

    requests = [(p, DECODE_STEPS + 1, i, 0.0) for i, p in enumerate(prompts)]
    streams, _, audit, steps, secs = serve_bucket(
        kvpool, tt, params, LM["heads"], PAGE_LEN, requests,
        (PROMPT, DECODE_STEPS), ROWS, PREFILL_CHUNK, kernel)
    return [streams[i] for i in range(len(prompts))], audit, steps, secs


def train_shape() -> tuple[int, int, int]:
    """(heads, head dim, panel) of the training path's attention: the
    stream's TRAIN_SEQ - 1 positions padded to one TRAIN_SEQ panel."""
    return LCT["heads"], LCT["d_model"] // LCT["heads"], TRAIN_SEQ


def check_fwd_train(torch, fa, gen, dtype) -> None:
    """The flash forward at the training shape (H, P, d) with valid_len P - 1:
    ``flash_attention_single_panel`` against its plain version on contiguous
    tensors and on (P, H, d) views, the output per element (attn_close) and
    lse within LSE_TOL."""
    H, d, P = train_shape()
    scale = 1.0 / math.sqrt(d)
    for strided in (False, True):
        if strided:  # (seq, heads, d) projections viewed as (heads, seq, d)
            q, k, v = (torch.randn((P, H, d), generator=gen, device="cuda")
                       .to(dtype).permute(1, 0, 2) for _ in range(3))
        else:
            q, k, v = (torch.randn((H, P, d), generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
        got, got_lse = fa.flash_attention_single_panel(
            q, k, v, P - 1, causal=True, scale=scale)
        want, want_lse = fa.flash_attention_single_panel_plain(
            q, k, v, P - 1, causal=True, scale=scale)
        torch.cuda.synchronize()
        label = (f"flash_attention_single_panel H={H} P={P} d={d} "
                 f"valid={P - 1}{' (P, H, d) views' if strided else ''} "
                 f"{str(dtype)[6:]}")
        attn_close(torch, label + " out", got, want, dtype)
        lse_err = float((got_lse - want_lse).abs().max())
        log(f"  {label} lse: max|err| {lse_err:.3e} (max|plain| "
            f"{float(want_lse.abs().max()):.3f}, tol {LSE_TOL:g})")
        if not (bool(torch.isfinite(got_lse).all()) and lse_err <= LSE_TOL):
            raise AssertionError(f"{label}: lse max|err| {lse_err}")


def backward_checks(torch, fa, gen):
    """Phase 10: the flash forward at the training shape, then the dK/dV
    and dQ kernels against the plain backward. Returns the f32
    training-shape backward errors {dq, dk, dv} and the largest err/bound of
    every backward case."""
    log("phase 10: the flash forward at the training shape, and "
        "flash_attention_panel_bwd (dK/dV and dQ kernels) vs its plain "
        "version")
    H_T, D_T, P_T = train_shape()
    bwd_errs, bwd_worst = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        check_fwd_train(torch, fa, gen, dtype)
        e, r = check_bwd(torch, fa, gen, f"training shape H={H_T} P={P_T} "
                         f"d={D_T} valid={P_T - 1} {dt}", H_T, P_T, D_T,
                         P_T - 1, dtype)
        if dtype == torch.float32:
            bwd_errs = e
        bwd_worst = max(bwd_worst, r)
        cases = (
            (f"(S, heads, d) views P={P_T} {dt}", H_T, P_T, D_T, P_T,
             dict(strided=True)),
            (f"two panels q_offset=5000 {dt}", H_T, 4096, D_T, 7000,
             dict(panels=(131, 131 + 2048), skv=2048, q_off=5000)),
            (f"non-causal P=4096 valid=4000 {dt}", H_T, 4096, D_T, 4000,
             dict(causal=False)),
            (f"d=64 H=4 P=4096 valid=4001 {dt}", 4, 4096, 64, 4001, {}),
        )
        for label, H, P, d, valid, kw in cases:
            _, r = check_bwd(torch, fa, gen, label, H, P, d, valid, dtype,
                             **kw)
            bwd_worst = max(bwd_worst, r)
        torch.cuda.empty_cache()
    log(f"  largest err/bound over the backward checks: {bwd_worst:.3f}")
    return bwd_errs, bwd_worst


def train_path(torch, np, tt, fa, ops):
    """Phase 11: config_lct's model trained on the card through the flash
    kernels, held against the plain versions; returns the main path's
    launch counts."""
    H_T, D_T, P_T = train_shape()
    log(f"phase 11: TransformerLM{tuple(LCT.values())} f32, Adam "
        f"{tt.TransformerLM.learning_rate:g}, attn='ring': 1 warm-up + "
        f"{TRAIN_STEPS} steps on a {TRAIN_SEQ}-token stream")
    from marlin_tpu_torch.parallel.ring_attention import (
        resolve_attention_backend)

    if resolve_attention_backend("auto", "cuda") != "flash":
        raise AssertionError("ring attention 'auto' must pick the flash "
                             "kernels on a CUDA device")
    lct = tt.TransformerLM(**LCT)
    stream = np.random.default_rng(0).integers(
        0, LCT["vocab"], TRAIN_SEQ).astype(np.int32)
    params0 = lct.init_params()
    lct.train(stream, steps=1, params=params0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params_k, losses_k = lct.train(stream, steps=TRAIN_STEPS, params=params0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  launches on the main path: {train_counts}")
    for kname in ("flash_attention_panel", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
        if train_counts[kname] != LCT["layers"] * TRAIN_STEPS:
            raise AssertionError(f"{kname}: {train_counts[kname]} launches, "
                                 f"want {LCT['layers']} per step")
    ktok_s = TRAIN_SEQ * TRAIN_STEPS / train_s / 1e3
    log(f"  losses {losses_k}; {ktok_s:.3f} ktok/s, "
        f"{train_s / TRAIN_STEPS * 1e3:.3f} ms per step (host clock, one "
        f"sync per step), peak device memory {train_peak:.2f} GiB")
    if not all(math.isfinite(x) for x in losses_k) or \
            abs(losses_k[0] - math.log(LCT["vocab"])) > 0.25:
        raise AssertionError(f"losses {losses_k}: want finite, the first "
                             f"near ln {LCT['vocab']}")
    loss_g, grads_k = tt.lm_value_and_grad(params0, stream,
                                           heads=LCT["heads"], attn="ring")
    kernel_fwd, kernel_bwd = (fa.flash_attention_single_panel,
                              fa.flash_attention_panel_bwd)
    fa.flash_attention_single_panel = fa.flash_attention_single_panel_plain
    fa.flash_attention_panel_bwd = fa.flash_attention_panel_bwd_plain
    try:
        ops.reset_launch_counts()
        loss_gp, grads_p = tt.lm_value_and_grad(
            params0, stream, heads=LCT["heads"], attn="ring")
        params_p, losses_p = lct.train(stream, steps=TRAIN_STEPS,
                                       params=params0)
        if any(ops.launch_counts().values()):
            raise AssertionError("the plain run launched a kernel")
    finally:
        fa.flash_attention_single_panel = kernel_fwd
        fa.flash_attention_panel_bwd = kernel_bwd
    log(f"  plain flash versions: losses {losses_p}")
    if abs(losses_k[0] - losses_p[0]) > TRAIN_LOSS0_RTOL * abs(losses_p[0]) \
            or any(abs(a - b) > TRAIN_LOSS_RTOL * abs(b)
                   for a, b in zip(losses_k, losses_p)):
        raise AssertionError(f"kernel losses {losses_k} vs plain {losses_p}")
    grads_k, grads_p = flat(grads_k), flat(grads_p)
    grad_worst = 0.0
    for path, gp in grads_p.items():
        gk = grads_k[path]
        grad_worst = max(grad_worst, float((gk - gp).abs().max())
                         / max(float(gp.abs().max()), 1e-30))
    log(f"  step-1 gradients: largest |kernel - plain| / max|plain| over the "
        f"leaves {grad_worst:.3e} (tol {TRAIN_GRAD_TOL:g}); losses "
        f"{float(loss_g)} vs {float(loss_gp)}")
    if not grad_worst <= TRAIN_GRAD_TOL:
        raise AssertionError(f"step-1 gradients differ by {grad_worst}")
    fk, fp, f0 = flat(params_k), flat(params_p), flat(params0)
    lr = lct.learning_rate
    n_el = sum(t.numel() for t in fp.values())
    n_off = sum(int(((fk[k] - fp[k]).abs() > lr / 10).sum()) for k in fp)
    diff = math.sqrt(sum(float(((fk[k] - fp[k]) ** 2).sum()) for k in fp))
    moved = math.sqrt(sum(float(((fp[k] - f0[k]) ** 2).sum()) for k in fp))
    log(f"  params after {TRAIN_STEPS} steps: {n_off} of {n_el} elements off "
        f"by more than lr/10; |kernel - plain| = {diff / moved:.3e} of the "
        f"distance moved")
    if n_off > TRAIN_OUTLIER_SHARE * n_el or diff > TRAIN_DIFF_SHARE * moved:
        raise AssertionError("kernel and plain params differ")
    del params_p, grads_k, grads_p
    for knobs in (dict(attn="ulysses"), dict(remat=True, loss_chunk=16384)):
        ops.reset_launch_counts()
        _, (loss1,) = tt.TransformerLM(**LCT, **knobs).train(
            stream, steps=1, params=params0)
        log(f"  one step with {knobs}: loss {loss1!r} (ring {losses_k[0]!r}),"
            f" launches {ops.launch_counts()}")
        if abs(loss1 - losses_k[0]) > TRAIN_LOSS0_RTOL * abs(losses_k[0]):
            raise AssertionError(f"{knobs}: loss {loss1} vs {losses_k[0]}")
    del params0, params_k
    torch.cuda.empty_cache()
    return train_counts


def bwd_ptxas(_build) -> dict:
    """Registers and spill bytes of every instance of the flash backward
    kernel, from the build's ptxas report, by label; raises if one spills."""
    import re

    report = _build.ptxas_report().split("== flash_attention_bwd.cu", 1)[1]
    report = report.split("\n== ", 1)[0]
    out, label = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            a = re.search(r"flash_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELb"
                          r"([01])ELb([01])E", m.group(1))
            label = (f"{'dkv' if a.group(4) == '1' else 'dq'} "
                     f"{'f32' if a.group(1) == 'f' else 'bf16'} d<={a.group(2)}"
                     f"{'' if a.group(3) == '1' else ' element-wise'}")
            out[label] = dict(registers=None, spill=None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and label:
            out[label]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and label:
            out[label]["registers"] = int(m.group(1))
    if len(out) != 16 or any(v["registers"] is None for v in out.values()):
        raise AssertionError(f"ptxas report of the backward kernels: {out}")
    for label, v in out.items():
        log(f"  ptxas {label}: {v['registers']} registers, {v['spill']} "
            f"bytes spilled")
    spilled = [k for k, v in out.items() if v["spill"]]
    if spilled:
        raise AssertionError(f"backward kernels spill: {spilled}")
    return out


def bwd_times(torch, fa, gen, dtype, pairs):
    """CUDA-event times of the dK/dV and dQ kernels and SDPA's backward at
    the training shape in ``dtype``, with their bounds; returns them by name
    and the kernels' arguments."""
    H_T, D_T, P_T = train_shape()
    q, do, kv, lse, delta, scale = bwd_inputs(
        torch, fa, gen, H_T, P_T, P_T, D_T, dtype, False, (0,), 0, P_T - 1,
        True)
    k, v, _ = kv[0]
    bargs = (q, k, v, do, lse, delta, 0, 0, P_T - 1)
    kw = dict(causal=True, scale=scale)
    t = dict(ms_dkv=cuda_ms(torch, lambda: fa.flash_attention_bwd_dkv(
        *bargs, **kw), 5))
    t["ms_dq"] = cuda_ms(torch, lambda: fa.flash_attention_bwd_dq(
        *bargs, **kw), 5)
    qs, ks, vs = (x.detach()[None].requires_grad_() for x in (q, k, v))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True)
    t["lib_bwd"] = cuda_ms(torch, lambda: torch.autograd.grad(
        o_sdpa, (qs, ks, vs), do[None], retain_graph=True), 5)
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(
            qs, ks, vs, None, 0.0, True)).name
    except Exception as exc:  # a private helper: name what went wrong
        backend = f"unknown ({type(exc).__name__})"
    del o_sdpa, qs, ks, vs
    dt = str(dtype)[6:]
    peak, rate = ((TF32_PEAK / 3, "3xTF32 tensor cores, 165 TFLOP/s")
                  if dtype == torch.float32
                  else (BF16_PEAK, "bf16 tensor cores, 989 TFLOP/s"))
    # bytes: q, k, v, dO read once, lse and delta read and the f32
    # gradients written once; the operations bound them here
    io_bytes = 4.0 * H_T * P_T * D_T * q.element_size() + 8.0 * H_T * P_T
    for name, per_pair, n_out in (("dkv", 8.0, 2), ("dq", 6.0, 1)):
        ops_ = per_pair * D_T * pairs
        ms = t[f"ms_{name}"]
        t[f"bound_{name}"] = 1e3 * max(
            ops_ / peak, (io_bytes + n_out * 4.0 * H_T * P_T * D_T)
            / HBM_BYTES_PER_S)
        log(f"  flash_attention_bwd_{name} {dt} {ms:.3f} ms "
            f"({ops_ / ms / 1e9:.1f} TFLOP/s), bound {t[f'bound_' + name]:.3f}"
            f" ms (operations, {per_pair:g}*d per pair, {rate})"
            + (f"; CUDA-core f32 bound {1e3 * ops_ / F32_PEAK:.3f} ms "
               f"(67 TFLOP/s)" if dtype == torch.float32 else ""))
    both = t["ms_dkv"] + t["ms_dq"]
    log(f"  dK/dV + dQ {dt} {both:.3f} ms; SDPA backward {dt} "
        f"(torch.autograd.grad of scaled_dot_product_attention, backend "
        f"{backend}) {t['lib_bwd']:.3f} ms: kernels "
        f"{'below' if both < t['lib_bwd'] else 'above'} SDPA")
    return t, bargs, kw


def train_times(torch, fa, gen, _build):
    """Phase 12: the backward kernels' registers and spills; kernel, plain,
    bound and library times of the flash kernels at the training shape, f32
    (the main path's type), then the backward pair in bf16. Returns the f32
    times by name."""
    H_T, D_T, P_T = train_shape()
    log(f"phase 12: flash kernel times at H={H_T} P={P_T} d={D_T} causal "
        f"valid={P_T - 1} (CUDA events)")
    bwd_ptxas(_build)
    pairs = H_T * live_pairs(P_T, P_T - 1)
    log(f"  {pairs} live (query, key) pairs")
    t, bargs, kw = bwd_times(torch, fa, gen, torch.float32, pairs)
    q, k, v = bargs[:3]
    t["plain_bwd"] = cuda_ms(torch, lambda: fa.flash_attention_panel_bwd_plain(
        *bargs, **kw), 2)
    ms_fwd = cuda_ms(torch, lambda: fa.flash_attention_single_panel(
        q, k, v, P_T - 1, **kw), 5)
    plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_single_panel_plain(
        q, k, v, P_T - 1, **kw), 2)
    lib_fwd = cuda_ms(torch, lambda: torch.nn.functional
                      .scaled_dot_product_attention(q[None], k[None], v[None],
                                                    is_causal=True), 5)
    bound_fwd = 1e3 * max(4.0 * D_T * pairs / F32_PEAK,
                          6.0 * H_T * P_T * D_T * 4 / HBM_BYTES_PER_S)
    log(f"  plain backward (dq, dk, dv) f32 {t['plain_bwd']:.3f} ms")
    log(f"  flash_attention_single_panel {ms_fwd:.3f} ms, plain "
        f"{plain_fwd:.3f} ms, SDPA forward {lib_fwd:.3f} ms, bound "
        f"{bound_fwd:.3f} ms (operations, 4*d per pair)")
    del bargs, q, k, v
    torch.cuda.empty_cache()
    bwd_times(torch, fa, gen, torch.bfloat16, pairs)
    torch.cuda.empty_cache()
    return t


def bsr_config(np, grid):
    """bench_all.py config_bsr's generator at ``grid``: sorted distinct block
    ids, standard-normal blocks and B, from default_rng(0). Returns (n, block
    rows, block cols, blocks, b) as numpy."""
    rng = np.random.default_rng(0)
    n = grid * BSR_BS
    nnzb = max(1, int(grid * grid * BSR_DENSITY))
    ids = np.sort(rng.choice(grid * grid, nnzb, replace=False))
    blocks = rng.standard_normal((nnzb, BSR_BS, BSR_BS)).astype(np.float32)
    b = rng.standard_normal((n, BSR_P)).astype(np.float32)
    return n, ids // grid, ids % grid, blocks, b


def bsr_rows_ref(np, brows, bcols, blocks, b, rows):
    """Rows ``rows`` of the block-sparse product in f64 on the host, from the
    numpy blocks (block rows sorted)."""
    bs = blocks.shape[1]
    out = np.zeros((len(rows), b.shape[1]))
    for i, r in enumerate(rows):
        for j in np.flatnonzero(brows == r // bs):
            c0 = int(bcols[j]) * bs
            out[i] += blocks[j, r % bs].astype(np.float64) @ \
                b[c0:c0 + bs].astype(np.float64)
    return out


def coo_rows_ref(torch, coo, b, rows):
    """Rows ``rows`` of ``coo @ b`` in f64, from a coalesced sparse COO
    tensor's entries."""
    idx, vals = coo.indices(), coo.values()
    out = torch.zeros((len(rows), b.shape[1]), dtype=torch.float64,
                      device=b.device)
    for i, r in enumerate(rows):
        sel = idx[0] == r
        out[i] = (vals[sel].double()[:, None]
                  * b[idx[1][sel]].double()).sum(0)
    return out


def check_rows(label, out, shape, ref_rows, got_rows) -> float:
    """Raises unless ``out`` has ``shape``, is finite on the sampled rows, and
    its max error there against the f64 rows is within F64_TOL of max|ref|."""
    import numpy as np

    ref = np.asarray(ref_rows, dtype=np.float64)
    got = np.asarray(got_rows, dtype=np.float64)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"  {label} vs f64 on {len(ref)} rows: max rel err {rel:.3e} "
        f"(tol {F64_TOL})")
    if tuple(out.shape) != tuple(shape) or not np.isfinite(got).all() \
            or not rel <= F64_TOL:
        raise AssertionError(f"{label}: shape {tuple(out.shape)}, rel err "
                             f"{rel}")
    return rel


def bsr_case(torch, sb, gen, m, n, p, bs, keep, dtype, empty_rows=(),
             hot_col=None):
    """A random BSR matrix on the card: each block of the (m/bs × n/bs) grid
    stored with probability ``keep``, none in ``empty_rows``, every other
    block row holding block column ``hot_col``; and a random B (n, p)."""
    nbr, nbc = -(-m // bs), -(-n // bs)
    mask = torch.rand((nbr, nbc), generator=gen, device="cuda") < keep
    if hot_col is not None:
        mask[:, hot_col] = True
    mask[list(empty_rows)] = False
    rows, cols = mask.nonzero(as_tuple=True)
    blocks = torch.randn((len(rows), bs, bs), generator=gen,
                         device="cuda").to(dtype)
    b = torch.randn((n, p), generator=gen, device="cuda").to(dtype)
    return sb.BsrMatrix(blocks, rows.int(), cols.int(), (m, n), bs), b


def check_bsr(torch, sb, label, bsr, b) -> tuple[float, float]:
    """``bsr_spmm_pallas`` against its plain version, per element (BSR_*
    bounds); returns the max |err| and the max err/bound."""
    got = sb.bsr_spmm_pallas(bsr, b)
    want = sb.bsr_spmm_pallas_plain(bsr, b)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    return bwd_close(torch, f"{label} nnzb={bsr.nnzb}", got, want, b.dtype,
                     BSR_F32_ATOL, BSR_F32_RTOL, BSR_BF16_ATOL)


def bsr_checks(torch, sb, gen, main_bsr, main_b):
    """Phase 13; returns the main shape's max |err| and the largest
    err/bound over the cases."""
    log("phase 13: bsr_spmm_pallas vs its plain version")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        cases = (  # (label, m, n, p, bs, keep, empty block rows, hot column)
            ("bs=8 ragged", 8 * 37 + 5, 8 * 21 + 3, 77, 8, 0.3, (2, 5), 3),
            ("bs=32 ragged", 32 * 13 + 7, 32 * 9 + 31, 129, 32, 0.3, (0,), 0),
            ("bs=64 ragged", 64 * 9 + 1, 64 * 7 + 5, 259, 64, 0.4, (4,), 2),
            ("bs=128 ragged", 128 * 5 + 100, 128 * 6 + 1, 69, 128, 0.5, (1,),
             5),
            ("no block", 192, 192, 10, 64, 0.0, (), None),
            # more block rows than a 2-D grid's y axis (65535) could hold
            ("bs=8, 65538 block rows", 65537 * 8 + 13, 64, 5, 8, 5e-4, (),
             None),
        )
        for label, m, n, p, bs, keep, empty, hot in cases:
            bsr, b = bsr_case(torch, sb, gen, m, n, p, bs, keep, dtype, empty,
                              hot)
            _, r = check_bsr(torch, sb, f"{label} {m}x{n} p={p} {dt}", bsr, b)
            worst = max(worst, r)
    err, r = check_bsr(torch, sb, f"main shape {main_bsr.shape} bs={BSR_BS} "
                       f"p={BSR_P} float32", main_bsr, main_b)
    worst = max(worst, r)
    log(f"  largest err/bound over the BSR checks: {worst:.3f}")
    return err, worst


def sparse_path(torch, np, mt, sb, autotune, ops, bsr, b, data):
    """Phase 14: the sparse path at full width, through the calls a user
    makes: ``BsrMatrix.multiply(backend="auto")`` twice (the first tunes),
    then ``SparseVecMatrix.multiply`` in every format. Returns the launch
    counts of that path alone, the tuner's timing calls included; the
    explicit ``backend="pallas"``/``"chunked"`` calls that check it run after
    the counts are read."""
    n, brows, bcols, blocks, b_np = data
    flops = 2.0 * bsr.nnzb * BSR_BS ** 2 * BSR_P
    log(f"phase 14: BsrMatrix {bsr.shape} bs={BSR_BS} nnzb={bsr.nnzb} "
        f"(block density {BSR_DENSITY}) @ ({n}, {BSR_P}) f32, "
        f"backend='auto', then SparseVecMatrix.multiply")
    rankings, by_tuner = [], [0]
    tune = autotune.tune_bsr

    def counted_tune(m, *args, **kw):
        before = sb.bsr_spmm_pallas.launches
        rankings.append(tune(m, *args, **kw))
        by_tuner[0] += sb.bsr_spmm_pallas.launches - before
        op = 2.0 * m.nnzb * m.block_size ** 2 * BSR_P
        log(f"  tune_bsr {m.shape} nnzb={m.nnzb} (CUDA events, median of "
            f"rounds; winner first): " + ", ".join(
                f"{nm} {sec * 1e3:.3f} ms ({op / sec / 1e9:.1f} GFLOP/s)"
                for nm, sec in rankings[-1]))
        return rankings[-1]

    def timed(label, call, tunes, via_bsr=True):
        """Runs one user call; raises unless it tuned ``tunes`` times and
        launched the kernel for its product exactly when it goes through
        ``BsrMatrix.multiply("auto")`` and the winner is the kernel. Returns
        (result, seconds)."""
        n_rank, launches = len(rankings), sb.bsr_spmm_pallas.launches
        tuned = by_tuner[0]
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tuned = by_tuner[0] - tuned
        by_product = sb.bsr_spmm_pallas.launches - launches - tuned
        winner = rankings[-1][0][0] if via_bsr else None
        log(f"  {label}: {secs:.3f} s" + (f"; ran {winner}" if via_bsr else "")
            + f"; kernel launches {tuned} by the tuner, {by_product} by the "
            f"product")
        if len(rankings) - n_rank != tunes or \
                by_product != int(winner == "pallas"):
            raise AssertionError(f"{label}: tuned {len(rankings) - n_rank} "
                                 f"times (want {tunes}), {by_product} product "
                                 f"launches with winner {winner}")
        return out, secs

    autotune.tune_bsr = counted_tune
    try:
        autotune.clear_cache()
        ops.reset_launch_counts()
        # ------------------------------------------- the path, counted
        out_auto, _ = timed("first multiply (tunes)",
                            lambda: bsr.multiply(b, backend="auto"), 1)
        out_auto, auto_s = timed("second multiply (cached winner)",
                                 lambda: bsr.multiply(b, backend="auto"), 0)
        log(f"  second multiply: {auto_s * 1e3:.3f} ms = "
            f"{flops / auto_s / 1e9:.1f} GFLOP/s (host clock with sync)")

        n8, br8, bc8, bl8, b8 = bsr_config(np, SPMV_GRID)
        r = (br8[:, None, None] * BSR_BS + np.arange(BSR_BS)[None, :, None])
        c = (bc8[:, None, None] * BSR_BS + np.arange(BSR_BS)[None, None, :])
        shape = (bl8.shape[0], BSR_BS, BSR_BS)
        sp = mt.CoordinateMatrix(np.broadcast_to(r, shape).ravel(),
                                 np.broadcast_to(c, shape).ravel(),
                                 bl8.ravel(),
                                 shape=(n8, n8)).to_sparse_vec_matrix()
        out8, _ = timed(f"SparseVecMatrix {sp.shape} nnz={sp.nnz} from COO "
                        f"triplets, multiply(format='bsr') (with to_bsr)",
                        lambda: sp.multiply(mt.BlockMatrix.from_array(b8),
                                            format="bsr"), 1)
        del sp

        sp = mt.SparseVecMatrix.random(7, ELL_N, ELL_N, ELL_DENSITY)
        dense = mt.DenseVecMatrix.random(8, ELL_N, BSR_P)
        outs = {}
        for fmt in ("ell", "bcoo", "auto"):  # "auto" picks ELL below 1 %
            outs[fmt], _ = timed(
                f"SparseVecMatrix {sp.shape} nnz={sp.nnz} "
                f"multiply(format={fmt!r})",
                lambda: sp.multiply(dense, format=fmt), 0, via_bsr=False)
        counts = ops.launch_counts()
    finally:
        autotune.tune_bsr = tune
    log(f"  launches on the main path: {counts} (bsr_spmm_pallas: "
        f"{by_tuner[0]} by the tuner, "
        f"{counts['bsr_spmm_pallas'] - by_tuner[0]} by the products)")
    if counts["bsr_spmm_pallas"] <= 0:
        raise AssertionError("bsr_spmm_pallas never launched on the main path")

    # ------------------------------------- checks, outside the counted path
    out_pallas = bsr.multiply(b, backend="pallas")
    out_chunked = bsr.multiply(b, backend="chunked")
    rows = [0, 1, n // 7, n // 3, n // 2 + 5, 2 * n // 3, n - 2, n - 1]
    ref = bsr_rows_ref(np, brows, bcols, blocks, b_np, rows)
    for label, out in (("auto", out_auto), ("pallas", out_pallas),
                       ("chunked", out_chunked)):
        check_rows(f"backend={label!r}", out, (n, BSR_P), ref,
                   out[rows].double().cpu().numpy())
    del out_auto, out_pallas, out_chunked
    rows8 = [0, BSR_BS - 1, BSR_BS, n8 // 2 + 1, n8 - 1]
    check_rows("SparseVecMatrix format='bsr'", out8, (n8, BSR_P),
               bsr_rows_ref(np, br8, bc8, bl8, b8, rows8),
               out8.data[rows8].double().cpu().numpy())
    rows = [0, 1, ELL_N // 3, ELL_N // 2 + 1, ELL_N - 1]
    ref = coo_rows_ref(torch, sp.bcoo, dense.data, rows).cpu().numpy()
    for fmt, out in outs.items():
        check_rows(f"SparseVecMatrix format={fmt!r}", out, (ELL_N, BSR_P),
                   ref, out.data[rows].double().cpu().numpy())
    del sp, dense, out8, outs
    torch.cuda.empty_cache()
    return counts


def bsr_times(torch, sb, bsr, b):
    """Phase 15: kernel, plain, chunked, library and bound times at the main
    shape; returns them by name."""
    log(f"phase 15: BSR times at {bsr.shape} bs={BSR_BS} nnzb={bsr.nnzb} "
        f"p={BSR_P} f32 (CUDA events)")
    ms = cuda_ms(torch, lambda: sb.bsr_spmm_pallas(bsr, b), 10)
    plain = cuda_ms(torch, lambda: sb.bsr_spmm_pallas_plain(bsr, b), 5)
    chunked = cuda_ms(torch, lambda: sb.bsr_spmm(bsr, b), 5)
    m, n = bsr.shape
    nbr = -(-m // BSR_BS)
    row_ptr = torch.zeros((nbr + 1,), dtype=torch.int64, device="cuda")
    torch.cumsum(torch.bincount(bsr.block_rows, minlength=nbr), 0,
                 out=row_ptr[1:])
    t = torch.sparse_bsr_tensor(row_ptr, bsr.block_cols.long(), bsr.blocks,
                                (m, n), check_invariants=False)
    lib_err = float((t @ b - sb.bsr_spmm_pallas_plain(bsr, b)).abs().max())
    lib = cuda_ms(torch, lambda: t @ b, 5)
    log(f"  library: torch.sparse_bsr_tensor @ b {lib:.3f} ms (max|err| vs "
        f"plain {lib_err:.3e})")
    flops = 2.0 * bsr.nnzb * BSR_BS ** 2 * BSR_P
    io_bytes = 4.0 * (bsr.nnzb * BSR_BS ** 2 + n * BSR_P + m * BSR_P) \
        + 8.0 * bsr.nnzb
    bound = 1e3 * max(flops / F32_PEAK, io_bytes / HBM_BYTES_PER_S)
    log(f"  bsr_spmm_pallas {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain:.3f} ms, chunked {chunked:.3f} ms, bound {bound:.3f} ms "
        f"(operations: {flops / 1e9:.2f} GFLOP; bytes "
        f"{1e3 * io_bytes / HBM_BYTES_PER_S:.3f} ms for "
        f"{io_bytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain=plain, chunked=chunked, lib=lib, bound=bound)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import marlin_tpu_torch as mt
    from marlin_tpu_torch import ops
    from marlin_tpu_torch.ops import _build
    from marlin_tpu_torch.ops import pallas_kernels as pk
    from marlin_tpu_torch.ops.tile_family import (BK_AXIS, BM_AXIS, BN_AXIS)
    from marlin_tpu_torch.parallel import autotune

    t_start = time.perf_counter()
    # ---------------------------------------------------------- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())

    # ------------------------------------- 3. kernels against plain versions
    log("phase 3: kernels vs plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((130, 70, 50), (64, 300, 64), (1000, 1000, 1000)):
            check_gemm(torch, pk, m, k, n, dtype, gen)
        for bm in BM_AXIS:
            for bn in BN_AXIS:
                for bk in BK_AXIS:
                    check_gemm(torch, pk, 257, 300, 199, dtype, gen, (bm, bn, bk))
    # more output-row tiles than a 2-D grid's y axis (65535) could hold
    check_gemm(torch, pk, 65535 * 128 + 77, 24, 40, torch.float32, gen)
    gemm_err = check_gemm(torch, pk, N, N, N, torch.float32, gen)
    fill_err = check_fill(torch, pk,
                          torch.randn((N, N), generator=gen, device="cuda"),
                          N - 1, 17)
    for shape, dtype in (((1001, 1001), torch.float32),
                         ((333, 517), torch.bfloat16),
                         ((256, 200), torch.bfloat16),
                         ((64, 40), torch.float64)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        check_fill(torch, pk, x, shape[0] - 3, shape[1] - 5)
    torch.cuda.empty_cache()

    # ------------------------------------------ 4. the slice at full size
    log(f"phase 4: DenseVecMatrix.random x2 -> multiply at {N}^2 f32")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    a = mt.DenseVecMatrix.random(0, N, N)
    b = mt.DenseVecMatrix.random(1, N, N)
    t0 = time.perf_counter()
    c = mt.evaluate(a.multiply(b, precision="high"))
    log(f"  multiply (torch.matmul): {time.perf_counter() - t0:.3f} s, "
        f"{type(c).__name__} {c.shape} {c.dtype} on {c.device}")
    t0 = time.perf_counter()
    g = mt.evaluate(ops.gemm(a.data, b.data, backend="pallas"))
    log(f"  gemm(backend='pallas'): {time.perf_counter() - t0:.3f} s")
    restored = mt.evaluate(ops.masked_fill(c.data, *c.shape))
    if not torch.equal(restored, c.data):
        raise AssertionError("masked_fill over the logical region changed data")
    rows = torch.tensor([0, 1, 4999, 9998, 12345, 17001, N - 2, N - 1],
                        device="cuda")
    ref = a.data[rows].double() @ b.data.double()
    scale = float(ref.abs().max())
    for label, out in (("multiply", c.data), ("gemm pallas", g)):
        if out.shape != (N, N) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: bad shape or non-finite values")
        rel = float((out[rows].double() - ref).abs().max()) / scale
        log(f"  {label} vs f64 on 8 rows: max rel err {rel:.3e} (tol {F64_TOL})")
        if not rel <= F64_TOL:
            raise AssertionError(f"{label}: rel err {rel} > {F64_TOL}")
    del ref, restored

    autotune.clear_cache()
    a4 = mt.DenseVecMatrix.random(2, 4096, 4096).data
    b4 = mt.DenseVecMatrix.random(3, 4096, 4096).data
    ranking = autotune.tune_gemm(a4, b4, reps=3)
    log("  tune_gemm 4096^3: " + ", ".join(f"{nm} {s * 1e3:.3f} ms"
                                           for nm, s in ranking))
    before = pk.pallas_matmul.launches
    t0 = time.perf_counter()
    best = autotune.best_gemm(a4, b4)
    if best != ranking[0][0] or pk.pallas_matmul.launches != before:
        raise AssertionError("best_gemm re-timed instead of reading the cache")
    log(f"  best_gemm: {best} from the cache in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in ("pallas_matmul", "masked_fill")}
    log(f"  launches on the main path: {launches}")
    for kname, n_launch in launches.items():
        if n_launch <= 0:
            raise AssertionError(f"{kname} never launched on the main path")
    del a4, b4

    # -------------------------------------------------------- 5. times
    log(f"phase 5: times at {N}^2 f32 (CUDA events after warm-up)")
    ad, bd = a.data, b.data
    ms_gemm = cuda_ms(torch, lambda: pk.pallas_matmul(ad, bd), 3)
    plain_gemm = cuda_ms(torch, lambda: pk.pallas_matmul_plain(ad, bd), 3)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_gemm = cuda_ms(torch, lambda: torch.matmul(ad, bd), 3)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    bound_gemm = 1e3 * max(2.0 * N ** 3 / F32_PEAK,
                           3.0 * N * N * 4 / HBM_BYTES_PER_S)
    fr, fc = N - 1, N - 1
    ms_fill = cuda_ms(torch, lambda: pk.masked_fill(ad, fr, fc), 20)
    plain_fill = cuda_ms(torch, lambda: pk.masked_fill_plain(ad, fr, fc), 20)
    lib_fill = cuda_ms(torch, lambda: torch.nn.functional.pad(
        ad[:fr, :fc], (0, N - fc, 0, N - fr)), 20)
    bound_fill = 1e3 * 2.0 * N * N * 4 / HBM_BYTES_PER_S
    log(f"  pallas_matmul {ms_gemm:.3f} ms ({2.0 * N ** 3 / ms_gemm / 1e9:.1f} "
        f"TFLOP/s), plain {plain_gemm:.3f} ms, torch.matmul {lib_gemm:.3f} ms, "
        f"bound {bound_gemm:.3f} ms (operations)")
    log(f"  masked_fill {ms_fill:.4f} ms, plain {plain_fill:.4f} ms, "
        f"F.pad {lib_fill:.4f} ms, bound {bound_fill:.4f} ms (bytes)")
    log(f"  peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    del a, b, c, g, ad, bd
    torch.cuda.empty_cache()

    import numpy as np
    from marlin_tpu_torch.models import transformer as tt
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.ops import paged_attention as pa

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 references would not be f32")

    # ------------------------------- 6. paged decode kernel vs plain version
    log("phase 6: paged_decode_attention vs its plain version")
    page_len = PAGE_LEN
    W = -(-(PROMPT + DECODE_STEPS) // page_len)  # 36: the bucket's table
    paged_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, kvh, group in ((ROWS, 8, 1), (64, 8, 1), (ROWS, 2, 4)):
            e = check_paged(torch, pa, gen, B, kvh, group, 64, page_len, W,
                            dtype)
            if dtype == torch.float32 and (B, group) == (ROWS, 1):
                paged_err = e

    # ----------------------------------- 7. flash panel kernel vs plain version
    log("phase 7: flash_attention_panel vs its plain version")
    flash_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for P in (4096, LONG_PROMPT):
            e = check_flash(torch, fa, gen, 8, P, 64, P - 100, dtype)
            if dtype == torch.float32 and P == LONG_PROMPT:
                flash_err = e
    torch.cuda.empty_cache()

    # ------------------------------------- 8. the serving path at full width
    log(f"phase 8: TransformerLM{tuple(LM.values())} f32: {ROWS} requests "
        f"of {PROMPT} tokens through PagedKVPool -> lm_prefill_paged -> "
        f"{DECODE_STEPS} x lm_decode_paged(kernel='pallas'), then generate "
        f"on {LONG_PROMPT} tokens")
    lm = tt.TransformerLM(**LM)
    params = lm.init_params()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, LM["vocab"], PROMPT).astype(np.int32)
               for _ in range(ROWS)]
    prompts[1][:SHARED] = prompts[0][:SHARED]  # a shared 256-token prefix
    long_prompt = rng.integers(0, LM["vocab"], LONG_PROMPT).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if tt.resolve_decode_kernel("auto", "cuda") != "pallas":
        raise AssertionError("decode kernel 'auto' must pick the kernel on a "
                             "CUDA device")
    streams, audit, steps, decode_s = serve(params, prompts, "pallas")
    t0 = time.perf_counter()
    long_out = lm.generate(params, long_prompt, steps=LONG_STEPS)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    path_counts = ops.launch_counts()
    log(f"  launches on the main path: {path_counts}")
    for kname in ("paged_decode_attention", "flash_attention_panel"):
        if path_counts[kname] <= 0:
            raise AssertionError(f"{kname} never launched on the main path")
    tok = ROWS * steps
    log(f"  decode: {tok} tokens in {decode_s:.3f} s = {tok / decode_s:.1f} "
        f"tok/s, {decode_s / steps * 1e3:.3f} ms per step (batch {ROWS}, "
        f"host clock, one sync per step)")
    log(f"  pool after release: {audit}")
    if not audit["ok"] or steps != DECODE_STEPS or audit["hits"] != 1 or \
            audit["cow_copies"] != 1 or audit["used"] != audit["cached"]:
        raise AssertionError(f"pool bookkeeping: {steps} steps, {audit}")
    log(f"  generate({LONG_PROMPT} tokens, {LONG_STEPS} steps): {long_s:.3f} s")
    log(f"  peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # references on the same card
    gather, _, _, gather_s = serve(params, prompts, "gather")
    log(f"  gather backend: {tok / gather_s:.1f} tok/s, "
        f"{gather_s / steps * 1e3:.3f} ms per step")
    if streams != gather:
        bad = [i for i in range(ROWS) if streams[i] != gather[i]]
        raise AssertionError(f"pallas vs gather streams differ in rows {bad}")
    for i, prompt in enumerate(prompts):
        ref = tt.lm_generate(params, prompt, 0, heads=LM["heads"],
                             max_len=PROMPT + DECODE_STEPS + 1,
                             steps=DECODE_STEPS + 1)[PROMPT:].tolist()
        if streams[i] != ref:
            raise AssertionError(f"request {i}: paged stream != lm_generate")
        if not all(0 <= t < LM["vocab"] for t in ref):
            raise AssertionError(f"request {i}: token out of range")
    log(f"  greedy streams: pallas == gather == lm_generate for all {ROWS} "
        f"requests ({DECODE_STEPS + 1} tokens each)")
    kernel_panel = fa.flash_attention_single_panel
    fa.flash_attention_single_panel = fa.flash_attention_single_panel_plain
    try:
        long_ref = lm.generate(params, long_prompt, steps=LONG_STEPS)
    finally:
        fa.flash_attention_single_panel = kernel_panel
    if long_out.tolist() != long_ref.tolist():
        raise AssertionError("16k generate: kernel flash != plain flash tokens")
    log(f"  generate {LONG_PROMPT}: tokens {long_out[LONG_PROMPT:].tolist()} "
        f"== the plain flash version's")
    del params
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 9. times
    log("phase 9: attention kernel times (CUDA events)")
    B, kvh, dh = ROWS, LM["heads"], LM["d_model"] // LM["heads"]
    q, kp, vp, tables, _ = paged_inputs(torch, gen, B, kvh, 1, dh, page_len,
                                        W, torch.float32)
    tables = (1 + torch.arange(B * W, device="cuda")).reshape(B, W).int()
    lengths = torch.full((B,), W * page_len, dtype=torch.int32, device="cuda")
    mask = (torch.arange(W * page_len, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]

    def sdpa_paged():
        k = kp[tables.long()].reshape(B, -1, kvh, dh).transpose(1, 2)
        v = vp[tables.long()].reshape(B, -1, kvh, dh).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, kvh, 1, dh), k, v, attn_mask=mask)

    ms_paged = cuda_ms_cold(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lengths), 20)
    plain_paged = cuda_ms_cold(torch, lambda: pa.paged_decode_attention_plain(
        q, kp, vp, tables, lengths), 5)
    lib_paged = cuda_ms_cold(torch, sdpa_paged, 20)
    live = int(lengths.sum())
    paged_bytes = (2.0 * live * kvh * dh + 2.0 * B * kvh * dh) * 4 \
        + 4.0 * B * (W + 1)
    bound_paged = 1e3 * paged_bytes / HBM_BYTES_PER_S
    log(f"  paged_decode_attention B={B} W={W} f32, L2 flushed: "
        f"{ms_paged:.4f} ms, plain {plain_paged:.4f} ms, gather+SDPA "
        f"{lib_paged:.4f} ms, bound {bound_paged:.4f} ms (bytes, "
        f"{paged_bytes / 1e6:.2f} MB)")
    H, P = LM["heads"], LONG_PROMPT
    qf, kf, vf = (torch.randn((H, P, dh), generator=gen, device="cuda")
                  for _ in range(3))
    scale = 1.0 / math.sqrt(dh)
    ms_flash = cuda_ms(torch, lambda: fa.flash_attention_single_panel(
        qf, kf, vf, P, causal=True, scale=scale), 5)
    plain_flash = cuda_ms(torch, lambda: fa.flash_attention_single_panel_plain(
        qf, kf, vf, P, causal=True, scale=scale), 2)
    lib_flash = cuda_ms(torch, lambda: torch.nn.functional
                        .scaled_dot_product_attention(qf[None], kf[None],
                                                      vf[None], is_causal=True),
                        5)
    flash_ops = 4.0 * dh * H * P * (P + 1) / 2  # live (query, key) pairs
    bound_flash = 1e3 * max(flash_ops / F32_PEAK,
                            6.0 * H * P * dh * 4 / HBM_BYTES_PER_S)
    log(f"  flash_attention_single_panel H={H} P={P} d={dh} causal f32: "
        f"{ms_flash:.3f} ms ({flash_ops / ms_flash / 1e9:.1f} TFLOP/s), plain "
        f"{plain_flash:.3f} ms, SDPA {lib_flash:.3f} ms, bound "
        f"{bound_flash:.3f} ms (operations)")

    del qf, kf, vf
    torch.cuda.empty_cache()

    bwd_errs, bwd_worst = backward_checks(torch, fa, gen)
    train_counts = train_path(torch, np, tt, fa, ops)
    t = train_times(torch, fa, gen, _build)
    torch.cuda.empty_cache()

    # the main shape's 215 MB of blocks are made once, for phases 13-15
    from marlin_tpu_torch.ops import sparse_bsr as sb

    data = bsr_config(np, BSR_GRID)
    n_bsr, brows, bcols, blocks, b_np = data
    main_bsr = sb.BsrMatrix(torch.from_numpy(blocks).cuda(),
                            torch.from_numpy(brows).cuda(),
                            torch.from_numpy(bcols).cuda(), (n_bsr, n_bsr),
                            BSR_BS)
    main_b = torch.from_numpy(b_np).cuda()
    bsr_err, _ = bsr_checks(torch, sb, gen, main_bsr, main_b)
    sparse_counts = sparse_path(torch, np, mt, sb, autotune, ops, main_bsr,
                                main_b, data)
    tb = bsr_times(torch, sb, main_bsr, main_b)

    # ---------------------------------------------------- kernels line
    kernels = [
        {"name": "pallas_matmul", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/gemm.cu",
         "replaces": "marlin_tpu/ops/pallas_kernels.py:45",
         "launches": launches["pallas_matmul"], "max_abs_err": gemm_err,
         "ms": ms_gemm, "plain_ms": plain_gemm, "bound_ms": bound_gemm,
         "bound_by": "operations", "library_ms": lib_gemm},
        {"name": "masked_fill", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/masked_fill.cu",
         "replaces": "marlin_tpu/ops/pallas_kernels.py:98",
         "launches": launches["masked_fill"], "max_abs_err": fill_err,
         "ms": ms_fill, "plain_ms": plain_fill, "bound_ms": bound_fill,
         "bound_by": "bytes", "library_ms": lib_fill},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/paged_attention.cu",
         "replaces": "marlin_tpu/ops/paged_attention.py:91",
         "launches": path_counts["paged_decode_attention"],
         "max_abs_err": paged_err, "ms": ms_paged, "plain_ms": plain_paged,
         "bound_ms": bound_paged, "bound_by": "bytes", "library_ms": lib_paged},
        {"name": "flash_attention_panel", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:93",
         "launches": path_counts["flash_attention_panel"],
         "max_abs_err": flash_err, "ms": ms_flash, "plain_ms": plain_flash,
         "bound_ms": bound_flash, "bound_by": "operations",
         "library_ms": lib_flash},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:195",
         "launches": train_counts["flash_attention_bwd_dkv"],
         "max_abs_err": max(bwd_errs["dk"], bwd_errs["dv"]),
         "ms": t["ms_dkv"], "plain_ms": t["plain_bwd"],
         "bound_ms": t["bound_dkv"], "bound_by": "operations",
         "library_ms": t["lib_bwd"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:232",
         "launches": train_counts["flash_attention_bwd_dq"],
         "max_abs_err": bwd_errs["dq"], "ms": t["ms_dq"],
         "plain_ms": t["plain_bwd"], "bound_ms": t["bound_dq"],
         "bound_by": "operations",
         "library_ms": t["lib_bwd"]},
        {"name": "bsr_spmm_pallas", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/bsr_spmm.cu",
         "replaces": "marlin_tpu/ops/sparse_bsr.py:203",
         "launches": sparse_counts["bsr_spmm_pallas"],
         "max_abs_err": bsr_err, "ms": tb["ms"], "plain_ms": tb["plain"],
         "bound_ms": tb["bound"], "bound_by": "operations",
         "library_ms": tb["lib"]},
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
