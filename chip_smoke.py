#!/usr/bin/env python3
"""Smoke run of marlin_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``marlin_tpu_torch/csrc/`` (one ``nvcc``
per source, all at once), holds each against its plain PyTorch version, and
drives the ported paths end to end through the public entry points:

- phases 1-5: the dense 20000² multiply (GEMM and masked-fill kernels): the
  GEMM's instances' registers and spills from ptxas (a spill fails the run),
  every tile in f32 and bf16 against the plain version, ragged and unaligned
  shapes, a long k (256 x 65536 x 256) against f64, two runs bit-identical;
  ``gemm(backend="pallas")`` at 20000² against f64 on sampled rows, the
  4096³ tuner ranking; the GEMM in f32 (and its pre-pass alone) and bf16
  beside ``torch.matmul`` and the 3xTF32 / bf16 tensor-core bounds;
- phases 6-7: the paged decode-attention (split and combine kernels: their
  instances' registers and spills from ptxas, a spill fails the run) and
  flash-panel kernels against their plain versions at the serving shapes
  (f32 and bf16; the paged kernel at the serving bucket, at one split, at
  16384 tokens, GQA, a group of 16 heads of 256 in two chunks, page_len 5
  with dh 40, an odd dh that takes element-wise copies, ragged and dummy
  rows, two runs bit-identical; the flash panel on the strided (P, heads, d)
  views that prefill passes, two panels with carried state and offsets, and
  at head dims 192 and 256), every element within tolerance;
- phase 8: the serving path at full width — ``TransformerLM(vocab=4096,
  d_model=512, heads=8, layers=4)`` (the repo's decode benchmark model,
  ``bench_all.py`` ``config_decode``), 8 requests of 512 tokens through
  ``paged_serve_loop.serve_bucket``: ``PagedKVPool`` (prefix match, insert,
  copy-on-write) → chunked ``lm_prefill_paged`` → 64
  ``lm_decode_paged(kernel="pallas")`` steps → release and audit, then
  ``generate`` on one 16384-token prompt through the flash kernel in every
  layer, and on a 4096-token prompt of a ``TransformerLM(vocab=4096,
  d_model=1024, heads=4, layers=2)`` (head dim 256); greedy tokens held
  against the gather backend, per-request ``lm_generate`` and the plain
  flash version;
- phase 9: kernel, plain, bound and library times; the paged kernel (split
  plus combine) at the serving bucket and at 16384 tokens beside gather +
  SDPA, timed on the card with L2 flushed; the flash forward also in bf16
  beside SDPA's bf16 forward;
- phase 10: the flash forward (output and lse) and backward kernels (dK/dV
  and dQ) against their plain versions, element by element: the training
  shape (2 heads × 32768 × 128, causal, ``valid_len`` 32767) in f32 and
  bf16, on contiguous tensors and the strided (S, heads, d) views ``_block``
  hands ring attention; for the backward also two panels with offsets, a
  non-causal case, d = 64, and the d <= 256 instances at head dim 256 (the
  training stream, the strided views and a non-causal case);
- phase 11: the training path at full width — ``bench_all.py``
  ``config_lct``'s ``TransformerLM(vocab=512, d_model=256, heads=2,
  layers=2)``, f32, Adam at 3e-3, ``attn="ring"``: one warm-up step, then 3
  steps of ``TransformerLM.train`` on one 32768-token stream through the
  flash forward, dK/dV and dQ kernels; the first step's gradients and the 3
  steps' losses and params held against the same run with the plain flash
  versions swapped in; one step each with ``attn="ulysses"`` and with
  ``remat=True, loss_chunk=16384`` held against the ring step; then one step
  of the model widened to head dim 256 with ``attn="ring"`` and
  ``"ulysses"`` (both through the flash kernels, launches counted) held
  against ``"ring_xla"``;
- phase 12: the forward and backward kernels' registers and spills from
  ptxas (a spill fails the run); the flash kernels' times at the training
  shape in f32 and bf16, each beside SDPA's and the tensor-core bound
  (3xTF32 at 495/3 TFLOP/s for f32, 989 for bf16), and the backward pair's
  at head dim 256 (2 x 32768 x 256);
- phase 13: the BSR SpMM kernel's instances' registers and spills from ptxas
  (a spill fails the run), then the kernel against its plain version,
  element by element: block sizes 8 and 32 (CUDA cores), 64, 128 and 192
  (tensor cores) with ragged m, n and p, empty block rows and a hot block
  column, in f32 and bf16; no block at all; more than 65535 block rows on
  both instances; 8192² with 204 blocks; the main shape; two runs
  bit-identical;
- phase 14: the sparse path at full width — ``bench_all.py`` ``config_bsr``
  (32768², bs 128, block density 0.05, p 256): ``BsrMatrix.multiply(
  backend="auto")`` tunes over the chunked formulation and the kernel, a second
  call reads the cache, and every backend is held against f64 on sampled rows;
  then ``SparseVecMatrix.multiply`` from COO triplets at 8192² (format "bsr")
  and on a 100000² matrix at density 1e-4 (formats "ell", "bcoo", "auto");
- phase 15: the BSR kernel's times at the main shape (with its pre-pass of
  B, and the pre-pass alone; bf16 beside) against the 3xTF32 bound, the
  plain and chunked paths and ``torch.sparse_bsr_tensor @ b``; and at 8192²
  against the chunked candidate;
- phase 16: the dense linalg path at ``bench_all.py``'s sizes: first the
  card's dist-mode factorizations against the port's own CPU run at 1024²
  (blocks of 128; every LU leg with perm equal, both Cholesky schedules,
  the inverse), then ``config_lu``'s matrix (8192², random + n·I) through
  ``lu_decompose(mode="dist")`` in its three legs (masked and shrinking
  with block pivoting, masked with panel pivoting), ``config_cholesky``'s
  (R Rᵀ + n·I) through both Cholesky schedules, ``inverse`` and ``solve``
  against 8192 x 64 right-hand sides, each call under
  ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside fails the
  run) and each result against f64 on 64 sampled rows (A[perm] − L U,
  A − L Lᵀ, A A⁻¹ − I, A x − b); host time, GFLOP/s and peak device memory
  logged;
- phase 17: ``config_svd``'s ``compute_svd(8, "dist-eigs",
  compute_u=False)`` on a 1,000,000 x 512 ``DenseVecMatrix.random(0, ...)``
  (singular values against the square roots of f64 ``eigvalsh(AᵀA)``) and
  ``lr`` on 262,144 rows of a label and 784 features for 100 iterations
  (weights against an f64 run).

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
# head dims above 128, which the forward kernel's widest instances take; the
# wide model: d_model 1024 over 4 heads (dh 256), generate on a 4096-token
# prompt (flash prefill from 2048 tokens)
WIDE_DH = (192, 256)
WIDE_LM = dict(vocab=4096, d_model=1024, heads=4, layers=2, seed=0)
WIDE_PROMPT, WIDE_STEPS = 4096, 4
# the training path: bench_all.py config_lct's model and stream
LCT = dict(vocab=512, d_model=256, heads=2, layers=2, seed=0)
TRAIN_SEQ, TRAIN_STEPS = 32768, 3
# one step of that model widened to dh 256, on a shorter stream; the
# backward kernels' d <= 256 instances also at the training shape
# (2 x 32768 x 256)
WIDE_TRAIN_DH, WIDE_TRAIN_SEQ = 256, 4096
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
# bf16 at head dims above 128 (the d <= 256 instances): the scores sum twice
# as many products, so more p and ds roundings land a step apart. The H100
# read a dq 1.27x the d = 128 bound above (1.9e-3 of max|plain|, non-causal,
# 4096 keys; the training shape 0.73x); 2e-3 of max|plain| is still a 50th
# of a typical element there.
BWD_BF16_WIDE_ATOL = 2e-3
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
# BSR_F32_RTOL * |plain| (both sum the products of up to a block row's blocks
# in other orders: the kernel in three TF32 passes on the tensor cores, or in
# one FMA chain for block sizes the tensor-core instance does not take, the
# plain version in cuBLAS's bmm, then index_add_); bf16 two bf16 ulps of the
# plain element plus BSR_BF16_ATOL * max|plain| (each side rounds its f32 sum
# once)
BSR_F32_ATOL, BSR_F32_RTOL, BSR_BF16_ATOL = 1e-5, 1e-5, 1e-5
# the dense linalg path at bench_all.py's sizes: config_lu and
# config_cholesky (8192², mode="dist", the default blocks of 1000), an
# 8192 x 64 right-hand side for solve, config_svd (1,000,000 x 512, top 8,
# dist-eigs, no U), and lr on config_nn's data shape (262,144 rows of a label
# and 784 features) for 100 iterations
LINALG_N, SOLVE_RHS = 8192, 64
LU_LEGS = (("masked", "block"), ("shrinking", "block"), ("masked", "panel"))
CHOL_LEGS = ("masked", "shrinking")
SVD_M, SVD_N, SVD_K = 1_000_000, 512, 8
LR_M, LR_D, LR_ITERS = 262_144, 784, 100
# the port's own CPU run against the card's at n = 1024, blocks of 128
LINALG_CPU_N, LINALG_CPU_BLOCK = 1024, 128
# f32 results vs f64 on LINALG_ROWS sampled rows (A[perm] - L U, A - L Lᵀ,
# A A⁻¹ - I, A x - b; singular values vs the Gramian's, lr weights vs an
# f64 run), and the card's L, U, L (Cholesky) and A⁻¹ vs the port's CPU
# run: |difference| <= LINALG_TOL * the largest |entry| of the reference
LINALG_TOL, LINALG_ROWS = 1e-4, 64


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


def check_gemm_f64(torch, pk, m, k, n, gen, tile) -> float:
    """The f32 kernel against an f64 product, relative to max |ref|: a long
    k in one tensor-core accumulator drifts (its sums are not rounded to
    nearest), which this catches."""
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    got = pk.pallas_matmul(a, b, *tile)
    ref = a.double() @ b.double()
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    log(f"  pallas_matmul {m}x{k}x{n} f32 tile {tile} vs f64: max rel err "
        f"{rel:.3e} (tol {F64_TOL})")
    if not rel <= F64_TOL:
        raise AssertionError(f"pallas_matmul long k {tile}: {rel} > {F64_TOL}")
    return rel


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


def cuda_ms_cold(torch, fn, reps: int, dirty: bool = False) -> float:
    """Milliseconds per call with L2 flushed before each call, timed by CUDA
    events around the call alone. The flush reads 64 MB (more than the 50 MB
    L2), so the call finds the L2 holding other, clean lines; ``dirty``
    writes the 64 MB instead, so the call also pays for writing those lines
    back as it evicts them (logged beside, to compare with times taken that
    way). A busy wait of about
    half a millisecond on the card follows the flush, so the host queues the
    call's launches while the card waits: the time is the card's, not the
    host's wrapper code (a call of a few microseconds would otherwise time
    the host)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        if dirty:
            flush.zero_()
        else:
            flush.max()
        torch.cuda._sleep(1_000_000)
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
    lengths[0] = 1
    if B > 1:
        lengths[1] = page_len
    lengths[-1] = W * page_len
    if B > 3:
        tables[2] = 0
    return q, kp, vp, tables, lengths


def check_paged(torch, pa, gen, B, kvh, group, dh, page_len, W, dtype,
                identical=False) -> float:
    """The split-K kernel against its plain version (one launch of the split
    kernel per call, the plan logged); ``identical``: two runs give the same
    bits."""
    q, kp, vp, tables, lengths = paged_inputs(torch, gen, B, kvh, group, dh,
                                              page_len, W, dtype)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, kp, vp, tables, lengths)
    want = pa.paged_decode_attention_plain(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != q.shape or \
            pa.paged_decode_attention.launches != before + 1:
        raise AssertionError(f"paged_decode_attention B={B}: got {got.dtype} "
                             f"{tuple(got.shape)}, "
                             f"{pa.paged_decode_attention.launches - before} "
                             f"launches")
    plan = pa.split_plan(B, kvh, group, dh, W, q.element_size(),
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    err = attn_close(torch, f"paged_decode_attention B={B} kvh={kvh} "
                     f"group={group} dh={dh} page_len={page_len} W={W} "
                     f"{str(dtype)[6:]} ({plan.splits} splits of "
                     f"{plan.split_pages} pages, runs of {plan.rows}, "
                     f"{plan.chunks} chunks)", got, want, dtype)
    if identical:
        if not torch.equal(got, pa.paged_decode_attention(q, kp, vp, tables,
                                                          lengths)):
            raise AssertionError(f"paged_decode_attention B={B} W={W}: two "
                                 f"runs differ")
        log("    two runs bit-identical")
    return err


def paged_times(torch, pa, gen, label, B, kvh, dh, page_len, W) -> dict:
    """Card times (L2 flushed) of ``paged_decode_attention`` (the split and
    combine kernels) at full lengths, beside its plain version, gather +
    SDPA, and the bytes bound: each live K and V element, q and the output
    once, and the tables."""
    q, kp, vp, _, _ = paged_inputs(torch, gen, B, kvh, 1, dh, page_len, W,
                                   torch.float32)
    tables = (1 + torch.arange(B * W, device="cuda")).reshape(B, W).int()
    lengths = torch.full((B,), W * page_len, dtype=torch.int32, device="cuda")
    mask = (torch.arange(W * page_len, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]

    def sdpa_paged():
        k = kp[tables.long()].reshape(B, -1, kvh, dh).transpose(1, 2)
        v = vp[tables.long()].reshape(B, -1, kvh, dh).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, kvh, 1, dh), k, v, attn_mask=mask)

    ms = cuda_ms_cold(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lengths), 20)
    ms_dirty = cuda_ms_cold(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lengths), 20, dirty=True)
    plain = cuda_ms_cold(torch, lambda: pa.paged_decode_attention_plain(
        q, kp, vp, tables, lengths), 3)
    lib = cuda_ms_cold(torch, sdpa_paged, 20)
    lib_dirty = cuda_ms_cold(torch, sdpa_paged, 20, dirty=True)
    live = int(lengths.sum())
    nbytes = (2.0 * live * kvh * dh + 2.0 * B * kvh * dh) * 4 \
        + 4.0 * B * (W + 1)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    plan = pa.split_plan(B, kvh, 1, dh, W, 4,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    # the same call under other split counts, the plan swapped in
    sweep, split_plan = [], pa.split_plan
    for splits in sorted({1, max(1, plan.splits // 2), plan.splits,
                          min(W, 2 * plan.splits)}):
        pages = -(-W // splits)
        forced = plan._replace(splits=-(-W // pages), split_pages=pages)
        pa.split_plan = lambda *args, forced=forced: forced
        try:
            ms_s = cuda_ms_cold(torch, lambda: pa.paged_decode_attention(
                q, kp, vp, tables, lengths), 10)
            sweep.append(f"{forced.splits} splits {ms_s:.4f}")
        finally:
            pa.split_plan = split_plan
    log(f"  paged_decode_attention {label}: B={B} kvh={kvh} dh={dh} W={W} "
        f"f32, L2 flushed: {ms:.4f} ms ({plan.splits} splits of "
        f"{plan.split_pages} pages, {1 + (plan.splits > 1)} launches), plain "
        f"{plain:.4f} ms, gather+SDPA {lib:.4f} ms, bound {bound:.4f} ms "
        f"(bytes, {nbytes / 1e6:.2f} MB): kernel "
        f"{'below' if ms < lib else 'above'} gather+SDPA, {bound / ms:.1%} "
        f"of the bound; after a flush that writes: kernel {ms_dirty:.4f} ms, "
        f"gather+SDPA {lib_dirty:.4f} ms; by split count (ms): "
        f"{', '.join(sweep)}")
    return dict(ms=ms, plain=plain, lib=lib, bound=bound)


def check_flash(torch, fa, gen, H, P, d, valid, dtype) -> float:
    """One panel at (H, P, d) with valid_len < P; the same through
    ``flash_attention_single_panel`` on the strided views ``_prefill_attn``
    passes (head stride d, row stride H * d); then a two-panel run with
    carried state and nonzero offsets that are no multiple of the tile. The
    plain version tiles by 1024 keys and the kernel by 32 or 64, so in bf16
    they round p at different running maxima (see BF16_ATTN_ATOL)."""
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
    panel (bwd_close's bounds; bf16 above d = 128 BWD_BF16_WIDE_ATOL);
    returns the largest |err| of dq, dk and dv, and the largest
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
                             dtype, bf16_atol=BWD_BF16_ATOL if d <= 128
                             else BWD_BF16_WIDE_ATOL)
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
            # the d <= 256 instances: the training stream at head dim 256
            (f"d={WIDE_TRAIN_DH} H={H_T} P={P_T} valid={P_T - 1} {dt}", H_T,
             P_T, WIDE_TRAIN_DH, P_T - 1, {}),
            (f"d={WIDE_TRAIN_DH} (S, heads, d) views P=4096 {dt}", H_T, 4096,
             WIDE_TRAIN_DH, 4096, dict(strided=True)),
            (f"d={WIDE_TRAIN_DH} non-causal P=4096 valid=4000 {dt}", H_T,
             4096, WIDE_TRAIN_DH, 4000, dict(causal=False)),
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

    if resolve_attention_backend("auto", "cuda", D_T) != "flash":
        raise AssertionError("ring attention 'auto' must pick the flash "
                             f"kernels on a CUDA device at dh {D_T}")
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
    wide_step(torch, tt, ops, resolve_attention_backend, stream)
    return train_counts


def wide_step(torch, tt, ops, resolve_attention_backend, stream) -> None:
    """One training step of config_lct's model at dh 256 (d_model 512 over 2
    heads) on WIDE_TRAIN_SEQ tokens with attn="ring" (which resolves to the
    flash kernels there: the forward, dK/dV and dQ kernels each launch once
    per layer) and "ulysses", held against the same step through the tiled
    "ring_xla" path (no kernel launched): the losses agree and start near
    ln vocab."""
    cfg = dict(LCT, d_model=2 * WIDE_TRAIN_DH)
    backend = resolve_attention_backend("auto", "cuda", WIDE_TRAIN_DH)
    log(f"  dh {WIDE_TRAIN_DH}: TransformerLM{tuple(cfg.values())}, ring "
        f"attention 'auto' resolves to {backend!r} on the card")
    if backend != "flash":
        raise AssertionError(f"ring 'auto' at dh {WIDE_TRAIN_DH}: {backend}")
    params = tt.TransformerLM(**cfg).init_params()
    losses = {}
    for attn in ("ring", "ulysses", "ring_xla"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, (losses[attn],) = tt.TransformerLM(**cfg, attn=attn).train(
            stream[:WIDE_TRAIN_SEQ], steps=1, params=params)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log(f"  one step at dh {WIDE_TRAIN_DH}, attn={attn!r}, "
            f"{WIDE_TRAIN_SEQ} tokens: loss {losses[attn]!r}, "
            f"{time.perf_counter() - t0:.3f} s, launches {counts}")
        want = 0 if attn == "ring_xla" else cfg["layers"]
        for kname in ("flash_attention_panel", "flash_attention_bwd_dkv",
                      "flash_attention_bwd_dq"):
            if counts[kname] != want:
                raise AssertionError(f"dh {WIDE_TRAIN_DH} {attn}: {kname} "
                                     f"launched {counts[kname]} times, want "
                                     f"{want}")
    ring = losses["ring"]
    if not (math.isfinite(ring) and abs(ring - math.log(LCT["vocab"])) < 0.25
            and all(abs(x - ring) <= TRAIN_LOSS0_RTOL * abs(ring)
                    for x in losses.values())):
        raise AssertionError(f"dh {WIDE_TRAIN_DH} losses {losses}")
    del params
    torch.cuda.empty_cache()


def flash_label(dtype: str, args: list) -> str:
    """A flash kernel instance's label from its template arguments (head dim,
    vectorised copies, and for the backward whether it is dK/dV)."""
    kind = "" if len(args) < 3 else ("dkv " if args[2] else "dq ")
    return (f"{kind}{dtype} d<={args[0]}"
            f"{'' if args[1] else ' element-wise'}")


def ptxas_table(_build, source: str, kernel: str, count: int,
                describe=flash_label) -> dict:
    """Registers and spill bytes of every instance of ``kernel`` in
    ``source``, from the build's ptxas report, by the label ``describe``
    gives its dtype and integer template arguments; raises unless there are
    ``count`` instances, or if one spills."""
    import re

    report = _build.ptxas_report().split(f"== {source}\n", 1)[1]
    report = report.split("\n== ", 1)[0]
    out, label = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            a = re.search(kernel + r"I(f|13__nv_bfloat16)((?:L[ib]\d+E)*)",
                          m.group(1))
            label = None if a is None else describe(
                "f32" if a.group(1) == "f" else "bf16",
                [int(x) for x in re.findall(r"L[ib](\d+)E", a.group(2))])
            if label is not None:
                out[label] = dict(registers=None, spill=None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and label:
            out[label]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and label:
            out[label]["registers"] = int(m.group(1))
    if len(out) != count or any(v["registers"] is None for v in out.values()):
        raise AssertionError(f"ptxas report of {kernel}: {out}")
    for label, v in out.items():
        log(f"  ptxas {kernel} {label}: {v['registers']} registers, "
            f"{v['spill']} bytes spilled")
    spilled = [k for k, v in out.items() if v["spill"]]
    if spilled:
        raise AssertionError(f"{kernel} spills: {spilled}")
    return out


def sdpa_backend(torch, q, k, v) -> str:
    """The backend SDPA picks for causal (1, H, S, d) ``q``, ``k``, ``v``."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                                  True)).name
    except Exception as exc:  # a private helper: name what went wrong
        return f"unknown ({type(exc).__name__})"


def fwd_times(torch, fa, gen, H, P, d, valid, dtype, plain_reps=2):
    """CUDA-event times of ``flash_attention_single_panel`` (the forward
    kernel) at (H, P, d), causal with ``valid_len`` ``valid``, beside its
    plain version (``plain_reps`` 0: not timed) and SDPA's causal forward
    in the same dtype, and its bound: 4·d operations per live pair at the
    tensor cores' rate (f32: three TF32 passes, 495/3 TFLOP/s; bf16: 989),
    or the bytes of q, k, v and the f32 output if larger. Logs the CUDA-core
    f32 bound (67 TFLOP/s) beside the f32 one. Returns a dict."""
    scale = 1.0 / math.sqrt(d)
    q, k, v = (torch.randn((H, P, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    t = dict(ms=cuda_ms(torch, lambda: fa.flash_attention_single_panel(
        q, k, v, valid, causal=True, scale=scale), 5))
    t["plain"] = cuda_ms(torch, lambda: fa.flash_attention_single_panel_plain(
        q, k, v, valid, causal=True, scale=scale), plain_reps) \
        if plain_reps else None
    t["lib"] = cuda_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(q[None], k[None], v[None],
                                                     is_causal=True), 5)
    backend = sdpa_backend(torch, q[None], k[None], v[None])
    f32 = dtype == torch.float32
    ops_ = 4.0 * d * H * live_pairs(P, valid)
    peak, rate = ((TF32_PEAK / 3, "3xTF32 tensor cores, 165 TFLOP/s") if f32
                  else (BF16_PEAK, "bf16 tensor cores, 989 TFLOP/s"))
    io_bytes = H * P * d * (3.0 * q.element_size() + 4.0)
    t["bound"] = 1e3 * max(ops_ / peak, io_bytes / HBM_BYTES_PER_S)
    dt = str(dtype)[6:]
    log(f"  flash_attention_single_panel H={H} P={P} d={d} valid={valid} "
        f"{dt}: {t['ms']:.3f} ms ({ops_ / t['ms'] / 1e9:.1f} TFLOP/s), "
        + (f"plain {t['plain']:.3f} ms, " if plain_reps else "")
        + f"SDPA forward ({backend}) {t['lib']:.3f} ms, bound "
        f"{t['bound']:.3f} ms (operations, 4*d per pair, {rate}"
        + (f"; CUDA-core f32 bound {1e3 * ops_ / F32_PEAK:.3f} ms, 67 "
           f"TFLOP/s" if f32 else "") + "): kernel "
        f"{'below' if t['ms'] < t['lib'] else 'above'} SDPA")
    del q, k, v
    torch.cuda.empty_cache()
    return t


def bwd_times(torch, fa, gen, dtype, pairs, d=None):
    """CUDA-event times of the dK/dV and dQ kernels and SDPA's backward at
    the training shape (head dim ``d`` if given) in ``dtype``, with their
    bounds; returns them by name and the kernels' arguments."""
    H_T, D_T, P_T = train_shape()
    D_T = d or D_T
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
    backend = sdpa_backend(torch, qs, ks, vs)
    try:
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
        t["lib_bwd"] = cuda_ms(torch, lambda: torch.autograd.grad(
            o_sdpa, (qs, ks, vs), do[None], retain_graph=True), 5)
        del o_sdpa
    except RuntimeError as exc:  # a yardstick only: say why it is missing
        t["lib_bwd"] = None
        backend = f"{backend}, refused: {str(exc)[:120]}"
    del qs, ks, vs
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
        log(f"  flash_attention_bwd_{name} d={D_T} {dt} {ms:.3f} ms "
            f"({ops_ / ms / 1e9:.1f} TFLOP/s), bound {t[f'bound_' + name]:.3f}"
            f" ms (operations, {per_pair:g}*d per pair, {rate})"
            + (f"; CUDA-core f32 bound {1e3 * ops_ / F32_PEAK:.3f} ms "
               f"(67 TFLOP/s)" if dtype == torch.float32 else ""))
    both = t["ms_dkv"] + t["ms_dq"]
    lib = t["lib_bwd"]
    log(f"  d={D_T}: dK/dV + dQ {dt} {both:.3f} ms; SDPA backward {dt} "
        f"(torch.autograd.grad of scaled_dot_product_attention, backend "
        f"{backend}) " + ("not timed" if lib is None else
                          f"{lib:.3f} ms: kernels "
                          f"{'below' if both < lib else 'above'} SDPA"))
    return t, bargs, kw


def train_times(torch, fa, gen, _build):
    """Phase 12: the forward and backward kernels' registers and spills;
    kernel, plain, bound and library times of the flash kernels at the
    training shape, f32 (the main path's type), and in bf16. Returns the
    backward's f32 times by name."""
    H_T, D_T, P_T = train_shape()
    log(f"phase 12: flash kernel times at H={H_T} P={P_T} d={D_T} causal "
        f"valid={P_T - 1} (CUDA events)")
    ptxas_table(_build, "flash_attention.cu", "flash_fwd_kernel", 8)
    ptxas_table(_build, "flash_attention_wide.cu", "flash_fwd_kernel", 4)
    ptxas_table(_build, "flash_attention_bwd.cu", "flash_bwd_kernel", 24)
    pairs = H_T * live_pairs(P_T, P_T - 1)
    log(f"  {pairs} live (query, key) pairs")
    t, bargs, kw = bwd_times(torch, fa, gen, torch.float32, pairs)
    t["plain_bwd"] = cuda_ms(torch, lambda: fa.flash_attention_panel_bwd_plain(
        *bargs, **kw), 2)
    log(f"  plain backward (dq, dk, dv) f32 {t['plain_bwd']:.3f} ms")
    del bargs
    torch.cuda.empty_cache()
    bwd_times(torch, fa, gen, torch.bfloat16, pairs)
    torch.cuda.empty_cache()
    # the d <= 256 instances at H=2, P=32768, d=256 (same live pairs)
    for dtype in (torch.float32, torch.bfloat16):
        bwd_times(torch, fa, gen, dtype, pairs, d=WIDE_TRAIN_DH)
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        fwd_times(torch, fa, gen, H_T, P_T, D_T, P_T - 1, dtype,
                  plain_reps=2 if dtype == torch.float32 else 0)
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
    bounds), with the instance that ran named; returns the max |err| and the
    max err/bound."""
    tile = sb.bsr_tile(bsr.block_size, b.shape[1],
                       -(-bsr.shape[0] // bsr.block_size),
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count, b.element_size())
    got = sb.bsr_spmm_pallas(bsr, b)
    want = sb.bsr_spmm_pallas_plain(bsr, b)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    inst = "CUDA cores" if tile is None else f"tensor cores {tile[0]}x{tile[1]}"
    return bwd_close(torch, f"{label} nnzb={bsr.nnzb} ({inst})", got, want,
                     b.dtype, BSR_F32_ATOL, BSR_F32_RTOL, BSR_BF16_ATOL)


def bsr_checks(torch, np, sb, _build, gen, main_bsr, main_b):
    """Phase 13; returns the main shape's max |err| and the largest
    err/bound over the cases."""
    log("phase 13: bsr_spmm_pallas vs its plain version")
    ptxas_table(_build, "bsr_spmm.cu", "bsr_tc_kernel", 7,
                lambda dt, a: f"{dt} {a[0]}x{a[1]}")
    ptxas_table(_build, "bsr_spmm.cu", "bsr_spmm_kernel", 6,
                lambda dt, a: f"{dt} {a[0]}x{a[1]}")
    n8, br8, bc8, bl8, b8 = bsr_config(np, SPMV_GRID)  # 8192², nnzb 204
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        cases = (  # (label, m, n, p, bs, keep, empty block rows, hot column)
            ("bs=8 ragged", 8 * 37 + 5, 8 * 21 + 3, 77, 8, 0.3, (2, 5), 3),
            ("bs=32 ragged", 32 * 13 + 7, 32 * 9 + 31, 129, 32, 0.3, (0,), 0),
            ("bs=64 ragged", 64 * 9 + 1, 64 * 7 + 5, 259, 64, 0.4, (4,), 2),
            ("bs=128 ragged", 128 * 5 + 100, 128 * 6 + 1, 69, 128, 0.5, (1,),
             5),
            ("bs=128 p=256", 128 * 8, 128 * 8, 256, 128, 0.3, (3,), 0),
            ("bs=192", 192 * 4 + 7, 192 * 3, 130, 192, 0.5, (), 1),
            ("no block", 192, 192, 10, 64, 0.0, (), None),
            # more block rows than a 2-D grid's y axis (65535) could hold
            ("bs=8, 65538 block rows", 65537 * 8 + 13, 64, 5, 8, 5e-4, (),
             None),
            ("bs=64, 65538 block rows", 65537 * 64 + 13, 64, 5, 64, 5e-4, (),
             None),
        )
        for label, m, n, p, bs, keep, empty, hot in cases:
            bsr, b = bsr_case(torch, sb, gen, m, n, p, bs, keep, dtype, empty,
                              hot)
            _, r = check_bsr(torch, sb, f"{label} {m}x{n} p={p} {dt}", bsr, b)
            worst = max(worst, r)
        bsr8 = sb.BsrMatrix(torch.from_numpy(bl8).cuda().to(dtype),
                            torch.from_numpy(br8).cuda(),
                            torch.from_numpy(bc8).cuda(), (n8, n8), BSR_BS)
        b8t = torch.from_numpy(b8).cuda().to(dtype)
        _, r = check_bsr(torch, sb, f"{n8}^2 bs={BSR_BS} p={BSR_P} {dt}",
                         bsr8, b8t)
        worst = max(worst, r)
        if not torch.equal(sb.bsr_spmm_pallas(bsr8, b8t),
                           sb.bsr_spmm_pallas(bsr8, b8t)):
            raise AssertionError(f"bsr_spmm_pallas {n8}^2 {dt}: two runs "
                                 f"differ")
        log(f"    {n8}^2 {dt}: two runs bit-identical")
    err, r = check_bsr(torch, sb, f"main shape {main_bsr.shape} bs={BSR_BS} "
                       f"p={BSR_P} float32", main_bsr, main_b)
    worst = max(worst, r)
    if not torch.equal(sb.bsr_spmm_pallas(main_bsr, main_b),
                       sb.bsr_spmm_pallas(main_bsr, main_b)):
        raise AssertionError("bsr_spmm_pallas main shape: two runs differ")
    log("    main shape: two runs bit-identical")
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
        prep0 = sb.bsr_spmm_pallas.prep_launches
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
        f"{counts['bsr_spmm_pallas'] - by_tuner[0]} by the products; its "
        f"pre-pass of B {sb.bsr_spmm_pallas.prep_launches - prep0})")
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


def bsr_library(torch, bsr):
    """``bsr`` as a ``torch.sparse_bsr_tensor`` (the library call's operand)."""
    m, n = bsr.shape
    nbr = -(-m // bsr.block_size)
    row_ptr = torch.zeros((nbr + 1,), dtype=torch.int64, device="cuda")
    torch.cumsum(torch.bincount(bsr.block_rows, minlength=nbr), 0,
                 out=row_ptr[1:])
    return torch.sparse_bsr_tensor(row_ptr, bsr.block_cols.long(), bsr.blocks,
                                   (m, n), check_invariants=False)


def bsr_times(torch, np, sb, pk, bsr, b):
    """Phase 15: kernel (with its pre-pass), pre-pass alone, plain, chunked,
    library and bound times at the main shape, bf16 beside; then the 8192²
    matrix against the chunked candidate the tuner times there. Returns the
    main shape's times by name."""
    log(f"phase 15: BSR times at {bsr.shape} bs={BSR_BS} nnzb={bsr.nnzb} "
        f"p={BSR_P} f32 (CUDA events)")
    ms = cuda_ms(torch, lambda: sb.bsr_spmm_pallas(bsr, b), 10)
    prep = cuda_ms(torch, lambda: pk.gemm_prepare_b(b), 10)
    plain = cuda_ms(torch, lambda: sb.bsr_spmm_pallas_plain(bsr, b), 5)
    chunked = cuda_ms(torch, lambda: sb.bsr_spmm(bsr, b), 5)
    m, n = bsr.shape
    t = bsr_library(torch, bsr)
    lib_err = float((t @ b - sb.bsr_spmm_pallas_plain(bsr, b)).abs().max())
    lib = cuda_ms(torch, lambda: t @ b, 5)
    log(f"  library: torch.sparse_bsr_tensor @ b {lib:.3f} ms (max|err| vs "
        f"plain {lib_err:.3e})")
    flops = 2.0 * bsr.nnzb * BSR_BS ** 2 * BSR_P
    io_bytes = 4.0 * (bsr.nnzb * BSR_BS ** 2 + n * BSR_P + m * BSR_P) \
        + 8.0 * bsr.nnzb
    # f32 at f32 accuracy on the tensor cores: three TF32 products
    bound = 1e3 * max(flops / (TF32_PEAK / 3), io_bytes / HBM_BYTES_PER_S)
    log(f"  bsr_spmm_pallas {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
        f"pre-pass of B alone {prep:.4f} ms), plain {plain:.3f} ms, chunked "
        f"{chunked:.3f} ms, bound {bound:.3f} ms (operations, 3xTF32 at "
        f"{TF32_PEAK / 3e12:.0f} TFLOP/s: {flops / 1e9:.2f} GFLOP; CUDA cores "
        f"{1e3 * flops / F32_PEAK:.3f} ms; bytes "
        f"{1e3 * io_bytes / HBM_BYTES_PER_S:.3f} ms for "
        f"{io_bytes / 1e6:.1f} MB): {bound / ms:.1%} of the bound")
    b16 = b.bfloat16()
    bsr16 = sb.BsrMatrix(bsr.blocks.bfloat16(), bsr.block_rows,
                         bsr.block_cols, bsr.shape, BSR_BS)
    ms16 = cuda_ms(torch, lambda: sb.bsr_spmm_pallas(bsr16, b16), 10)
    ops16 = 1e3 * flops / BF16_PEAK
    bytes16 = 1e3 * io_bytes / 2 / HBM_BYTES_PER_S
    log(f"  bsr_spmm_pallas bf16 {ms16:.3f} ms, bound {max(ops16, bytes16):.3f} "
        f"ms (operations at {BF16_PEAK / 1e12:.0f} TFLOP/s {ops16:.3f} ms, "
        f"bytes {bytes16:.3f} ms)")
    del b16, bsr16
    n8, br8, bc8, bl8, b8 = bsr_config(np, SPMV_GRID)
    bsr8 = sb.BsrMatrix(torch.from_numpy(bl8).cuda(),
                        torch.from_numpy(br8).cuda(),
                        torch.from_numpy(bc8).cuda(), (n8, n8), BSR_BS)
    b8 = torch.from_numpy(b8).cuda()
    ms8 = cuda_ms(torch, lambda: sb.bsr_spmm_pallas(bsr8, b8), 20)
    ch8 = cuda_ms(torch, lambda: sb.bsr_spmm(bsr8, b8, bsr8.nnzb), 20)
    flops8 = 2.0 * bsr8.nnzb * BSR_BS ** 2 * BSR_P
    log(f"  {n8}^2 nnzb={bsr8.nnzb}: bsr_spmm_pallas {ms8:.4f} ms, "
        f"chunked:{bsr8.nnzb} {ch8:.4f} ms, bound "
        f"{1e3 * flops8 / (TF32_PEAK / 3):.4f} ms (operations, 3xTF32): "
        f"kernel {'below' if ms8 < ch8 else 'above'} chunked")
    return dict(ms=ms, plain=plain, chunked=chunked, lib=lib, bound=bound)


def guarded_call(torch, label, fn, flop=None, sync_guard=True):
    """``fn()`` once, under ``torch.cuda.set_sync_debug_mode("error")`` when
    ``sync_guard`` (a host sync inside it raises), then a synchronize; logs
    the host time and, given ``flop``, the rate. Returns (result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_guard:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"  {label}: {dt:.4f} s (host clock, one sync)"
        + (f", {flop / dt / 1e9:.1f} GFLOP/s" if flop else "")
        + (", no host sync inside" if sync_guard else ""))
    return out, dt


def linalg_close(label, err: float, scale: float) -> float:
    """Raise unless ``err`` <= LINALG_TOL * ``scale``; returns err / scale."""
    rel = err / scale
    log(f"  {label}: max|diff| {err:.3e}, {rel:.3e} of {scale:.6g} "
        f"(tol {LINALG_TOL:g})")
    if not (math.isfinite(err) and rel <= LINALG_TOL):
        raise AssertionError(f"{label}: {err} of {scale}")
    return rel


def linalg_cpu_checks(torch, np, mt):
    """The card's dist-mode factorizations against the port's own CPU run
    at n = 1024, blocks of 128: every LU leg on config_lu's kind of matrix
    with its rows shuffled inside each block of 128, so every pivot block
    swaps rows while the factorization stays as well conditioned (perm
    equal, L and U within tolerance); both Cholesky schedules and the
    inverse."""
    n, b = LINALG_CPU_N, LINALG_CPU_BLOCK
    rng = np.random.default_rng(9)
    r = rng.random((n, n), dtype=np.float32)
    spd = (r @ r.T + n * np.eye(n)).astype(np.float32)
    well = (r + n * np.eye(n)).astype(np.float32)
    shuffle = np.concatenate([o + rng.permutation(b)
                              for o in range(0, n, b)])
    swaps = well[shuffle]

    def both(a, fn):
        outs = []
        for dev in ("cpu", "cuda"):
            with mt.config_context(device=dev):
                outs.append(fn(mt.BlockMatrix.from_array(a)))
        return outs

    def diff(x, y):
        x = x.logical() if hasattr(x, "logical") else x
        y = y.logical() if hasattr(y, "logical") else y
        return float((x.cpu().double() - y.cpu().double()).abs().max())

    scale = float(np.abs(swaps).max())
    for sched, piv in LU_LEGS:
        (cl, cu, cp), (gl, gu, gp) = both(swaps, lambda m: m.lu_decompose(
            mode="dist", block_size=b, schedule=sched, pivot=piv))
        if not torch.equal(cp, gp.cpu()) or torch.equal(
                cp, torch.arange(n)):
            raise AssertionError(f"LU {sched}/{piv} {n}: perm differs from "
                                 f"the CPU run's, or no row swapped")
        linalg_close(f"LU {sched}/{piv} n={n} b={b} card vs CPU (perm "
                     f"equal), L", diff(gl, cl), scale)
        linalg_close(f"LU {sched}/{piv} n={n} b={b} card vs CPU, U",
                     diff(gu, cu), scale)
    for sched in CHOL_LEGS:
        c, g = both(spd, lambda m: m.cholesky_decompose(
            mode="dist", block_size=b, schedule=sched))
        linalg_close(f"Cholesky {sched} n={n} b={b} card vs CPU, L",
                     diff(g, c), float(c.logical().abs().max()))
    c, g = both(well, lambda m: m.inverse(mode="dist", block_size=b))
    linalg_close(f"inverse n={n} b={b} card vs CPU", diff(g, c),
                 float(c.logical().abs().max()))


def linalg_path(torch, np, mt, ops):
    """Phases 16-17: the dense linalg path at bench_all.py's sizes through
    the DenseMatrix methods; each result against f64 on sampled rows, the
    dist-mode loops under set_sync_debug_mode("error"). Returns the
    results by name (seconds, GFLOP/s)."""
    n = LINALG_N
    log(f"phase 16: LU, Cholesky, inverse and solve at {n}^2 f32 "
        f"(mode='dist', blocks of 1000)")
    linalg_cpu_checks(torch, np, mt)
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = torch.randperm(n, generator=gen, device="cuda")[:LINALG_ROWS]
    eye = torch.eye(n, device="cuda")
    res = {}
    ops.reset_launch_counts()
    # config_lu: BlockMatrix.random(0, n, n) + n I
    a = mt.BlockMatrix.random(0, n, n).add(mt.BlockMatrix.from_array(n * eye))
    a64 = a.logical().double()
    scale = float(a64.abs().max())
    for sched, piv in LU_LEGS:
        torch.cuda.reset_peak_memory_stats()
        (l, u, p), dt = guarded_call(
            torch, f"lu_decompose {sched}/{piv}", lambda: a.lu_decompose(
                mode="dist", schedule=sched, pivot=piv),
            flop=2 / 3 * n ** 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lhs = a64[p[rows]]
        rhs = l.logical()[rows].double() @ u.logical().double()
        linalg_close(f"  A[perm] - L U ({sched}/{piv}, peak device memory "
                     f"{peak:.2f} GiB)", float((lhs - rhs).abs().max()), scale)
        res[f"lu_{sched}_{piv}"] = dict(s=dt, gflops=2 / 3 * n ** 3 / dt / 1e9)
        del l, u, p, lhs, rhs
    # config_cholesky: R Rᵀ + n I
    rmat = mt.BlockMatrix.random(0, n, n)
    spd = rmat.multiply(rmat.transpose(), precision="high").add(
        mt.BlockMatrix.from_array(n * eye))
    del rmat
    s64 = spd.logical().double()
    s_scale = float(s64.abs().max())
    for sched in CHOL_LEGS:
        torch.cuda.reset_peak_memory_stats()
        l, dt = guarded_call(
            torch, f"cholesky_decompose {sched}",
            lambda: spd.cholesky_decompose(mode="dist", schedule=sched),
            flop=1 / 3 * n ** 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        l64 = l.logical().double()
        rhs = l64[rows] @ l64.T
        linalg_close(f"  A - L Lᵀ ({sched}, peak device memory {peak:.2f} "
                     f"GiB)", float((s64[rows] - rhs).abs().max()), s_scale)
        res[f"cholesky_{sched}"] = dict(s=dt, gflops=n ** 3 / 3 / dt / 1e9)
        del l, l64, rhs
    del spd, s64
    torch.cuda.reset_peak_memory_stats()
    inv, dt = guarded_call(torch, "inverse", lambda: a.inverse(mode="dist"),
                           flop=2.0 * n ** 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prod = a64[rows] @ inv.logical().double()
    prod[torch.arange(LINALG_ROWS, device="cuda"), rows] -= 1.0
    linalg_close(f"  A A^-1 - I (peak device memory {peak:.2f} GiB)",
                 float(prod.abs().max()), 1.0)
    res["inverse"] = dict(s=dt, gflops=2.0 * n ** 3 / dt / 1e9)
    del inv, prod
    b = torch.randn((n, SOLVE_RHS), generator=gen, device="cuda")
    x, dt = guarded_call(torch, f"solve (n x {SOLVE_RHS} rhs)",
                         lambda: a.solve(b, mode="dist"))
    linalg_close("  A x - b", float((a64 @ x.double() - b.double()).abs()
                                     .max()), float(b.abs().max()))
    res["solve"] = dict(s=dt)
    del a, a64, x, b
    torch.cuda.empty_cache()

    log(f"phase 17: compute_svd({SVD_K}, 'dist-eigs', compute_u=False) on a "
        f"{SVD_M} x {SVD_N} DenseVecMatrix; lr on {LR_M} x (1 + {LR_D}) for "
        f"{LR_ITERS} iterations")
    torch.cuda.reset_peak_memory_stats()
    m_svd = mt.DenseVecMatrix.random(0, SVD_M, SVD_N)
    svd, dt = guarded_call(torch, "compute_svd", lambda: m_svd.compute_svd(
        SVD_K, mode="dist-eigs", compute_u=False), sync_guard=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if svd.u is not None or svd.s.shape != (SVD_K,) or \
            np.any(np.diff(svd.s) > 0):
        raise AssertionError(f"compute_svd: u {svd.u}, s {svd.s}")
    g64 = m_svd.logical().double()
    ref = torch.linalg.eigvalsh(g64.T @ g64).flip(0)[:SVD_K].clamp(min=0)
    ref = ref.sqrt().cpu().numpy()
    log(f"  s {svd.s.tolist()}")
    linalg_close(f"  s vs sqrt(eigvalsh(AᵀA)) in f64 (peak device memory "
                 f"{peak:.2f} GiB)", float(np.abs(svd.s - ref).max()),
                 float(ref[0]))
    res["svd"] = dict(s=dt)
    del m_svd, g64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # labels from a linear rule on the features, so the gradient carries a
    # signal: with labels unrelated to the features (alternating 0/1) the
    # gradient is a cancellation of 262,144 terms and the f32 weights read
    # 1.6e-4 of max |w| from the f64 run's on an H100, a measure of the
    # data's conditioning rather than of the port
    feats = torch.rand((LR_M, LR_D), generator=gen, device="cuda")
    score = feats @ torch.randn((LR_D,), generator=gen, device="cuda")
    labels = (score > score.median()).float()[:, None]
    data = mt.DenseVecMatrix.from_array(torch.cat([labels, feats], dim=1))
    del labels, feats, score
    w, dt = guarded_call(torch, "lr", lambda: data.lr(1.0, LR_ITERS),
                         flop=4.0 * LR_M * (LR_D + 1) * LR_ITERS,
                         sync_guard=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    w64 = mt.ml.logistic_regression(data.logical().double(), 1.0,
                                    LR_ITERS).weights
    linalg_close(f"  lr weights vs an f64 run (peak device memory "
                 f"{peak:.2f} GiB)", float(np.abs(w - w64).max()),
                 float(np.abs(w64).max()))
    res["lr"] = dict(s=dt)
    log(f"  launches of the port's kernels on the linalg path: "
        f"{ops.launch_counts()} (its products are torch.matmul, as the JAX "
        f"package's are jnp.dot outside any Pallas kernel)")
    del data
    torch.cuda.empty_cache()
    return res


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
        if "Compiling entry" in line or "registers" in line or "spill" in line \
                or "wgmma" in line:
            log("  " + line.strip())

    # ------------------------------------- 3. kernels against plain versions
    log("phase 3: kernels vs plain versions")
    ptxas_table(_build, "gemm.cu", "gemm_kernel",
                            2 * len(BM_AXIS) * len(BN_AXIS) * len(BK_AXIS),
                            lambda dt, a: f"{dt} {'x'.join(map(str, a))}")
    ptxas_table(_build, "gemm.cu", "prep_kernel", 2, lambda dt, a: dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tiles = [(bm, bn, bk) for bm in BM_AXIS for bn in BN_AXIS for bk in BK_AXIS]
    for dtype in (torch.float32, torch.bfloat16):
        # (1, 129, 3): rows of k and n whose bytes are no multiple of 16
        for m, k, n in ((130, 70, 50), (64, 300, 64), (1, 129, 3),
                        (1000, 1000, 1000)):
            check_gemm(torch, pk, m, k, n, dtype, gen)
        for tile in tiles:
            check_gemm(torch, pk, 257, 300, 199, dtype, gen, tile)
    # more output-row tiles than a 2-D grid's y axis (65535) could hold
    check_gemm(torch, pk, 65535 * 128 + 77, 24, 40, torch.float32, gen)
    for tile in tiles:
        check_gemm_f64(torch, pk, 256, 65536, 256, gen, tile)
    x = torch.randn((1000, 1000), generator=gen, device="cuda")
    if not torch.equal(pk.pallas_matmul(x, x), pk.pallas_matmul(x, x)):
        raise AssertionError("pallas_matmul: two runs differ")
    log("  pallas_matmul 1000^3 f32: two runs bit-identical")
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
    log(f"phase 5: times at {N}^2 (CUDA events after warm-up)")
    torch.cuda.reset_peak_memory_stats()
    ad, bd = a.data, b.data
    ms_gemm = cuda_ms(torch, lambda: pk.pallas_matmul(ad, bd), 3)
    ms_prep = cuda_ms(torch, lambda: pk.gemm_prepare(ad, bd), 3)
    peak_f32 = torch.cuda.max_memory_allocated()
    plain_gemm = cuda_ms(torch, lambda: pk.pallas_matmul_plain(ad, bd), 3)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_gemm = cuda_ms(torch, lambda: torch.matmul(ad, bd), 3)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    # f32 at f32 accuracy on the tensor cores: three TF32 products
    bound_gemm = 1e3 * max(2.0 * N ** 3 / (TF32_PEAK / 3),
                           3.0 * N * N * 4 / HBM_BYTES_PER_S)
    simt_gemm = 1e3 * 2.0 * N ** 3 / F32_PEAK
    log(f"  pallas_matmul f32 {ms_gemm:.3f} ms ({2.0 * N ** 3 / ms_gemm / 1e9:.1f} "
        f"TFLOP/s; pre-pass alone {ms_prep:.3f} ms), plain {plain_gemm:.3f} ms, "
        f"torch.matmul {lib_gemm:.3f} ms, bound {bound_gemm:.3f} ms "
        f"(operations, 3xTF32 at {TF32_PEAK / 3e12:.0f} TFLOP/s; CUDA cores "
        f"{simt_gemm:.3f} ms): kernel "
        f"{'below' if ms_gemm < lib_gemm else 'above'} torch.matmul")
    for tile in tiles:
        log(f"  f32 tile {tile}: "
            f"{cuda_ms(torch, lambda: pk.pallas_matmul(ad, bd, *tile), 2):.3f} ms")
    ab, bb = ad.bfloat16(), bd.bfloat16()
    ms_gemm16 = cuda_ms(torch, lambda: pk.pallas_matmul(ab, bb), 3)
    prep16 = cuda_ms(torch, lambda: pk.gemm_prepare(ab, bb), 3)
    lib_gemm16 = cuda_ms(torch, lambda: torch.matmul(ab, bb), 3)
    bound_gemm16 = 1e3 * max(2.0 * N ** 3 / BF16_PEAK,
                             3.0 * N * N * 2 / HBM_BYTES_PER_S)
    log(f"  pallas_matmul bf16 {ms_gemm16:.3f} ms (pre-pass alone "
        f"{prep16:.3f} ms), torch.matmul bf16 {lib_gemm16:.3f} ms, bound "
        f"{bound_gemm16:.3f} ms (operations, {BF16_PEAK / 1e12:.0f} TFLOP/s)")
    for tile in tiles:
        log(f"  bf16 tile {tile}: "
            f"{cuda_ms(torch, lambda: pk.pallas_matmul(ab, bb, *tile), 3):.3f} ms")
    del ab, bb
    fr, fc = N - 1, N - 1
    ms_fill = cuda_ms(torch, lambda: pk.masked_fill(ad, fr, fc), 20)
    plain_fill = cuda_ms(torch, lambda: pk.masked_fill_plain(ad, fr, fc), 20)
    lib_fill = cuda_ms(torch, lambda: torch.nn.functional.pad(
        ad[:fr, :fc], (0, N - fc, 0, N - fr)), 20)
    bound_fill = 1e3 * 2.0 * N * N * 4 / HBM_BYTES_PER_S
    log(f"  masked_fill {ms_fill:.4f} ms, plain {plain_fill:.4f} ms, "
        f"F.pad {lib_fill:.4f} ms, bound {bound_fill:.4f} ms (bytes)")
    log(f"  peak device memory of phase 5: {peak_f32 / 2 ** 30:.2f} GiB "
        f"(the f32 product and its pre-pass scratch beside phase 4's "
        f"tensors); with the plain versions and bf16 "
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
    ptxas_table(_build, "paged_attention.cu", "paged_split_kernel", 34,
                lambda dt, a: f"{dt} DI={a[0]} GM={a[1]}")
    ptxas_table(_build, "paged_attention.cu", "paged_combine_kernel", 2,
                lambda dt, a: dt)
    page_len = PAGE_LEN
    W = -(-(PROMPT + DECODE_STEPS) // page_len)  # 36: the bucket's table
    W_LONG = LONG_PROMPT // page_len
    paged_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, kvh, group, dh, pl_, w_ in (
                (ROWS, 8, 1, 64, page_len, W),     # the serving bucket
                (64, 8, 1, 64, page_len, W),       # one split, no combine
                (2, 8, 1, 64, page_len, W_LONG),   # 16384 tokens
                (ROWS, 2, 4, 64, page_len, W),     # GQA group 4
                (4, 2, 16, 256, page_len, W),      # two chunks of 8 heads
                (5, 2, 4, 40, 5, 7),               # page_len 5, dh 40
                (5, 2, 3, 17, 7, 6)):              # element-wise copies
            e = check_paged(torch, pa, gen, B, kvh, group, dh, pl_, w_, dtype,
                            identical=(B, w_) in ((ROWS, W), (2, W_LONG)))
            if dtype == torch.float32 and (B, group, w_) == (ROWS, 1, W):
                paged_err = e

    # ----------------------------------- 7. flash panel kernel vs plain version
    log("phase 7: flash_attention_panel vs its plain version")
    flash_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for P in (4096, LONG_PROMPT):
            e = check_flash(torch, fa, gen, 8, P, 64, P - 100, dtype)
            if dtype == torch.float32 and P == LONG_PROMPT:
                flash_err = e
        for d in WIDE_DH:  # the d <= 256 instances
            check_flash(torch, fa, gen, 2, 4096, d, 4000, dtype)
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
    wide_lm = tt.TransformerLM(**WIDE_LM)
    wide_params = wide_lm.init_params()
    wide_prompt = rng.integers(0, WIDE_LM["vocab"], WIDE_PROMPT).astype(
        np.int32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    combine0 = pa.paged_decode_attention.combine_launches
    if tt.resolve_decode_kernel("auto", "cuda") != "pallas":
        raise AssertionError("decode kernel 'auto' must pick the kernel on a "
                             "CUDA device")
    streams, audit, steps, decode_s = serve(params, prompts, "pallas")
    t0 = time.perf_counter()
    long_out = lm.generate(params, long_prompt, steps=LONG_STEPS)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    before_wide = fa.flash_attention_panel.launches
    t0 = time.perf_counter()
    wide_out = wide_lm.generate(wide_params, wide_prompt, steps=WIDE_STEPS)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_launches = fa.flash_attention_panel.launches - before_wide
    path_counts = ops.launch_counts()
    paged_combines = pa.paged_decode_attention.combine_launches - combine0
    log(f"  launches on the main path: {path_counts}; the paged combine "
        f"kernel {paged_combines}")
    for kname in ("paged_decode_attention", "flash_attention_panel"):
        if path_counts[kname] <= 0:
            raise AssertionError(f"{kname} never launched on the main path")
    if wide_launches != WIDE_LM["layers"]:
        raise AssertionError(f"dh 256 generate: {wide_launches} flash forward "
                             f"launches, want one per layer")
    tok = ROWS * steps
    log(f"  decode: {tok} tokens in {decode_s:.3f} s = {tok / decode_s:.1f} "
        f"tok/s, {decode_s / steps * 1e3:.3f} ms per step (batch {ROWS}, "
        f"host clock, one sync per step)")
    log(f"  pool after release: {audit}")
    if not audit["ok"] or steps != DECODE_STEPS or audit["hits"] != 1 or \
            audit["cow_copies"] != 1 or audit["used"] != audit["cached"]:
        raise AssertionError(f"pool bookkeeping: {steps} steps, {audit}")
    log(f"  generate({LONG_PROMPT} tokens, {LONG_STEPS} steps): {long_s:.3f} s")
    log(f"  TransformerLM{tuple(WIDE_LM.values())} (dh "
        f"{WIDE_LM['d_model'] // WIDE_LM['heads']}) generate({WIDE_PROMPT} "
        f"tokens, {WIDE_STEPS} steps): {wide_s:.3f} s, {wide_launches} flash "
        f"forward launches")
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
        wide_ref = wide_lm.generate(wide_params, wide_prompt, steps=WIDE_STEPS)
    finally:
        fa.flash_attention_single_panel = kernel_panel
    if long_out.tolist() != long_ref.tolist():
        raise AssertionError("16k generate: kernel flash != plain flash tokens")
    log(f"  generate {LONG_PROMPT}: tokens {long_out[LONG_PROMPT:].tolist()} "
        f"== the plain flash version's")
    if wide_out.tolist() != wide_ref.tolist():
        raise AssertionError("dh 256 generate: kernel flash != plain flash "
                             "tokens")
    log(f"  dh 256 generate {WIDE_PROMPT}: tokens "
        f"{wide_out[WIDE_PROMPT:].tolist()} == the plain flash version's")
    del params, wide_params
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 9. times
    log("phase 9: attention kernel times (CUDA events)")
    dh = LM["d_model"] // LM["heads"]
    paged_t = {}
    for label, B, w_ in (("main", ROWS, W), ("16384 tokens", 1, W_LONG)):
        paged_t[label] = paged_times(torch, pa, gen, label, B, LM["heads"],
                                     dh, page_len, w_)
    ms_paged, plain_paged, lib_paged, bound_paged = (
        paged_t["main"][k] for k in ("ms", "plain", "lib", "bound"))
    tf = fwd_times(torch, fa, gen, LM["heads"], LONG_PROMPT, dh, LONG_PROMPT,
                   torch.float32)
    fwd_times(torch, fa, gen, LM["heads"], LONG_PROMPT, dh, LONG_PROMPT,
              torch.bfloat16, plain_reps=0)

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
    bsr_err, _ = bsr_checks(torch, np, sb, _build, gen, main_bsr, main_b)
    sparse_counts = sparse_path(torch, np, mt, sb, autotune, ops, main_bsr,
                                main_b, data)
    tb = bsr_times(torch, np, sb, pk, main_bsr, main_b)
    del main_bsr, main_b, data
    torch.cuda.empty_cache()
    linalg_path(torch, np, mt, ops)

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
         "source": "marlin_tpu_torch/csrc/flash_attention.cuh",
         "replaces": "marlin_tpu/ops/flash_attention.py:93",
         "launches": path_counts["flash_attention_panel"],
         "max_abs_err": flash_err, "ms": tf["ms"], "plain_ms": tf["plain"],
         "bound_ms": tf["bound"], "bound_by": "operations",
         "library_ms": tf["lib"]},
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
