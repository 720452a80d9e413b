#!/usr/bin/env python3
"""Smoke run of marlin_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``marlin_tpu_torch/csrc/`` (one ``nvcc``
per source, all at once), holds each against its plain PyTorch version, and
drives the two ported paths end to end through the public entry points:

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
- phase 9: kernel, plain, bound and library times.

It prints the card's name, count and power limit, one ``{"kernels": [...]}``
line (launches on the main path, max error, kernel / plain / bound / library
times), and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line. It also exits non-zero where ``torch.cuda.is_available()`` is false and
where the package is not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N = 20000                 # the north-star multiply: 20000 x 20000 x 20000
F32_PEAK = 67e12          # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
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

    import math

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

    # ---------------------------------------------------- 10. kernels line
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
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
