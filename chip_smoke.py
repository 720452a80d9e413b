#!/usr/bin/env python3
"""Smoke run of marlin_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``marlin_tpu_torch/csrc/`` (one ``nvcc``
per source, all at once; the lr kernel as a library of its own), holds each
against its plain PyTorch version, and
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
  (weights against the plain loop in f64; one launch of the fused lr kernel an
  iteration), then that kernel's step at ``tall_10m``'s 10^7 rows of a label
  and 512 features against its plain version and timed beside its byte
  bound, the plain step and the two cuBLAS gemvs it replaced.
- phase 18: the serving engine at full width — ``ServeEngine`` over phase
  8's model with buckets ((128, 32), (512, 64)), 8 rows, pages of 16 tokens
  and 256 prompt tokens per worker iteration (a 512-token prompt prefills
  in two chunks between decode steps), ``decode_kernel="auto"`` resolving
  to the CUDA kernel. Leg (a): 32 requests from 4 submitter threads
  (prompts of 16-512 tokens, 8-64 steps, 8 of them sampled at temperature
  0.8 and top_k 40): greedy tokens == ``lm_generate`` on the card, sampled
  tokens == the same request served alone by a second engine, and a
  ``/metrics`` scrape of ``obs.MetricsServer`` during the leg carrying the
  ``marlin_serve_*`` families. Leg (b): 16 requests behind one 256-token
  system prompt: prefix-cache hits, tokens == unshared ``lm_generate``.
  Leg (c): two injected ``serve.decode_step`` faults and one
  ``serve.prefill`` fault, ``max_attempts=3``: one OK Result per request,
  leg (a)'s tokens. Leg (d): leg (a) again while the main thread runs
  TF32 products (``local_matmul(precision="default")``) back to back with
  no synchronize: the serve ends within a bound, leg (a)'s tokens, the
  TF32 flag off after. After each leg the worker is joined, the pool's
  audit is clean and the paged kernel launched once per layer of every
  decode step. Then phase 8's workload through ``serve_bucket`` and the
  engine in turns, nine rounds: the same streams, and the two loops' ms
  per decode step side by side with their medians and interquartile
  ranges, the gap called resolved only where it exceeds both ranges; and
  the synchronizing CUDA calls of one decode step as the engine makes it
  (``set_sync_debug_mode("warn")``).
- phase 19: the ml path at ``bench_all.py``'s sizes. ``config_als``
  (1,000,000 users x 100,000 items, rank 32, 10^7 ratings, λ 0.05) through
  ``CoordinateMatrix.als``, which takes the blocked path: one warm-up
  sweep, then 3 timed, every half-step under
  ``set_sync_debug_mode("error")``; the RMSE of each sweep must fall, users
  without ratings come out exactly 0, and the last user half-step holds
  against an f64 numpy solve for 64 sampled users. ``config_nn`` (262,144 x
  784, hidden 1024, 10 classes, batch 8192) through ``NeuralNetwork.train``:
  the first 3 steps against the same steps in f64 on the CPU, then 2
  warm-up and 50 timed steps (steps/s, model GFLOP/s). ``config_pagerank``
  (10^7 nodes, 10^8 edges) through ``build_transition_operator`` (host build
  timed apart) and ``pagerank`` (10 iterations after one warm-up), the
  ranks against a scipy.sparse f64 power iteration.
- phase 20: ``bench_all.py`` ``config_serve_als`` through ``ServeEngine``
  (``TransformerLM(256, 64, 4, 2)``, bucket (64, 32), 8 rows,
  ``max_wait_ms=1.0``, ALS factors 512 x 256 of rank 16): (a) 256 ALS
  requests alone (req/s, submit-to-result p50/p99; every top-8 == numpy's
  as a set); (b) 32 LM requests alone, then 32 beside 32 ALS requests
  (tok/s of both and their ratio; greedy tokens == ``lm_generate`` in both);
  then a ``ClassifyProgram`` over phase 19's MLP and a
  ``PageRankQueryProgram`` over a 10^4-node graph on one engine (numpy f64
  oracles), and ``swap_model`` under load (answers before the swap read the
  old factors, after it the new, none torn); the paged kernel's split and
  combine launches counted.
- phase 21: BASELINE.md config 4 as ``bench_all.py`` ``config4`` runs it,
  without its row cut: the port's native libraries built from
  ``marlin_tpu_torch/native/`` (a failed build fails the run), then
  ``streamed_gramian`` of 10^7 x 512 f32 (uniform rows, chunks of 2^19 rows
  generated from a seed on the prefetcher's producer thread, 20.5 GB never
  resident at once) through pinned staging buffers and a side stream,
  against an f64 accumulation of the same chunks on the card in a plain
  loop; at 2^22 rows the sync control equal to the prefetch leg bit for
  bit, and a bf16-transfer leg; ``streamed_matmul`` of 2^20 x 512 by 512 x
  512 into a writable ``np.memmap`` against f64 on sampled rows; every
  host-to-device copy from a pinned buffer; the stage breakdown, the side
  stream's copy rate beside a plain 1 GiB pinned copy, and the resident
  rank update's time against the f32 bound;
- phase 22: ``bench_all.py`` ``_config4_file_legs`` at its default 65536 x
  512: the file written by ``save_to_file_system`` (the port's native
  writer), streamed by the Python text parser and by its ``transcode_text``
  sidecar (auto-selected; the two Gramians equal bit for bit, GFLOP/s and
  stages per leg), a flipped sidecar byte raising
  ``ChunkstoreCorruptError``, an idx3 file through
  ``mnist_images_out_of_core`` both ways, and a ``/metrics`` scrape carrying
  the ``marlin_prefetch_*`` and ``marlin_dataplane_*`` families;
- phase 23: ``save_sharded``/``load_sharded`` of a 20000² f32
  ``DenseVecMatrix`` with its CRCs re-read; phase 11's ``config_lct`` run
  stopped by an injected fault after step 2 and resumed from generation 2
  through ``ResilientLoop`` (losses and params equal to phase 11's bit for
  bit), then again with generation 3 corrupted by one byte (the loop falls
  back to generation 2); ``NeuralNetwork.train(checkpoint_dir=...)`` at
  ``config_nn`` for 3 steps with a resume, equal to the uninterrupted run;
  ``heartbeat()`` over the card; each save's and load's wall time and bytes.
- phase 24: the port's example CLIs (``marlin_tpu_torch/examples/``)
  in-process, every kernel's launch count set to 0 before each and read
  after: ``matrix_multiply 20000 20000 20000 1`` (BASELINE.md config 3; C on
  sampled rows against f64, its GFLOP/s beside ``torch.matmul``'s, its
  ``rmm_matmul`` cost row), ``--files`` and ``lu_decompose`` on files of
  ``tools/genmat.cpp`` (built with g++; the product against f64, LU's
  componentwise backward error), ``blas1``, ``blas3`` (a ``2 2 2`` split
  refused at world size 1), ``rmm_compare`` ``all`` and ``tuned`` (a
  ``multiply`` cost row per timed strategy with flops 2mkn, and the
  strategies' ``*_matmul`` rows), ``sparse_multiply`` modes 1-6 and mode 7
  at block density 0.05 on 32768² (the BSR kernel launched; sampled rows
  against f64), ``logistic_regression``, ``pagerank``, ``als``,
  ``neural_network``, ``distributed_training``, ``attention 16384 128 1 8``
  under ``ring`` and ``ulysses`` (the flash forward launched),
  ``long_context_training`` at ``config_lct``'s widths (the forward and
  both backward kernels launched) and ``decode_serving`` at
  ``config_decode``'s (greedy batched rows == one-at-a-time); then
  ``obs.console.main(["--url", url, "--once"])`` against a live
  ``ServeEngine``'s ``MetricsServer``: return code 0, the engine's gauges
  and the memory panel in the frame.

- phase 25: the serving fleet around the engine at full width — phase 18's
  model and engine settings per replica, every leg with the kernels' launch
  counts set to 0 before it and read after. Leg (a): ``Router(factory,
  replicas=2)`` with supervisors takes leg (a) of phase 18's 32 requests from
  4 submitter threads while ``rolling_restart()`` rotates both replicas,
  then the same 32 again on the rebuilt ones: one OK Result each, greedy
  tokens == ``lm_generate``, sampled == the request served alone,
  ``marlin_serve_migrations_total{leg="adopt"}`` risen, clean audits, decode
  steps on every replica (old and rebuilt), each replica's ms per decode
  step. Leg (b): ``freeze_rows`` on an engine held at a decode step,
  corrupted blobs (a flipped byte, a truncation) refused with
  ``MigrationCorruptError`` by a fresh target whose audit stays clean, then
  ``adopt_rows`` on another: decode resumes == the uninterrupted streams;
  the blob imported and re-exported through a pool on the card gives the
  same page bodies byte for byte; rows, pages, bytes, freeze, export and
  adopt times and the export's device-to-host GB/s; ``export_prefixes`` →
  ``import_prefixes`` gives a fresh replica a hit on its first
  shared-prompt request. Leg (c): ``serve.worker_crash`` at rate 0.03 (seed
  9) under a supervisor, ``max_attempts=5``: one OK Result each == leg (a)'s
  first tokens; then a crash every iteration under the default restart
  budget opens the breaker, every request ends terminal and shutdown does
  not hang. Leg (d): a p99 TTFT objective (``serve_slo``) breached by a
  burst: ``/debug/slo`` shows it, a priority-0 request is shed with the
  ``SHED_REASON_PREFIX`` reason and a priority-1 one served, the breach
  clears after the quiet and admission reopens, a ``/metrics`` scrape
  carries the ``marlin_slo_*`` families. Leg (e): a ``FleetController`` on
  an injected clock over the router's fleet-merged burn scales out during a
  burst (the new replica warmed before it joins) and scales in under load:
  zero dropped, leg (a)'s tokens, ``/debug/fleet`` scraped.
- phase 26: the mixture-of-experts family at ``bench_all.py``
  ``config_moe``'s full width (config_lct's model and 32768-token stream,
  8 experts, top-2, capacity factor 1.25, groups of 4096, remat, loss
  chunks of 2048): one warm and 3 timed steps beside config_lct's dense
  model on the same stream (ktok/s of both, the flash kernels' launches:
  the forward twice a layer and step under remat, dK/dV and dQ once), one
  step's loss and gradients against the plain attention path, ``moe_ffn``
  on the card against the same call in f64 on the CPU over a 4096-token
  group (dispatch equal, outputs within 1e-5 of max|ref|, the aux), the
  paged kernel at the engine's shapes against its plain version, then
  ``ServeEngine(moe=(2, 1.25, 4096))`` (paged, the CUDA decode kernel)
  over the trained params at phase 18's load (32 requests of 16-512
  tokens, most of several 64-token prefill chunks, every fourth sampled,
  from 4 threads onto 8 rows): greedy tokens == the same chunked prefill
  and gather decode done without the engine, sampled == served alone by
  a second engine, tok/s and TTFT p50/p99.
- phase 27: ``ServeEngine(paged=False)``, the dense-slab control, at
  ``bench_all.py`` ``config_serve``'s widths (d_model 128, 8 heads of 16,
  4 layers, vocab 256; its buckets and 8 rows, and a (2048, 8) bucket):
  48 requests of config_serve's ranges, every fourth sampled, and 4
  prompts of 2048 tokens whose ``lm_prefill_slot`` launches the flash
  forward once a layer; then the same requests through the paged engine.
  First the flash forward at 8 × 2048 × 16 and the paged kernel at kvh 8,
  dh 16 and each bucket's table against their plain versions.
  Greedy tokens == ``lm_generate`` on both; tok/s and TTFT p50/p99 of
  each, the sampled rows' agreement between them.
- phase 28: ``lazy.fuse`` over ``a.multiply(b).add(c).multiply(2.0)`` at
  8192² f32 through inductor: one graph (counted by a backend that wraps
  inductor's ``compile_fx``) holding one product, equal to the eager
  chain within 1e-6 of
  max|eager|, fused and eager times by CUDA events beside the f32 bound,
  and ``lazy.grad`` of a fused sum returning a ``DenseVecMatrix`` equal to
  ``ones @ b^T``.

- phase 29: the rest of long-context training and the collectives layer:
  (a) config_lct's widths on its 32768-token stream at 2 and 8 layers, 2
  remat steps with and without ``offload_residuals`` (losses, gradients and
  params bit for bit, one residual a layer to pinned memory, ms a step and
  peak memory; at 8 layers the offloaded peak must be lower); (b)
  ``plan_context`` on config_lct's model with a budget halfway between its
  first and last rung's measured peaks (the ladder climbs; the chosen
  model's step stays within it) and with an unreachable 64 MiB (fits False,
  the lowest-peak rung); (c) a one-rank NCCL world (``initialize_distributed``
  with a file store, ``create_mesh((1, 1))``): ``ring_matmul`` and the RMM
  at 8192² against ``torch.matmul``, ring and Ulysses attention at 8 ×
  4096 × 128 causal, forward and backward, against the plain flash
  versions, ``pipeline_apply`` against its stages in sequence, the
  ``pipeline_training`` CLI, ``pp_lm_loss`` at 2048 tokens against the
  plain flash version, the pipeline composed with tensor parallelism on
  the (1, 1) grid (a two-matrix stage with its weights placed over
  ``cols``, against the stages in sequence; ``pp_lm_loss`` at 2048 tokens
  with ``pp_tp_placement``, through the flash forward, against the
  unplaced loss), and the time of a one-float ``all_reduce`` and
  ``all_gather``; the group is destroyed after.
- phase 31: the matrices across ranks, in a one-rank NCCL world: two
  20000² ``DenseVecMatrix.random`` over the rank mesh (each rank draws its
  block by threefry counter) multiplied by ``multiply`` (auto: the RMM on
  blocks) against the world-of-one multiply of the gathered inputs, timed
  by CUDA events and the host clock, with the peak memory and the bytes a
  rank holds; phase 16's 8192² LU legs and Cholesky on row blocks against
  the logical path; phase 17's ``compute_svd`` ``dist-eigs`` on row blocks
  against the logical path; ``lr`` (20 iterations, phase 17's shape) on row
  blocks, through the fused kernel with the rank all-reduce between its sum
  and its update, equal to the world of one's bit for bit; ``save_sharded``/``load_sharded`` of a 20000²
  matrix bit for bit, and its restore outside the world;
  ``to_sparse_vec_matrix`` of a rank-local 8192² matrix (95 % of its entries
  dropped) and its ``multiply(format="bsr")`` by a rank-local 8192 x 256
  operand through the BSR kernel, against the world of one (the kernel then
  held against its plain version at that shape).
- phase 30: the workloads across ranks, in a one-rank NCCL world (their
  plain runs made first, outside it): config_lct on phase 11's stream with
  the stream sharded over the ranks (``TransformerLM.train(mesh=rank
  mesh)``: embedding to loss on this rank's block, ``ring_attention_shard``
  / ``ulysses_attention_shard``) with ``ring_flash`` and ``ulysses`` (the
  flash forward, dK/dV and dQ kernels each once a layer a step), held
  against phase 11's logical run (losses and params, phase 11's
  tolerances); config_moe with its experts over the ranks (the
  expert-parallel path: two all-to-alls a MoE layer) against its logical
  trainer (one step's loss and gradients, then 3 steps' losses); the
  ``distributed_training`` CLI at (1, 1) against the same CLI
  outside the world; blocked ALS and edge-sharded PageRank through their
  rank paths against their plain paths.

- phase 32: the flash forward, dK/dV and dQ kernels at DeepSeek-V2's
  (q/k 192, v 128) widths against their plain versions at 16 heads x 32768,
  f32 and bf16 (one panel, the strided single panel, two panels; each
  kernel's launches counted, the bf16 forwards all on the wgmma design and
  the f32 ones on mma.sync), then one ``TransformerLM.deepseek`` train
  step of the ``dsv2_lite`` cell's model and settings (bf16, remat, 32768
  tokens): its flash launches (twice a layer forward, every one on the
  wgmma design, once a layer each backward kernel) go into the kernels
  line, its loss that of random weights.

``python3 chip_smoke.py --phases 21,22,23`` (any subset of phases 19-32;
20 runs 19 first) builds the kernels and runs only those phases, printing no
result lines.

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
# phase 32: DeepSeek-V2-Lite's latent attention, q/k 192 (128 + 64 rotary)
# and v 128 over 16 heads of one 32768-token stream, and one train step of
# the benchmark's dsv2_lite model (portbench/configs/dsv2_lite.json: the
# published widths, experts 0-7 of 64 held, a vocabulary of 12800, 14
# layers) as its cell runs it
MLA_HEADS, MLA_DQK, MLA_DV, MLA_SEQ = 16, 192, 128, 32768
DSV2 = dict(vocab=12800, d_model=2048, layers=14, heads=16, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            d_ff=10944, moe_d_ff=1408, n_routed_experts=64,
            n_shared_experts=2, experts_per_token=6, first_k_dense_replace=1,
            held_experts=(0, 8))
DSV2_STEP = dict(attn="ring", remat=True, precision="default",
                 loss_chunk=4096, compute_dtype="bfloat16",
                 learning_rate=4.2e-4, moe_aux_weight=1e-3)
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
# the fused lr kernel's main shape: the benchmark's tall_10m rows (10^7 of a
# label and 512 features, 20.5 GB), one step timed
LR_MAIN_M, LR_MAIN_D = 10_000_000, 512
# the port's own CPU run against the card's at n = 1024, blocks of 128
LINALG_CPU_N, LINALG_CPU_BLOCK = 1024, 128
# the serving engine (phase 18) over config_decode's model: two buckets, 8
# rows, pages of 16 tokens, 256 prompt tokens per worker iteration (so a
# 512-token prompt prefills in two chunks between decode steps); leg (a) is
# ENGINE_REQUESTS requests from ENGINE_THREADS submitter threads, prompts of
# 16-512 tokens and 8-64 steps drawn from seed 0, every ENGINE_SAMPLED_EVERY-th
# sampled (temperature 0.8, top_k 40, its own seed); leg (b) SHARED_REQUESTS
# requests behind one SYSTEM_PROMPT-token system prompt
ENGINE_BUCKETS = ((128, 32), (512, 64))
ENGINE_REQUESTS, ENGINE_THREADS, ENGINE_SAMPLED_EVERY = 32, 4, 4
SHARED_REQUESTS, SYSTEM_PROMPT = 16, 256
ENGINE_WAIT_S = 300.0
# phase 8's workload through serve_bucket and the engine in turns, this many
# rounds of each (host clocks drift over a run: only adjacent runs compare;
# the gap counts as resolved only where it exceeds both loops' IQR)
ENGINE_TIMING_ROUNDS = 9
# leg (d) fails if the serve beside back-to-back TF32 products takes longer
LEG_D_BOUND_S = 120.0
# the /metrics families a serving scrape must carry: bench_all.py's serve
# list (the prefetch family registered at endpoint start, at zero)
SERVE_FAMILIES = (
    "marlin_serve_submitted_total", "marlin_serve_queue_depth",
    "marlin_serve_slot_occupancy", "marlin_serve_kv_inflight_bytes",
    "marlin_compile_total", "marlin_prefetch_chunks_total",
    "marlin_device_memory_bytes_in_use",
    "marlin_program_roofline_frac", "marlin_mem_registered_bytes",
    "marlin_mem_live_bytes", "marlin_mem_unattributed_bytes",
    "marlin_serve_kv_pages_total", "marlin_serve_kv_pages_used",
    "marlin_serve_prefix_cache_total")
# the serving fleet (phase 25) over phase 18's model and engine settings:
# FLEET_REPLICAS replicas behind a Router; leg (b) freezes at the
# FLEET_HOLD_STEP-th decode step; leg (c) serves CHAOS_STEPS-step requests
# under seeded worker crashes with CHAOS_ATTEMPTS attempts each (an attempt
# must survive some CHAOS_STEPS + 2 worker iterations at a crash rate of
# 0.03 each); legs (d) and (e) declare a p99 TTFT objective of FLEET_TTFT_S
# that a burst of twice leg (a)'s requests breaches, evaluated every 0.25 s
# over a 3 s fast window
FLEET_REPLICAS, FLEET_HOLD_STEP, FLEET_WAIT_S = 2, 24, 120.0
CHAOS_STEPS, CHAOS_ATTEMPTS = 4, 5
FLEET_TTFT_S = 0.25
FLEET_SLO_KNOBS = dict(serve_slo_eval_interval_s=0.25,
                       serve_slo_fast_window_s=3.0, serve_slo_burn_fast=5.0,
                       serve_slo_hysteresis=2, serve_ts_bucket_s=0.5,
                       serve_ts_window_s=60.0)
SLO_FAMILIES = ("marlin_slo_compliance", "marlin_slo_budget_remaining",
                "marlin_slo_burn_rate", "marlin_slo_breached",
                "marlin_slo_shed_total")
# the ml path at bench_all.py's sizes: config_als (one warm-up sweep, then
# ALS["iters"] timed; blocked, as the 256 MB rule picks at these sizes),
# config_nn (NN["warm"] warm-up steps, then NN["iters"]) and config_pagerank
# (one warm-up iteration, then PR["iters"])
ALS = dict(users=1_000_000, items=100_000, rank=32, nnz=10_000_000, lam=0.05,
           iters=3)
NN = dict(m=262_144, d=784, hidden=1024, classes=10, batch=8192, warm=2,
          iters=50, f64_steps=3)
PR = dict(n=10_000_000, e=100_000_000, iters=10)
# ALS: the card's last user half-step against an f64 numpy solve of the same
# normal equations from the same fixed item factors, on ALS_SAMPLE users:
# max |diff| <= ALS_TOL * max |f64 row entry|. Each system sums ~10 rated
# items' outer products in f32 (index_add_ in another order) and solves a
# rank-32 system whose condition number the weighted λ (0.05 · count)
# bounds; the port's CPU run of this check at 70,000 users read 3.7e-7.
ALS_SAMPLE, ALS_TOL = 64, 1e-4
# MLP: the first NN["f64_steps"] steps (init, sampled rows, SGD at lr 0.5)
# on the card against the same steps in f64 on the CPU: |loss diff| <=
# NN_TOL * loss, max |param diff| <= NN_TOL * max |f64 param| per layer
# (TF32 off: f32 products of 784- and 1024-long dot products; the port's
# CPU run of this check at 16,384 rows read 1.0e-7)
NN_TOL = 1e-5
# PageRank: the card's ranks after PR["iters"] steps against a scipy.sparse
# f64 power iteration on the same operator: max |diff| <= PR_TOL * max rank
# (each step sums ~10 in-edges per node in f32, in another order, and
# renormalizes over 10^7 nodes; the port's CPU run of this check at 10^6
# nodes read 1.7e-7)
PR_TOL = 1e-5
# phase 20: bench_all.py config_serve_als — TransformerLM(vocab 256, d_model
# 64, 4 heads, 2 layers) in one bucket (64, 32), 8 rows, max_wait_ms 1.0,
# resident ALS factors of SERVE_ALS users x items, rank 16; leg (a) 256 ALS
# requests alone; leg (b) 32 LM requests alone, then 32 LM beside 32 ALS
SERVE_LM = dict(vocab=256, d_model=64, heads=4, layers=2, seed=0)
SERVE_BUCKETS = ((64, 32),)
SERVE_ALS = dict(users=512, items=256, rank=16, requests=256, k=8)
SERVE_MIX = 32
# the PageRank program's graph (10^4 nodes, 5 out-edges a node on average),
# and the classification program's rows
SERVE_PR_N, SERVE_PR_E, SERVE_PR_REFRESH = 10_000, 50_000, 20
SERVE_CLASSIFY_ROWS = 64
# f32 serving results vs numpy f64: classification probabilities and
# PageRank ranks and scores, absolute (both are O(1) or smaller)
SERVE_TOL = 1e-5
# f32 results vs f64 on LINALG_ROWS sampled rows (A[perm] - L U, A - L Lᵀ,
# A A⁻¹ - I, A x - b; singular values vs the Gramian's, lr weights vs an
# f64 run), and the card's L, U, L (Cholesky) and A⁻¹ vs the port's CPU
# run: |difference| <= LINALG_TOL * the largest |entry| of the reference
LINALG_TOL, LINALG_ROWS = 1e-4, 64
# phase 21: BASELINE.md config 4 as bench_all.py config4 runs it, without its
# row cut: a TALL_ROWS x TALL_COLS f32 operand of uniform [0, 1) rows
# (bench_all.py's draw), generated in chunks of TALL_CHUNK rows, chunk i
# from default_rng([TALL_SEED, i]), on the prefetcher's producer thread;
# the sync and bf16 legs at TALL_CHECK_ROWS, streamed_matmul at
# TALL_MATMUL_ROWS x 512 @ 512 x 512 into a memmap
TALL_ROWS, TALL_COLS, TALL_CHUNK, TALL_SEED = 10_000_000, 512, 1 << 19, 4
TALL_CHECK_ROWS, TALL_MATMUL_ROWS = 1 << 22, 1 << 20
# the bf16 leg against the f64 Gramian of the f32 rows: one bf16 rounding
# step (2^-8) of the largest |entry| (its own bf16-rounded rows' f64
# Gramian is held to F64_TOL)
TALL_BF16_TOL = 2.0 ** -8
# phase 22: bench_all.py _config4_file_legs at its default size (a row-text
# file of FILE_ROWS x TALL_COLS, streamed in chunks of FILE_CHUNK rows) and a
# synthetic idx3 file of MNIST's test-set shape
FILE_ROWS, FILE_CHUNK = 65536, 8192
IDX_N, IDX_SIDE = 10_000, 28
# phase 23: save_sharded/load_sharded of an N x N DenseVecMatrix; the families
# a /metrics scrape of phase 22 must carry
PREFETCH_FAMILIES = (
    "marlin_prefetch_chunks_total", "marlin_prefetch_stall_seconds_total",
    "marlin_prefetch_ready_depth", "marlin_prefetch_inflight_bytes",
    "marlin_dataplane_chunks_total", "marlin_dataplane_bytes_total")

# phase 24: the port's example CLIs in-process. The main paths at full width:
# BASELINE.md config 3, attention at the serving forward's 16384 tokens,
# config_lct's widths, config_decode's, and sparse mode 7 at a block density
# near config_bsr's (3276 of 65536 blocks of 128: one nonzero each of
# 32768^2 * 3.05e-6); the other CLIs at the sizes PERF.md states
CLI_MM = (str(N), str(N), str(N), "1")
CLI_ATTN = ("16384", "128", "1", "8")
CLI_LCT = (str(TRAIN_SEQ), str(TRAIN_STEPS), str(LCT["d_model"]),
           str(LCT["heads"]), str(LCT["layers"]), "ring")
CLI_DECODE = (str(ROWS), str(PROMPT), str(DECODE_STEPS), str(LM["d_model"]),
              str(LM["heads"]), str(LM["layers"]))
CLI_BSR = ("32768", "32768", "256", "3.05e-6", "7")
CLI_SPARSE = ("8192", "8192", "256", "0.001")
CLI_BLAS1_N, CLI_BLAS3_N, CLI_RMM_N = 1 << 24, 4096, 4096
CLI_LR = ("100", "1.0", "65536", "784")
CLI_PR_NODES = 100_000
CLI_GENMAT_N, CLI_LU_N = 2048, 1024
# LU from a genmat file (uniform [0, 5), no diagonal shift): componentwise
# backward error max |A[perm] - L U| / (|L| |U|) per element. Its growth
# factor puts |L||U| some 1000x above |A|, so a bound relative to max |A|
# would only measure the growth; the port's CPU run at 1024 read 2.4e-7
LU_BWD_TOL = 1e-5
CLI_ALS = dict(users=10_000, items=2_000, nnz=200_000, rank=16, iters=5)
# phase 26: bench_all.py config_moe — config_lct's model and stream with the
# FFN of each layer replaced by 8 experts, top-2, capacity factor 1.25,
# routing groups of 4096 tokens, remat and the LM head in 2048-token chunks
MOE_LM = dict(LCT, n_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
              moe_group=4096, remat=True, loss_chunk=2048)
MOE_ENGINE = (2, 1.25, 4096)
# the served MoE workload: phase 18's leg (a) load (config_decode's 32
# requests of 16-512-token prompts and 8-64 steps, every fourth sampled,
# buckets (128, 32) and (512, 64) over 8 rows, pages of 16, 256 prompt
# tokens an iteration) drawn over config_moe's vocab. The engine prefills in
# 64-token chunks (kvpool.PagedGroup's cap at page_len 16) and routes each
# chunk, zero-padded past the prompt, as a group of its own with that
# group's capacity, as the JAX engine does; lm_generate routes the whole
# prompt as one group, so under capacity drops the two differ. The greedy
# reference is that chunked computation without the engine: lm_prefill_paged
# chunk by chunk on a pool of its own, then lm_decode_paged's gather route,
# one request at a time
# moe_ffn on the card vs the same call on the CPU in f64 (routing in f32 on
# both, so the choices are equal): per element within MOE_F64_TOL of
# max|ref| (IEEE f32 products of 256- and 1024-long sums)
MOE_F64_TOL = 1e-5
# phase 27: bench_all.py config_serve's model (d_model 128, 8 heads, dh 16,
# 4 layers, vocab 256), its buckets and batch, and a bucket of 2048-token
# prompts so lm_prefill_slot takes the flash kernel; greedy and sampled
# requests, config_serve's prompt and step ranges
SERVE_MODEL = dict(vocab=256, d_model=128, heads=8, layers=4, seed=0)
SLAB_BUCKETS = ((64, 32), (256, 32), (2048, 8))
SLAB_BATCH, SLAB_REQUESTS, SLAB_LONG = 8, 48, 4
# phase 28: lazy.fuse over a.multiply(b).add(c).multiply(2.0) at this size,
# f32; fused vs eager per element within FUSE_TOL of max|eager| (the same
# IEEE f32 product, the elementwise tail fused)
FUSE_N, FUSE_TOL = 8192, 1e-6
# what a product's node in the fused graph calls
FUSE_PRODUCTS = ("matmul", "__matmul__", "mm", "addmm", "bmm", "linear")


# phase 29: config_lct's widths (LCT) on the TRAIN_SEQ stream at
# OFFLOAD_LAYERS layers, OFFLOAD_STEPS remat steps with and without
# offload_residuals; the planner on config_lct's model at TRAIN_SEQ tokens
# and an unreachable PLAN_TINY_BUDGET; then a one-rank NCCL world: ring_matmul
# and the RMM at DIST_N^2 (DIST_TOL of max|ref| against torch.matmul), ring
# and Ulysses attention at DIST_ATTN (heads, seq, head dim) causal, the
# pipeline over PIPE_SHAPE (batch, width; 2 tanh layers a stage, microbatches
# of PIPE_MB; PIPE_TOL of max|ref| against the stages in sequence, whose
# microbatches' products cuBLAS may block apart), the pipeline_training CLI at its defaults on PP_CLI (batch,
# seq len, steps), and pp_lm_loss at PP_LONG tokens. pp x tp: the two-matrix
# stage (width -> PIPE_FF -> width) with its weights placed over "cols",
# within PIPE_TOL of the stages in sequence, and pp_lm_loss with
# pp_tp_placement within PP_TP_RTOL of the unplaced loss (its row-split
# products are summed by an all-reduce). tools/workloads_ranks.py trains
# config_decode's model (LM) that way for TRAIN_STEPS steps on a PP_TP_BATCH
# (sequences, tokens) batch
OFFLOAD_LAYERS, OFFLOAD_STEPS = (2, 8), 2
PLAN_TINY_BUDGET = 64 * 2 ** 20
DIST_N, DIST_TOL = 8192, 1e-4
DIST_ATTN = (8, 4096, 128)
PIPE_SHAPE, PIPE_MB, PIPE_TOL = (64, 1024), 8, 1e-5
PIPE_FF = 4096
PP_CLI = ("8", "512", "8")
PP_LONG = 2048
PP_TP_RTOL = 1e-5
PP_TP_BATCH = (8, 512)
# phase 30: the workloads across ranks in a one-rank NCCL world. config_lct
# on the TRAIN_SEQ stream sharded over the ranks with each of RANKS_ATTN,
# held against phase 11's logical run with phase 11's tolerances
# (TRAIN_LOSS_RTOL on the losses; params: at most TRAIN_OUTLIER_SHARE of the
# elements past lr/10, difference TRAIN_DIFF_SHARE of the distance moved);
# config_moe (MOE_LM) through the expert-parallel path against its logical
# trainer: one step's loss and gradients with phase 26's tolerances
# (TRAIN_LOSS0_RTOL, TRAIN_GRAD_TOL of each leaf's max) and the losses of
# TRAIN_STEPS steps within TRAIN_LOSS_RTOL; the params' drift is logged, not
# held: the paths sum the expert batches in other orders (an H100 read
# 4.6e-6 of max on the step's gradients), and Adam moves an element whose
# gradient sits within that of 0 by up to 2·lr apart (871 of 9049344
# elements past lr/10 after 3 steps); the distributed_training CLI at (1, 1)
# on RANKS_NN_CLI (iterations, hidden, batch) against the same CLI outside
# the world (step losses within RANKS_TOL relative); blocked ALS at
# RANKS_ALS and PageRank at RANKS_PR through their rank paths against their
# plain paths (RANKS_TOL of the largest |entry|: the segment sums and the
# edge sums are index_add_ atomics, summed in another order each run)
RANKS_ATTN = ("ring_flash", "ulysses")
RANKS_NN_CLI = ("100", "64", "256")
RANKS_ALS = dict(users=100_000, items=20_000, nnz=2_000_000, rank=32,
                 iters=3, block=4096)
RANKS_PR = dict(n=1_000_000, e=10_000_000, iters=10)
RANKS_TOL = 1e-4
# phase 31: the matrices across ranks in a one-rank NCCL world: two N x N
# DenseVecMatrix.random over the rank mesh multiplied (auto) against the
# world-of-one multiply of the gathered inputs (F64_TOL of the largest
# |entry|); LINALG_N's LU legs and Cholesky through the row-block path
# against the logical path (perm equal, LINALG_TOL); compute_svd dist-eigs at
# SVD_M x SVD_N (s within LINALG_TOL of s[0]); save_sharded/load_sharded of
# an N x N matrix, bit for bit, restored in the world and outside it. The
# rank count's analytic bytes a rank holds at MATRIX_RANKS. RANKS_SPARSE: a
# rank-local n x n uniform [0, 1) DenseVecMatrix through
# to_sparse_vec_matrix(tol) (the entries above tol, 5 %, kept; triplets equal
# to the world of one's), times a rank-local n x p operand with
# multiply(format="bsr") (F64_TOL of the largest |entry| against the world of
# one's product)
MATRIX_RANKS = (1, 2, 4)
RANKS_SPARSE = dict(n=8192, p=256, tol=0.95)


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


def check_flash(torch, fa, gen, H, P, d, valid, dtype, dv=None) -> float:
    """One panel at (H, P, d) with valid_len < P; the same through
    ``flash_attention_single_panel`` on the strided views ``_prefill_attn``
    passes (head stride d, row stride H * d); then a two-panel run with
    carried state and nonzero offsets that are no multiple of the tile. The
    plain version tiles by 1024 keys and the kernel by 32 or 64, so in bf16
    they round p at different running maxima (see BF16_ATTN_ATOL). ``dv``
    (d by default) is v's width, and the output's."""
    import math

    import torch.nn.functional as F
    dv = dv or d
    scale = 1.0 / math.sqrt(d)
    dt = str(dtype)[6:]
    q, k, v = (torch.randn((H, P, w), generator=gen, device="cuda").to(dtype)
               for w in (d, d, dv))
    m = torch.full((H, P), -1e30, device="cuda")
    l = torch.zeros((H, P), device="cuda")
    acc = torch.zeros((H, P, dv), device="cuda")
    got = fa.flash_attention_panel(q, k, v, m, l, acc, 0, 0, valid,
                                   causal=True, scale=scale)
    want = fa.flash_attention_panel_plain(q, k, v, m, l, acc, 0, 0, valid,
                                          causal=True, scale=scale)
    outs = [st[2] / st[1].clamp(min=1e-30)[..., None] for st in (got, want)]
    torch.cuda.synchronize()
    m_err = float((got[0] - want[0]).abs().max())
    log(f"  flash_attention_panel H={H} P={P} d={d} dv={dv} valid={valid} "
        f"{dt} one panel: max|err| m {m_err:.3e} (tol {ATTN_F32_TOL:g})")
    if not m_err <= ATTN_F32_TOL:
        raise AssertionError(f"flash one panel P={P} {dtype}: m {m_err}")
    err = attn_close(torch, f"flash_attention_panel H={H} P={P} {dt} one "
                     f"panel out", outs[0], outs[1], dtype)
    del got, want, outs, m, l, acc
    # (valid, H, d) activations padded to P and viewed as (H, P, d)
    qs, ks, vs = (F.pad(torch.randn((valid, H, w), generator=gen,
                                    device="cuda").to(dtype),
                        (0, 0, 0, 0, 0, P - valid)).permute(1, 0, 2)
                  for w in (d, d, dv))
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
    acc = torch.zeros((H, P, dv), device="cuda")
    half = P // 2
    k2 = torch.randn((H, half, d), generator=gen, device="cuda").to(dtype)
    v2 = torch.randn((H, half, dv), generator=gen, device="cuda").to(dtype)
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
               valid, causal, dv=None):
    """q (H, sq, d) and dO (H, sq, dv); K/V panels (H, skv, d) and (H, skv,
    dv) with their key offsets (``dv`` d by default); ``lse`` and ``delta``
    from the plain forward over all panels. With ``strided``, (seq, heads,
    width) tensors viewed as (heads, seq, width), as ``_block`` hands them to
    ring attention."""
    dv = dv or d

    def make(n, w):
        if strided:
            t = torch.randn((n, H, w), generator=gen, device="cuda")
            return t.to(dtype).permute(1, 0, 2)
        return torch.randn((H, n, w), generator=gen, device="cuda").to(dtype)

    scale = 1.0 / d ** 0.5
    q, do = make(sq, d), make(sq, dv)
    kv = [(make(skv, d), make(skv, dv), off) for off in panels]
    st = (torch.full((H, sq), -1e30, device="cuda"),
          torch.zeros((H, sq), device="cuda"),
          torch.zeros((H, sq, dv), device="cuda"))
    for k, v, off in kv:
        st = fa.flash_attention_panel_plain(q, k, v, *st, q_off, off, valid,
                                            causal=causal, scale=scale)
    m, l, acc = st
    lf = l.clamp(min=1e-30)
    lse = m + torch.log(lf)
    delta = (do.float() * (acc / lf[..., None]).to(dtype).float()).sum(-1)
    return q, do, kv, lse, delta, scale


def check_bwd(torch, fa, gen, label, H, sq, d, valid, dtype, causal=True,
              strided=False, panels=(0,), skv=None, q_off=0, dv=None):
    """The dK/dV and dQ kernels against the plain backward on each K/V
    panel (bwd_close's bounds; bf16 above d = 128 BWD_BF16_WIDE_ATOL);
    returns the largest |err| of dq, dk and dv, and the largest
    err/bound. ``dv`` (d by default) is v's and dO's width."""
    q, do, kv, lse, delta, scale = bwd_inputs(
        torch, fa, gen, H, sq, skv or sq, d, dtype, strided, panels, q_off,
        valid, causal, dv)
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
    launch counts and the run (stream, initial params, params and losses
    after TRAIN_STEPS steps) phase 23 resumes to."""
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
    torch.cuda.empty_cache()
    wide_step(torch, tt, ops, resolve_attention_backend, stream)
    return train_counts, (stream, params0, params_k, losses_k)


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
    """A flash kernel instance's label from its template arguments (q/k and
    v widths, vectorised copies, and for the backward whether it is
    dK/dV)."""
    kind = "" if len(args) < 4 else ("dkv " if args[3] else "dq ")
    width = f"{args[0]}" if args[0] == args[1] else f"({args[0]}, {args[1]})"
    return (f"{kind}{dtype} d<={width}"
            f"{'' if args[2] else ' element-wise'}")


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
    ptxas_table(_build, "flash_attention_mla.cu", "flash_fwd_kernel", 4)
    ptxas_table(_build, "flash_attention_bwd.cu", "flash_bwd_kernel", 32)
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
    before = ops.launch_counts()["lr_step"]
    w, dt = guarded_call(torch, "lr", lambda: data.lr(1.0, LR_ITERS),
                         flop=4.0 * LR_M * (LR_D + 1) * LR_ITERS,
                         sync_guard=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lr_launches = ops.launch_counts()["lr_step"] - before
    if lr_launches != LR_ITERS:
        raise AssertionError(f"lr: {lr_launches} fused kernel launches for "
                             f"{LR_ITERS} iterations")
    # the plain loop in float64 (its intercept copy, two mat-vecs an
    # iteration): on the card logistic_regression takes float64 rows to the
    # fused kernel too
    from marlin_tpu_torch.ml.logistic_regression import _lr_fori

    x64 = data.logical().double()
    w64 = _lr_fori(torch.cat([torch.ones_like(x64[:, :1]), x64[:, 1:]], 1),
                   x64[:, 0], 1.0, LR_ITERS).cpu().numpy()
    del x64
    linalg_close(f"  lr weights vs an f64 run (peak device memory "
                 f"{peak:.2f} GiB)", float(np.abs(w - w64).max()),
                 float(np.abs(w64).max()))
    log(f"  launches of the port's kernels on the linalg path: "
        f"{ops.launch_counts()} (its products are torch.matmul, as the JAX "
        f"package's are jnp.dot outside any Pallas kernel; lr's steps are "
        f"the fused lr kernel, one launch an iteration)")
    del data
    torch.cuda.empty_cache()
    res["lr"] = dict(s=dt, launches=lr_launches, **lr_times(torch, np))
    return res


def lr_times(torch, np) -> dict:
    """The fused lr step at tall_10m's shape (LR_MAIN_M rows of a label and
    LR_MAIN_D features uniform on [-1, 1)): one step against the plain step
    (the move ``w_new - w`` within LINALG_TOL of the plain move's largest
    entry), then by CUDA events beside its byte bound (one read of the
    rows), the plain step and the step as the plain loop takes it, the
    intercept copy's two cuBLAS gemvs (``library_ms``; the copy itself not
    timed)."""
    from marlin_tpu_torch.ops import lr_gradient as lg

    m, n = LR_MAIN_M, LR_MAIN_D + 1
    gen = torch.Generator(device="cuda").manual_seed(17)
    data = torch.empty((m, n), device="cuda")
    for r0 in range(0, m, 1_000_000):
        r1 = min(m, r0 + 1_000_000)
        data[r0:r1] = torch.rand((r1 - r0, n), generator=gen,
                                 device="cuda") * 2 - 1
        data[r0:r1, 0] = (data[r0:r1, 0] > 0).float()
    w = torch.randn(n, generator=gen, device="cuda") * 0.05
    scale = torch.full((1,), 1.0 / m, device="cuda")
    want = lg.lr_step_plain(data, w, scale, m) - w
    got = lg.lr_step(data, w.clone(), scale, m) - w
    err = linalg_close(f"  lr step at {m} x {n} vs the plain step",
                       float((got - want).abs().max()),
                       float(want.abs().max()))
    w_run = w.clone()
    ms = cuda_ms(torch, lambda: lg.lr_step(data, w_run, scale, m), 20)
    plain = cuda_ms(torch, lambda: lg.lr_step_plain(data, w, scale, m), 5)
    feats = torch.cat([torch.ones((m, 1), device="cuda"), data[:, 1:]], 1)
    labels = data[:, 0]
    lib = cuda_ms(torch, lambda: w - feats.T @ (
        1.0 / (1.0 + torch.exp(-(feats @ w))) - labels) * scale, 5)
    bound = 1e3 * 4.0 * m * n / HBM_BYTES_PER_S
    log(f"  lr step at {m} x {n}: kernel {ms:.3f} ms "
        f"({4.0 * m * n / ms / 1e6:.1f} GB/s), bound {bound:.3f} ms (bytes), "
        f"plain {plain:.3f} ms, the two cuBLAS gemvs {lib:.3f} ms (CUDA "
        f"events)")
    del data, feats, labels
    torch.cuda.empty_cache()
    return dict(ms=ms, plain=plain, lib=lib, bound=bound, err=err)


def als_leg(torch, np, mt):
    """config_als through ``CoordinateMatrix.als``: one warm-up sweep, then
    ALS["iters"] timed; every blocked half-step under
    ``set_sync_debug_mode("error")`` (the index-max reads and the host
    packing before the loop stay outside it)."""
    from marlin_tpu_torch.ml import als as als_mod

    cfg, sample = ALS, ALS_SAMPLE
    users, items, rank, nnz = (cfg[k] for k in ("users", "items", "rank",
                                                "nnz"))
    rng = np.random.default_rng(0)
    ui = rng.integers(0, users, nnz).astype(np.int32)
    ii = rng.integers(0, items, nnz).astype(np.int32)
    u_t = rng.standard_normal((users, 8)).astype(np.float32) / 8.0
    v_t = rng.standard_normal((items, 8)).astype(np.float32)
    vals = np.einsum("nk,nk->n", u_t[ui], v_t[ii]) + \
        0.1 * rng.standard_normal(nnz).astype(np.float32)
    coo = mt.CoordinateMatrix(ui, ii, vals, shape=(users, items))
    calls = []  # (fixed factors, result, host time at entry) per half-step
    orig = als_mod._solve_side_sharded

    def guarded(other, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(other, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append((other, out, t0))
        return out

    als_mod._solve_side_sharded = guarded
    try:
        t0 = time.perf_counter()
        coo.als(rank=rank, iterations=1, lam=cfg["lam"])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if len(calls) != 2:
            raise AssertionError(f"ALS at {users} users took the unblocked "
                                 f"path ({len(calls)} blocked half-steps)")
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = coo.als(rank=rank, iterations=cfg["iters"], lam=cfg["lam"])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        als_mod._solve_side_sharded = orig
    total_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    starts = [c[2] for c in calls[::2]] + [t_end]
    sweep_s = [b - a for a, b in zip(starts, starts[1:])]
    rmses = []
    for k in range(cfg["iters"]):
        uk, vk = calls[2 * k][1][:users], calls[2 * k + 1][1][:items]
        rmses.append(als_mod.ALSModel(
            mt.DenseVecMatrix.from_array(uk),
            mt.DenseVecMatrix.from_array(vk)).rmse(coo))
    if not all(math.isfinite(r) for r in rmses) or \
            any(b >= a for a, b in zip(rmses, rmses[1:])):
        raise AssertionError(f"ALS RMSE per sweep does not fall: {rmses}")
    if abs(model.rmse(coo) - rmses[-1]) > 1e-6:
        raise AssertionError("the returned model is not the last sweep's")
    # the last user half-step against f64 numpy from the same item factors
    v_fixed = calls[-2][0][:items].double().cpu().numpy()
    u_card = calls[-2][1][:users].cpu().numpy()
    counts = np.bincount(ui, minlength=users)
    empty = np.flatnonzero(counts == 0)
    if empty.size and np.abs(u_card[empty]).max() != 0:
        raise AssertionError("ALS: users without ratings are not exactly 0")
    picks = np.random.default_rng(1).choice(np.flatnonzero(counts > 0),
                                            sample, replace=False)
    order = np.argsort(ui, kind="stable")
    starts_u = np.concatenate([[0], np.cumsum(counts)])
    err = scale = 0.0
    for uid in picks:
        rows = order[starts_u[uid]:starts_u[uid + 1]]
        vs = v_fixed[ii[rows]]
        a = vs.T @ vs + cfg["lam"] * len(rows) * np.eye(rank)
        x = np.linalg.solve(a, vs.T @ vals[rows].astype(np.float64))
        err = max(err, float(np.abs(u_card[uid] - x).max()))
        scale = max(scale, float(np.abs(x).max()))
    log(f"  ALS {users} x {items}, rank {rank}, {nnz} ratings, λ "
        f"{cfg['lam']}: warm-up sweep {warm_s:.3f} s; {cfg['iters']} sweeps "
        f"in {total_s:.3f} s = {total_s / cfg['iters']:.3f} s/sweep "
        f"(bench_all.py's figure: init, packing and sweeps); the sweeps "
        f"alone {', '.join(f'{t:.3f}' for t in sweep_s)} s; RMSE per sweep "
        f"{', '.join(f'{r:.5f}' for r in rmses)}; peak device memory "
        f"{peak:.2f} GiB; {len(empty)} users without ratings exactly 0")
    rel = err / scale
    log(f"  ALS user half-step vs f64 numpy on {sample} users: max|diff| "
        f"{err:.3e}, {rel:.3e} of {scale:.4g} (tol {ALS_TOL:g}); every "
        f"half-step ran under set_sync_debug_mode('error')")
    if not rel <= ALS_TOL:
        raise AssertionError(f"ALS half-step vs f64: {rel} > {ALS_TOL}")


def nn_leg(torch, np, mt):
    """config_nn through ``NeuralNetwork.train``: NN["warm"] warm-up steps,
    then NN["iters"] timed; the first NN["f64_steps"] steps held against the
    same steps in f64 on the CPU. Returns the trained params."""
    from marlin_tpu_torch import threefry
    from marlin_tpu_torch.ml import NeuralNetwork, train_step

    cfg = NN
    m, d, hidden, classes, batch = (cfg[k] for k in ("m", "d", "hidden",
                                                     "classes", "batch"))
    data = mt.DenseVecMatrix.random(0, m, d)
    labels = np.arange(m) % classes
    nn = NeuralNetwork(input_dim=d, hidden_dim=hidden, output_dim=classes)
    # the first steps against f64 on the CPU, from the same init and keys
    n64 = cfg["f64_steps"]
    p_first, l_first = nn.train(data, labels, iterations=n64,
                                batch_size=batch)
    x64 = data.logical().double().cpu()
    y64 = torch.nn.functional.one_hot(torch.from_numpy(labels),
                                      classes).double()
    p64 = {k: v.double().cpu() for k, v in nn.init_params().items()}
    key = threefry.key_words(nn.seed + 1)
    l64 = []
    for _ in range(n64):
        key, sub = threefry.split_words(key)
        p64, loss = train_step(p64, x64, y64, sub, batch, nn.learning_rate)
        l64.append(float(loss))
    del x64, y64
    loss_err = max(abs(a - b) / b for a, b in zip(l_first, l64))
    w_err = max(float((p_first[k].double().cpu() - p64[k]).abs().max())
                / float(p64[k].abs().max()) for k in p64)
    log(f"  MLP first {n64} steps vs f64 on the CPU: losses "
        f"{', '.join(f'{v:.7f}' for v in l_first)} (f64 "
        f"{', '.join(f'{v:.7f}' for v in l64)}), max rel diff {loss_err:.3e};"
        f" params max diff {w_err:.3e} of max |w| (tol {NN_TOL:g})")
    if not (loss_err <= NN_TOL and w_err <= NN_TOL):
        raise AssertionError(f"MLP vs f64: loss {loss_err}, params {w_err}")
    params, warm_losses = nn.train(data, labels, iterations=cfg["warm"],
                                   batch_size=batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, losses = nn.train(data, labels, iterations=cfg["iters"],
                              batch_size=batch, params=params)
    dt = time.perf_counter() - t0  # train reads the losses: one sync
    if not (math.isfinite(losses[-1]) and losses[-1] < warm_losses[0]):
        raise AssertionError(f"MLP losses {warm_losses[0]} (first step) -> "
                             f"{losses[-1]}")
    layer_flops = 2 * batch * (d * hidden + hidden * classes)
    steps_s = cfg["iters"] / dt
    log(f"  MLP {m} x {d}, hidden {hidden}, {classes} classes, batch {batch}:"
        f" {cfg['iters']} steps in {dt:.3f} s = {steps_s:.2f} steps/s, "
        f"{3 * layer_flops * steps_s / 1e9:.1f} GFLOP/s model (bench_all.py's"
        f" count: 3 products per layer); loss {warm_losses[0]:.5f} at the "
        f"first step, {losses[0]:.5f} -> {losses[-1]:.5f} over the timed "
        f"steps; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return params


def pagerank_leg(torch, np, mt):
    """config_pagerank through ``build_transition_operator`` and
    ``pagerank``: the host build timed apart, one warm-up iteration, then
    PR["iters"]; the ranks against a scipy.sparse f64 power iteration on
    the same operator."""
    import scipy.sparse as sp

    from marlin_tpu_torch.ml import build_transition_operator, pagerank

    n, e, iters = PR["n"], PR["e"], PR["iters"]
    rng = np.random.default_rng(0)
    edges = np.empty((e, 2), np.int64)
    edges[:, 0] = rng.integers(0, n, e)
    edges[:, 1] = rng.integers(0, n, e)
    t0 = time.perf_counter()
    op = build_transition_operator(edges, n=n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del edges
    pagerank(op, iterations=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = pagerank(op, iterations=iters)  # the ranks come back to the host
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not abs(float(r.sum(dtype=np.float64)) - 1.0) < 1e-3:
        raise AssertionError(f"PageRank ranks sum to {r.sum()}")
    # the oracle: dst-sorted edges are CSR rows as they stand
    src, dst = op.src.cpu().numpy(), op.dst.cpu().numpy()
    inv_deg = op.inv_deg.double().cpu().numpy()
    dangling = op.dangling.double().cpu().numpy()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    m64 = sp.csr_matrix((inv_deg[src], src, indptr), shape=(n, n))
    r64 = np.full(n, 1.0 / n)
    for _ in range(iters):
        r64 = 0.85 * (m64 @ r64 + (r64 @ dangling) / n) + 0.15 / n
        r64 /= r64.sum()
    err = float(np.abs(r - r64).max())
    rel = err / float(r64.max())
    log(f"  PageRank {n} nodes, {e} edges: host build {build_s:.3f} s; "
        f"{iters} iterations in {dt:.3f} s = {dt / iters * 1e3:.3f} ms/iter "
        f"(the ranks read back once); sum {r.sum(dtype=np.float64):.7f}; vs "
        f"scipy.sparse f64 max|diff| {err:.3e}, {rel:.3e} of the largest "
        f"rank (tol {PR_TOL:g}); peak device memory {peak:.2f} GiB")
    if not rel <= PR_TOL:
        raise AssertionError(f"PageRank vs f64: {rel} > {PR_TOL}")


def ml_path(torch, np, mt, ops, smi):
    """Phase 19: the ml path at bench_all.py's sizes; returns the trained
    MLP params (phase 20 serves them)."""
    log(f"phase 19: config_als {ALS}, config_nn {NN}, config_pagerank {PR}")
    ops.reset_launch_counts()
    als_leg(torch, np, mt)
    torch.cuda.empty_cache()
    params = nn_leg(torch, np, mt)
    torch.cuda.empty_cache()
    pagerank_leg(torch, np, mt)
    torch.cuda.empty_cache()
    log(f"  launches of the port's kernels on the ml path: "
        f"{ops.launch_counts()} (ALS, the MLP and PageRank are torch ops "
        f"and library calls, as the JAX package's are outside any Pallas "
        f"kernel)")
    log(f"phase 19 result: every check passed; {smi}")
    return params


def _served(handles, what):
    """Each handle's Result, all OK."""
    out = []
    for h in handles:
        r = h.result(timeout=ENGINE_WAIT_S)
        if r.status != "ok":
            raise AssertionError(f"{what}: request {r.rid} {r.status}: "
                                 f"{r.reason}")
        out.append(r)
    return out


def programs_path(torch, np, tt, pa, mlp_params, smi):
    """Phase 20: bench_all.py config_serve_als through ServeEngine, then the
    classification and PageRank programs and a swap under load (see the
    module docstring). Returns the paged kernel's (split, combine) launches
    in this phase."""
    import threading

    from marlin_tpu_torch.ml import build_transition_operator
    from marlin_tpu_torch.serving import (ALSScoreProgram, ClassifyProgram,
                                          PageRankQueryProgram, Request,
                                          ServeEngine, percentile)

    log(f"phase 20: ServeEngine over TransformerLM{tuple(SERVE_LM.values())}"
        f" f32, bucket {SERVE_BUCKETS}, max_batch 8, max_wait_ms 1.0, "
        f"ALSScoreProgram over {SERVE_ALS}")
    heads, vocab, n_mix = SERVE_LM["heads"], SERVE_LM["vocab"], SERVE_MIX
    users, items, rank, n_als, k = (SERVE_ALS[x] for x in (
        "users", "items", "rank", "requests", "k"))
    rng = np.random.default_rng(0)
    uf = rng.standard_normal((users, rank)).astype(np.float32)
    pf = rng.standard_normal((items, rank)).astype(np.float32)
    scores64 = uf.astype(np.float64) @ pf.T.astype(np.float64)
    params = tt.TransformerLM(**SERVE_LM).init_params()
    split0 = pa.paged_decode_attention.launches
    comb0 = pa.paged_decode_attention.combine_launches
    steps = 0  # LM decode steps the engines recorded

    def make_engine(*programs, depth=4 * (n_als + n_mix)):
        eng = ServeEngine(params, heads, buckets=SERVE_BUCKETS, max_batch=8,
                          max_wait_ms=1.0, queue_depth=depth,
                          programs=list(programs))
        eng.warmup()
        eng.launches0 = pa.paged_decode_attention.launches
        return eng

    def close(eng):
        """Close and hold: the worker joined, the pool's audit clean, the
        paged kernel launched once per layer of every LM decode step."""
        nonlocal steps
        eng.close()
        if eng._thread.is_alive() or not eng.kvpool_audit()["ok"]:
            raise AssertionError("phase 20: worker alive or pool audit "
                                 "failed after close")
        snap = eng.metrics.snapshot()
        lm_steps = snap["steps"] - snap["program_steps"]
        launched = pa.paged_decode_attention.launches - eng.launches0
        if launched != lm_steps * SERVE_LM["layers"]:
            raise AssertionError(f"phase 20: {launched} paged launches for "
                                 f"{lm_steps} LM decode steps x "
                                 f"{SERVE_LM['layers']} layers")
        steps += lm_steps

    def als_reqs(n):
        return [Request(program="als", payload={
            "user": int(rng.integers(0, users)), "k": k}) for _ in range(n)]

    def check_als(reqs, results, what, model=None):
        s64 = scores64 if model is None else model
        for q, r in zip(reqs, results):
            u = q.payload["user"]
            want = set(np.argsort(-s64[u], kind="stable")[:k].tolist())
            if set(r.value["items"].tolist()) != want:
                raise AssertionError(f"{what}: user {u} top-{k} != numpy")

    # (a) ALS alone
    eng = make_engine(ALSScoreProgram((uf, pf)))
    try:
        reqs = als_reqs(n_als)
        t0 = time.perf_counter()
        handles = [eng.submit(q) for q in reqs]
        eng.drain()
        span = time.perf_counter() - t0
        results = _served(handles, "leg (a)")
    finally:
        close(eng)
    check_als(reqs, results, "leg (a)")
    lat = sorted(r.metrics["total_s"] for r in results)
    qps = len(results) / span
    p50, p99 = percentile(lat, 50) * 1e3, percentile(lat, 99) * 1e3
    log(f"  (a) {n_als} ALS requests alone: {qps:.1f} req/s, submit-to-"
        f"result p50 {p50:.3f} ms, p99 {p99:.3f} ms; every top-{k} == numpy "
        f"f64's as a set")

    # (b) LM alone, then LM beside as many ALS requests, on one engine each
    def lm_reqs(n):
        return [Request(prompt=rng.integers(0, vocab, int(rng.integers(
            8, 48))).astype(np.int32), steps=int(rng.integers(4, 16)))
            for _ in range(n)]

    def run_lm(mixed):
        reqs = lm_reqs(n_mix)
        extra = als_reqs(n_mix) if mixed else []
        eng = make_engine(ALSScoreProgram((uf, pf)))
        try:
            t0 = time.perf_counter()
            handles = [eng.submit(q) for q in reqs]
            ehandles = [eng.submit(q) for q in extra]
            eng.drain()
            span = time.perf_counter() - t0
            lm_out = _served(handles, "leg (b) LM")
            als_out = _served(ehandles, "leg (b) ALS")
        finally:
            close(eng)
        check_als(extra, als_out, "leg (b)")
        for q, r in zip(reqs, lm_out):
            ref = tt.lm_generate(params, q.prompt, 0, heads=heads,
                                 max_len=len(q.prompt) + q.steps,
                                 steps=q.steps).tolist()
            if r.tokens.tolist() != ref:
                raise AssertionError(f"leg (b) {'mixed' if mixed else 'LM'}:"
                                     f" greedy tokens != lm_generate")
        toks = sum(r.tokens.size - len(q.prompt) for q, r in zip(reqs, lm_out))
        return toks / span

    solo, mixed = run_lm(False), run_lm(True)
    log(f"  (b) {n_mix} LM requests alone {solo:.1f} tok/s; beside {n_mix} "
        f"ALS requests {mixed:.1f} tok/s; mixed/solo {mixed / solo:.3f} (the"
        f" reference's bar is >= 0.95, host clock; not gated); greedy tokens "
        f"== lm_generate in both runs")

    # classification over phase 19's MLP, PageRank over a 10^4-node graph
    n_pr, e_pr = SERVE_PR_N, SERVE_PR_E
    edges = np.stack([rng.integers(0, n_pr, e_pr), rng.integers(0, n_pr,
                                                                e_pr)], 1)
    mlp = {kk: v.detach() for kk, v in mlp_params.items()}
    mlp64 = {kk: v.double().cpu().numpy() for kk, v in mlp.items()}
    clf = ClassifyProgram(mlp)
    prq = PageRankQueryProgram(build_transition_operator(edges, n=n_pr))
    eng = make_engine(clf, prq)
    try:
        ranks = prq.refresh(iterations=SERVE_PR_REFRESH)
        xs = rng.random((SERVE_CLASSIFY_ROWS, clf.feature_dim)).astype(
            np.float32)
        nodes = rng.integers(0, n_pr, SERVE_CLASSIFY_ROWS)
        hc = [eng.submit(Request(program="classify", payload={"x": x}))
              for x in xs]
        hp = [eng.submit(Request(program="pagerank",
                                 payload={"node": int(v), "k": k}))
              for v in nodes]
        rc, rp = _served(hc, "classify"), _served(hp, "pagerank")
    finally:
        close(eng)
    h = xs.astype(np.float64)
    for i in range(len(mlp64)):
        h = 1.0 / (1.0 + np.exp(-(h @ mlp64[f"w{i}"])))
    c_err = max(float(np.abs(r.value["proba"] - h[j]).max())
                for j, r in enumerate(rc))
    if not c_err <= SERVE_TOL or any(r.value["label"] != int(np.argmax(h[j]))
                                     for j, r in enumerate(rc)):
        raise AssertionError(f"classify vs numpy f64: {c_err}")
    # PageRank: the refreshed ranks vs an f64 power iteration, and each
    # answer's scores vs the top-k of the node's out-neighbors' ranks (ties
    # between neighbors of equal rank may come out in either order)
    deg = np.bincount(edges[:, 0], minlength=n_pr).astype(np.float64)
    r64 = np.full(n_pr, 1.0 / n_pr)
    for _ in range(SERVE_PR_REFRESH):
        contrib = np.where(deg > 0, r64 / np.maximum(deg, 1), 0.0)
        acc = np.bincount(edges[:, 1], weights=contrib[edges[:, 0]],
                          minlength=n_pr)
        r64 = 0.85 * (acc + r64[deg == 0].sum() / n_pr) + 0.15 / n_pr
        r64 /= r64.sum()
    r_err = float(np.abs(ranks - r64).max())
    p_err = 0.0
    for v, r in zip(nodes, rp):
        nbr = edges[edges[:, 0] == v, 1]
        want = np.sort(ranks[nbr])[::-1][:k]
        got = r.value["scores"]
        if len(got) != len(want) or not set(r.value["items"].tolist()) <= \
                set(nbr.tolist()):
            raise AssertionError(f"pagerank node {v}: {r.value} vs {nbr}")
        if len(got):
            p_err = max(p_err, float(np.abs(got - want).max()),
                        float(np.abs(ranks[r.value["items"]] - got).max()))
    if not (r_err <= SERVE_TOL * r64.max() and p_err == 0.0):
        raise AssertionError(f"pagerank: ranks {r_err}, scores {p_err}")
    log(f"  classify ({SERVE_CLASSIFY_ROWS} rows, phase 19's MLP) vs numpy "
        f"f64 max|diff| {c_err:.3e} (tol {SERVE_TOL:g}); PageRank program "
        f"({n_pr} nodes, {e_pr} edges, refresh {SERVE_PR_REFRESH}) ranks vs "
        f"f64 max|diff| {r_err:.3e} of max {r64.max():.3e}; "
        f"{SERVE_CLASSIFY_ROWS} top-{k} answers == the neighbors' ranks")

    # swap_model under load: rows answered before the swap read the old
    # factors, rows submitted after it returned read the new ones, and
    # every answer reads one model whole
    als = ALSScoreProgram((uf, pf))
    eng = make_engine(als)
    new64 = -scores64
    try:
        stop, before, during = threading.Event(), [], []

        def pump():
            while not stop.is_set():
                q = als_reqs(1)[0]
                during.append((q, eng.submit(q)))
                time.sleep(0.0005)

        for q in als_reqs(64):
            before.append((q, eng.submit(q)))
        _served([hh for _, hh in before], "swap (before)")
        th = threading.Thread(target=pump, name="smoke-pump")
        th.start()
        time.sleep(0.05)
        done_before = [(q, hh) for q, hh in during if hh.done()]
        shapes = (tuple(als._uf.shape), tuple(als._pf.shape), als._uf.device)
        eng.swap_model("als", (-uf, pf))
        after = [(q, eng.submit(q)) for q in als_reqs(64)]
        time.sleep(0.05)
        stop.set()
        th.join(60)
        pairs = before + during + after
        answers = _served([hh for _, hh in pairs], "swap")
    finally:
        close(eng)
    if (tuple(als._uf.shape), tuple(als._pf.shape), als._uf.device) != shapes:
        raise AssertionError("swap_model changed the resident shapes")
    old_ids = {id(hh) for _, hh in before + done_before}
    new_ids = {id(hh) for _, hh in after}
    n_old = n_new = 0
    for (q, hh), r in zip(pairs, answers):
        got = set(r.value["items"].tolist())
        u = q.payload["user"]
        is_old = got == set(np.argsort(-scores64[u], kind="stable")[:k]
                            .tolist())
        is_new = got == set(np.argsort(-new64[u], kind="stable")[:k]
                            .tolist())
        if not (is_old or is_new) or (id(hh) in old_ids and not is_old) or \
                (id(hh) in new_ids and not is_new):
            raise AssertionError(f"swap: user {u} read a torn or wrong model")
        n_old += is_old
        n_new += is_new
    split = pa.paged_decode_attention.launches - split0
    comb = pa.paged_decode_attention.combine_launches - comb0
    log(f"  swap under load: {len(pairs)} ALS answers ({len(before)} + "
        f"{len(done_before)} answered before the swap read the old model, "
        f"the {len(after)} submitted after it the new; {n_old} old, {n_new} "
        f"new in all), resident shapes kept, {als.swap_count} swap")
    if steps <= 0:
        raise AssertionError("phase 20: no LM decode step")
    log(f"phase 20 result: ALS alone {qps:.1f} req/s (p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms); LM {solo:.1f} tok/s alone, {mixed:.1f} beside ALS "
        f"(ratio {mixed / solo:.3f}); the paged kernel {split} split + {comb}"
        f" combine launches ({steps} LM decode steps x "
        f"{SERVE_LM['layers']} layers, the rest the engines' warm-ups); "
        f"{smi}")
    return split, comb


def engine_specs(np, vocab=LM["vocab"]):
    """Leg (a)'s request set, drawn from seed 0: prompts of 16-512 tokens
    over ``vocab``, 8-64 steps, every ENGINE_SAMPLED_EVERY-th sampled with
    its own seed."""
    rng = np.random.default_rng(0)
    specs = []
    for i in range(ENGINE_REQUESTS):
        n, steps = int(rng.integers(16, 513)), int(rng.integers(8, 65))
        spec = dict(prompt=rng.integers(0, vocab, n).astype(np.int32),
                    steps=steps)
        if i % ENGINE_SAMPLED_EVERY == ENGINE_SAMPLED_EVERY - 1:
            spec.update(temperature=0.8, top_k=40, seed=1000 + i)
        specs.append(spec)
    return specs


def submit_from_threads(eng, Request, specs, **extra):
    """Submit ``specs`` from ENGINE_THREADS threads (thread t takes every
    ENGINE_THREADS-th spec from t); returns the handles in spec order."""
    import threading

    handles = [None] * len(specs)
    errors = []

    def submitter(t):
        try:
            for i in range(t, len(specs), ENGINE_THREADS):
                handles[i] = eng.submit(Request(**specs[i], **extra))
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(t,),
                                name=f"smoke-submit-{t}")
               for t in range(ENGINE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(ENGINE_WAIT_S)
    if errors or any(h is None for h in handles):
        raise AssertionError(f"submitters failed: {errors}")
    return handles


def engine_results(handles, what):
    """One Result per handle, each OK (a non-OK Result that was not injected
    fails the run)."""
    out = []
    for h in handles:
        r = h.result(timeout=ENGINE_WAIT_S)
        if r.status != "ok":
            raise AssertionError(f"{what}: request {r.rid} {r.status}: "
                                 f"{r.reason}")
        out.append(r.tokens.tolist())
    return out


def decode_syncs(torch, np, tt, params, sampled):
    """Synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode("warn")``)
    in one decode step made as the engine makes it: numpy block tables,
    positions, tokens and sampling vectors in (``sampled``: temperature 0.8
    and top_k 40 on every row), then the read of the emitted tokens.
    Returns (the syncs inside ``lm_decode_paged``, the syncs in all)."""
    import warnings

    from marlin_tpu_torch.serving import kvpool

    pool = kvpool.PagedKVPool(params, LM["heads"], 64, PAGE_LEN)
    g = kvpool.PagedGroup(ENGINE_BUCKETS[-1], ROWS, PAGE_LEN, PREFILL_CHUNK)
    tables, positions, cur = g.decode_inputs()
    temp = np.full(ROWS, 0.8 if sampled else 0.0, np.float32)
    top_k = np.full(ROWS, 40 if sampled else 0, np.int32)

    def step():
        return tt.lm_decode_paged(
            params, pool.pages, tables, positions, cur, g.steps_done, g.seeds,
            temp, g.top_p, top_k, heads=LM["heads"], page_len=PAGE_LEN,
            kernel="pallas")

    step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, nxt = step()
            inside = len(caught)
            nxt.cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = ["synchroniz" in str(w.message) for w in caught]
    return sum(syncs[:inside]), sum(syncs)


def engine_path(torch, np, tt, ops, pa, prompts8, streams8,
                serve_bucket_ms, smi):
    """Phase 18: serve through the port's ServeEngine at full width (see
    the module docstring); returns the paged kernel's launches on it."""
    import urllib.request

    from marlin_tpu_torch import obs
    from marlin_tpu_torch.ops.local import local_matmul
    from marlin_tpu_torch.serving import Request, ServeEngine
    from marlin_tpu_torch.utils import faults

    layers = LM["layers"]
    log(f"phase 18: ServeEngine over TransformerLM{tuple(LM.values())} f32, "
        f"buckets {ENGINE_BUCKETS}, max_batch {ROWS}, page_len {PAGE_LEN}, "
        f"prefill_chunk {PREFILL_CHUNK}, decode_kernel 'auto'")
    params = tt.TransformerLM(**LM).init_params()
    specs = engine_specs(np)

    def make_engine():
        eng = ServeEngine(params, LM["heads"], buckets=ENGINE_BUCKETS,
                          max_batch=ROWS, page_len=PAGE_LEN,
                          prefill_chunk=PREFILL_CHUNK, decode_kernel="auto")
        if eng._decode_kernel != "pallas":
            raise AssertionError(f"decode_kernel 'auto' resolved to "
                                 f"{eng._decode_kernel!r} on the card")
        eng.warmup()
        return eng

    def finish(eng, label, launches0):
        """Close the engine and hold its leg's postconditions: the worker
        joined, the pool's audit clean, and the paged kernel launched once
        per layer of every decode step the engine recorded."""
        eng.close()
        if eng._thread.is_alive():
            raise AssertionError(f"{label}: worker thread still alive")
        audit = eng.kvpool_audit()
        if not audit["ok"]:
            raise AssertionError(f"{label}: pool audit {audit['errors']}")
        snap = eng.metrics.snapshot()
        launches = pa.paged_decode_attention.launches - launches0
        if launches != snap["steps"] * layers or launches <= 0:
            raise AssertionError(f"{label}: {launches} paged launches for "
                                 f"{snap['steps']} decode steps x {layers}")
        log(f"  {label}: {snap['completed']} ok, {snap['steps']} decode "
            f"steps, {launches} paged kernel launches, retries "
            f"{snap['retries']}, prefix hits {snap['prefix_hits']}, audit "
            f"clean (used {audit['used']}, cached {audit['cached']})")
        return snap

    greedy = [i for i, s in enumerate(specs) if "temperature" not in s]
    refs = {i: tt.lm_generate(params, specs[i]["prompt"], 0,
                              heads=LM["heads"],
                              max_len=len(specs[i]["prompt"])
                              + specs[i]["steps"],
                              steps=specs[i]["steps"]).tolist()
            for i in greedy}

    def check_greedy(tokens, label):
        bad = [i for i in greedy if tokens[i] != refs[i]]
        if bad:
            raise AssertionError(f"{label}: greedy requests {bad} != "
                                 f"lm_generate")

    # (a) mixed load from submitter threads, a /metrics scrape during it
    ops.reset_launch_counts()
    combine0 = pa.paged_decode_attention.combine_launches
    server = obs.MetricsServer(port=0)
    server.start()
    try:
        eng = make_engine()
        l0 = pa.paged_decode_attention.launches
        t0 = time.perf_counter()
        handles = submit_from_threads(eng, Request, specs)
        scrape = urllib.request.urlopen(server.url, timeout=60).read()\
            .decode()
        got_a = engine_results(handles, "leg (a)")
        wall_a = time.perf_counter() - t0
        snap_a = finish(eng, "(a) mixed load", l0)
    finally:
        server.close()
    missing = [f for f in SERVE_FAMILIES if f"# TYPE {f} " not in scrape]
    if missing:
        raise AssertionError(f"/metrics scrape lacks {missing}")
    check_greedy(got_a, "leg (a)")
    solo = make_engine()
    l0 = pa.paged_decode_attention.launches
    for i, s in enumerate(specs):
        if "temperature" in s:
            one = engine_results([solo.submit(Request(**s))], "solo")[0]
            if one != got_a[i]:
                raise AssertionError(f"sampled request {i}: served in the "
                                     f"mix != served alone")
    finish(solo, "(a) sampled requests served alone", l0)
    gen_tok = sum(len(t) - len(s["prompt"]) for t, s in zip(got_a, specs))
    log(f"  (a) {len(greedy)} greedy == lm_generate, "
        f"{len(specs) - len(greedy)} sampled == served alone; /metrics "
        f"carries {len(SERVE_FAMILIES)} families")

    # (b) a shared system prompt
    rng = np.random.default_rng(1)
    system = rng.integers(0, LM["vocab"], SYSTEM_PROMPT).astype(np.int32)
    shared = [dict(prompt=np.concatenate([system, rng.integers(
        0, LM["vocab"], int(rng.integers(1, 200)))]).astype(np.int32),
        steps=int(rng.integers(8, 65))) for _ in range(SHARED_REQUESTS)]
    eng = make_engine()
    l0 = pa.paged_decode_attention.launches
    got_b = engine_results(submit_from_threads(eng, Request, shared),
                           "leg (b)")
    snap_b = finish(eng, "(b) shared prefix", l0)
    if snap_b["prefix_hits"] <= 0:
        raise AssertionError("leg (b): no prefix-cache hit")
    for i, s in enumerate(shared):
        ref = tt.lm_generate(params, s["prompt"], 0, heads=LM["heads"],
                             max_len=len(s["prompt"]) + s["steps"],
                             steps=s["steps"]).tolist()
        if got_b[i] != ref:
            raise AssertionError(f"leg (b): request {i} != unshared "
                                 f"lm_generate")

    # (c) chaos: two decode-step faults and one prefill fault, retried
    eng = make_engine()
    l0 = pa.paged_decode_attention.launches
    with faults.injected("serve.decode_step", faults.RaiseFault(times=2)), \
            faults.injected("serve.prefill", faults.RaiseFault(times=1)):
        handles = submit_from_threads(eng, Request, specs, max_attempts=3)
        got_c = engine_results(handles, "leg (c)")
    snap_c = finish(eng, "(c) chaos", l0)
    if got_c != got_a or snap_c["retries"] < 3 or faults.active():
        raise AssertionError(f"leg (c): tokens equal {got_c == got_a}, "
                             f"retries {snap_c['retries']}, faults left "
                             f"{faults.active()}")

    # (d) the main thread runs TF32 products while the engine serves
    flags = torch.backends.cuda.matmul
    if flags.allow_tf32:
        raise AssertionError("TF32 is on before leg (d)")
    x = torch.randn((1024, 1024), device="cuda")
    tf32_err = float((local_matmul(x, x, precision="default")
                      - local_matmul(x, x, precision="highest")).abs().max())
    if not tf32_err > 0:
        raise AssertionError("precision='default' is not TF32 on this card")
    # back to back with no synchronize, as a training loop dispatches: the
    # main thread is inside a TF32 scope almost all the time, and the serve
    # must still end within LEG_D_BOUND_S
    eng = make_engine()
    l0 = pa.paged_decode_attention.launches
    t0 = time.perf_counter()
    handles = submit_from_threads(eng, Request, specs)
    products = 0
    while not all(h.done() for h in handles):
        if time.perf_counter() - t0 > LEG_D_BOUND_S:
            eng.close()
            raise AssertionError(f"leg (d): the serve did not end within "
                                 f"{LEG_D_BOUND_S} s beside TF32 products")
        local_matmul(x, x, precision="default")
        products += 1
    wall_d = time.perf_counter() - t0
    torch.cuda.synchronize()
    got_d = engine_results(handles, "leg (d)")
    finish(eng, "(d) TF32 interference", l0)
    check_greedy(got_d, "leg (d)")
    if got_d != got_a or flags.allow_tf32:
        raise AssertionError(f"leg (d): tokens equal {got_d == got_a}, "
                             f"TF32 flag {flags.allow_tf32} after")
    log(f"  (d) {products} TF32 products back to back, no synchronize (max "
        f"|TF32 - f32| {tf32_err:.3e} at 1024^3), beside the serve: "
        f"{wall_d:.3f} s (leg (a) {wall_a:.3f} s, bound {LEG_D_BOUND_S} s); "
        f"tokens == leg (a); flag False after")
    engine_launches = ops.launch_counts()["paged_decode_attention"]
    engine_combines = pa.paged_decode_attention.combine_launches - combine0

    # (e) phase 8's workload through serve_bucket and the engine in turns:
    # equal streams, and each loop's ms per decode step (the engine's from
    # its step records with all 8 rows live, past the prefill iterations)
    sb_ms, eng_ms = [], []
    for _ in range(ENGINE_TIMING_ROUNDS):
        _, _, steps_sb, secs_sb = serve(params, prompts8, "pallas")
        sb_ms.append(secs_sb / steps_sb * 1e3)
        eng = make_engine()
        l0 = pa.paged_decode_attention.launches
        got_e = engine_results(
            [eng.submit(Request(prompt=p, steps=DECODE_STEPS))
             for p in prompts8], "phase 8's workload")
        finish(eng, "(e) phase 8's workload", l0)
        for i, toks in enumerate(got_e):
            if toks[PROMPT:] != streams8[i][:DECODE_STEPS]:
                raise AssertionError(f"phase 8's request {i}: engine != "
                                     f"serve_bucket")
        t_full = [r["t"] for r in eng.flight.records()
                  if r.get("ev") == "step" and r.get("rows") == ROWS]
        eng_ms.append((t_full[-1] - t_full[0]) / (len(t_full) - 1) * 1e3)
    syncs = {k: decode_syncs(torch, np, tt, params, k == "sampled")
             for k in ("greedy", "sampled")}
    log(f"  (e) synchronizing calls in one decode step (set_sync_debug_mode"
        f"), inside lm_decode_paged / with the read of the tokens: "
        + ", ".join(f"{k} {a} / {b}" for k, (a, b) in syncs.items()))
    (sb_q1, sb_med, sb_q3), (eng_q1, eng_med, eng_q3) = (
        np.percentile(v, (25, 50, 75)) for v in (sb_ms, eng_ms))
    gap, spread = eng_med - sb_med, max(sb_q3 - sb_q1, eng_q3 - eng_q1)
    verdict = ("resolved" if abs(gap) > spread else
               "unresolved: the gap is within the spread")
    log(f"phase 18 result: leg (a) {gen_tok} tokens in {wall_a:.3f} s = "
        f"{gen_tok / wall_a:.1f} tok/s, decode {snap_a['p50_step_s'] * 1e3:.3f}"
        f" ms per step (p50 of the engine's step records), TTFT p50 "
        f"{snap_a['p50_ttft_s'] * 1e3:.1f} ms p99 "
        f"{snap_a['p99_ttft_s'] * 1e3:.1f} ms; phase 8's 8 x {PROMPT} tokens:"
        f" serve_bucket {serve_bucket_ms:.3f} ms per step in phase 8; in "
        f"{ENGINE_TIMING_ROUNDS} alternating rounds, serve_bucket "
        f"{', '.join(f'{t:.3f}' for t in sb_ms)} (median {sb_med:.3f}, IQR "
        f"{sb_q1:.3f}-{sb_q3:.3f}) and ServeEngine "
        f"{', '.join(f'{t:.3f}' for t in eng_ms)} (median {eng_med:.3f}, IQR "
        f"{eng_q1:.3f}-{eng_q3:.3f}) ms per step ({len(t_full)} engine steps "
        f"with {ROWS} rows live; streams equal); engine - serve_bucket "
        f"{gap:+.3f} ms against a spread (larger IQR) of {spread:.3f}: "
        f"{verdict}; {smi}")
    del params
    torch.cuda.empty_cache()
    return engine_launches, engine_combines


def tall_chunks(np, rows: int, dtype=None):
    """Phase 21's operand: ``rows`` x TALL_COLS uniform [0, 1) f32 rows in
    chunks of TALL_CHUNK, chunk i drawn from default_rng([TALL_SEED, i])."""
    for i, start in enumerate(range(0, rows, TALL_CHUNK)):
        n = min(TALL_CHUNK, rows - start)
        yield np.random.default_rng([TALL_SEED, i]).random(
            (n, TALL_COLS), np.float32)


def rel_err(np, got, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def out_of_core_path(torch, np, mt, smi):
    """Phase 21: config 4's 10^7 x 512 Gramian streamed from the host through
    pinned buffers on a side stream, against an f64 accumulation of the same
    chunks; the sync and bf16 legs; streamed_matmul into a memmap; the
    pinned copy rate and the resident rank update's time."""
    import tempfile

    from marlin_tpu_torch import native
    from marlin_tpu_torch.ops.local import precision_scope
    from marlin_tpu_torch.parallel import prefetch
    from marlin_tpu_torch.parallel.streaming import (streamed_gramian,
                                                     streamed_matmul)
    from marlin_tpu_torch.utils.profiling import StageTimes

    rows, n = TALL_ROWS, TALL_COLS
    log(f"phase 21: streamed_gramian of {rows} x {n} f32 in chunks of "
        f"{TALL_CHUNK} rows ({rows * n * 4 / 1e9:.1f} GB, generated on the "
        f"producer thread), prefetch on; {smi}")
    t0 = time.perf_counter()
    ok = native.available() and native.chunkstore_available()
    log(f"  native libraries: {time.perf_counter() - t0:.1f} s into "
        f"{native.build_dir()}")
    if not ok:
        raise AssertionError(f"native build failed: {native.build_error()}")
    streamed_gramian(iter([np.zeros((1024, n), np.float32)]))  # warm-up
    prefetch.reset_staging_counts()
    stats = StageTimes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = streamed_gramian(tall_chunks(np, rows), chunk_rows=TALL_CHUNK,
                         precision="highest", prefetch=True, stats=stats)
    dt = time.perf_counter() - t0
    staged = prefetch.staging_counts()
    n_chunks = -(-rows // TALL_CHUNK)
    flop = 2.0 * rows * n * n
    log(f"  prefetch leg: {dt:.3f} s = {flop / dt / 1e9:.1f} GFLOP/s end to "
        f"end (host clock); stages: {stats.summary()}")
    if staged["pinned"] != n_chunks or staged["unpinned"]:
        raise AssertionError(f"staging {staged}: want {n_chunks} pinned "
                             "copies, none pageable")
    copy_gbs = staged["bytes"] / staged["copy_s"] / 1e9
    # the f64 reference: the same chunks, a plain loop, no prefetcher; the
    # first TALL_CHECK_ROWS rows also in bf16-rounded form
    g64 = torch.zeros((n, n), dtype=torch.float64, device="cuda")
    g64_check = g64b_check = None
    gb64 = torch.zeros_like(g64)
    t0 = time.perf_counter()
    for i, c in enumerate(tall_chunks(np, rows)):
        x = torch.from_numpy(c).to("cuda", torch.float64)
        g64.addmm_(x.T, x)
        if (i + 1) * TALL_CHUNK <= TALL_CHECK_ROWS:
            xb = torch.from_numpy(c).to(torch.bfloat16).to("cuda",
                                                            torch.float64)
            gb64.addmm_(xb.T, xb)
        if (i + 1) * TALL_CHUNK == TALL_CHECK_ROWS:
            g64_check = g64.to("cpu", copy=True).numpy()
            g64b_check = gb64.to("cpu", copy=True).numpy()
    g64 = g64.cpu().numpy()
    err = rel_err(np, g, g64)
    log(f"  vs an f64 accumulation of the same {n_chunks} chunks on the card "
        f"(plain loop, {time.perf_counter() - t0:.1f} s): max rel err "
        f"{err:.3e} (tol {F64_TOL})")
    if not (g.shape == (n, n) and np.isfinite(g).all() and err <= F64_TOL):
        raise AssertionError(f"streamed Gramian vs f64: {err}")
    # the sync control and the prefetch leg at TALL_CHECK_ROWS: equal bits
    legs = {}
    for name, kw in (("sync", dict(prefetch=False)),
                     ("prefetch", dict(prefetch=True)),
                     ("bf16", dict(prefetch=True,
                                   transfer_dtype="bfloat16"))):
        st = StageTimes()
        t0 = time.perf_counter()
        legs[name] = streamed_gramian(
            tall_chunks(np, TALL_CHECK_ROWS), chunk_rows=TALL_CHUNK,
            precision="highest", stats=st, **kw)
        dt_leg = time.perf_counter() - t0
        log(f"  {name} leg at {TALL_CHECK_ROWS} rows: {dt_leg:.3f} s = "
            f"{2.0 * TALL_CHECK_ROWS * n * n / dt_leg / 1e9:.1f} GFLOP/s; "
            f"stages: {st.summary()}")
    if not np.array_equal(legs["sync"], legs["prefetch"]):
        raise AssertionError("prefetch on and off differ at "
                             f"{TALL_CHECK_ROWS} rows")
    err22 = rel_err(np, legs["sync"], g64_check)
    errb = rel_err(np, legs["bf16"], g64b_check)
    errb32 = rel_err(np, legs["bf16"], g64_check)
    log(f"  sync == prefetch bit for bit; vs f64 {err22:.3e}; bf16 transfer "
        f"vs its rows' f64 Gramian {errb:.3e} (tol {F64_TOL}), vs the f32 "
        f"rows' {errb32:.3e} (tol {TALL_BF16_TOL:.3e})")
    if not (err22 <= F64_TOL and errb <= F64_TOL and errb32 <= TALL_BF16_TOL):
        raise AssertionError(f"check legs: {err22}, {errb}, {errb32}")
    # streamed_matmul into a preallocated writable memmap
    b = torch.from_numpy(np.random.default_rng(TALL_SEED + 1).standard_normal(
        (n, n)).astype(np.float32)).cuda()
    with tempfile.TemporaryDirectory() as d:
        out = np.memmap(os.path.join(d, "y.f32"), np.float32, "w+",
                        shape=(TALL_MATMUL_ROWS, n))
        st = StageTimes()
        t0 = time.perf_counter()
        got = streamed_matmul(tall_chunks(np, TALL_MATMUL_ROWS), b,
                              chunk_rows=TALL_CHUNK, out=out,
                              precision="highest", stats=st)
        dt_mm = time.perf_counter() - t0
        if got is not out:
            raise AssertionError("streamed_matmul did not fill the memmap")
        sample = np.random.default_rng(5).choice(TALL_MATMUL_ROWS,
                                                 LINALG_ROWS, replace=False)
        a_all = np.concatenate(list(tall_chunks(np, TALL_MATMUL_ROWS)))
        ref = a_all[sample].astype(np.float64) @ b.double().cpu().numpy()
        err_mm = rel_err(np, out[sample], ref)
        finite = bool(np.isfinite(out[::4096]).all())
        del a_all, out
    log(f"  streamed_matmul {TALL_MATMUL_ROWS} x {n} @ {n} x {n} into a "
        f"memmap: {dt_mm:.3f} s = "
        f"{2.0 * TALL_MATMUL_ROWS * n * n / dt_mm / 1e9:.1f} GFLOP/s; "
        f"stages: {st.summary()}; vs f64 on {LINALG_ROWS} sampled rows "
        f"{err_mm:.3e} (tol {F64_TOL})")
    if not (finite and err_mm <= F64_TOL):
        raise AssertionError(f"streamed_matmul vs f64: {err_mm}")
    # a plain 1 GiB pinned copy, and the rank update with its chunk resident
    host = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    plain_ms = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True), 5)
    del host, dev
    x = torch.from_numpy(next(tall_chunks(np, TALL_CHUNK))).cuda()
    acc = torch.zeros((n, n), device="cuda")
    with precision_scope("highest"):
        rank_ms = cuda_ms(torch, lambda: acc.addmm_(x.T, x), 10)
    bound_ms = 2.0 * TALL_CHUNK * n * n / F32_PEAK * 1e3
    del x, acc
    log(f"  pinned copies of the prefetch leg: {staged['bytes'] / 2 ** 30:.2f}"
        f" GiB in {staged['copy_s']:.3f} s on the side stream = "
        f"{copy_gbs:.2f} GB/s; a plain 1 GiB pinned copy {plain_ms:.3f} ms "
        f"= {(1 << 30) / plain_ms / 1e6:.2f} GB/s (CUDA events)")
    log(f"  the resident rank update ({TALL_CHUNK} x {n}, f32, TF32 off): "
        f"{rank_ms:.3f} ms = {2.0 * TALL_CHUNK * n * n / rank_ms / 1e9:.1f} "
        f"GFLOP/s against a {bound_ms:.3f} ms f32 bound (operations, "
        f"{F32_PEAK / 1e12:.0f} TFLOP/s)")
    log(f"phase 21 result: {rows} x {n} in {dt:.3f} s, "
        f"{flop / dt / 1e9:.1f} GFLOP/s end to end; {smi}")
    torch.cuda.empty_cache()


def disk_path(torch, np, mt, smi):
    """Phase 22: bench_all.py's config-4 file legs — one row-text file
    written by the port's native writer, streamed by the Python text parser
    and by its chunk-store sidecar (equal Gramians); a flipped sidecar byte;
    an idx3 file through mnist_images_out_of_core; a /metrics scrape."""
    import struct
    import tempfile
    import urllib.request

    from marlin_tpu_torch import obs
    from marlin_tpu_torch.io import (ChunkstoreCorruptError, transcode_idx,
                                     transcode_text)
    from marlin_tpu_torch.io.mnist import mnist_images_out_of_core
    from marlin_tpu_torch.io.text import load_matrix_file_out_of_core
    from marlin_tpu_torch.utils.profiling import StageTimes

    rows, n = FILE_ROWS, TALL_COLS
    gflop = 2.0 * rows * n * n / 1e9
    server = obs.MetricsServer(port=0)
    server.start()
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tall.txt")
            a = mt.DenseVecMatrix.from_array(np.random.default_rng(7).random(
                (rows, n)), dtype=torch.float64)
            t0 = time.perf_counter()
            a.save_to_file_system(path)
            log(f"phase 22: {rows} x {n} written by save_to_file_system "
                f"(native writer) in {time.perf_counter() - t0:.2f} s, "
                f"{os.path.getsize(path) / 1e6:.0f} MB of text")
            grams = {}
            for leg in ("text", "chunkstore"):
                if leg == "chunkstore":
                    t0 = time.perf_counter()
                    side = transcode_text(path, chunk_rows=FILE_CHUNK)
                    build_s = time.perf_counter() - t0
                    ooc = load_matrix_file_out_of_core(
                        path, chunk_rows=FILE_CHUNK)
                    if "chunkstore" not in repr(ooc):
                        raise AssertionError(f"sidecar not selected: {ooc!r}")
                    note = f"sidecar built in {build_s:.2f} s; "
                else:
                    ooc = load_matrix_file_out_of_core(
                        path, chunk_rows=FILE_CHUNK, chunkstore=False)
                    note = "Python parse every pass; "
                st = StageTimes()
                t0 = time.perf_counter()
                grams[leg] = ooc.gramian(stats=st, precision="highest")
                dt = time.perf_counter() - t0
                log(f"  {leg} leg: {dt:.3f} s = {gflop / dt:.2f} GFLOP/s from "
                    f"disk ({note}stages: {st.summary()})")
            ref = a.logical().T @ a.logical()
            err = rel_err(np, grams["text"], ref.cpu().numpy())
            if not np.array_equal(grams["text"], grams["chunkstore"]):
                raise AssertionError("text and chunk-store Gramians differ")
            log(f"  the two legs' Gramians equal bit for bit; vs f64 {err:.3e}"
                f" (tol {F64_TOL})")
            if not err <= F64_TOL:
                raise AssertionError(f"file Gramian vs f64: {err}")
            blob = bytearray(open(side, "rb").read())
            blob[len(blob) // 2] ^= 0x01
            open(side, "wb").write(bytes(blob))
            try:
                load_matrix_file_out_of_core(
                    path, chunk_rows=FILE_CHUNK).gramian()
            except ChunkstoreCorruptError as e:
                log(f"  a flipped sidecar byte raises: {str(e)[:90]}")
            else:
                raise AssertionError("a corrupt sidecar read back quietly")
            # an idx3 file of MNIST's test-set shape
            idx = os.path.join(d, "t10k-images-idx3-ubyte")
            raw = np.random.default_rng(8).integers(
                0, 256, (IDX_N, IDX_SIDE * IDX_SIDE), dtype=np.uint8)
            with open(idx, "wb") as f:
                f.write(struct.pack(">IIII", 2051, IDX_N, IDX_SIDE, IDX_SIDE))
                f.write(raw.tobytes())
            g_idx = mnist_images_out_of_core(
                idx, chunk_rows=4096, chunkstore=False).gramian(
                    precision="highest")
            transcode_idx(idx, chunk_rows=4096)
            ooc = mnist_images_out_of_core(idx, chunk_rows=4096)
            g_side = ooc.gramian(precision="highest")
            x = (raw / 255.0).astype(np.float32).astype(np.float64)
            err_idx = rel_err(np, g_idx, x.T @ x)
            if "chunkstore" not in repr(ooc) or \
                    not np.array_equal(g_idx, g_side) or err_idx > F64_TOL:
                raise AssertionError(f"idx legs: {ooc!r}, {err_idx}")
            log(f"  idx3 {IDX_N} x {IDX_SIDE}^2 through "
                f"mnist_images_out_of_core: idx and sidecar Gramians equal, "
                f"vs f64 {err_idx:.3e}")
        scrape = urllib.request.urlopen(server.url, timeout=60).read().decode()
    finally:
        server.close()
    missing = [f for f in PREFETCH_FAMILIES if f"# TYPE {f} " not in scrape]
    chunks = [line for line in scrape.splitlines()
              if line.startswith("marlin_prefetch_chunks_total ")]
    if missing or not chunks or float(chunks[0].split()[1]) <= 0:
        raise AssertionError(f"/metrics: missing {missing}, {chunks}")
    log(f"  /metrics carries {len(PREFETCH_FAMILIES)} prefetch and "
        f"data-plane families ({chunks[0]})")
    log(f"phase 22 result: every check passed; {smi}")


def nbytes_of(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def checkpoint_path(torch, np, mt, tt, lct_run, smi):
    """Phase 23: save_sharded/load_sharded of an N² DenseVecMatrix with its
    CRCs; config_lct's trainer stopped by a fault after step 2, resumed from
    generation 2 through ResilientLoop (== phase 11's uninterrupted run, bit
    for bit), and again past a corrupt generation 3; NeuralNetwork.train at
    config_nn resumed alike; heartbeat over the card."""
    import tempfile
    import zlib

    from marlin_tpu_torch.io import checkpoint as ck
    from marlin_tpu_torch.ml import NeuralNetwork
    from marlin_tpu_torch.utils import ResilientLoop, faults, heartbeat
    from marlin_tpu_torch.utils.tracing import EventLog

    log(f"phase 23: checkpoints and resume; {smi}")
    with tempfile.TemporaryDirectory() as d:
        m = mt.DenseVecMatrix.random(3, N, N)
        path = os.path.join(d, "sharded")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integ = ck.save_sharded(m, path)
        save_s = time.perf_counter() - t0
        for rel, rec in integ.items():
            crc = 0
            with open(os.path.join(path, rel), "rb") as f:
                while chunk := f.read(1 << 24):
                    crc = zlib.crc32(chunk, crc)
            if (crc & 0xFFFFFFFF) != rec["crc32"]:
                raise AssertionError(f"{rel}: CRC {crc} != {rec['crc32']}")
        t0 = time.perf_counter()
        back = ck.load_sharded(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = nbytes_of(path)
        if not (back.device.type == "cuda" and torch.equal(back, m.logical())):
            raise AssertionError("load_sharded differs from what was saved")
        log(f"  save_sharded {N}^2 f32: {size / 1e9:.3f} GB in {save_s:.3f} s;"
            f" load_sharded {load_s:.3f} s; CRCs verified, bit-identical")
        del m, back
        torch.cuda.empty_cache()

        # config_lct: stopped after step 2, resumed through ResilientLoop
        stream, params0, want_params, want_losses = lct_run
        lct = tt.TransformerLM(**LCT)
        cdir = os.path.join(d, "lct")
        with faults.injected("ckpt.write", faults.RaiseFault(
                match="ckpt_00000003")):
            try:
                lct.train(stream, steps=TRAIN_STEPS, params=params0,
                          checkpoint_dir=cdir, checkpoint_every=1)
            except faults.FaultInjected:
                pass
            else:
                raise AssertionError("the injected fault did not stop it")
        if ck.list_generations(cdir) != [1, 2]:
            raise AssertionError(f"generations {ck.list_generations(cdir)}")
        tokens = tt._ints(stream, "cuda")  # as TransformerLM.train has it

        def step_fn(state, i):
            p, o, loss = tt.lm_train_step(
                state["params"], state["opt_state"], tokens, None,
                LCT["heads"], lct.attn, lct.remat, lct.precision,
                lct.learning_rate)
            return {"params": p, "opt_state": o}, loss

        template = {"params": params0, "opt_state": tt.adam_init(params0)}
        for leg in ("resume from generation 2", "generation 3 corrupt"):
            events = EventLog(os.path.join(d, f"events{len(leg)}.jsonl"))
            t0 = time.perf_counter()
            state, losses = ResilientLoop(
                step_fn, cdir, checkpoint_every=1, event_log=events).run(
                    template, TRAIN_STEPS)
            dt = time.perf_counter() - t0
            seq = [(e["kind"], e["step"]) for e in events.read()
                   if e["kind"].startswith("resume")]
            fp, fw = flat(state["params"]), flat(want_params)
            same = all(torch.equal(fp[k], fw[k]) for k in fw)
            log(f"  {leg}: events {seq}, step 3's loss {losses} (phase 11: "
                f"{want_losses[2]}), params bit-identical: {same}; "
                f"{dt:.3f} s")
            if not (same and losses == want_losses[2:]):
                raise AssertionError(f"{leg}: resumed run != uninterrupted")
            want_seq = ([("resume", 2)] if leg.startswith("resume") else
                        [("resume_skip", 3), ("resume", 2)])
            if seq != want_seq:
                raise AssertionError(f"{leg}: events {seq} != {want_seq}")
            if leg.startswith("resume"):  # one flipped byte in generation 3
                gen3 = os.path.join(cdir, "ckpt_00000003", "state.npz")
                with open(gen3, "r+b") as f:
                    f.seek(-20, os.SEEK_END)
                    b = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([b[0] ^ 0xFF]))
        gsize = nbytes_of(os.path.join(cdir, "ckpt_00000002"))
        t0 = time.perf_counter()
        ck.save_checkpoint(template, os.path.join(d, "timing"), 1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.load_checkpoint(template, os.path.join(d, "timing"))
        torch.cuda.synchronize()
        log(f"  config_lct state ({gsize / 1e6:.2f} MB a generation): "
            f"save_checkpoint {save_s:.3f} s, load_checkpoint (CRCs checked) "
            f"{time.perf_counter() - t0:.3f} s")

        # config_nn through NeuralNetwork.train with checkpoint_dir
        data = mt.DenseVecMatrix.random(0, NN["m"], NN["d"])
        labels = np.arange(NN["m"]) % NN["classes"]
        nn = NeuralNetwork(input_dim=NN["d"], hidden_dim=NN["hidden"],
                           output_dim=NN["classes"])
        kw = dict(batch_size=NN["batch"])
        want_p, want_l = nn.train(data, labels, iterations=3, **kw)
        ndir = os.path.join(d, "nn")
        nn.train(data, labels, iterations=2, checkpoint_dir=ndir,
                 checkpoint_every=1, **kw)
        t0 = time.perf_counter()
        got_p, got_l = nn.train(data, labels, iterations=3,
                                checkpoint_dir=ndir, checkpoint_every=1,
                                resume=True, **kw)
        dt = time.perf_counter() - t0
        same = all(torch.equal(got_p[k], want_p[k]) for k in want_p)
        log(f"  NeuralNetwork.train at config_nn resumed from generation 2: "
            f"loss {got_l} (uninterrupted {want_l[2:]}), params "
            f"bit-identical: {same}; {dt:.3f} s with its save; a generation "
            f"{nbytes_of(os.path.join(ndir, 'ckpt_00000003')) / 1e6:.2f} MB")
        if not (same and got_l == want_l[2:]):
            raise AssertionError("config_nn resumed run != uninterrupted")
        del data
    beats = heartbeat(timeout_s=60.0)
    log(f"  heartbeat: {beats}")
    if list(beats) != [f"cuda:{i}" for i in range(torch.cuda.device_count())]:
        raise AssertionError(f"heartbeat {beats}")
    log(f"phase 23 result: every check passed; {smi}")
    torch.cuda.empty_cache()


def cli_path(torch, np, mt, ops, pa, smi) -> dict:
    """Phase 24: the port's example CLIs (``marlin_tpu_torch/examples/``)
    in-process on the card, each with every kernel's launch count set to 0
    just before it and read just after, and the ops console against a live
    engine. Returns the launches of the kernels on these paths."""
    import contextlib
    import io
    import tempfile
    import urllib.request

    from marlin_tpu_torch import obs
    from marlin_tpu_torch.examples import neural_network as nn_cli
    from marlin_tpu_torch.models import TransformerLM
    from marlin_tpu_torch.obs import console, perf
    from marlin_tpu_torch.parallel import autotune
    from marlin_tpu_torch.serving import Request, ServeEngine

    log("phase 24: the example CLIs (marlin_tpu_torch.examples) in-process")
    dev = mt.config.resolve_device()
    launched = {}

    def run(name, *args):
        """Run one CLI's main with the counts at 0; log its stdout and its
        launches; returns (value, stdout lines, launches)."""
        import importlib

        main = importlib.import_module(
            f"marlin_tpu_torch.examples.{name}").main
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                value = main(list(args))
        finally:
            lines = buf.getvalue().splitlines()
            for ln in lines:
                log(f"    | {ln}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        log(f"  {name} {' '.join(args)}: {time.perf_counter() - t0:.2f} s, "
            f"launches {counts or 'none'}")
        return value, lines, counts

    def expect(counts, *kernels):
        for k in kernels:
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"phase 24: {k} never launched")
            launched[k] = launched.get(k, 0) + counts[k]

    def rows_close(label, got_rows, ref_rows, tol=F64_TOL):
        scale = float(ref_rows.abs().max())
        err = float((got_rows.double() - ref_rows).abs().max()) / scale
        log(f"  {label}: max rel err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{label}: rel err {err} > {tol}")

    perf.get_program_costs().reset()
    # --------------------------------------- the north-star multiply
    c, lines, counts = run("matrix_multiply", *CLI_MM)
    gflops = float(lines[1].split()[1])
    a = mt.DenseVecMatrix.random(0, N, N)
    b = mt.DenseVecMatrix.random(1, N, N)
    if c.shape != (N, N) or not bool(torch.isfinite(c.data).all()):
        raise AssertionError("matrix_multiply: bad shape or non-finite C")
    rows = torch.tensor([0, 1, N // 2 - 1, N - 1], device=dev)
    rows_close("matrix_multiply C vs f64 on 4 rows", c.data[rows],
               a.data[rows].double() @ b.data.double())
    lib_ms = cuda_ms(torch, lambda: torch.matmul(a.data, b.data), 2)
    log(f"  matrix_multiply {N}^3: {gflops:.1f} GFLOP/s (host clock, one "
        f"call to evaluate); torch.matmul {2.0 * N ** 3 / lib_ms / 1e6:.1f} "
        f"GFLOP/s ({lib_ms:.3f} ms, CUDA events); {smi}")
    key = f"shape={N}x{N}x{N} dtype=float32"
    hooked = [r["program"] for r in perf.get_program_costs().rows()
              if r["key"].startswith(key)]
    # the auto dispatch: broadcast under the threshold, else CARMA RMM
    small = N * N * 4 / 1e6 <= mt.get_config().broadcast_threshold_mb
    if hooked != ["broadcast_matmul" if small else "rmm_matmul"]:
        raise AssertionError(f"matrix_multiply: cost rows {hooked}")
    del a, b, c
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        # ------------------------------- genmat's files: --files and LU
        exe = os.path.join(d, "genmat")
        build = subprocess.run(
            ["g++", "-O2", "-std=c++17", "-Wall", "-o", exe,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "genmat.cpp")],
            capture_output=True, text=True, timeout=120)
        if build.returncode != 0:
            raise AssertionError(f"genmat build failed: {build.stderr}")
        paths = {}
        for label, n, seed in (("a", CLI_GENMAT_N, 1), ("b", CLI_GENMAT_N, 2),
                               ("lu", CLI_LU_N, 3)):
            paths[label] = os.path.join(d, f"{label}.txt")
            with open(paths[label], "w") as f:
                subprocess.run([exe, str(n), str(n), str(seed)], stdout=f,
                               check=True, timeout=120)
        c, _, _ = run("matrix_multiply", "--files", paths["a"], paths["b"])
        fa_, fb_ = (mt.load_matrix_file(paths[k]).data for k in "ab")
        rows_close("matrix_multiply --files vs f64", c.data,
                   fa_.double() @ fb_.double())
        del c, fa_, fb_
        out = os.path.join(d, "lu")
        run("lu_decompose", paths["lu"], str(CLI_LU_N), str(CLI_LU_N), out)
        a = mt.load_matrix_file(paths["lu"]).data.double()
        lo, up = (mt.load_matrix_file(f"{out}.{k}").data.double()
                  for k in "LU")
        with open(f"{out}.perm") as f:
            perm = torch.tensor([int(x) for x in f.read().split(",")],
                                device=dev)
        if sorted(perm.tolist()) != list(range(CLI_LU_N)):
            raise AssertionError("lu_decompose: .perm is no permutation")
        bwd = float(((a[perm] - lo @ up).abs()
                     / (lo.abs() @ up.abs()).clamp_min(1e-300)).max())
        log(f"  lu_decompose {CLI_LU_N}^2 genmat file: componentwise "
            f"backward error {bwd:.3e} (tol {LU_BWD_TOL})")
        if not bwd <= LU_BWD_TOL:
            raise AssertionError(f"lu_decompose: backward error {bwd}")
        del a, lo, up

        # --------------------------------------------- blas1, blas3
        n1 = CLI_BLAS1_N
        x = mt.DistributedVector.random(0, n1, column_major=False).data
        y = mt.DistributedVector.random(1, n1).data
        want = float(x.double() @ y.double())
        for mode in ("local", "dist"):
            got, _, _ = run("blas1", mode, str(n1), "1")
            err = abs(got - want) / abs(want)
            if not err <= F64_TOL:
                raise AssertionError(f"blas1 {mode}: rel err {err}")
        log(f"  blas1 vs f64: {want:.3f}")
        del x, y
        n3 = str(CLI_BLAS3_N)
        for mode in "123":
            _, lines, _ = run("blas3", n3, n3, n3, mode)
            if not lines or "used" not in lines[0]:
                raise AssertionError(f"blas3 {mode}: {lines}")
        try:
            run("blas3", n3, n3, n3, "3", "2", "2", "2")
        except ValueError as e:
            if "needs 8 devices, have 1" not in str(e):
                raise
            log(f"  blas3 split 2 2 2 refused at world size 1: {e}")
        else:
            raise AssertionError("blas3: split 2 2 2 ran on one device")

        # ------------------------------------- rmm_compare, the hooks
        perf.get_program_costs().reset()
        nr = str(CLI_RMM_N)
        timings, _, _ = run("rmm_compare", nr, nr, nr, "all")
        if set(timings) != {"rmm", "gspmd", "broadcast"}:
            raise AssertionError(f"rmm_compare all: {timings}")
        autotune.clear_cache()
        table, _, _ = run("rmm_compare", nr, nr, nr, "tuned")
        cost_rows = perf.get_program_costs().rows()
        mult = {r["key"].split()[0].split("=")[1]: r for r in cost_rows
                if r["program"] == "multiply"}
        if set(mult) != set(table) or any(
                r["flops"] != 2.0 * CLI_RMM_N ** 3 or r["calls"] < 1
                for r in mult.values()):
            raise AssertionError(f"tune_multiply rows: {sorted(mult)} for "
                                 f"{sorted(table)}")
        progs = sorted({r["program"] for r in cost_rows
                        if r["program"].endswith("_matmul")})
        if progs != ["broadcast_matmul", "gspmd_matmul", "rmm_matmul"]:
            raise AssertionError(f"matmul cost rows: {progs}")
        for r in sorted(mult.values(), key=lambda r: r["seconds_per_call"]):
            log(f"  ProgramCosts multiply {r['key']}: "
                f"{r['seconds_per_call'] * 1e3:.3f} ms a call, "
                f"{r['achieved_flops_per_s'] / 1e12:.2f} TFLOP/s, roofline "
                f"fraction {r['roofline_frac']}")
        log(f"  matmul cost rows: {progs}")

        # ------------------------------------------ sparse, modes 1-7
        for mode in "123456":
            _, lines, _ = run("sparse_multiply", *CLI_SPARSE, mode)
            if not lines or "millis" not in lines[0]:
                raise AssertionError(f"sparse_multiply {mode}: {lines}")
        autotune.clear_cache()
        _, lines, counts = run("sparse_multiply", *CLI_BSR)
        expect(counts, "bsr_spmm_pallas")
        n_b, p_b = int(CLI_BSR[0]), int(CLI_BSR[2])
        sa = mt.SparseVecMatrix.random(0, n_b, n_b, density=float(CLI_BSR[3]))
        db = mt.BlockMatrix.random(1, n_b, p_b)
        bsr = sa.to_bsr()
        if not abs(bsr.density - BSR_DENSITY) <= 0.01:
            raise AssertionError(f"mode 7: block density {bsr.density}")
        c = sa.multiply(db, format="bsr").logical()  # the tuned winner
        idx = sa.bcoo.coalesce().indices()
        vals = sa.bcoo.coalesce().values().double()
        pick = torch.tensor([0, 1, n_b // 2 + 1, n_b - 1] + idx[0, :4].tolist(),
                            device=dev)
        ref = torch.zeros((len(pick), p_b), dtype=torch.float64, device=dev)
        for i, r in enumerate(pick.tolist()):
            sel = idx[0] == r
            ref[i] = vals[sel] @ db.logical()[idx[1, sel]].double()
        rows_close(f"sparse_multiply 7 (nnzb {bsr.nnzb}, block density "
                   f"{bsr.density:.4f}) vs f64 on {len(pick)} rows",
                   c[pick], ref)
        del sa, db, bsr, c

        # ---------------------------------------------------------- ml
        _, lines, counts = run("logistic_regression", *CLI_LR)
        expect(counts, "lr_step")
        acc = float(lines[0].split()[-1])
        if not acc > 0.9:
            raise AssertionError(f"logistic_regression: accuracy {acc}")
        edges = os.path.join(d, "edges.txt")
        with open(edges, "w") as f:
            f.write("0 1\n1 2\n2 0\n2 1\n")
        for args in ((edges, "30"), ("random", "20", str(CLI_PR_NODES))):
            _, lines, _ = run("pagerank", *args)
            top = [float(ln.split()[-1]) for ln in lines
                   if ln.startswith("node")]
            if not top or not all(0 < r < 1 for r in top) or \
                    top != sorted(top, reverse=True):
                raise AssertionError(f"pagerank {args}: top ranks {top}")
        rng = np.random.default_rng(5)
        u = rng.random((CLI_ALS["users"], 4))
        v = rng.random((CLI_ALS["items"], 4))
        ui = rng.integers(0, CLI_ALS["users"], CLI_ALS["nnz"])
        ii = rng.integers(0, CLI_ALS["items"], CLI_ALS["nnz"])
        r_ = np.einsum("nk,nk->n", u[ui], v[ii])
        ratings = os.path.join(d, "ratings.txt")
        np.savetxt(ratings, np.stack([ui, ii, r_], 1), fmt="%d %d %.4f")
        _, lines, _ = run("als", ratings, str(CLI_ALS["rank"]),
                          str(CLI_ALS["iters"]), "0.01")
        rmse = float(lines[-1].split()[-1])
        if not 0 <= rmse < 0.5 * float(np.std(r_)):
            raise AssertionError(f"als: RMSE {rmse}, ratings std "
                                 f"{np.std(r_):.4f}")
        nn_cli.WEIGHTS = os.path.join(d, "nn_weights")
        _, lines, _ = run("neural_network", "synthetic", "-", "200", "100",
                          "0.5", "256")
        if not os.path.exists(nn_cli.WEIGHTS + ".w0.csv") or \
                not math.isfinite(float(lines[-2].split("final loss ")[1]
                                        .split(",")[0])):
            raise AssertionError(f"neural_network: {lines[-2:]}")
        _, lines, _ = run("distributed_training", "200", "64", "256",
                          os.path.join(d, "dist_train"))
        if lines[0] != ("mesh: 1 data-parallel x 1 tensor-parallel over 1 "
                        "devices") or "accuracy" not in lines[1]:
            raise AssertionError(f"distributed_training: {lines}")

    # ---------------------------------------- attention and the LM paths
    for strategy in ("ring", "ulysses"):
        _, lines, counts = run("attention", *CLI_ATTN, strategy)
        expect(counts, "flash_attention_panel")
        if f"{strategy}:" not in lines[0] or "GFLOP/s" not in lines[0]:
            raise AssertionError(f"attention {strategy}: {lines}")
    losses, lines, counts = run("long_context_training", *CLI_LCT)
    expect(counts, "flash_attention_panel", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"long_context_training: losses {losses}")
    # its 30 training steps on a 4096-token stream run the flash kernels too
    outs, lines, counts = run("decode_serving", *CLI_DECODE)
    expect(counts, "flash_attention_panel", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq")
    for i, row in enumerate(outs):
        if len(row) != PROMPT - i + DECODE_STEPS or not (
                (row >= 0) & (row < 512)).all():
            raise AssertionError(f"decode_serving: row {i} bad")
    log(f"  decode_serving: {len(outs)} ragged rows, greedy batched == "
        f"one-at-a-time")
    torch.cuda.empty_cache()

    # ------------------------------- the ops console against a live engine
    params = TransformerLM(**LM).init_params()
    rng = np.random.default_rng(24)
    ops.reset_launch_counts()
    combine0 = pa.paged_decode_attention.combine_launches
    with ServeEngine(params, LM["heads"], buckets=((PROMPT, 64),),
                     max_batch=ROWS, page_len=PAGE_LEN) as eng:
        hs = [eng.submit(Request(prompt=rng.integers(
            0, LM["vocab"], 64).astype(np.int32), steps=16))
            for _ in range(ROWS)]
        for h in hs:
            h.result(timeout=ENGINE_WAIT_S)
        with obs.MetricsServer(port=0) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = console.main(["--url", url, "--once"])
            frame = buf.getvalue()
            metrics = console.parse_metrics(urllib.request.urlopen(
                url + "/metrics", timeout=10).read().decode())
    counts = ops.launch_counts()
    combines = pa.paged_decode_attention.combine_launches - combine0
    for ln in frame.splitlines():
        log(f"    | {ln}")
    pages = console.metric_value(metrics, "marlin_serve_kv_pages_total")
    if rc != 0 or not pages > 0 or \
            f"/{int(pages)}" not in frame.split("process gauges:")[1] or \
            "memory: registered=" not in frame or "kvpool" not in frame:
        raise AssertionError(f"console: rc {rc}, pages {pages}, frame "
                             f"{frame!r}")
    expect(counts, "paged_decode_attention")
    launched["paged_combine"] = combines
    log(f"  console --once: rc 0, the engine's gauges (pages total "
        f"{int(pages)}) and the memory panel; paged launches "
        f"{counts['paged_decode_attention']} split + {combines} combine")
    log(f"phase 24 launches: {launched}")
    return launched


def _fleet_slo(mt):
    """The config context of phase 25's SLO legs: a p99 TTFT objective of
    FLEET_TTFT_S and FLEET_SLO_KNOBS."""
    return mt.config_context(serve_slo=(
        {"name": "ttft", "metric": "p99:marlin_serve_ttft_seconds",
         "target": FLEET_TTFT_S, "window_s": 30.0},), **FLEET_SLO_KNOBS)


def _wait_until(what, pred, timeout=FLEET_WAIT_S, poll=0.05):
    """Poll ``pred()`` until it returns a truthy value; raise after
    ``timeout`` seconds."""
    t0 = time.perf_counter()
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"phase 25: {what} not reached within "
                                 f"{timeout} s")
        time.sleep(poll)


def _fleet_burn(payload) -> float:
    """The worst fast-window burn of an SLO payload (0.0 without one)."""
    if not payload:
        return 0.0
    return max((o.get("burn_rate") or 0.0
                for o in payload.get("objectives", ())), default=0.0)


def fleet_path(torch, np, mt, tt, ops, pa, smi):
    """Phase 25: the serving fleet around the engine at full width (see the
    module docstring). Returns the paged kernel's split and combine
    launches over its five legs."""
    import json as _json
    import random
    import threading
    import urllib.request

    from marlin_tpu_torch import obs
    from marlin_tpu_torch.obs import memledger
    from marlin_tpu_torch.obs.metrics import get_registry
    from marlin_tpu_torch.serving import (FleetController,
                                          MigrationCorruptError,
                                          MigrationError, PagedKVPool,
                                          Request, Router, ServeEngine,
                                          Supervisor, kvpool)
    from marlin_tpu_torch.serving.request import SHED_REASON_PREFIX
    from marlin_tpu_torch.utils import faults

    log(f"phase 25: the serving fleet over TransformerLM{tuple(LM.values())}"
        f" f32, phase 18's engine settings per replica (buckets "
        f"{ENGINE_BUCKETS}, max_batch {ROWS}, page_len {PAGE_LEN}, "
        f"decode_kernel 'auto'); {smi}")
    params = tt.TransformerLM(**LM).init_params()
    specs = engine_specs(np)
    reg = get_registry()
    launches = {"split": 0, "combine": 0}

    def make_engine(**kw):
        eng = ServeEngine(params, LM["heads"], buckets=ENGINE_BUCKETS,
                          max_batch=ROWS, page_len=PAGE_LEN,
                          prefill_chunk=PREFILL_CHUNK, decode_kernel="auto",
                          **kw)
        if eng._decode_kernel != "pallas":
            raise AssertionError(f"decode_kernel 'auto' resolved to "
                                 f"{eng._decode_kernel!r} on the card")
        eng.warmup()
        return eng

    class Leg:
        """Set every kernel's launch count to 0 before a leg and read the
        counts after it: the paged kernel must have launched."""

        def __init__(self, label):
            self.label = label

        def __enter__(self):
            ops.reset_launch_counts()
            self.c0 = pa.paged_decode_attention.combine_launches
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, *exc):
            if exc_type is not None:
                return False
            counts = ops.launch_counts()
            split = counts["paged_decode_attention"]
            comb = pa.paged_decode_attention.combine_launches - self.c0
            if split <= 0:
                raise AssertionError(f"phase 25 {self.label}: the paged "
                                     f"kernel never launched")
            others = {k: v for k, v in counts.items()
                      if v and k != "paged_decode_attention"}
            launches["split"] += split
            launches["combine"] += comb
            log(f"  {self.label}: {time.perf_counter() - self.t0:.2f} s, "
                f"paged kernel split {split} / combine {comb} launches"
                + (f", others {others}" if others else ""))
            return False

    def adopted_total():
        fam = reg._families.get("marlin_serve_migrations_total")
        return fam.labels(leg="adopt").value if fam is not None else 0.0

    def check_tokens(got, want, label):
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad or len(got) != len(want):
            raise AssertionError(f"phase 25 {label}: requests {bad} differ "
                                 f"from the reference")

    def audit_clean(eng, label):
        audit = eng.kvpool_audit()
        if not audit["ok"]:
            raise AssertionError(f"phase 25 {label}: pool audit "
                                 f"{audit['errors']}")

    def step_ms(engines):
        return ", ".join(
            f"{e._name} {e.metrics.snapshot()['p50_step_s'] * 1e3:.3f}"
            for e in engines if e.metrics.snapshot()["steps"])

    greedy = [i for i, s in enumerate(specs) if "temperature" not in s]
    sampled = [i for i in range(len(specs)) if i not in greedy]
    refs = {i: tt.lm_generate(params, specs[i]["prompt"], 0,
                              heads=LM["heads"],
                              max_len=len(specs[i]["prompt"])
                              + specs[i]["steps"],
                              steps=specs[i]["steps"]).tolist()
            for i in greedy}
    with Leg("sampled requests served alone"):
        solo = make_engine()
        try:
            for i in sampled:
                refs[i] = engine_results([solo.submit(Request(**specs[i]))],
                                         "solo")[0]
        finally:
            solo.close()
    want = [refs[i] for i in range(len(specs))]

    # (a) rolling restart under load
    def factory():
        return make_engine()

    engines = []
    adopt0 = adopted_total()
    with Leg("(a) rolling restart under load"):
        router = Router(factory, replicas=FLEET_REPLICAS,
                        supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                        rng=random.Random(7))
        try:
            engines += [r.engine for r in router._replicas]
            handles = submit_from_threads(router, Request, specs)
            # both replicas decode before the rotation takes them, and the
            # rotation starts while their rows are mid-stream
            _wait_until("a decode step on every replica", lambda: all(
                e.metrics.snapshot()["steps"] for e in engines), poll=0.001)
            t0 = time.perf_counter()
            rotated = router.rolling_restart()
            t_rot = time.perf_counter() - t0
            got_a = engine_results(handles, "leg (a)")
            rebuilt = [r.engine for r in router._replicas]
            engines += rebuilt
            # a second wave reaches the rebuilt replicas
            got_a2 = engine_results(
                submit_from_threads(router, Request, specs), "leg (a) 2")
            router.drain()
            snap = router.snapshot()
            for eng in rebuilt:
                audit_clean(eng, "leg (a)")
        finally:
            router.close()
    check_tokens(got_a, want, "leg (a)")
    check_tokens(got_a2, want, "leg (a) second wave")
    adopted = adopted_total() - adopt0
    if sorted(rotated) != list(range(FLEET_REPLICAS)) or adopted <= 0:
        raise AssertionError(f"phase 25 leg (a): rotated {rotated}, "
                             f"adopted {adopted}")
    idle = [e._name for e in engines if e.metrics.snapshot()["steps"] <= 0]
    steps = sum(e.metrics.snapshot()["steps"] for e in engines)
    if idle:
        raise AssertionError(f"phase 25 leg (a): no decode step on {idle}")
    log(f"  (a) {2 * len(specs)} requests one OK Result each ({len(greedy)}"
        f" greedy == lm_generate, {len(sampled)} sampled == served alone, "
        f"twice); rotation {t_rot:.3f} s, migrations_total{{leg=adopt}} "
        f"+{adopted:.0f}, retries {snap['retries']}, prefix hits "
        f"{snap['prefix_hits']}; decode steps {steps} on "
        f"{len(engines)} replicas (old and rebuilt); ms per decode step "
        f"(p50 of each replica's step records): {step_ms(engines)}; {smi}")

    # (b) the blob: freeze a loaded engine, adopt on a fresh one
    with Leg("(b) freeze / adopt / corruption / cache warm"):
        small = [i for i, s in enumerate(specs)
                 if len(s["prompt"]) <= ENGINE_BUCKETS[0][0]
                 and s["steps"] <= ENGINE_BUCKETS[0][1]][:ROWS]
        large = [i for i in range(len(specs)) if i not in small][:ROWS]
        picked = small + large
        src, dst, bad_dst = make_engine(start=False), make_engine(), \
            make_engine()
        try:
            hs = [src.submit(Request(**specs[i])) for i in picked]
            gate, release = threading.Event(), threading.Event()

            class Hold(faults.Fault):
                def on_fire(self, point, ctx):
                    gate.set()
                    release.wait(FLEET_WAIT_S)

            # a decode step some 12 iterations in: the long prompts have
            # prefilled, rows are mid-stream (or mid-prefill)
            faults.inject("serve.decode_step",
                          Hold(times=1, schedule=faults.Schedule(
                              fire_on=[FLEET_HOLD_STEP])))
            try:
                src.start()
                if not gate.wait(FLEET_WAIT_S):
                    raise AssertionError("phase 25 leg (b): never held")
            finally:
                release.set()
                faults.clear("serve.decode_step")
            t0 = time.perf_counter()
            frozen = src.freeze_rows()
            t_freeze = time.perf_counter() - t0
            blob = frozen["blob"]
            done = sum(h.done() for h in hs)
            if blob is None or len(frozen["entries"]) + done != len(picked) \
                    or frozen["fallback"] or frozen["queued"]:
                raise AssertionError(
                    f"phase 25 leg (b): froze {len(frozen['entries'])} of "
                    f"{len(picked)} rows ({done} done), fallback "
                    f"{len(frozen['fallback'])}, queued "
                    f"{len(frozen['queued'])}")
            meta_len = kvpool._MIG_HDR.unpack_from(blob, 0)[3]
            rows = _json.loads(blob[kvpool._MIG_HDR.size:
                                    kvpool._MIG_HDR.size + meta_len])["rows"]
            mid = sum(r["pf_next"] < 0 and r["steps_done"] > 1 for r in rows)
            if not mid:
                raise AssertionError("phase 25 leg (b): no row froze "
                                     "mid-decode")
            n_pages = sum(len(r["pages"]) for r in rows)
            # the export alone, again, on the frozen pool: gather on the
            # card, one copy to the host, the framing
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = src._kvpool.export_rows(rows)
            t_export = time.perf_counter() - t0
            if again != blob:
                raise AssertionError("phase 25 leg (b): a second export of "
                                     "the frozen rows differs")
            page_bytes = len(blob) - kvpool._MIG_HDR.size * (len(rows) + 1) \
                - meta_len
            # import then re-export through a standalone pool on the card:
            # the same page bodies, byte for byte
            pool = PagedKVPool(params, LM["heads"],
                               kvpool.auto_num_pages(ENGINE_BUCKETS, ROWS,
                                                     PAGE_LEN), PAGE_LEN)
            back = pool.export_rows(pool.import_rows(blob))
            bodies = [b for k, b in kvpool._mig_chunks(back)
                      if k == kvpool._MIG_ROW]
            if bodies != [b for k, b in kvpool._mig_chunks(blob)
                          if k == kvpool._MIG_ROW]:
                raise AssertionError("phase 25 leg (b): re-exported page "
                                     "bodies differ from the frozen ones")
            del pool
            # corruption: a flipped byte and a truncation each refused, the
            # target's pool untouched
            flipped = bytearray(blob)
            flipped[len(blob) // 2] ^= 0xFF
            for label, bad in (("flipped byte", bytes(flipped)),
                               ("truncation", blob[:-7])):
                try:
                    bad_dst.adopt_rows({"blob": bad,
                                        "entries": frozen["entries"]})
                except MigrationError as exc:
                    if not isinstance(exc.__cause__, MigrationCorruptError):
                        raise AssertionError(
                            f"phase 25 leg (b): {label} raised {exc!r}")
                else:
                    raise AssertionError(f"phase 25 leg (b): {label} "
                                         f"adopted")
            audit_clean(bad_dst, "leg (b) corrupt target")
            if bad_dst._kvpool.used_count() != 0:
                raise AssertionError("phase 25 leg (b): a refused blob "
                                     "left pages behind")
            t0 = time.perf_counter()
            res = dst.adopt_rows(frozen)
            t_adopt = time.perf_counter() - t0
            if res["fallback"] or \
                    len(res["adopted"]) != len(frozen["entries"]):
                raise AssertionError(f"phase 25 leg (b): adopted "
                                     f"{len(res['adopted'])} of "
                                     f"{len(frozen['entries'])}")
            for rid in res["adopted"]:
                src._queue.release(frozen["entries"][rid].cost)
            got_b = engine_results(hs, "leg (b)")
            check_tokens(got_b, [want[i] for i in picked], "leg (b)")
            if dst.metrics.snapshot()["retries"]:
                raise AssertionError("phase 25 leg (b): a row restarted")
            # prefix warm: a shared system prompt's chains move to a fresh
            # replica, whose first shared-prompt request hits
            rng = np.random.default_rng(25)
            system = rng.integers(0, LM["vocab"], SYSTEM_PROMPT).astype(
                np.int32)
            shared = [np.concatenate([system, rng.integers(
                0, LM["vocab"], 8)]).astype(np.int32) for _ in range(2)]
            engine_results([dst.submit(Request(prompt=shared[0], steps=8))],
                           "leg (b) warm source")
            pblob = dst.export_prefixes(32)
            warmed = bad_dst.import_prefixes(pblob)
            got_w = engine_results([bad_dst.submit(
                Request(prompt=shared[1], steps=8))], "leg (b) warmed")[0]
            hits = bad_dst.metrics.snapshot()["prefix_hits"]
            ref_w = tt.lm_generate(params, shared[1], 0, heads=LM["heads"],
                                   max_len=len(shared[1]) + 8,
                                   steps=8).tolist()
            if not warmed or hits <= 0 or got_w != ref_w:
                raise AssertionError(f"phase 25 leg (b): warmed {warmed}, "
                                     f"hits {hits}, tokens == lm_generate "
                                     f"{got_w == ref_w}")
            dst.drain()
            audit_clean(dst, "leg (b) target")
        finally:
            for eng in (src, dst, bad_dst):
                eng.close()
    log(f"  (b) {len(rows)} rows ({mid} mid-decode, {done} finished before "
        f"the freeze), {n_pages} pages, blob {len(blob)} bytes "
        f"({page_bytes} of page bodies); freeze_rows {t_freeze * 1e3:.2f} ms"
        f" (park + export), export alone {t_export * 1e3:.2f} ms = "
        f"{page_bytes / t_export / 1e9:.2f} GB/s device to host, adopt_rows "
        f"{t_adopt * 1e3:.2f} ms; decode resumed == the uninterrupted "
        f"streams; re-exported page bodies equal; flipped byte and "
        f"truncation refused (MigrationCorruptError), target audit clean; "
        f"{warmed} prefix chains warmed a fresh replica: {hits} hit on its "
        f"first shared-prompt request; {smi}")

    # (c) the supervisor: seeded worker crashes, then the breaker
    short = [dict(s, steps=min(s["steps"], CHAOS_STEPS)) for s in specs]
    want_c = [w[:len(s["prompt"]) + s["steps"]] for w, s in zip(want, short)]
    with Leg("(c) supervisor"):
        eng = make_engine()
        try:
            sup = Supervisor(eng, backoff_s=0.005, poll_s=0.02,
                             restart_max=100000, restart_window_s=1e6)
            try:
                with faults.injected("serve.worker_crash", faults.RaiseFault(
                        times=-1, schedule=faults.Schedule(seed=9,
                                                           rate=0.03))):
                    got_c = engine_results(
                        submit_from_threads(eng, Request, short,
                                            max_attempts=CHAOS_ATTEMPTS),
                        "leg (c)")
                restarts = sup.restart_count
            finally:
                sup.close()
            check_tokens(got_c, want_c, "leg (c)")
            if restarts <= 0 or sup.breaker_open:
                raise AssertionError(f"phase 25 leg (c): restarts "
                                     f"{restarts}, breaker {sup.breaker_open}")
        finally:
            eng.close()
        eng = make_engine()
        sup = Supervisor(eng, poll_s=0.02)   # the default restart budget
        try:
            with faults.injected("serve.worker_crash",
                                 faults.RaiseFault(times=-1)):
                statuses = [h.result(timeout=FLEET_WAIT_S).status for h in
                            submit_from_threads(eng, Request, short,
                                                max_attempts=10)]
            t0 = time.perf_counter()
            eng.close()
            t_close = time.perf_counter() - t0
        finally:
            sup.close()
            eng.close()
        if not sup.breaker_open or eng._state != "closed" or \
                not set(statuses) <= {"error", "shutting_down"} or \
                t_close > 5.0 or eng._thread.is_alive():
            raise AssertionError(
                f"phase 25 leg (c): breaker {sup.breaker_open}, state "
                f"{eng._state}, statuses {set(statuses)}, close {t_close} s")
    log(f"  (c) serve.worker_crash at rate 0.03 (seed 9), max_attempts "
        f"{CHAOS_ATTEMPTS}: {restarts} supervised restarts, {len(short)} "
        f"requests one OK Result each == leg (a)'s first {CHAOS_STEPS} "
        f"tokens; under a crash every iteration the default budget "
        f"({sup.restart_max} in {sup.restart_window_s:.0f} s) opened the "
        f"breaker, {len(statuses)} requests ended {sorted(set(statuses))}, "
        f"close() took {t_close * 1e3:.1f} ms")

    # (d) SLO and shedding
    server = obs.MetricsServer(port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    burst = specs + specs
    with Leg("(d) SLO breach, shedding, recovery"):
        try:
            with _fleet_slo(mt):
                eng = make_engine()
            try:
                for i in range(3):
                    engine_results([eng.submit(Request(**short[i]))],
                                   "leg (d) healthy")
                time.sleep(FLEET_SLO_KNOBS["serve_slo_eval_interval_s"])
                p = eng._slo_payload()
                if p["objectives"][0]["breached"]:
                    raise AssertionError("phase 25 leg (d): breached while "
                                         "healthy")
                t0 = time.perf_counter()
                got_d = engine_results(
                    submit_from_threads(eng, Request, burst), "leg (d)")
                t_burst = time.perf_counter() - t0
                check_tokens(got_d, want + want, "leg (d) burst")
                p = _wait_until("the breach", lambda: (
                    lambda q: q if q["objectives"][0]["breached"]
                    and q["shed_level"] else None)(eng._slo_payload()))
                burn = p["objectives"][0]["burn_rate"]
                ttft_p99 = p["objectives"][0]["value"]
                scrape = urllib.request.urlopen(base + "/metrics",
                                                timeout=60).read().decode()
                debug = _json.loads(urllib.request.urlopen(
                    base + "/debug/slo", timeout=60).read())
                mine = [s for s in debug["scopes"] if s["scope"] == eng._name]
                if not mine or not mine[0]["objectives"][0]["breached"]:
                    raise AssertionError("phase 25 leg (d): /debug/slo does "
                                         "not show the breach")
                missing = [f for f in SLO_FAMILIES
                           if f"# TYPE {f} " not in scrape]
                if missing:
                    raise AssertionError(f"phase 25 leg (d): /metrics lacks "
                                         f"{missing}")
                low = eng.submit(Request(**short[0])).result(FLEET_WAIT_S)
                high = eng.submit(Request(**short[1], priority=1)).result(
                    FLEET_WAIT_S)
                if low.status != "rejected" or \
                        not low.reason.startswith(SHED_REASON_PREFIX) or \
                        high.status != "ok" or \
                        high.tokens.tolist() != want_c[1]:
                    raise AssertionError(
                        f"phase 25 leg (d): low {low.status} {low.reason!r},"
                        f" high {high.status}")
                t0 = time.perf_counter()
                _wait_until("the clear", lambda: (
                    lambda q: not q["objectives"][0]["breached"]
                    and q["shed_level"] == 0)(eng._slo_payload()))
                t_clear = time.perf_counter() - t0
                again = eng.submit(Request(**short[0])).result(FLEET_WAIT_S)
                if again.status != "ok":
                    raise AssertionError(f"phase 25 leg (d): after the clear "
                                         f"{again.status} {again.reason}")
                events = [e["state"] for e in eng._slo.payload()["events"]]
                shed = eng._queue.shed_count
            finally:
                eng.close()
        finally:
            server.close()
    log(f"  (d) p99 TTFT objective {FLEET_TTFT_S} s: a burst of "
        f"{len(burst)} requests ({t_burst:.3f} s, one OK Result each == leg "
        f"(a)) drove p99 TTFT to {ttft_p99:.3f} s, burn {burn:.1f}: breached"
        f" on /debug/slo, {shed} low-priority request(s) shed ('"
        f"{low.reason[:40]}...'), priority 1 served; cleared "
        f"{t_clear:.2f} s later and admission reopened; transitions "
        f"{events}; /metrics carries {len(SLO_FAMILIES)} marlin_slo_* "
        f"families; {smi}")

    # (e) the elastic fleet on an injected clock, fed by the router's
    # fleet-merged burn
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clock()
    server = obs.MetricsServer(port=0)
    server.start()
    with Leg("(e) scale out, scale in"):
        try:
            with _fleet_slo(mt):
                router = Router(factory, replicas=1,
                                supervisor_kw=dict(backoff_s=0.005,
                                                   poll_s=0.02),
                                rng=random.Random(11))
            ctl = FleetController(router, clock=clk, min_replicas=1,
                                  max_replicas=FLEET_REPLICAS,
                                  eval_interval_s=1.0, out_burn=1.0,
                                  in_burn=0.1, hysteresis=1, cooldown_s=0.0,
                                  flap_window_s=0.0, threaded=False)
            try:
                # a shared prompt first, so the fleet has chains to warm with
                engine_results([router.submit(Request(**specs[0]))],
                               "leg (e) first")
                handles = submit_from_threads(router, Request, burst)
                _wait_until("the fleet burn", lambda: _fleet_burn(
                    router._fleet_slo()) >= 1.0)
                clk.t += 1.0
                d_out = ctl.tick()
                if d_out.get("action") != "scale_out" or \
                        router.replica_count() != 2 or \
                        ctl._last_action["outcome"] != "ok":
                    raise AssertionError(f"phase 25 leg (e): {d_out}, "
                                         f"{ctl._last_action}")
                fresh = router._replicas[-1].engine
                warmed = fresh._kvpool.cached_count()
                if warmed <= 0:
                    raise AssertionError("phase 25 leg (e): the new replica "
                                         "joined with a cold prefix cache")
                got_e = engine_results(handles, "leg (e) burst")
                check_tokens(got_e, want + want, "leg (e) burst")
                # quiet: the burst's samples aged out of every replica's
                # fast window and no replica sheds any more
                _wait_until("the quiet", lambda: (
                    lambda m: m is not None and _fleet_burn(m) <= 0.1
                    and not any(o["breached"] for o in m["objectives"]))(
                        router._fleet_slo()))
                handles = submit_from_threads(router, Request, specs)
                clk.t += 1.0
                d_in = ctl.tick()
                if d_in.get("action") != "scale_in" or \
                        router.replica_count() != 1 or \
                        ctl._last_action["outcome"] != "ok":
                    raise AssertionError(f"phase 25 leg (e): {d_in}, "
                                         f"{ctl._last_action}")
                got_in = engine_results(handles, "leg (e) scale-in")
                check_tokens(got_in, want, "leg (e) scale-in")
                fleet = _json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/debug/fleet",
                    timeout=60).read())
                mine = [f for f in fleet["fleets"]
                        if f.get("controller") == ctl._name]
                if not mine or [h["action"] for h in mine[0]["history"]] \
                        != ["scale_out", "scale_in"]:
                    raise AssertionError(f"phase 25 leg (e): /debug/fleet "
                                         f"{mine}")
                snap = router.snapshot()
                router.drain()
                for rep in router._replicas:
                    audit_clean(rep.engine, "leg (e)")
                if router.pending():
                    raise AssertionError("phase 25 leg (e): work left")
            finally:
                ctl.close()
                router.close()
        finally:
            server.close()
    if memledger.get_ledger().totals().get("migration", 0):
        raise AssertionError("phase 25: migration bytes left in the ledger")
    log(f"  (e) FleetController (injected clock, hysteresis 1) on the "
        f"router's fleet-merged burn: scale_out during a {len(burst)}-request"
        f" burst (the new replica joined with {warmed} warm cache entries), "
        f"scale_in under a {len(specs)}-request wave; zero dropped, tokens "
        f"== leg (a); migrated in {snap['migrated_in']}, fallback "
        f"{snap['migrate_fallback']}; /debug/fleet history scale_out, "
        f"scale_in")
    del params
    torch.cuda.empty_cache()
    return launches["split"], launches["combine"]

def moe_chunked_reference(np, tt, params, prompt, steps):
    """Greedy tokens of one request computed as ServeEngine(moe=...) does,
    without the engine: ``lm_prefill_paged`` over its bucket's chunks (the
    last zero-padded) on a pool of its own, a table as wide as the bucket
    gives a row, then ``lm_decode_paged`` through its gather route. Returns
    prompt + generated tokens."""
    from marlin_tpu_torch.serving import kvpool
    from marlin_tpu_torch.serving.batcher import pick_bucket

    n = len(prompt)
    g = kvpool.PagedGroup(pick_bucket(n, steps, ENGINE_BUCKETS), ROWS,
                          PAGE_LEN, PREFILL_CHUNK)
    chunk, per_row = g.chunk, g.pages_per_row
    table = np.arange(1, g.table_width + 1, dtype=np.int32)
    heads = MOE_LM["heads"]
    pages = tt.init_kv_pages(params, len(table) + 1, PAGE_LEN, heads)
    for cs in range(0, n, chunk):
        piece = np.zeros(chunk, np.int32)
        piece[:min(chunk, n - cs)] = prompt[cs:cs + chunk]
        pages, first = tt.lm_prefill_paged(params, pages, table, piece, cs,
                                           n, heads=heads, page_len=PAGE_LEN,
                                           moe=MOE_ENGINE)
    toks = [int(first)]
    for step in range(1, steps):
        pages, nxt = tt.lm_decode_paged(
            params, pages, table[None, :per_row], np.int32([n + step - 1]),
            np.int32([toks[-1]]), np.int32([step]), np.uint32([0]),
            np.float32([0.0]), np.float32([1.0]), np.int32([0]), heads=heads,
            page_len=PAGE_LEN, moe=MOE_ENGINE, kernel="gather")
        toks.append(int(nxt[0]))
    return [int(t) for t in prompt] + toks


def moe_path(torch, np, tt, fa, pa, ops, smi):
    """Phase 26: bench_all.py config_moe on the card — one warm step and
    TRAIN_STEPS timed steps beside config_lct's dense model on the same
    stream, one step's loss and gradients against the plain attention path,
    ``moe_ffn`` against an f64 CPU run on one 4096-token group, then greedy
    ``lm_generate`` and ``ServeEngine(moe=...)`` over the trained params.
    Returns the launch counts of the training and serving legs."""
    from marlin_tpu_torch.models import moe as tm
    from marlin_tpu_torch.serving import Request, ServeEngine, kvpool

    log(f"phase 26: config_moe TransformerLM{tuple(MOE_LM.values())} f32 on "
        f"a {TRAIN_SEQ}-token stream, Adam: 1 warm + {TRAIN_STEPS} steps "
        f"beside config_lct's; {smi}")
    stream = np.random.default_rng(0).integers(
        0, MOE_LM["vocab"], TRAIN_SEQ).astype(np.int32)
    rates = {}
    for label, cfg in (("config_lct", LCT), ("config_moe", MOE_LM)):
        lm = tt.TransformerLM(**cfg)
        params0 = lm.init_params()
        lm.train(stream, steps=1, params=params0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, losses = lm.train(stream, steps=TRAIN_STEPS, params=params0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        rates[label] = TRAIN_SEQ * TRAIN_STEPS / dt / 1e3
        log(f"  {label}: losses {losses}; {rates[label]:.3f} ktok/s, "
            f"{dt / TRAIN_STEPS * 1e3:.3f} ms per step (host clock), peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches {counts}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: losses {losses}")
    train_counts = counts
    # remat recomputes each block's forward in the backward: the forward
    # kernel runs twice a layer and step, the backward pair once
    want = MOE_LM["layers"] * TRAIN_STEPS
    for kname, n in (("flash_attention_panel", 2 * want),
                     ("flash_attention_bwd_dkv", want),
                     ("flash_attention_bwd_dq", want)):
        if train_counts[kname] != n:
            raise AssertionError(f"config_moe: {kname} {train_counts[kname]} "
                                 f"launches, want {n}")
    log(f"  config_moe {rates['config_moe']:.3f} ktok/s against config_lct "
        f"{rates['config_lct']:.3f} ktok/s "
        f"({rates['config_moe'] / rates['config_lct']:.3f}x)")
    # one step's loss and gradients against the plain attention path
    knobs = dict(heads=MOE_LM["heads"], attn="ring", remat=True,
                 loss_chunk=MOE_LM["loss_chunk"], moe=MOE_ENGINE)
    loss_k, grads_k = tt.lm_value_and_grad(params0, stream, **knobs)
    kernel_fwd, kernel_bwd = (fa.flash_attention_single_panel,
                              fa.flash_attention_panel_bwd)
    fa.flash_attention_single_panel = fa.flash_attention_single_panel_plain
    fa.flash_attention_panel_bwd = fa.flash_attention_panel_bwd_plain
    try:
        ops.reset_launch_counts()
        loss_p, grads_p = tt.lm_value_and_grad(params0, stream, **knobs)
        if any(ops.launch_counts().values()):
            raise AssertionError("phase 26: the plain run launched a kernel")
    finally:
        fa.flash_attention_single_panel = kernel_fwd
        fa.flash_attention_panel_bwd = kernel_bwd
    grads_k, grads_p = flat(grads_k), flat(grads_p)
    grad_worst = max(float((grads_k[k] - g).abs().max())
                     / max(float(g.abs().max()), 1e-30)
                     for k, g in grads_p.items())
    log(f"  step-1 loss {float(loss_k)!r} (plain {float(loss_p)!r}); "
        f"gradients: largest |kernel - plain| / max|plain| over the leaves "
        f"{grad_worst:.3e} (tol {TRAIN_GRAD_TOL:g}); router |grad| max "
        f"{float(grads_k['l0/moe/wg'].abs().max()):.3e}")
    if abs(float(loss_k) - float(loss_p)) > TRAIN_LOSS0_RTOL * abs(
            float(loss_p)) or not grad_worst <= TRAIN_GRAD_TOL or not float(
            grads_k["l0/moe/wg"].abs().max()) > 0:
        raise AssertionError("phase 26: kernel and plain steps differ")
    del grads_k, grads_p, params0
    # moe_ffn on the card against the same call in f64 on the CPU
    mp = params["l0"]["moe"]
    x = params["emb"][torch.as_tensor(stream[:MOE_ENGINE[2]],
                                      device="cuda").long()]
    x = x + 0.1 * torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(26), device="cuda")
    out, aux = tm.moe_ffn(mp, x, top_k=MOE_ENGINE[0],
                          capacity_factor=MOE_ENGINE[1],
                          group_size=MOE_ENGINE[2])
    mp64 = {k: v.double().cpu() for k, v in mp.items()}
    ref, aux_ref = tm.moe_ffn(mp64, x.double().cpu(), top_k=MOE_ENGINE[0],
                              capacity_factor=MOE_ENGINE[1],
                              group_size=MOE_ENGINE[2])
    disp = [tm._route_group(t, torch.ones(t.shape[0], device=t.device),
                            w["wg"], MOE_ENGINE[0], tm.moe_capacity(
                                t.shape[0], 8, *MOE_ENGINE[:2]))[0].cpu()
            for t, w in ((x, mp), (x.double().cpu(), mp64))]
    moe_err = float((out.double().cpu() - ref).abs().max()) / float(
        ref.abs().max())
    log(f"  moe_ffn on {x.shape[0]} tokens: card vs f64 CPU max err "
        f"{moe_err:.3e} of max|ref| (tol {MOE_F64_TOL:g}); dispatch equal: "
        f"{bool(torch.equal(disp[0], disp[1]))}; aux {float(aux):.4f} "
        f"(f64 {float(aux_ref):.4f}, 1.0 = balanced)")
    if not (torch.equal(disp[0], disp[1]) and moe_err <= MOE_F64_TOL
            and abs(float(aux) - float(aux_ref)) <= 1e-4):
        raise AssertionError("phase 26: moe_ffn on the card != f64 run")
    # the paged kernel at the engine's shapes (kvh 2, group 1, dh 128, the
    # buckets' tables) against its plain version
    gen = torch.Generator(device="cuda").manual_seed(26)
    dh = MOE_LM["d_model"] // MOE_LM["heads"]
    for p, s in ENGINE_BUCKETS:
        check_paged(torch, pa, gen, ROWS, MOE_LM["heads"], 1, dh, PAGE_LEN,
                    -(-(p + s) // PAGE_LEN), torch.float32)
    # serve phase 18's load over the trained params
    specs = engine_specs(np, MOE_LM["vocab"])
    engine_kw = dict(moe=MOE_ENGINE, buckets=ENGINE_BUCKETS, max_batch=ROWS,
                     page_len=PAGE_LEN, prefill_chunk=PREFILL_CHUNK,
                     decode_kernel="auto")
    with ServeEngine(params, MOE_LM["heads"], **engine_kw) as eng:
        eng.warmup()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        combine0 = pa.paged_decode_attention.combine_launches
        t0 = time.perf_counter()
        served = engine_results(submit_from_threads(eng, Request, specs),
                                "phase 26 engine")
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        serve_counts = ops.launch_counts()
        serve_counts["paged_combine"] = \
            pa.paged_decode_attention.combine_launches - combine0
    # the sampled requests one at a time on a second engine: resubmitted to
    # the first, each would hit its own prompt in the prefix cache, and a
    # hit moves the prefill chunks' boundaries and so the MoE's groups
    sampled = [i for i, sp in enumerate(specs) if sp.get("temperature")]
    with ServeEngine(params, MOE_LM["heads"], **engine_kw) as eng:
        alone = {i: engine_results([eng.submit(Request(**specs[i]))],
                                   "phase 26 alone")[0] for i in sampled}
    gen_toks = sum(len(t) - len(sp["prompt"]) for t, sp in zip(served, specs))
    chunk = kvpool.PagedGroup(ENGINE_BUCKETS[-1], ROWS, PAGE_LEN,
                              PREFILL_CHUNK).chunk
    multi = sum(1 for sp in specs if len(sp["prompt"]) > chunk)
    log(f"  ServeEngine(moe={MOE_ENGINE}): {len(specs)} requests "
        f"({len(sampled)} sampled, {multi} of more than one {chunk}-token "
        f"prefill chunk) on {ROWS} rows: {gen_toks} tokens in {wall:.3f} s "
        f"= {gen_toks / wall:.1f} tok/s, TTFT p50 "
        f"{snap['p50_ttft_s'] * 1e3:.1f} ms, p99 "
        f"{snap['p99_ttft_s'] * 1e3:.1f} ms (host clock); launches "
        f"{serve_counts}")
    if serve_counts["paged_decode_attention"] <= 0:
        raise AssertionError("phase 26: the paged kernel never launched")
    bad = [i for i in sampled if served[i] != alone[i]]
    if bad:
        raise AssertionError(f"phase 26: sampled requests {bad} differ from "
                             f"the same requests served alone")
    same_gen = 0
    for i, sp in enumerate(specs):
        if i in alone:
            continue
        ref = moe_chunked_reference(np, tt, params, sp["prompt"],
                                    sp["steps"])
        if served[i] != ref:
            raise AssertionError(f"phase 26: request {i} greedy tokens != "
                                 f"the chunked paged reference")
        same_gen += ref == tt.lm_generate(
            params, sp["prompt"], 0, heads=MOE_LM["heads"],
            max_len=len(sp["prompt"]) + sp["steps"], steps=sp["steps"],
            moe=MOE_ENGINE).tolist()
    greedy = len(specs) - len(sampled)
    log(f"  greedy tokens: engine == the chunked reference for all {greedy} "
        f"requests ({same_gen} of them also == lm_generate's whole-prompt "
        f"routing); sampled == served alone for all {len(sampled)}; phase 26"
        f" result: every check passed; {smi}")
    del params
    torch.cuda.empty_cache()
    return train_counts, serve_counts


def _slab_traffic(np):
    """Phase 27's requests: config_serve's prompt (8-191 tokens) and step
    (4-32) ranges, every fourth request sampled, and SLAB_LONG prompts of
    exactly 2048 tokens with 8 steps."""
    rng = np.random.default_rng(27)
    vocab = SERVE_MODEL["vocab"]
    specs = []
    for i in range(SLAB_REQUESTS):
        spec = dict(prompt=rng.integers(0, vocab, int(rng.integers(8, 192)))
                    .astype(np.int32), steps=int(rng.integers(4, 33)))
        if i % 4 == 3:
            spec.update(temperature=0.8, seed=1000 + i, top_p=0.95)
        specs.append(spec)
    for i in range(SLAB_LONG):
        specs.insert(7 * i + 3, dict(
            prompt=rng.integers(0, vocab, 2048).astype(np.int32), steps=8))
    return specs


def slab_path(torch, np, tt, fa, pa, ops, smi):
    """Phase 27: ServeEngine(paged=False) over config_serve's model; the same
    requests through the paged engine. The flash forward at the shape
    ``lm_prefill_slot`` gives it (8 heads of 16 over 2048 positions) and the
    paged kernel at the paged engine's (kvh 8, group 1, dh 16, each
    bucket's table) are first held against their plain versions. Returns
    the slab leg's and the paged leg's launch counts."""
    from marlin_tpu_torch import config as mconfig
    from marlin_tpu_torch.serving import Request, ServeEngine

    lm = tt.TransformerLM(**SERVE_MODEL)
    params = lm.init_params()
    specs = _slab_traffic(np)
    log(f"phase 27: ServeEngine(paged=False) over TransformerLM"
        f"{tuple(SERVE_MODEL.values())} f32 (dh "
        f"{SERVE_MODEL['d_model'] // SERVE_MODEL['heads']}), buckets "
        f"{SLAB_BUCKETS}, {SLAB_BATCH} rows: {len(specs)} requests "
        f"({sum(1 for s in specs if s.get('temperature'))} sampled, "
        f"{SLAB_LONG} of 2048 tokens); then the paged engine; {smi}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    heads = SERVE_MODEL["heads"]
    dh = SERVE_MODEL["d_model"] // heads
    check_flash(torch, fa, gen, heads, SLAB_BUCKETS[-1][0], dh,
                SLAB_BUCKETS[-1][0], torch.float32)
    page_len = mconfig.get_config().serve_page_len
    for p, s in SLAB_BUCKETS:
        check_paged(torch, pa, gen, SLAB_BATCH, heads, 1, dh, page_len,
                    -(-(p + s) // page_len), torch.float32)
    legs = {}
    for paged in (False, True):
        with ServeEngine(params, SERVE_MODEL["heads"], buckets=SLAB_BUCKETS,
                         max_batch=SLAB_BATCH, paged=paged,
                         queue_depth=4 * len(specs)) as eng:
            eng.warmup()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            combine0 = pa.paged_decode_attention.combine_launches
            t0 = time.perf_counter()
            handles = [eng.submit(Request(**s)) for s in specs]
            res = _served(handles, f"phase 27 paged={paged}")
            wall = time.perf_counter() - t0
            snap = eng.metrics.snapshot()
        counts = ops.launch_counts()
        counts["paged_combine"] = \
            pa.paged_decode_attention.combine_launches - combine0
        gen = sum(len(r.tokens) - len(s["prompt"]) for r, s in zip(res, specs))
        legs[paged] = ([r.tokens.tolist() for r in res], counts)
        log(f"  paged={paged}: {gen} tokens in {wall:.3f} s = "
            f"{gen / wall:.1f} tok/s, TTFT p50 {snap['p50_ttft_s'] * 1e3:.1f}"
            f" ms, p99 {snap['p99_ttft_s'] * 1e3:.1f} ms (host clock); "
            f"launches {counts}")
    slab_counts, paged_counts = legs[False][1], legs[True][1]
    if slab_counts["flash_attention_panel"] != SLAB_LONG * \
            SERVE_MODEL["layers"]:
        raise AssertionError(f"phase 27: lm_prefill_slot launched the flash "
                             f"forward {slab_counts['flash_attention_panel']}"
                             f" times, want one a layer of each 2048-token "
                             f"prompt")
    if paged_counts["paged_decode_attention"] <= 0:
        raise AssertionError("phase 27: the paged engine's kernel never "
                             "launched")
    same_sampled = 0
    for i, s in enumerate(specs):
        slab, paged = legs[False][0][i], legs[True][0][i]
        if s.get("temperature"):
            same_sampled += slab == paged
            continue
        ref = tt.lm_generate(params, s["prompt"], 0,
                             heads=SERVE_MODEL["heads"],
                             max_len=len(s["prompt"]) + s["steps"],
                             steps=s["steps"]).tolist()
        if slab != ref or paged != ref:
            raise AssertionError(f"phase 27: request {i} greedy tokens "
                                 f"(slab {slab == ref}, paged {paged == ref})"
                                 f" != lm_generate")
    n_sampled = sum(1 for s in specs if s.get("temperature"))
    log(f"  greedy tokens: slab == paged == lm_generate for all "
        f"{len(specs) - n_sampled} greedy requests; sampled rows equal "
        f"across the two engines: {same_sampled} of {n_sampled}; phase 27 "
        f"result: every check passed; {smi}")
    del params
    torch.cuda.empty_cache()
    return slab_counts, paged_counts


def fuse_target_name(node) -> str | None:
    """The name of what an FX node calls (``torch.matmul`` -> "matmul",
    ``aten.mm.default`` -> "mm", ``x.matmul(y)`` -> "matmul"), None for a
    node that calls nothing."""
    if node.op == "call_method":
        return node.target
    if node.op != "call_function":
        return None
    name = getattr(node.target, "__name__", None) or str(node.target)
    return name.split(".")[0]


def fuse_path(torch, np, mt, smi):
    """Phase 28: lazy.fuse over a.multiply(b).add(c).multiply(2.0) at
    FUSE_N² f32 through inductor: one graph, equal to the eager chain, its
    time beside the eager chain's (CUDA events); lazy.grad of a fused
    scalar loss returns a DenseVecMatrix."""
    from torch._inductor.compile_fx import compile_fx

    from marlin_tpu_torch import lazy

    n = FUSE_N
    log(f"phase 28: lazy.fuse over a.multiply(b).add(c).multiply(2.0) at "
        f"{n}^2 f32 (inductor); {smi}")
    a, b, c = (mt.DenseVecMatrix.random(s, n, n) for s in (280, 281, 282))
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return compile_fx(gm, example_inputs)

    def chain(a, b, c):
        return a.multiply(b).add(c).multiply(2.0)

    fused = mt.fuse(chain, backend=backend)
    t0 = time.perf_counter()
    out = fused(a, b, c)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    eager = chain(a, b, c)
    err = float((out.data - eager.data).abs().max()) / float(
        eager.data.abs().max())
    products = [fuse_target_name(node) for node in graphs[0].graph.nodes
                if fuse_target_name(node) in FUSE_PRODUCTS]
    log(f"  first call (trace + compile) {compile_s:.3f} s: {len(graphs)} "
        f"graph, {len(products)} product(s) in it {products}; fused vs eager"
        f" max err {err:.3e} of max|eager| (tol {FUSE_TOL:g})")
    if len(graphs) != 1 or len(products) != 1 or not isinstance(
            out, mt.DenseVecMatrix) or not err <= FUSE_TOL:
        raise AssertionError("phase 28: the fused chain is not one graph "
                             "with one product equal to the eager chain")
    ms_fused = cuda_ms(torch, lambda: fused(a, b, c), 5)
    ms_eager = cuda_ms(torch, lambda: chain(a, b, c), 5)
    bound = 1e3 * max(2.0 * n ** 3 / F32_PEAK, 4.0 * n * n * 4 /
                      HBM_BYTES_PER_S)
    log(f"  fused {ms_fused:.3f} ms, eager {ms_eager:.3f} ms a call (CUDA "
        f"events, TF32 off), bound {bound:.3f} ms (operations, f32 outside "
        f"the tensor cores)")
    loss = mt.fuse(lambda a, b: a.multiply(b).sum(), backend=backend)
    g = lazy.grad(lambda a: loss(a, b))(a)
    want = b.data.sum(dim=1)[None, :].expand(n, n)
    gerr = float((g.data - want).abs().max()) / float(want.abs().max())
    log(f"  lazy.grad of a fused sum: {type(g).__name__} {g.shape}, vs "
        f"ones @ b^T max err {gerr:.3e} of max")
    if not isinstance(g, mt.DenseVecMatrix) or g.shape != a.shape or \
            not gerr <= 1e-5:
        raise AssertionError("phase 28: lazy.grad cotangent wrong")
    log(f"phase 28 result: every check passed; {smi}")
    del a, b, c, out, eager, g, want
    torch.cuda.empty_cache()
    return ms_fused, ms_eager


def plain_flash(fa):
    """Swap the flash forward and backward wrappers for their plain versions
    until the returned function is called (restores them)."""
    saved = (fa.flash_attention_panel, fa.flash_attention_panel_bwd)
    fa.flash_attention_panel = fa.flash_attention_panel_plain
    fa.flash_attention_panel_bwd = fa.flash_attention_panel_bwd_plain

    def restore():
        fa.flash_attention_panel, fa.flash_attention_panel_bwd = saved
    return restore


def offload_leg(torch, np, tt, ops, smi) -> dict:
    """Phase 29 (a): OFFLOAD_STEPS remat steps of config_lct's widths with
    and without offload_residuals, at each of OFFLOAD_LAYERS: losses,
    gradients and params bit for bit, ms a step, peak memory; with 8 layers
    the offloaded peak must be lower. Returns the launch counts."""
    stream = np.random.default_rng(0).integers(
        0, LCT["vocab"], TRAIN_SEQ).astype(np.int32)
    counts = dict.fromkeys(ops.launch_counts(), 0)
    for layers in OFFLOAD_LAYERS:
        lm = tt.TransformerLM(**dict(LCT, layers=layers), remat=True)
        params0 = lm.init_params()
        knobs = dict(heads=lm.heads, attn="ring", remat=True)
        runs = {}
        for offload in (False, True, False, True):  # warm, then timed
            params, opt = params0, tt.adam_init(params0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            moved = tt._ResidualOffload.moved
            t0 = time.perf_counter()
            losses, grads = [], []
            for _ in range(OFFLOAD_STEPS):
                loss, g = tt.lm_value_and_grad(params, stream,
                                               offload_residuals=offload,
                                               **knobs)
                params, opt = tt._adam_update(params, g, opt,
                                              lm.learning_rate)
                losses.append(loss)
                grads.append(g)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / OFFLOAD_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated()
            host = [x.cpu() for x in losses + [y for g in grads
                                               for y in tt._leaves(g)]
                    + tt._leaves(params)]
            runs[offload] = dict(host=host, ms=ms, peak=peak,
                                 moved=tt._ResidualOffload.moved - moved,
                                 losses=[float(x) for x in losses])
            del params, opt, losses, grads
            for k, n in ops.launch_counts().items():
                counts[k] += n
        plain, off = runs[False], runs[True]
        if off["moved"] != layers * OFFLOAD_STEPS:
            raise AssertionError(f"offload: {off['moved']} tensors moved, "
                                 f"want one a layer and step")
        if not all(torch.equal(a, b)
                   for a, b in zip(plain["host"], off["host"])):
            raise AssertionError(f"offload at {layers} layers: losses, "
                                 f"gradients or params differ from remat")
        log(f"  {layers} layers, {OFFLOAD_STEPS} remat steps: losses "
            f"{off['losses']} bit-equal with and without "
            f"offload (gradients and params too); {off['moved']} residuals "
            f"to pinned host memory; ms a step (host clock) {plain['ms']:.3f} "
            f"-> {off['ms']:.3f} offloaded; peak "
            f"{plain['peak'] / 2 ** 20:.1f} -> {off['peak'] / 2 ** 20:.1f} "
            f"MiB; {smi}")
        if layers == max(OFFLOAD_LAYERS):
            saved = plain["peak"] - off["peak"]
            resid = (layers - 1) * TRAIN_SEQ * LCT["d_model"] * 4
            log(f"  {layers} layers: offload lowers the peak by "
                f"{saved / 2 ** 20:.1f} MiB, beside {layers - 1} residuals "
                f"of {TRAIN_SEQ} x {LCT['d_model']} f32 = "
                f"{resid / 2 ** 20:.1f} MiB")
            if not saved > 0:
                raise AssertionError(f"offload at {layers} layers: peak "
                                     f"{off['peak']} not below {plain['peak']}")
        del runs, plain, off, params0
        torch.cuda.empty_cache()
    return counts


def planner_leg(torch, np, tt, mt, ops, smi) -> dict:
    """Phase 29 (b): plan_context on config_lct's model at TRAIN_SEQ tokens
    with a budget between the first and the last rung's measured peaks (the
    ladder must climb), one training step of the chosen model within the
    budget, and an unreachable budget (fits=False, the lowest-peak rung).
    Returns the launch counts."""
    from dataclasses import replace

    from marlin_tpu_torch.models import planner

    mesh = mt.create_mesh()
    lm = tt.TransformerLM(**LCT)
    ops.reset_launch_counts()
    rungs = planner._ladder(lm, TRAIN_SEQ)
    first, note0 = planner._measured_peak(lm, TRAIN_SEQ, mesh, mesh.device)
    last, note1 = planner._measured_peak(replace(lm, **rungs[-1]), TRAIN_SEQ,
                                         mesh, mesh.device)
    if first is None or last is None or not last < first:
        raise AssertionError(f"planner: rung peaks {first} ({note0}), "
                             f"{last} ({note1})")
    budget = (first + last) // 2
    log(f"  rung 0 peak {first / 2 ** 20:.1f} MiB, last rung {rungs[-1]} "
        f"{last / 2 ** 20:.1f} MiB; budget {budget / 2 ** 20:.1f} MiB; {smi}")
    t0 = time.perf_counter()
    plan = mt.models.plan_context(TRAIN_SEQ, lm, hbm_budget=budget)
    log(f"  plan_context ({time.perf_counter() - t0:.1f} s):")
    for line in plan.describe().splitlines():
        log("    " + line)
    if not plan.fits or not plan.knobs or len(plan.trail) < 2:
        raise AssertionError(f"planner: the ladder did not climb to a fit: "
                             f"{plan.describe()}")
    stream = np.random.default_rng(0).integers(
        0, LCT["vocab"], TRAIN_SEQ).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, losses = plan.model.train(stream, steps=1, mesh=mesh)
    peak = torch.cuda.max_memory_allocated()
    log(f"  the chosen model {plan.knobs} trained one step (loss "
        f"{losses[0]:.4f}) at a peak of {peak / 2 ** 20:.1f} MiB of the "
        f"{budget / 2 ** 20:.1f} MiB budget")
    if not (peak <= budget and math.isfinite(losses[0])):
        raise AssertionError(f"planner: the chosen model's step peaked at "
                             f"{peak}, budget {budget}")
    tiny = mt.models.plan_context(TRAIN_SEQ, lm, hbm_budget=PLAN_TINY_BUDGET)
    peaks = [p for _, p, _, _ in tiny.trail if p is not None]
    log(f"  unreachable budget {PLAN_TINY_BUDGET / 2 ** 20:.0f} MiB: fits "
        f"{tiny.fits}, the lowest-peak rung {tiny.knobs} at "
        f"{tiny.peak_bytes / 2 ** 20:.1f} MiB of {len(tiny.trail)} probed")
    if tiny.fits or tiny.peak_bytes != min(peaks):
        raise AssertionError(f"planner: unreachable budget gave "
                             f"{tiny.describe()}")
    torch.cuda.empty_cache()
    return ops.launch_counts()


def mlp2_stage(p, xs):
    """The two-matrix stage of the pp x tp checks (``tests/test_pipeline.py``'s):
    ``tanh(relu(xs @ w0) @ w1)``."""
    import torch

    return torch.tanh(torch.relu(xs @ p["w0"]) @ p["w1"])


def tp_mlp2_stage(mesh, axis="cols"):
    """:func:`mlp2_stage` on this rank's blocks of ``w0``'s columns and
    ``w1``'s rows over ``axis``, with the activation collectives."""
    import torch

    from marlin_tpu_torch.parallel import collectives as col

    def stage(p, xs):
        h = torch.relu(col.Replicate.apply(xs, mesh, axis) @ p["w0"])
        return torch.tanh(col.AllReduce.apply(h @ p["w1"], mesh, axis))
    return stage


def mlp2_placement(mesh) -> dict:
    """:func:`tp_mlp2_stage`'s placement of the stacked weights."""
    from marlin_tpu_torch.mesh import Sharding

    return {"w0": Sharding(mesh, ("rows", None, "cols")),
            "w1": Sharding(mesh, ("rows", "cols", None))}


def pp_tp_leg(torch, mt, pl, pipeline_apply, mesh, gen, x, sp, outer, toks,
              unplaced: float) -> None:
    """Phase 29 (c), pp x tp: the stage weights placed over "cols" (a group
    of one rank on the (1, 1) grid), the stages' collectives through it.
    The two-matrix stage against the stages in sequence, and ``pp_lm_loss``
    at PP_LONG tokens with ``pp_tp_placement`` through the flash forward
    (two launches a layer: 2 rows x 2 layers) against ``unplaced``, the
    same loss without a placement."""
    from marlin_tpu_torch import ops

    width = x.shape[1]
    w = {"w0": torch.randn((1, width, PIPE_FF), generator=gen,
                           device=x.device) / math.sqrt(width),
         "w1": torch.randn((1, PIPE_FF, width), generator=gen,
                           device=x.device) / math.sqrt(PIPE_FF)}
    with mt.ops.local.precision_scope("highest"):
        split = pipeline_apply(w, tp_mlp2_stage(mesh), x, mesh,
                               microbatch=PIPE_MB,
                               placement=mlp2_placement(mesh))
        seq = mlp2_stage({k: v[0] for k, v in w.items()}, x)
    rel = float((split - seq).abs().max()) / float(seq.abs().max())
    log(f"  pipeline_apply, w0/w1 placed over cols ({width} -> {PIPE_FF} "
        f"-> {width}): max err {rel:.3e} of max|ref| against the stages in "
        f"sequence (tol {PIPE_TOL:g})")
    if not rel <= PIPE_TOL:
        raise AssertionError(f"pipeline_apply placed: {rel}")
    before = ops.launch_counts()["flash_attention_panel"]
    with torch.no_grad():
        placed = float(pl.pp_lm_loss(sp, outer, toks, mesh, heads=2,
                                     placement=pl.pp_tp_placement(mesh)))
    n_flash = ops.launch_counts()["flash_attention_panel"] - before
    rel = abs(placed - unplaced) / abs(unplaced)
    log(f"  pp_lm_loss at {PP_LONG} tokens, pp_tp_placement: {placed:.6f} "
        f"against {unplaced:.6f} unplaced, rel {rel:.3e} (tol "
        f"{PP_TP_RTOL:g}); {n_flash} flash forward launches")
    if not (rel <= PP_TP_RTOL and n_flash == 2 * 2):
        raise AssertionError(f"pp_lm_loss placed: rel {rel}, {n_flash} "
                             f"launches")


def nccl_leg(torch, np, mt, tt, fa, ops, smi) -> tuple[dict, dict]:
    """Phase 29 (c): a one-rank NCCL world on the card, its mesh, and the
    multi-rank paths through it against their references. Returns the
    launch counts of the user calls and the NCCL overheads."""
    import contextlib
    import io
    import tempfile

    import torch.distributed as dist

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.examples import pipeline_training
    from marlin_tpu_torch.models import pipeline_lm as pl
    from marlin_tpu_torch.parallel import (matmul, pipeline_apply,
                                           ring_attention, ring_matmul,
                                           stack_stage_params,
                                           ulysses_attention)

    counts = dict.fromkeys(ops.launch_counts(), 0)

    def add():
        for k, n in ops.launch_counts().items():
            counts[k] += n

    overhead = {}
    with tempfile.TemporaryDirectory() as tmp:
        mm.initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            mesh = mm.create_mesh((1, 1))
            log(f"  {dist.get_backend()} world of {mm.world_size()} on "
                f"{mesh.device}, mesh {mesh.shape} over ranks {mesh.ranks}")
            if dist.get_backend() != "nccl" or mesh.ranks != (0,):
                raise AssertionError("phase 29: not an NCCL rank mesh")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(29)
            a = torch.randn((DIST_N, DIST_N), generator=gen, device="cuda")
            b = torch.randn((DIST_N, DIST_N), generator=gen, device="cuda")
            local_matmul = mt.ops.local.local_matmul
            ref = local_matmul(a, b, "highest")
            scale = float(ref.abs().max())
            for label, fn in (
                    ("ring_matmul", lambda: ring_matmul(a, b, mesh,
                                                        precision="high")),
                    ("matmul(strategy='rmm')", lambda: matmul(
                        a, b, mesh, strategy="rmm", precision="high"))):
                rel = float((fn() - ref).abs().max()) / scale
                ms = cuda_ms(torch, fn, 3)
                overhead[label] = ms
                log(f"  {label} {DIST_N}^2 through NCCL: max err {rel:.3e} "
                    f"of max|ref| (tol {DIST_TOL}), {ms:.3f} ms; {smi}")
                if not rel <= DIST_TOL:
                    raise AssertionError(f"{label}: {rel} > {DIST_TOL}")
            overhead["torch.matmul"] = cuda_ms(
                torch, lambda: local_matmul(a, b, "highest"), 3)
            one = torch.ones(1, device="cuda")
            overhead["all_reduce"] = cuda_ms(
                torch, lambda: dist.all_reduce(one), 100) * 1e3
            overhead["all_gather"] = cuda_ms(
                torch, lambda: dist.all_gather([torch.empty_like(one)], one),
                100) * 1e3
            log(f"  torch.matmul {overhead['torch.matmul']:.3f} ms (TF32 "
                f"off); NCCL at world 1: all_reduce of 1 float "
                f"{overhead['all_reduce']:.1f} us, all_gather "
                f"{overhead['all_gather']:.1f} us a call; {smi}")
            del a, b, ref
            # ring and Ulysses attention, forward and backward
            h, s, d = DIST_ATTN
            q, k, v, ct = (torch.randn((h, s, d), generator=gen,
                                       device="cuda") for _ in range(4))

            def attn(fn):
                xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
                out = fn(*xs)
                grads = torch.autograd.grad((out * ct).sum(), xs)
                return out.detach(), grads

            for label, fn in (
                    ("ring_attention(backend='flash')",
                     lambda *x: ring_attention(*x, mesh, causal=True,
                                               backend="flash")),
                    ("ulysses_attention",
                     lambda *x: ulysses_attention(*x, mesh, causal=True))):
                ops.reset_launch_counts()
                out, grads = attn(fn)
                torch.cuda.synchronize()
                add()
                restore = plain_flash(fa)
                try:
                    out_p, grads_p = attn(fn)
                finally:
                    restore()
                attn_close(torch, f"{label} {DIST_ATTN} out", out, out_p,
                           torch.float32)
                for name, g, w in zip("qkv", grads, grads_p):
                    bwd_close(torch, f"{label} d{name}", g, w, torch.float32)
            # the pipeline against its stages in sequence
            batch, width = PIPE_SHAPE
            w = torch.randn((1, 2, width, width), generator=gen,
                            device="cuda") / math.sqrt(width)
            x = torch.randn((batch, width), generator=gen, device="cuda")

            def stage(p, xs):
                for j in range(p["w"].shape[0]):
                    xs = torch.tanh(xs @ p["w"][j])
                return xs

            with mt.ops.local.precision_scope("highest"):
                got = pipeline_apply(stack_stage_params([{"w": w[0]}], mesh),
                                     stage, x, mesh, microbatch=PIPE_MB)
                want = stage({"w": w[0]}, x)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            log(f"  pipeline_apply {PIPE_SHAPE}, microbatches of {PIPE_MB}: "
                f"max err {rel:.3e} of max|ref| against the stages in "
                f"sequence (tol {PIPE_TOL:g})")
            if not rel <= PIPE_TOL:
                raise AssertionError(f"pipeline_apply: {rel}")
            # the CLI at its defaults
            ops.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                losses = pipeline_training.main(list(PP_CLI))
            add()
            for line in buf.getvalue().splitlines():
                log(f"  pipeline_training {' '.join(PP_CLI)}: {line}")
            log(f"  ({smi})")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"pipeline_training: losses {losses}")
            # pp_lm_loss at PP_LONG tokens: the flash forward in each stage
            params = tt.init_transformer(0, 512, 128, 2, 2)
            sp, outer = pl.pp_stage_params(params, mesh)
            toks = np.random.default_rng(0).integers(
                0, 512, (2, PP_LONG + 1)).astype(np.int32)
            ops.reset_launch_counts()
            with torch.no_grad():
                got = pl.pp_lm_loss(sp, outer, toks, mesh, heads=2)
                torch.cuda.synchronize()
                add()
                n_flash = ops.launch_counts()["flash_attention_panel"]
                restore = plain_flash(fa)
                try:
                    want = pl.pp_lm_loss(sp, outer, toks, mesh, heads=2)
                finally:
                    restore()
            rel = abs(float(got) - float(want)) / abs(float(want))
            log(f"  pp_lm_loss at {PP_LONG} tokens (2 x 2 layers, no grad): "
                f"{float(got):.6f}, plain flash {float(want):.6f}, rel "
                f"{rel:.3e}; {n_flash} flash forward launches")
            if not (rel <= 1e-5 and n_flash == 2 * 2):
                raise AssertionError(f"pp_lm_loss at {PP_LONG}: rel {rel}, "
                                     f"{n_flash} launches")
            ops.reset_launch_counts()
            pp_tp_leg(torch, mt, pl, pipeline_apply, mesh, gen, x, sp, outer,
                      toks, float(got))
            add()
        finally:
            mm.shutdown_distributed()
    if mm.distributed():
        raise AssertionError("phase 29: the process group is still up")
    return counts, overhead


def collectives_path(torch, np, mt, tt, fa, ops, smi) -> dict:
    """Phase 29: offloaded residuals, the planner, and the collectives layer
    at world size 1 over NCCL. Returns the launch counts of its user
    paths."""
    log(f"phase 29: (a) offload_residuals at config_lct's widths, "
        f"{OFFLOAD_LAYERS} layers; (b) plan_context; (c) a one-rank NCCL "
        f"world; {smi}")
    totals = offload_leg(torch, np, tt, ops, smi)
    for k, n in planner_leg(torch, np, tt, mt, ops, smi).items():
        totals[k] += n
    counts, _ = nccl_leg(torch, np, mt, tt, fa, ops, smi)
    for k, n in counts.items():
        totals[k] += n
    log(f"  phase 29 launches: {totals}")
    for kname in ("flash_attention_panel", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
        if totals[kname] <= 0:
            raise AssertionError(f"phase 29: {kname} never launched")
    return totals


def params_close(label, got, want, start, lr) -> str:
    """Phase 11's test of two trainers' params after TRAIN_STEPS steps:
    at most TRAIN_OUTLIER_SHARE of the elements off by more than lr/10 and
    the difference at most TRAIN_DIFF_SHARE of the distance moved from
    ``start``. Returns the logged figures."""
    fg, fw, f0 = flat(got), flat(want), flat(start)
    n_el = sum(t.numel() for t in fw.values())
    n_off = sum(int(((fg[k] - fw[k]).abs() > lr / 10).sum()) for k in fw)
    diff = math.sqrt(sum(float(((fg[k] - fw[k]) ** 2).sum()) for k in fw))
    moved = math.sqrt(sum(float(((fw[k] - f0[k]) ** 2).sum()) for k in fw))
    if n_off > TRAIN_OUTLIER_SHARE * n_el or diff > TRAIN_DIFF_SHARE * moved:
        raise AssertionError(f"{label}: params differ ({n_off} of {n_el} "
                             f"past lr/10, {diff / moved:.3e} of the "
                             f"distance moved)")
    return (f"{n_off} of {n_el} elements past lr/10, difference "
            f"{diff / moved:.3e} of the distance moved")


def losses_close(label, got, want) -> float:
    """The largest relative difference of two runs' losses, within
    TRAIN_LOSS_RTOL."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label}: losses {got} vs {want}")
    return worst


def log_shard_bytes(torch, mm, tt) -> None:
    """Per rank, analytic: the f32 activations a config_lct training step
    holds a layer when its TRAIN_SEQ stream is sharded over 1, 2 and 4
    ranks with the ring's flash rule (the layout ``_seq_shards`` gives):
    the residual stream, q/k/v/o, the FFN's (rows, 4·d) intermediate, and
    the logits of the LM head."""
    d, vocab = LCT["d_model"], LCT["vocab"]
    for p in (1, 2, 4):
        sh = tt._seq_shards(mm.Mesh(torch.device("cuda"), (p, 1)),
                            TRAIN_SEQ - 1, "ring_flash", d // LCT["heads"],
                            "cuda")
        mib = {name: sh.rows * width * 4 / 2 ** 20 for name, width in (
            ("residual", d), ("q/k/v/o", 4 * d), ("ffn", 4 * d),
            ("logits", vocab))}
        log(f"  per rank at p = {p} (analytic, f32): {sh.rows} of "
            f"{sh.padded} rows; residual {mib['residual']:g} MiB, q/k/v/o "
            f"{mib['q/k/v/o']:g} MiB a layer, FFN intermediate "
            f"{mib['ffn']:g} MiB, logits {mib['logits']:g} MiB")


def moe_knobs() -> dict:
    """config_moe's lm_loss arguments, as TransformerLM(**MOE_LM) passes
    them."""
    return dict(heads=MOE_LM["heads"], attn="ring", remat=MOE_LM["remat"],
                loss_chunk=MOE_LM["loss_chunk"], moe=(
                    MOE_LM["moe_top_k"], MOE_LM["moe_capacity_factor"],
                    MOE_LM["moe_group"]))


def ranks_references(torch, np, mt, tt):
    """Phase 30's plain runs, made outside the process group: config_moe's
    logical trainer, the distributed_training CLI's step losses, blocked
    ALS and PageRank in a world of one; with the inputs the rank paths
    take."""
    import contextlib
    import io
    import json
    import tempfile

    from marlin_tpu_torch.examples import distributed_training
    from marlin_tpu_torch.ml import build_transition_operator, pagerank

    ref = {}
    stream = np.random.default_rng(0).integers(
        0, LCT["vocab"], TRAIN_SEQ).astype(np.int32)
    moe = tt.TransformerLM(**MOE_LM)
    ref["moe_params0"] = moe.init_params()
    ref["moe"] = moe.train(stream, steps=TRAIN_STEPS,
                           params=ref["moe_params0"])
    ref["moe_grads"] = tt.lm_value_and_grad(ref["moe_params0"], stream,
                                            **moe_knobs())
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            distributed_training.main([*RANKS_NN_CLI, tmp])
        with open(os.path.join(tmp, "events.jsonl")) as f:
            ref["nn_cli"] = [json.loads(ln)["loss"] for ln in f
                             if json.loads(ln)["kind"] == "step"]
    rng = np.random.default_rng(30)
    a = RANKS_ALS
    ref["als_in"] = (rng.integers(0, a["users"], a["nnz"]),
                     rng.integers(0, a["items"], a["nnz"]),
                     rng.random(a["nnz"]).astype(np.float32) * 4 + 1)
    coo = mt.CoordinateMatrix(*ref["als_in"], shape=(a["users"],
                                                     a["items"]))
    model = coo.als(rank=a["rank"], iterations=a["iters"], lam=0.05,
                    shard=True, segment_block=a["block"])
    ref["als"] = (model.user_features.logical().clone(),
                  model.product_features.logical().clone())
    n, e = RANKS_PR["n"], RANKS_PR["e"]
    ref["pr_edges"] = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)],
                               axis=1)
    ref["pr"] = pagerank(build_transition_operator(ref["pr_edges"], n=n),
                         iterations=RANKS_PR["iters"])
    torch.cuda.synchronize()
    return ref


def mla_path(torch, tt, fa, ops, smi) -> dict:
    """Phase 32: the flash forward, dK/dV and dQ kernels at DeepSeek-V2's
    (192, 128) widths against the plain versions at 16 x 32768, f32 and
    bf16 (check_flash's and check_bwd's cases and bounds, each kernel's
    launches counted from 0), then one ``TransformerLM.deepseek`` train
    step at the dsv2_lite cell's widths and settings: the flash kernels
    launch twice a layer forward (remat) and once a layer for dK/dV and dQ,
    and the loss is the one random weights give. Returns that step's
    launches."""
    log(f"phase 32: the flash kernels at (q/k {MLA_DQK}, v {MLA_DV}), "
        f"H={MLA_HEADS} P={MLA_SEQ} causal, against the plain versions; one "
        f"DeepSeek-V2-Lite train step {DSV2}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        ops.reset_launch_counts()
        check_flash(torch, fa, gen, MLA_HEADS, MLA_SEQ, MLA_DQK, MLA_SEQ - 1,
                    dtype, dv=MLA_DV)
        _, r = check_bwd(torch, fa, gen, f"({MLA_DQK}, {MLA_DV}) H={MLA_HEADS}"
                         f" P={MLA_SEQ} valid={MLA_SEQ - 1} {dt}", MLA_HEADS,
                         MLA_SEQ, MLA_DQK, MLA_SEQ - 1, dtype, dv=MLA_DV)
        worst = max(worst, r)
        counts = ops.launch_counts()
        # one panel, the single panel, two panels; one of each backward;
        # bf16 forwards on the wgmma design, f32 on mma.sync
        want = {"flash_attention_panel": 4, "flash_attention_bwd_dkv": 1,
                "flash_attention_bwd_dq": 1}
        want_wgmma = 4 if dtype == torch.bfloat16 else 0
        wgmma = fa.flash_attention_panel.launches_wgmma
        if any(counts[k] != n for k, n in want.items()) \
                or wgmma != want_wgmma:
            raise AssertionError(f"phase 32 {dt}: launches {counts}, wgmma "
                                 f"{wgmma}, want {want}, wgmma {want_wgmma}")
        log(f"  {dt} launches {want}, of the forward's on wgmma {wgmma}")
        torch.cuda.empty_cache()
    log(f"  largest err/bound of the backward at ({MLA_DQK}, {MLA_DV}): "
        f"{worst:.3f}")
    from marlin_tpu_torch.models import DeepSeekConfig, adam_init

    cfg = DeepSeekConfig(**DSV2)
    model = tt.TransformerLM.deepseek(cfg, seed=32, **DSV2_STEP)
    params = model.init_params(device="cuda")
    opt = adam_init(params)
    tokens = torch.randint(0, DSV2["vocab"], (MLA_SEQ + 1,), generator=gen,
                           device="cuda")
    model.train_step(params, opt, tokens)  # builds and warms every shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, loss = model.train_step(params, opt, tokens)
    loss = float(loss)
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    wgmma = fa.flash_attention_panel.launches_wgmma
    layers = DSV2["layers"]
    want = {"flash_attention_panel": 2 * layers,
            "flash_attention_bwd_dkv": layers,
            "flash_attention_bwd_dq": layers}
    # at init the logits are normal with variance init_std^2 d_model (the
    # final norm's output has unit RMS), so the loss is log(vocab) plus
    # half that; each MoE layer's balance term is about 1 (uniform routing)
    want_loss = (math.log(DSV2["vocab"])
                 + cfg.init_std ** 2 * DSV2["d_model"] / 2
                 + DSV2_STEP["moe_aux_weight"]
                 * sum(cfg.is_moe(i) for i in range(DSV2["layers"])))
    log(f"  train step: {secs:.3f} s, loss {loss:.6f} (expected "
        f"{want_loss:.6f}), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{counts}, of the forward's on wgmma {wgmma}; {smi}")
    # every forward of the step on the wgmma design
    if any(counts[k] != n for k, n in want.items()) or wgmma != 2 * layers:
        raise AssertionError(f"phase 32: the step's launches {counts}, wgmma "
                             f"{wgmma}, want {want}, wgmma {2 * layers}")
    if not abs(loss - want_loss) < 0.02:
        raise AssertionError(f"phase 32: the step's loss {loss}, expected "
                             f"{want_loss}")
    del model, params, opt
    torch.cuda.empty_cache()
    return counts


def matrices_ranks_path(torch, np, mt, ops, smi) -> dict:
    """Phase 31: the matrices across ranks (rank-local blocks, the RMM on
    blocks, linalg on row blocks, sharded checkpoints, the sparse
    conversion and its BSR product) in a one-rank NCCL world, each against
    the world-of-one path on the same logical inputs. Returns the kernels'
    launch counts of the phase."""
    import tempfile

    import torch.distributed as dist

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.io import checkpoint as ck

    log(f"phase 31: the matrices across ranks in a one-rank NCCL world: "
        f"{N}^2 random + multiply, LU/Cholesky at {LINALG_N}^2, dist-eigs at "
        f"{SVD_M} x {SVD_N}, save/load_sharded at {N}^2, "
        f"to_sparse_vec_matrix and multiply(format='bsr') at {RANKS_SPARSE}; "
        f"{smi}")
    for p in MATRIX_RANKS:
        log(f"  a rank's block of an {N}^2 f32 DenseVecMatrix at p = {p} "
            f"(analytic): {N * N * 4 / p / 1e6:g} MB")
    one = mm.Mesh(torch.device("cuda"))  # the world of one: no ranks
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        mm.initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            mesh = mm.create_mesh((1, 1))
            if dist.get_backend() != "nccl" or mesh.ranks != (0,):
                raise AssertionError("phase 31: not an NCCL rank mesh")
            ad, bd, cd, rank_times = matrices_multiply(torch, mt, mesh)
            matrices_linalg(torch, np, mt, mesh, one)
            path = os.path.join(tmp, "sharded")
            m = mt.DenseVecMatrix.random(3, N, N, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save_sharded(m, path)
            back = ck.load_sharded(path, m.sharding)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not torch.equal(back, m.data):
                raise AssertionError("phase 31: load_sharded over the rank "
                                     "mesh differs from what was saved")
            del back
            counts = dict(ops.launch_counts())
            sp, *sparse, sp_counts = matrices_sparse(torch, mt, ops, mesh)
            counts = {k: counts[k] + n for k, n in sp_counts.items()}
            from marlin_tpu_torch.ops import sparse_bsr as sb

            check_bsr(torch, sb, f"phase 31's BSR at {RANKS_SPARSE['n']}^2",
                      sp.to_bsr(), sparse[1])
        finally:
            mm.shutdown_distributed()
        if dist.is_initialized():
            raise AssertionError("phase 31: the process group is still up")
        # outside the world a matrix of the world of one multiplies alone
        matrices_world_of_one(torch, mt, one, ad, bd, cd, rank_times)
        del ad, bd, cd
        whole = ck.load_sharded(path)
        if not torch.equal(whole, m.data):  # one rank's block is the whole
            raise AssertionError("phase 31: the one-rank save restored into "
                                 "the world of one differs")
        log(f"  save_sharded + load_sharded {N}^2 over the rank mesh: "
            f"{dt:.3f} s, bit-identical; restored outside the world "
            f"bit-identical")
        del m, whole
    matrices_sparse_world_of_one(torch, np, mt, one, *sparse,
                                 sp._coo_triplets())
    del sp, sparse
    torch.cuda.empty_cache()
    log(f"  phase 31 launches (the world's products): {counts}")
    return counts


def matrices_sparse(torch, mt, ops, mesh):
    """Phase 31 (e), in the world: RANKS_SPARSE's rank-local matrix through
    ``to_sparse_vec_matrix`` and its BSR product by a rank-local operand (a
    first call, which converts and tunes, then one timed). Returns the
    sparse matrix, the operands' and the product's logical matrices
    (gathered over the ranks), the figures (the conversion's s, the timed
    product's CUDA-event ms, host ms and peak GiB, the BSR kernel's
    launches by each call) and the launch counts of the two calls. Raises
    unless the timed product launched the BSR kernel."""
    s = RANKS_SPARSE
    m = mt.DenseVecMatrix.random(7, s["n"], s["n"], mesh=mesh)
    b = mt.DenseVecMatrix.random(8, s["n"], s["p"], mesh=mesh)
    torch.cuda.synchronize()
    torch.distributed.barrier()  # each timed call starts on every rank at once
    t0 = time.perf_counter()
    sp = m.to_sparse_vec_matrix(s["tol"])
    torch.cuda.synchronize()
    conv = time.perf_counter() - t0
    ops.reset_launch_counts()
    sp.multiply(b, format="bsr")  # the BSR conversion, the tuning, a product
    first = dict(ops.launch_counts())
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    out, ev, host, peak = _timed_ms(torch, lambda: sp.multiply(
        b, format="bsr"))
    timed = dict(ops.launch_counts())
    fig = dict(to_sparse_s=conv, ms=ev, host_ms=host, peak_gib=peak,
               first_launches=first["bsr_spmm_pallas"],
               launches=timed["bsr_spmm_pallas"])
    log(f"  to_sparse_vec_matrix({s['tol']}) of {s['n']}^2 over the rank "
        f"mesh: nnz {sp.nnz} in {conv:.3f} s; multiply(format='bsr') by "
        f"{s['n']} x {s['p']}: block {tuple(out.data.shape)}, {ev:.3f} ms "
        f"(CUDA events), {host:.3f} ms host, peak +{peak:.2f} GiB; BSR "
        f"kernel launches: {fig['first_launches']} by the first call (the "
        f"tuner's and its product), {fig['launches']} by the timed product")
    if fig["launches"] < 1:
        raise AssertionError("phase 31: the rank mesh's BSR product did not "
                             "launch the BSR kernel")
    return sp, m.logical(), b.logical(), out.logical(), fig, \
        {k: first[k] + timed[k] for k in first}


def matrices_sparse_world_of_one(torch, np, mt, one, md, bd, od, fig,
                                 triplets):
    """Phase 31 (e), outside the world: the same conversion and product in
    the world of one on the rank mesh's logical matrices ``md``, ``bd``,
    held against the rank mesh's triplets and product ``od``. Returns the
    world of one's product ms (CUDA events) and the largest relative
    difference."""
    s = RANKS_SPARSE
    sp1 = mt.DenseVecMatrix.from_array(md, one).to_sparse_vec_matrix(s["tol"])
    if not all(np.array_equal(g, w) for g, w in
               zip(triplets, sp1._coo_triplets())):
        raise AssertionError("phase 31: to_sparse_vec_matrix's triplets "
                             "differ from the world of one's")
    b1 = mt.DenseVecMatrix.from_array(bd, one)
    sp1.multiply(b1, format="bsr")
    out1, ev1, _, _ = _timed_ms(torch, lambda: sp1.multiply(
        b1, format="bsr"))
    rel = float((od - out1.data).abs().max()) / float(out1.data.abs().max())
    log(f"  the world of one: triplets equal; multiply(format='bsr') "
        f"{ev1:.3f} ms (CUDA events) against the rank mesh's "
        f"{fig['ms']:.3f}; the rank product's max rel diff {rel:.3e} (tol "
        f"{F64_TOL})")
    if not rel <= F64_TOL:
        raise AssertionError(f"phase 31: the sparse product differs: {rel}")
    return ev1, rel


def _timed_ms(torch, fn):
    """(result, CUDA-event ms, host ms, peak GiB above the start) of one
    call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return out, start.elapsed_time(end), host, peak


def matrices_multiply(torch, mt, mesh):
    """Phase 31 (a), in the world: the N² draws and the multiply over the
    rank mesh (a warm-up call, then one timed), beside the logical in/out
    RMM over the same world (``parallel.rmm_matmul``: C gathered whole, the
    path a matrix's multiply over ranks took before its blocks). Returns
    the operands' and the product's blocks (the whole matrices at p = 1)
    and the rank multiply's (ms, host ms, peak GiB)."""
    from marlin_tpu_torch.parallel import rmm_matmul

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = mt.DenseVecMatrix.random(0, N, N, mesh=mesh)
    b = mt.DenseVecMatrix.random(1, N, N, mesh=mesh)
    torch.cuda.synchronize()
    draw = time.perf_counter() - t0
    held = a.data.numel() * a.data.element_size()
    if tuple(a.data.shape) != (N, N):
        raise AssertionError(f"phase 31: a one-rank block {a.data.shape}")
    log(f"  two {N}^2 threefry draws over the rank mesh: {draw:.3f} s; a "
        f"rank holds {held / 1e6:g} MB of each (measured, p = 1)")
    a.multiply(b, precision="high")  # warm-up: the rank grid's groups
    c, ev, host, peak = _timed_ms(torch, lambda: a.multiply(
        b, precision="high"))
    if c.data.shape != (N, N) or not bool(torch.isfinite(c.data).all()):
        raise AssertionError("phase 31: the rank product is bad")
    log(f"  multiply over the rank mesh (RMM on blocks): {ev:.3f} ms (CUDA "
        f"events), {host:.3f} ms host, peak +{peak:.2f} GiB")
    c_log, ev_l, host_l, peak_l = _timed_ms(torch, lambda: rmm_matmul(
        a.data, b.data, precision="high"))
    if not torch.equal(c_log, c.data):
        raise AssertionError("phase 31: the logical RMM differs")
    log(f"  the logical in/out RMM over the same world (C gathered): "
        f"{ev_l:.3f} ms, {host_l:.3f} ms host, peak +{peak_l:.2f} GiB; "
        f"equal bit for bit")
    del c_log
    torch.cuda.empty_cache()
    return a.data, b.data, c.data, (ev, host, peak)


def matrices_world_of_one(torch, mt, one, ad, bd, cd, rank_times) -> None:
    """Phase 31 (a), outside the world: the world of one's multiply of the
    same logical inputs against the rank product, timed alike."""
    a1 = mt.DenseVecMatrix.from_array(ad, one)
    b1 = mt.DenseVecMatrix.from_array(bd, one)
    a1.multiply(b1, precision="high")  # warm-up
    c1, ev1, host1, peak1 = _timed_ms(torch, lambda: a1.multiply(
        b1, precision="high"))
    scale = float(c1.data.abs().max())
    rel = float((cd - c1.data).abs().max()) / scale
    ev, host, _ = rank_times
    log(f"  the world of one: {ev1:.3f} ms (CUDA events), {host1:.3f} ms "
        f"host, peak +{peak1:.2f} GiB; the rank mesh's {ev / ev1:.4f}x its "
        f"time; max rel diff {rel:.3e} (tol {F64_TOL})")
    if not rel <= F64_TOL:
        raise AssertionError(f"phase 31: the rank multiply differs: {rel}")


def matrices_linalg(torch, np, mt, mesh, one) -> None:
    """Phase 31 (b, c): phase 16's LU legs and Cholesky and phase 17's
    dist-eigs SVD and lr on row blocks against the logical path, the same
    logical matrices."""
    # warm-up: each path's first factorization and eigh in the process
    # carry the solver libraries' set-up, so neither is timed cold
    w = 1024
    gen = torch.Generator(device="cuda").manual_seed(310)
    tall = torch.randn((w, 64), device="cuda", generator=gen)
    for where in (mesh, one):
        small = mt.BlockMatrix.from_array(torch.eye(w, device="cuda") * 2,
                                          where)
        small.lu_decompose(mode="dist", block_size=128)
        small.cholesky_decompose(mode="dist", block_size=128)
        mt.DenseVecMatrix.from_array(tall, where).compute_svd(
            4, mode="dist-eigs")
    torch.cuda.synchronize()
    n = LINALG_N
    eye = torch.eye(n, device="cuda")
    a = mt.BlockMatrix.random(0, n, n, mesh=mesh).add(
        mt.BlockMatrix.from_array(n * eye, mesh))
    a1 = mt.BlockMatrix.from_array(a.logical(), one)
    scale = float(a1.data.abs().max())

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for sched, piv in LU_LEGS:
        (l, u, p), dt = run(lambda: a.lu_decompose(
            mode="dist", schedule=sched, pivot=piv))
        (l1, u1, p1), dt1 = run(lambda: a1.lu_decompose(
            mode="dist", schedule=sched, pivot=piv))
        if not torch.equal(p, p1):
            raise AssertionError(f"phase 31 LU {sched}/{piv}: perm differs")
        err = max(float((l.logical() - l1.data).abs().max()),
                  float((u.logical() - u1.data).abs().max()))
        linalg_close(f"LU {sched}/{piv} on row blocks {dt:.3f} s, logical "
                     f"{dt1:.3f} s; L, U vs logical", err, scale)
        del l, u, p, l1, u1, p1
    r = mt.BlockMatrix.from_array(torch.randn(
        (n, n), device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(31)), one)
    spd1 = r.multiply(r.transpose(), precision="high").add(
        mt.BlockMatrix.from_array(n * eye, one))
    spd = mt.BlockMatrix.from_array(spd1.data, mesh)
    del r
    s_scale = float(spd1.data.abs().max())
    for sched in CHOL_LEGS:
        l, dt = run(lambda: spd.cholesky_decompose(
            mode="dist", schedule=sched))
        l1, dt1 = run(lambda: spd1.cholesky_decompose(
            mode="dist", schedule=sched))
        linalg_close(f"Cholesky {sched} on row blocks {dt:.3f} s, logical "
                     f"{dt1:.3f} s; L vs logical",
                     float((l.logical() - l1.data).abs().max()), s_scale)
        del l, l1
    del a, a1, spd, spd1, eye
    torch.cuda.empty_cache()
    m_svd = mt.DenseVecMatrix.random(0, SVD_M, SVD_N, mesh=mesh)
    m1 = mt.DenseVecMatrix.from_array(m_svd.logical(), one)
    svd, dt = run(lambda: m_svd.compute_svd(SVD_K, mode="dist-eigs",
                                                   compute_u=False))
    svd1, dt1 = run(lambda: m1.compute_svd(SVD_K, mode="dist-eigs",
                                                  compute_u=False))
    linalg_close(f"compute_svd dist-eigs on row blocks {dt:.3f} s, logical "
                 f"{dt1:.3f} s; s vs logical",
                 float(np.abs(svd.s - svd1.s).max()), float(svd1.s[0]))
    del m_svd, m1
    torch.cuda.empty_cache()
    # lr on row blocks: the fused step's gradient goes through the rank
    # all-reduce between the kernel's sum and its update; over one rank that
    # sum is exact, so the weights equal the world of one's bit for bit
    from marlin_tpu_torch.ops import lr_gradient as lg

    rows = torch.rand((LR_M, LR_D + 1), device="cuda", generator=gen) * 2 - 1
    rows[:, 0] = (rows[:, 0] > 0).float()
    before = lg.lr_step.launches
    w_rank = mt.DenseVecMatrix.from_array(rows, mesh).lr(1.0, 20)
    launches = lg.lr_step.launches - before
    w_one = mt.DenseVecMatrix.from_array(rows, one).lr(1.0, 20)
    if launches != 20 or not np.array_equal(w_rank, w_one):
        raise AssertionError(f"phase 31 lr on row blocks: {launches} fused "
                             f"launches, max diff "
                             f"{float(np.abs(w_rank - w_one).max())}")
    log(f"  lr (20 iterations) on {LR_M} x {LR_D + 1} row blocks: {launches} "
        f"fused launches, weights equal to the world of one's bit for bit")
    del rows


def ranks_path(torch, np, mt, tt, ops, lct_run, smi) -> dict:
    """Phase 30: the workloads across ranks (the sequence-sharded trainer,
    the expert-parallel MoE trainer, the (dp, tp) MLP CLI, blocked ALS and
    edge-sharded PageRank) in a one-rank NCCL world, each against its
    logical or plain run. Returns the launch counts of the rank paths."""
    import contextlib
    import io
    import json
    import tempfile

    import torch.distributed as dist

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.examples import distributed_training
    from marlin_tpu_torch.ml import build_transition_operator, pagerank

    stream, params0, params_ref, losses_ref = lct_run
    log(f"phase 30: the workloads across ranks in a one-rank NCCL world: "
        f"config_lct sharded ({', '.join(RANKS_ATTN)}), config_moe "
        f"expert-parallel, distributed_training {' '.join(RANKS_NN_CLI)}, "
        f"ALS {RANKS_ALS}, PageRank {RANKS_PR}; {smi}")
    t_ref = time.perf_counter()
    ref = ranks_references(torch, np, mt, tt)
    log(f"  the plain runs (outside the world): "
        f"{time.perf_counter() - t_ref:.1f} s")
    counts = dict.fromkeys(ops.launch_counts(), 0)

    def add():
        for k, n in ops.launch_counts().items():
            counts[k] += n

    lr = tt.TransformerLM.learning_rate
    log_shard_bytes(torch, mm, tt)
    with tempfile.TemporaryDirectory() as tmp:
        mm.initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            mesh = mm.create_mesh((1, 1))
            if dist.get_backend() != "nccl" or mesh.ranks != (0,):
                raise AssertionError("phase 30: not an NCCL rank mesh")
            # (a) config_lct with the stream sharded over the ranks
            for attn in RANKS_ATTN:
                lm = tt.TransformerLM(**LCT, attn=attn)
                lm.train(stream, steps=1, mesh=mesh, params=params0)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                params, losses = lm.train(stream, steps=TRAIN_STEPS,
                                          mesh=mesh, params=params0)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / TRAIN_STEPS
                got = ops.launch_counts()
                add()
                for kname in ("flash_attention_panel",
                              "flash_attention_bwd_dkv",
                              "flash_attention_bwd_dq"):
                    if got[kname] != LCT["layers"] * TRAIN_STEPS:
                        raise AssertionError(
                            f"phase 30 {attn}: {kname} launched "
                            f"{got[kname]} times, want one a layer a step")
                worst = losses_close(f"phase 30 {attn}", losses, losses_ref)
                note = params_close(f"phase 30 {attn}", params, params_ref,
                                    params0, lr)
                shards = tt._seq_shards(mesh, TRAIN_SEQ - 1, attn,
                                        LCT["d_model"] // LCT["heads"],
                                        "cuda")
                log(f"  config_lct {attn} over the ranks: losses {losses} "
                    f"(phase 11 {losses_ref}; largest rel diff "
                    f"{worst:.3e}, tol {TRAIN_LOSS_RTOL:g}); params {note}; "
                    f"{dt * 1e3:.3f} ms a step (host clock); this rank's "
                    f"block {shards.rows} of {shards.padded} rows; launches "
                    f"{got}")
                del params
            # (b) config_moe's experts over the ranks: one step's loss and
            # gradients (phase 26's test), then TRAIN_STEPS Adam steps
            moe = tt.TransformerLM(**MOE_LM)
            ops.reset_launch_counts()
            loss_g, grads = tt.lm_value_and_grad(ref["moe_params0"], stream,
                                                 mesh, **moe_knobs())
            want_loss, want_grads = ref.pop("moe_grads")
            fg, fw = flat(grads), flat(want_grads)
            grad_worst = {k: float((fg[k] - g).abs().max())
                          / max(float(g.abs().max()), 1e-30)
                          for k, g in fw.items()}
            worst_leaf = max(grad_worst, key=grad_worst.get)
            log(f"  config_moe expert-parallel, one step: loss "
                f"{float(loss_g)!r} (logical {float(want_loss)!r}); "
                f"gradients: largest |ranks - logical| / max|logical| "
                f"{grad_worst[worst_leaf]:.3e} ({worst_leaf}; tol "
                f"{TRAIN_GRAD_TOL:g})")
            if abs(float(loss_g) - float(want_loss)) > TRAIN_LOSS0_RTOL * \
                    abs(float(want_loss)) or not \
                    grad_worst[worst_leaf] <= TRAIN_GRAD_TOL:
                raise AssertionError("phase 30: config_moe's step differs")
            del grads, want_grads, fg, fw
            t0 = time.perf_counter()
            params, losses = moe.train(stream, steps=TRAIN_STEPS, mesh=mesh,
                                       params=ref["moe_params0"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / TRAIN_STEPS
            got = ops.launch_counts()
            add()
            want_params, want_losses = ref.pop("moe")
            worst = losses_close("phase 30 config_moe", losses, want_losses)
            fg, fw, f0 = (flat(t) for t in (params, want_params,
                                            ref["moe_params0"]))
            lr = moe.learning_rate
            off = {k: int(((fg[k] - w).abs() > lr / 10).sum())
                   for k, w in fw.items()}
            diff = math.sqrt(sum(float(((fg[k] - w) ** 2).sum())
                                 for k, w in fw.items()))
            moved = math.sqrt(sum(float(((w - f0[k]) ** 2).sum())
                                  for k, w in fw.items()))
            log(f"  config_moe expert-parallel, {TRAIN_STEPS} steps: losses "
                f"{losses} (logical {want_losses}; largest rel diff "
                f"{worst:.3e}); params past lr/10 by leaf "
                f"{ {k: n for k, n in off.items() if n} }, difference "
                f"{diff / moved:.3e} of the distance moved; "
                f"{dt * 1e3:.3f} ms a step (host clock, no warm-up); "
                f"launches {got}")
            del params, want_params, fg, fw, f0
            torch.cuda.empty_cache()
            # (c) the (dp, tp) MLP CLI at (1, 1)
            ops.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                distributed_training.main([*RANKS_NN_CLI, tmp + "/nn"])
            add()
            lines = buf.getvalue().splitlines()
            for ln in lines:
                log(f"    | {ln}")
            with open(os.path.join(tmp, "nn", "rank0", "events.jsonl")) as f:
                nn_losses = [json.loads(ln)["loss"] for ln in f
                             if json.loads(ln)["kind"] == "step"]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(nn_losses, ref["nn_cli"]))
            log(f"  distributed_training at (1, 1): {len(nn_losses)} step "
                f"losses, largest rel diff {rel:.3e} against the CLI outside "
                f"the world (tol {RANKS_TOL:g})")
            if not (lines[0] == "mesh: 1 data-parallel x 1 tensor-parallel "
                                "over 1 devices"
                    and len(nn_losses) == len(ref["nn_cli"])
                    and rel <= RANKS_TOL):
                raise AssertionError(f"phase 30: distributed_training "
                                     f"{lines} {rel}")
            # (d) blocked ALS, the blocks over the ranks
            a = RANKS_ALS
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            coo = mt.CoordinateMatrix(*ref["als_in"],
                                      shape=(a["users"], a["items"]),
                                      mesh=mesh)
            model = coo.als(rank=a["rank"], iterations=a["iters"], lam=0.05,
                            shard=True, segment_block=a["block"])
            got_u = model.user_features.logical()
            got_v = model.product_features.logical()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            add()
            errs = [float((g - w).abs().max()) / float(w.abs().max())
                    for g, w in zip((got_u, got_v), ref["als"])]
            log(f"  ALS over the ranks: {dt:.3f} s; factors vs the plain "
                f"blocked run {errs[0]:.3e} / {errs[1]:.3e} of the largest "
                f"entry (tol {RANKS_TOL:g}); rmse {model.rmse(coo):.6f}")
            if not max(errs) <= RANKS_TOL:
                raise AssertionError(f"phase 30 ALS: {errs}")
            del coo, model, got_u, got_v
            # (e) PageRank, the edges over the ranks
            n = RANKS_PR["n"]
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            op = build_transition_operator(ref["pr_edges"], n=n, mesh=mesh)
            r = pagerank(op, iterations=RANKS_PR["iters"])
            dt = time.perf_counter() - t0
            add()
            rel = float(np.abs(r - ref["pr"]).max()) / float(ref["pr"].max())
            log(f"  PageRank over the ranks: {n} nodes, {op.nnz} edges on "
                f"this rank, {dt:.3f} s with the host build; vs the plain "
                f"operator {rel:.3e} of the largest rank (tol {RANKS_TOL:g})")
            if not rel <= RANKS_TOL:
                raise AssertionError(f"phase 30 PageRank: {rel}")
            del op
        finally:
            mm.shutdown_distributed()
    if mm.distributed():
        raise AssertionError("phase 30: the process group is still up")
    log(f"  phase 30 launches: {counts}")
    for kname in ("flash_attention_panel", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
        if counts[kname] <= 0:
            raise AssertionError(f"phase 30: {kname} never launched")
    torch.cuda.empty_cache()
    return counts


def lct_reference(torch, np, tt):
    """Phase 11's uninterrupted run, for a run of phase 23 without phase 11:
    (stream, initial params, params and losses after TRAIN_STEPS steps)."""
    lct = tt.TransformerLM(**LCT)
    stream = np.random.default_rng(0).integers(
        0, LCT["vocab"], TRAIN_SEQ).astype(np.int32)
    params0 = lct.init_params()
    lct.train(stream, steps=1, params=params0)  # warm-up, as phase 11
    params, losses = lct.train(stream, steps=TRAIN_STEPS, params=params0)
    return stream, params0, params, losses


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="run the build, then only these of phases 19-32 "
                         "(comma-separated; 20 runs 19 first), and print no "
                         "result lines")
    only = ap.parse_args().phases
    only = None if only is None else {int(p) for p in only.split(",")}
    if only is not None and not only <= set(range(19, 33)):
        ap.error("--phases takes a subset of 19,20,...,32")
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
    marks = [t_start]

    def lap(phases: str) -> None:
        """Log the wall time since the last lap."""
        now = time.perf_counter()
        log(f"{phases} wall: {now - marks[0]:.1f} s")
        marks[0] = now

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
    for lib in ("kernels", "lr"):
        t0 = time.perf_counter()
        _build.load_library(lib)
        log(f"build of the {lib} library: {time.perf_counter() - t0:.1f} s "
            f"into {_build.build_dir(lib)}")
        for line in _build.ptxas_report(lib).splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "wgmma" in line:
                log("  " + line.strip())

    lap("phases 1-2")
    if only is not None:
        import numpy as np

        from marlin_tpu_torch.models import transformer as tt
        from marlin_tpu_torch.ops import paged_attention as pa

        if only & {19, 20}:
            mlp_params = ml_path(torch, np, mt, ops, smi)
            lap("phase 19")
        if 20 in only:
            programs_path(torch, np, tt, pa, mlp_params, smi)
            lap("phase 20")
        if 21 in only:
            out_of_core_path(torch, np, mt, smi)
            lap("phase 21")
        if 22 in only:
            disk_path(torch, np, mt, smi)
            lap("phase 22")
        if 23 in only:
            checkpoint_path(torch, np, mt, tt, lct_reference(torch, np, tt),
                            smi)
            lap("phase 23")
        if 24 in only:
            cli_path(torch, np, mt, ops, pa, smi)
            lap("phase 24")
        if 25 in only:
            fleet_path(torch, np, mt, tt, ops, pa, smi)
            lap("phase 25")
        if only & {26, 27, 29}:
            from marlin_tpu_torch.ops import flash_attention as fa
        if 26 in only:
            moe_path(torch, np, tt, fa, pa, ops, smi)
            lap("phase 26")
        if 27 in only:
            slab_path(torch, np, tt, fa, pa, ops, smi)
            lap("phase 27")
        if 28 in only:
            fuse_path(torch, np, mt, smi)
            lap("phase 28")
        if 29 in only:
            collectives_path(torch, np, mt, tt, fa, ops, smi)
            lap("phase 29")
        if 30 in only:
            ranks_path(torch, np, mt, tt, ops, lct_reference(torch, np, tt),
                       smi)
            lap("phase 30")
        if 31 in only:
            matrices_ranks_path(torch, np, mt, ops, smi)
            lap("phase 31")
        if 32 in only:
            from marlin_tpu_torch.ops import flash_attention as fa

            mla_path(torch, tt, fa, ops, smi)
            lap("phase 32")
        log(f"phases {sorted(only)}: every check passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
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

    lap("phase 3")
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

    lap("phase 4")
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

    lap("phase 5")
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

    lap("phase 6")
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

    lap("phase 7")
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
    serve_bucket_ms = decode_s / steps * 1e3
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

    lap("phase 8")
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

    lap("phase 9")
    bwd_errs, bwd_worst = backward_checks(torch, fa, gen)
    lap("phase 10")
    train_counts, lct_run = train_path(torch, np, tt, fa, ops)
    lap("phase 11")
    t = train_times(torch, fa, gen, _build)
    lap("phase 12")
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
    lap("phase 13 (and the main shape's blocks)")
    sparse_counts = sparse_path(torch, np, mt, sb, autotune, ops, main_bsr,
                                main_b, data)
    lap("phase 14")
    tb = bsr_times(torch, np, sb, pk, main_bsr, main_b)
    lap("phase 15")
    del main_bsr, main_b, data
    torch.cuda.empty_cache()
    lr = linalg_path(torch, np, mt, ops)["lr"]
    lap("phases 16-17")
    engine_launches, engine_combines = engine_path(
        torch, np, tt, ops, pa, prompts, streams, serve_bucket_ms, smi)
    lap("phase 18")
    mlp_params = ml_path(torch, np, mt, ops, smi)
    lap("phase 19")
    ops.reset_launch_counts()
    prog_split, prog_combines = programs_path(torch, np, tt, pa, mlp_params,
                                              smi)
    if ops.launch_counts()["paged_decode_attention"] != prog_split:
        raise AssertionError("phase 20: the paged launch count disagrees")
    lap("phase 20")
    del mlp_params
    torch.cuda.empty_cache()
    out_of_core_path(torch, np, mt, smi)
    lap("phase 21")
    disk_path(torch, np, mt, smi)
    lap("phase 22")
    checkpoint_path(torch, np, mt, tt, lct_run, smi)
    lap("phase 23")
    cli = cli_path(torch, np, mt, ops, pa, smi)
    lap("phase 24")
    fleet_split, fleet_combines = fleet_path(torch, np, mt, tt, ops, pa, smi)
    lap("phase 25")
    moe_train, moe_serve = moe_path(torch, np, tt, fa, pa, ops, smi)
    lap("phase 26")
    slab_counts, slab_paged = slab_path(torch, np, tt, fa, pa, ops, smi)
    lap("phase 27")
    late_combines = moe_serve["paged_combine"] + slab_paged["paged_combine"]
    fuse_path(torch, np, mt, smi)
    lap("phase 28")
    lc29 = collectives_path(torch, np, mt, tt, fa, ops, smi)
    lap("phase 29")
    lc30 = ranks_path(torch, np, mt, tt, ops, lct_run, smi)
    del lct_run
    lap("phase 30")
    lc31 = matrices_ranks_path(torch, np, mt, ops, smi)
    lap("phase 31")
    lc32 = mla_path(torch, tt, fa, ops, smi)
    lap("phase 32")
    late = {k: moe_train[k] + moe_serve[k] + slab_counts[k] + slab_paged[k]
            + lc29[k] + lc30[k] + lc31[k] + lc32[k] for k in moe_train}
    paged_launches = path_counts["paged_decode_attention"] + \
        engine_launches + prog_split + cli["paged_decode_attention"] + \
        fleet_split + late["paged_decode_attention"]
    combines = paged_combines + engine_combines + prog_combines + \
        cli["paged_combine"] + fleet_combines + late_combines
    log(f"paged kernel launches on the main paths: split {paged_launches} "
        f"(phase 8 {path_counts['paged_decode_attention']}, phase 18 "
        f"{engine_launches}, phase 20 {prog_split}, phase 24 "
        f"{cli['paged_decode_attention']}, phase 25 {fleet_split}, phase 26 "
        f"{moe_serve['paged_decode_attention']}, phase 27 "
        f"{slab_paged['paged_decode_attention']}); combine {combines} (phase "
        f"8 {paged_combines}, phase 18 {engine_combines}, phase 20 "
        f"{prog_combines}, phase 24 {cli['paged_combine']}, phase 25 "
        f"{fleet_combines}, phases 26-27 {late_combines})")
    for kname, before in (
            ("flash_attention_panel", path_counts["flash_attention_panel"]),
            ("flash_attention_bwd_dkv", train_counts["flash_attention_bwd_dkv"]),
            ("flash_attention_bwd_dq", train_counts["flash_attention_bwd_dq"]),
            ("bsr_spmm_pallas", sparse_counts["bsr_spmm_pallas"])):
        log(f"{kname} launches on the main paths: "
            f"{before + cli[kname] + late[kname]} (phases 8/11/14 {before}, "
            f"phase 24 {cli[kname]}, phase 26 {moe_train[kname]}, phase 27 "
            f"{slab_counts[kname]}, phase 29 {lc29[kname]}, phase 30 "
            f"{lc30[kname]}, phase 31 {lc31[kname]}, phase 32 "
            f"{lc32[kname]})")

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
         "launches": paged_launches,
         "max_abs_err": paged_err, "ms": ms_paged, "plain_ms": plain_paged,
         "bound_ms": bound_paged, "bound_by": "bytes", "library_ms": lib_paged},
        {"name": "flash_attention_panel", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention.cuh",
         "replaces": "marlin_tpu/ops/flash_attention.py:93",
         "launches": path_counts["flash_attention_panel"]
         + cli["flash_attention_panel"] + late["flash_attention_panel"],
         "max_abs_err": flash_err, "ms": tf["ms"], "plain_ms": tf["plain"],
         "bound_ms": tf["bound"], "bound_by": "operations",
         "library_ms": tf["lib"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:195",
         "launches": train_counts["flash_attention_bwd_dkv"]
         + cli["flash_attention_bwd_dkv"] + late["flash_attention_bwd_dkv"],
         "max_abs_err": max(bwd_errs["dk"], bwd_errs["dv"]),
         "ms": t["ms_dkv"], "plain_ms": t["plain_bwd"],
         "bound_ms": t["bound_dkv"], "bound_by": "operations",
         "library_ms": t["lib_bwd"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:232",
         "launches": train_counts["flash_attention_bwd_dq"]
         + cli["flash_attention_bwd_dq"] + late["flash_attention_bwd_dq"],
         "max_abs_err": bwd_errs["dq"], "ms": t["ms_dq"],
         "plain_ms": t["plain_bwd"], "bound_ms": t["bound_dq"],
         "bound_by": "operations",
         "library_ms": t["lib_bwd"]},
        {"name": "bsr_spmm_pallas", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/bsr_spmm.cu",
         "replaces": "marlin_tpu/ops/sparse_bsr.py:203",
         "launches": sparse_counts["bsr_spmm_pallas"]
         + cli["bsr_spmm_pallas"] + late["bsr_spmm_pallas"],
         "max_abs_err": bsr_err, "ms": tb["ms"], "plain_ms": tb["plain"],
         "bound_ms": tb["bound"], "bound_by": "operations",
         "library_ms": tb["lib"]},
        {"name": "lr_step", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/lr_gradient.cuh",
         "replaces": "none (marlin_tpu/ml/logistic_regression.py _lr_fori's "
                     "two mat-vecs, left to XLA)",
         "launches": lr["launches"] + cli["lr_step"],
         "max_abs_err": lr["err"], "ms": lr["ms"], "plain_ms": lr["plain"],
         "bound_ms": lr["bound"], "bound_by": "bytes",
         "library_ms": lr["lib"]},
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
