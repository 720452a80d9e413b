// The two flash-attention backward kernels of one panel, hand-written for
// Hopper (sm_90a) on its tensor cores.
//
// Replaces: marlin_tpu/ops/flash_attention.py `_bwd_dkv_kernel` and
// `_bwd_dq_kernel` (both reached through `flash_attention_panel_bwd`), the
// Pallas TPU kernels of the two-pass recompute backward: probabilities are
// rebuilt per tile from the forward's logsumexp rows, so no score matrix is
// ever saved. dK/dV runs over a grid (kv blocks, q blocks) with the kv block
// outer and its accumulators resident in VMEM; dQ over (q blocks, kv blocks)
// with the q block outer.
//
// Computes, for every head h, query row i of the panel (global position
// q_offset + i) and key j (global position k_offset + j); the entry is live
// iff k_offset + j < valid_len and, when causal, q_offset + i >= k_offset + j:
//   s = (q_i . k_j) * scale in f32
//   p = live ? exp(s - lse_i) : 0
//   ds = p * (dO_i . v_j - delta_i)
//   dV_j += p . dO_i           and  dK_j += ds . q_i * scale   (kernel 1)
//   dQ_i += ds . k_j * scale                                   (kernel 2)
// with p and ds rounded to the input type before their products, as the TPU
// kernels cast them down before each dot. q, k, v, dO are f32 or bf16, q and k
// dqk wide, v and dO dv wide (dqk == dv but for latent attention's 192 and
// 128); lse and delta (H, sq) f32; dq (H, sq, dqk), dk (H, skv, dqk) and dv
// (H, skv, dv) f32 out.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): operations — 4 (dqk + dv)
// per live (query, key) pair for dK/dV (the s and dO.V recomputes, p.dO and
// ds.Q) and 4 dqk + 2 dv for dQ (s, dO.V, ds.K) — at 495 / 3 = 165 TFLOP/s
// for f32 (three TF32 passes) and 989 TFLOP/s for bf16.
//
// Design:
// - Two kernels, as on the TPU, so every output element has one writer: no
//   atomics, and the results do not change from run to run. They share one
//   body: a block keeps BR rows of two matrices resident in shared memory
//   (dK/dV: K and V of a key tile; dQ: Q and dO of a query tile) and streams
//   BC-row tiles of the other two (dK/dV: Q and dO; dQ: K and V) through a
//   ring of STAGES shared-memory buffers filled by cp.async, the next tile's
//   copy in flight while the current one computes. 8 warps. Up to d = 128
//   (Plan: BR = 128, BC = 32) warp w owns resident rows 16w..16w+15 and all
//   d output columns against every row of the streamed tile.
// - d <= 256 (DP = 256) cannot keep that plan: a warp's dK/dV accumulators
//   over 256 columns would take 256 registers a thread of the 255, and two
//   128-row resident matrices 256 KB of shared memory in f32, past the 227
//   KB a block may have. So the warps form 4 row groups x 2 column halves
//   over BR = 64 resident rows: warp w owns rows 16 (w % 4).. and output
//   columns 128 (w / 4)..+127, 128 accumulator floats as at d = 128. Both
//   warps of a pair compute the same full-width 16 x BC score tile (the
//   two score products run twice: 12 d operations per live pair for dK/dV
//   and 10 d for dQ, against 8 d and 6 d of useful work), which needs no
//   exchange through shared memory and no barrier between them. f32 streams
//   BC = 16-row tiles so the ring and its small halves fit beside the 128 KB
//   of resident rows; bf16 keeps BC = 32.
// - q/k 192 and v 128 wide (latent attention) keep the d = 128 plan, each
//   warp over both whole widths: bf16 dK/dV holds 96 + 64 accumulator
//   floats a thread, 160 against d = 128's 128, with no score product run
//   twice (in bf16 a warp's 96 dK columns of a column half would start
//   mid-way through a group of the swizzle's 8 chunks). f32 dQ streams
//   BC = 16-row tiles, so that 160 KB of resident Q and dO, the ring and its
//   small halves fit in a block's 227 KB. f32 dK/dV at 160 accumulator
//   floats spilled 48 bytes (ptxas -O1, 255 registers), so it takes the
//   column halves of d = 256: 64 resident rows, 96 + 64 columns a warp (80
//   floats), 32-row tiles; 96 f32 columns are 24 chunks, whole groups of 8.
// - Products on the tensor cores with mma.sync (m16n8k8 TF32, m16n8k16 bf16),
//   fragments loaded from shared memory by the threads. wgmma was not taken:
//   it reads TF32 operands from shared memory only K-major, and three of the
//   five products (p.dO, ds.Q, ds.K) contract over the rows of a tile stored
//   [row][d]; register fragments take any layout.
// - Each warp computes its score tile with the resident rows as M (dK/dV:
//   S^T = K Q^T, keys as M), so p and ds come out in the accumulator layout
//   and serve directly as the A operand of the second products (dV += P^T dO,
//   dK += dS^T Q; dQ += dS K): p and ds never touch shared memory. The
//   accumulator's column pairs (2t, 2t+1) become the A fragment's k slots
//   (t, t+4) for TF32, or its pairs for bf16, and B is loaded to match.
// - f32 inputs take three TF32 passes (tensor_core.cuh): f32 accuracy (the
//   TPU kernels pin Precision.HIGHEST; one TF32 pass would be ~1e-3 off).
//   The resident operand and p and ds are split in registers as their
//   fragments load; each streamed tile is split once for all warps as it
//   arrives, its big halves in place and its small halves in a buffer beside
//   the ring. The rounding is done with integer operations: cvt.rna.tf32
//   issues at a quarter of that rate and, with it, the splits and not the
//   products set the kernels' speed. bf16 inputs stay bf16 in shared memory
//   and take one bf16 pass; p and ds are rounded to bf16 as they are packed,
//   and each bf16 product is exact in the f32 accumulator.
// - The tensor cores do not round their f32 sums to nearest: the second
//   products add each tile's 32 rows into a fresh accumulator and that into
//   the output's in IEEE f32 (see accumulate).
// - Shared memory, f32 at d = 128: 2 x 64 KB resident + 2 stages x 2 x 16
//   KB streamed + 32 KB of small halves = 224 KB, one block per SM; bf16 96
//   KB. At d = 256, f32: 2 x 64 KB + 2 x 2 x 16 KB + 32 KB = 224 KB; bf16
//   128 KB. 16-byte chunks are XOR-swizzled by row so the fragment loads hit
//   distinct banks.
// - Registers: the dK/dV accumulators take 128 of a thread's 255. dK/dV
//   finishes dV += P^T dO before the dO.V scores, so p and ds are never both
//   held through a product, and the file is built with ptxas -O1
//   (ops/_build.py), whose schedule keeps every instance free of spills.
// - dK/dV starts each key tile's loop at the causal frontier (the first q
//   tile holding a row at or past the tile's first key), and a key tile wholly
//   past valid_len runs no iteration; dQ ends its loop at the last key tile
//   holding a live key (valid_len and the causal frontier of the tile's last
//   row). Skipping a tile with no live entry is exact: it would add p = ds =
//   0. Tiles wholly live skip the mask. The 1-D grid puts a tile's heads
//   together and the longest loops first (dK/dV's first key tiles, dQ's last
//   q tiles), so the short ones fill the tail of the launch.
// - Ragged edges (sq, skv not multiples of the tiles, d below the compiled
//   width) are zero-filled by the copies and masked; strides for q, k, v and
//   dO let the caller pass a (seq, heads, d) layout without a transposed
//   copy; offsets are 64-bit. The 16-byte copies need 16-byte-aligned base
//   pointers, strides and rows (d * element size); for other inputs the host
//   picks the same kernel with element-wise synchronous copies (VEC = false).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int STAGES = 2;

// The tile plan of an instance (see the head note), q and k DQ wide, v and
// dO DV wide: up to d = 128 and at (192, 128), 8 row groups of 16 resident
// rows, each warp over the full widths; at DQ = 256, 4 row groups x 2 column
// halves.
template <typename T, int DQ, int DV, bool DKV>
struct Plan {
  static constexpr bool F32 = std::is_same_v<T, float>;
  // column halves of the widths
  static constexpr int NCH = DQ > 192 || (F32 && DKV && DQ > 128) ? 2 : 1;
  static constexpr int DWQ = DQ / NCH;          // dK or dQ columns of a warp
  static constexpr int DWV = DV / NCH;          // dV columns of a warp
  static constexpr int NRG = NT / 32 / NCH;     // row groups of 16
  static constexpr int BR = 16 * NRG;           // resident rows of a block
  // streamed rows: f32 at 128 resident rows of more than 128 + 128
  // columns, or at DQ = 256, streams 16 to fit the block's shared memory
  static constexpr int BC = F32 && DQ > 128 && (NCH == 1 || DQ == 256) ? 16 : 32;
  static constexpr int NJ = BC / 8;  // 8-column accumulator tiles of a score tile
  // the dO.V scores at d <= 256 sum each 64 columns in a fresh accumulator
  // (score_tile's SEG): ds = p (dO.V - delta) cancels where dO.V is near
  // delta, and with the 256 columns in one accumulator a dq element whose
  // exact value is 0 came out 1.06e-5 on an H100
  static constexpr int SEG_DS = DV > 128 ? 64 / (4 * (16 / (int)sizeof(T))) : 0;
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *out0, *out1;
  int H, sq, skv, dqk, dv;
  int64_t q_sh, q_si, k_sh, k_si, v_sh, v_si, o_sh, o_si;
  int q_offset, k_offset, valid_len, causal;
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ bool is_live(int qi, int kj, const Args& a) {
  const int64_t qpos = (int64_t)a.q_offset + qi;
  const int64_t kpos = (int64_t)a.k_offset + kj;
  return qi < a.sq && kj < a.skv && kpos < a.valid_len && (!a.causal || qpos >= kpos);
}

// rows [r0, r0 + nrows) of an (n, d) matrix with row stride si into a
// swizzled [nrows][DP] tile; zeros past n and past d
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int64_t si,
                                          int r0, int nrows, int n, int d) {
  if constexpr (VEC) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CPR = DP / E;
    for (int idx = threadIdx.x; idx < nrows * CPR; idx += NT) {
      const int r = idx / CPR;
      const int c = (idx % CPR) * E;
      const int row = r0 + r;
      const bool ok = row < n && c < d;
      tc::cp_async16(dst + tc::swz_at<T, DP>(r, c), ok ? src + (int64_t)row * si + c : src,
                     ok ? 16 : 0);
    }
  } else {
    // one synchronous load in flight a thread: unrolled, the loads held at
    // once pushed the f32 d <= 256 dK/dV instance past 255 registers
#pragma unroll 1
    for (int idx = threadIdx.x; idx < nrows * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int row = r0 + r;
      dst[tc::swz_at<T, DP>(r, c)] =
          (row < n && c < d) ? src[(int64_t)row * si + c] : static_cast<T>(0.f);
    }
  }
}

// acc[j] = X[16rg + (g, g+8)] . Y[8j + g] over d: the warp's 16 x BC score
// tile. Thread t reads 16-byte chunk 4kc + t of each row; its two k steps map
// the fragment's k slots onto the chunk's elements (0, 1) and (2, 3) for
// TF32, the pairs (0-1, 2-3) and (4-5, 6-7) for bf16. The NJ accumulators
// are independent, so the products are issued pass by pass across them.
// Every row read has row % 8 == g, so chunk 4kc + t of it sits at chunk
// 4 (kc ^ b) + ((t ^ sg) & 3), sg = swz(g), b = sg / 4: an offset of 4E kc
// plus one of two per-thread constants, by the parity of kc.
// SEG > 0: the products of each SEG steps of kc go to a fresh accumulator,
// added to acc in IEEE f32 (see accumulate: the tensor cores'
// f32 sums are not rounded to nearest and drift over a long contraction).
template <typename T, int DP, int NJ, int SEG>
__device__ __forceinline__ void score_tile(float (&acc)[NJ][4], const T* X, const T* Y,
                                           const float* Ysm, int rg, int g, int t) {
  constexpr int E = 16 / (int)sizeof(T);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float part[NJ][4];
  const int sg = tc::swz(g);
  const int lo = E * ((t ^ sg) & 3) + g * DP;
  const int lo_par[2] = {lo + 4 * E * (sg >> 2), lo - 4 * E * (sg >> 2)};
  const T* xr = X + 16 * rg * DP;
#pragma unroll
  for (int kc = 0; kc < DP / (4 * E); ++kc) {
    if constexpr (SEG > 0) {
      if (kc % SEG == 0)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    }
    float(&cur)[NJ][4] = *(SEG > 0 ? &part : &acc);
    const int c = 4 * E * kc + lo_par[kc & 1];
    const uint4 xa = tc::lds128(xr + c);
    const uint4 xb = tc::lds128(xr + 8 * DP + c);
    uint4 y[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = tc::lds128(Y + 8 * j * DP + c);
    if constexpr (std::is_same_v<T, float>) {
      // the passes that read B's big halves, then the small halves' pass, so
      // the two are not held at once
      tc::Split<4> as[2];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint32_t a[4] = {st ? xa.z : xa.x, st ? xb.z : xb.x, st ? xa.w : xa.y,
                               st ? xb.w : xb.y};
        as[st] = tc::split_tf32(a);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t b[2] = {st ? y[j].z : y[j].x, st ? y[j].w : y[j].y};
          tc::mma_tf32(cur[j], as[st].small, b);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t b[2] = {st ? y[j].z : y[j].x, st ? y[j].w : y[j].y};
          tc::mma_tf32(cur[j], as[st].big, b);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = tc::lds128(Ysm + 8 * j * DP + c);
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t b[2] = {st ? y[j].z : y[j].x, st ? y[j].w : y[j].y};
          tc::mma_tf32(cur[j], as[st].big, b);
        }
    } else {
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint32_t a[4] = {st ? xa.z : xa.x, st ? xb.z : xb.x, st ? xa.w : xa.y,
                               st ? xb.w : xb.y};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t b[2] = {st ? y[j].z : y[j].x, st ? y[j].w : y[j].y};
          tc::mma_bf16(cur[j], a, b);
        }
      }
    }
    if constexpr (SEG > 0) {
      if (kc % SEG == SEG - 1)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }
}

// acc[i] += A . Y over the BC rows of Y, for the DW columns of Y (row
// stride DP) from its pointer on; A the warp's 16 x BC p or ds tile in the
// accumulator layout of score_tile. The pointer may start 128 columns in
// (the second column half at DP = 256): 128 columns are 32 (f32) or 16
// (bf16) chunks, so each chunk's swizzle and the parity of its group of four
// stay those of the offsets below. TF32: k step j takes accumulator tile
// j, slots (t, t+4) = columns (8j + 2t, 8j + 2t + 1); output tile i holds
// columns 32 (i / 4) + 4 n + i % 4, so one 16-byte read of rows 8j + 2t and
// 8j + 2t + 1 gives B for four tiles. bf16: k step jj takes tiles 2jj and
// 2jj + 1 (their pairs, in order), B by ldmatrix.trans, tile i = columns
// 8i..8i+7.
// The tensor cores add into their f32 accumulator without rounding to
// nearest, so a sum over thousands of rows in one accumulator drifts (5x
// chip_smoke's f32 bound at 32768 rows): four output tiles at a time sum
// the tile's BC rows in a fresh accumulator, which is then added to acc in
// IEEE f32.
// Rows 8j + 2t (+ 1) and 16jj + lane % 8 (+ 8) keep their swizzle over j and
// jj, so each thread's offsets are a few per-thread bases plus constants.
template <typename T, int DP, int DW, int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[DW / 8][4], const float (&A)[NJ][4],
                                           const T* Y, const float* Ysm, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float part[4][4];
  if constexpr (std::is_same_v<T, float>) {
    // column 32 ig + 4g of row r: chunk 8 ig + (g ^ swz(r))
    const int base0 = 2 * t * DP + 4 * (g ^ tc::swz(2 * t));
    const int base1 = (2 * t + 1) * DP + 4 * (g ^ tc::swz(2 * t + 1));
    tc::Split<4> as[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float af[4] = {A[j][0], A[j][2], A[j][1], A[j][3]};
      as[j] = tc::split_tf32(af);
    }
#pragma unroll
    for (int ig = 0; ig < DW / 32; ++ig) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[e][x] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int o0 = base0 + 8 * j * DP + 32 * ig;
        const int o1 = base1 + 8 * j * DP + 32 * ig;
        const uint4 u = tc::lds128(Y + o0), v = tc::lds128(Y + o1);
        const uint4 us = tc::lds128(Ysm + o0), vs = tc::lds128(Ysm + o1);
        const tc::Split<2> bs[4] = {{{u.x, v.x}, {us.x, vs.x}},
                                    {{u.y, v.y}, {us.y, vs.y}},
                                    {{u.z, v.z}, {us.z, vs.z}},
                                    {{u.w, v.w}, {us.w, vs.w}}};
        tc::mma_3xtf32<4>(part, as[j], bs);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[4 * ig + e][x] += part[e][x];
    }
  } else {
    uint32_t a[NJ / 2][4];
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      a[jj][0] = tc::pack_bf16(A[2 * jj][0], A[2 * jj][1]);
      a[jj][1] = tc::pack_bf16(A[2 * jj][2], A[2 * jj][3]);
      a[jj][2] = tc::pack_bf16(A[2 * jj + 1][0], A[2 * jj + 1][1]);
      a[jj][3] = tc::pack_bf16(A[2 * jj + 1][2], A[2 * jj + 1][3]);
    }
    // lane l reads row 16jj + l % 8 + 8 ((l / 8) % 2), chunk i + l / 16 (+ 2),
    // i a multiple of 4: at chunk 4 ((i / 4) ^ b) + ((l / 16 (+ 2)) ^ sr) % 4
    const int sr = tc::swz(lane & 7);
    const int rb = ((lane & 7) + ((lane >> 3) & 1) * 8) * DP;
    const int q0 = 8 * (((lane >> 4) ^ sr) & 3);
    const int q1 = 8 * (((2 + (lane >> 4)) ^ sr) & 3);
    const int bp = 32 * (sr >> 2);
    const int ob[2][2] = {{rb + q0 + bp, rb + q1 + bp}, {rb + q0 - bp, rb + q1 - bp}};
#pragma unroll
    for (int i = 0; i < DW / 8; i += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[e][x] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        const int o = 16 * jj * DP + 8 * i;
        uint32_t b[2][4];
        tc::ldmatrix_x4_trans(b[0], Y + o + ob[(i / 4) & 1][0]);
        tc::ldmatrix_x4_trans(b[1], Y + o + ob[(i / 4) & 1][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bb[2] = {b[e >> 1][2 * (e & 1)], b[e >> 1][2 * (e & 1) + 1]};
          tc::mma_bf16(part[e], a[jj], bb);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i + e][x] += part[e][x];
    }
  }
}

// the column of d that accumulate's output tile i, element e holds
template <typename T>
__device__ __forceinline__ int out_col(int i, int e, int t) {
  if constexpr (std::is_same_v<T, float>) return 32 * (i / 4) + 8 * t + 4 * (e & 1) + i % 4;
  return 8 * i + 2 * t + (e & 1);
}

template <typename T, int DQ, int DV, bool DKV>
constexpr size_t smem_bytes() {
  using P = Plan<T, DQ, DV, DKV>;
  return ((size_t)P::BR * (DQ + DV) + (size_t)STAGES * P::BC * (DQ + DV)) * sizeof(T) +
         (size_t)STAGES * 2 * P::BC * sizeof(float) +
         (std::is_same_v<T, float> ? (size_t)P::BC * (DQ + DV) * sizeof(float) : 0);
}
static_assert(smem_bytes<float, 256, 256, true>() <= 232448, "f32 d <= 256 past a block's shared memory");
static_assert(smem_bytes<float, 128, 128, true>() <= 232448, "f32 d <= 128 past a block's shared memory");
static_assert(smem_bytes<float, 192, 128, true>() <= 232448, "f32 (192, 128) dK/dV past a block's shared memory");
static_assert(smem_bytes<float, 192, 128, false>() <= 232448, "f32 (192, 128) dQ past a block's shared memory");

// DKV: the dK/dV kernel (resident K, V; streamed Q, dO; out0 = dk, out1 =
// dv). Otherwise the dQ kernel (resident Q, dO; streamed K, V; out0 = dq).
template <typename T, int DQ, int DV, bool VEC, bool DKV>
__global__ void __launch_bounds__(NT, 1) flash_bwd_kernel(const Args a) {
  using P_ = Plan<T, DQ, DV, DKV>;
  constexpr int BR = P_::BR, BC = P_::BC, NJ = P_::NJ, DWQ = P_::DWQ, DWV = P_::DWV;
  constexpr int NIQ = DWQ / 8, NIV = DWV / 8;
  extern __shared__ uint4 smem[];
  T* X0 = reinterpret_cast<T*>(smem);  // K or Q, [BR][DQ]
  T* X1 = X0 + BR * DQ;                // V or dO, [BR][DV]
  // [STAGES]: Q [BC][DQ] then dO [BC][DV], or K then V
  T* Ys = X1 + BR * DV;
  float* lse_s = reinterpret_cast<float*>(Ys + STAGES * BC * (DQ + DV));  // [STAGES][BC]
  float* dlt_s = lse_s + STAGES * BC;
  float* Ysm = dlt_s + STAGES * BC;  // f32: the small TF32 halves of the current tile

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int rg = w % P_::NRG;  // row group: resident rows 16 rg..16 rg + 15
  const int c0q = w / P_::NRG * DWQ;  // the warp's first dK or dQ column
  const int c0v = w / P_::NRG * DWV;  // and dV column
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nr = DKV ? a.skv : a.sq;  // rows of the resident matrices
  const int nc = DKV ? a.sq : a.skv;  // rows of the streamed ones
  const int h = blockIdx.x % a.H;
  const int tile = DKV ? blockIdx.x / a.H : (nr + BR - 1) / BR - 1 - blockIdx.x / a.H;
  const int r0 = tile * BR;

  const T* q = static_cast<const T*>(a.q) + (int64_t)h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + (int64_t)h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + (int64_t)h * a.v_sh;
  const T* o = static_cast<const T*>(a.dout) + (int64_t)h * a.o_sh;
  const float* lse = a.lse + (int64_t)h * a.sq;
  const float* delta = a.delta + (int64_t)h * a.sq;
  const T* x0 = DKV ? k : q;
  const T* x1 = DKV ? v : o;
  const T* y0 = DKV ? q : k;
  const T* y1 = DKV ? o : v;
  const int64_t x0_si = DKV ? a.k_si : a.q_si;
  const int64_t x1_si = DKV ? a.v_si : a.o_si;
  const int64_t y0_si = DKV ? a.q_si : a.k_si;
  const int64_t y1_si = DKV ? a.o_si : a.v_si;

  // the streamed rows [c_first, c_end) that hold a live entry for this tile
  int64_t c_first = 0, c_end;
  if (DKV) {
    // rows before qb see none of this tile's keys; a tile whose first key is
    // at or past valid_len has no live entry at all
    int64_t qb = a.causal ? (int64_t)a.k_offset + r0 - a.q_offset : 0;
    qb = qb < 0 ? 0 : qb;
    const bool any = (int64_t)a.k_offset + r0 < a.valid_len && qb < a.sq;
    c_first = any ? qb / BC * BC : 0;
    c_end = any ? a.sq : 0;
  } else {
    // keys at or past c_end hold no live entry for any row of this tile
    c_end = a.skv;
    c_end = c_end < (int64_t)a.valid_len - a.k_offset ? c_end
                                                       : (int64_t)a.valid_len - a.k_offset;
    if (a.causal) {
      const int64_t q_last = (int64_t)a.q_offset + (r0 + BR < a.sq ? r0 + BR : a.sq) - 1;
      const int64_t f = q_last - a.k_offset + 1;
      c_end = c_end < f ? c_end : f;
    }
  }
  const int ntiles = c_end > c_first ? (int)((c_end - c_first + BC - 1) / BC) : 0;

  load_rows<T, DQ, VEC>(X0, x0, x0_si, r0, BR, nr, a.dqk);
  load_rows<T, DV, VEC>(X1, x1, x1_si, r0, BR, nr, a.dv);
  tc::cp_async_commit();

  auto load_stage = [&](int s, int c0) {
    T* Y0 = Ys + s * BC * (DQ + DV);
    load_rows<T, DQ, VEC>(Y0, y0, y0_si, c0, BC, nc, a.dqk);
    load_rows<T, DV, VEC>(Y0 + BC * DQ, y1, y1_si, c0, BC, nc, a.dv);
    if (DKV && threadIdx.x < 2 * BC) {
      const int i = threadIdx.x % BC;
      const bool ok = c0 + i < a.sq;
      const float* src = threadIdx.x < BC ? lse : delta;
      float* dst = threadIdx.x < BC ? lse_s : dlt_s;
      tc::cp_async4(dst + s * BC + i, ok ? src + c0 + i : src, ok ? 4 : 0);
    }
  };

  // dQ: lse and delta of the warp's rows 16rg + g and 16rg + g + 8
  float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 16 * rg + g + 8 * hh;
      if (row < a.sq) {
        lse_r[hh] = lse[row];
        dlt_r[hh] = delta[row];
      }
    }
  }

  float acc_p[DKV ? NIV : 1][4];  // dV: P^T dO
  float acc_ds[NIQ][4];           // dK: dS^T Q, or dQ: dS K
#pragma unroll
  for (int i = 0; i < NIQ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_ds[i][e] = 0.f;
  if constexpr (DKV)
#pragma unroll
    for (int i = 0; i < NIV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_p[i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, (int)c_first + s * BC);
    tc::cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int nxt = it + STAGES - 1;
    if (nxt < ntiles) load_stage(nxt % STAGES, (int)c_first + nxt * BC);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();
    __syncthreads();

    const int s = it % STAGES;
    const int c0 = (int)c_first + it * BC;
    T* Y0 = Ys + s * BC * (DQ + DV);
    T* Y1 = Y0 + BC * DQ;
    if constexpr (std::is_same_v<T, float>) {
      // split the streamed tile once for all warps: the big halves in place,
      // the small ones beside them
      uint4* yb = reinterpret_cast<uint4*>(Y0);
      uint4* ysm = reinterpret_cast<uint4*>(Ysm);
      for (int i = threadIdx.x; i < BC * (DQ + DV) / 4; i += NT) {
        const uint4 x = yb[i];
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const tc::Split<4> sp = tc::split_tf32(xs);
        yb[i] = make_uint4(sp.big[0], sp.big[1], sp.big[2], sp.big[3]);
        ysm[i] = make_uint4(sp.small[0], sp.small[1], sp.small[2], sp.small[3]);
      }
      __syncthreads();
    }
    // p, then (dK/dV) dV += P^T dO before the dO.V scores, so p and ds are
    // never both held through a product: the accumulators take 128 of the
    // 255 registers a thread may have
    float P[NJ][4], dS[NJ][4];
    score_tile<T, DQ, NJ, 0>(P, X0, Y0, Ysm, rg, g, t);
    const int64_t q_lo = DKV ? c0 : r0, q_hi = DKV ? c0 + BC : r0 + BR;
    const int64_t k_lo = DKV ? r0 : c0, k_hi = DKV ? r0 + BR : c0 + BC;
    const bool full = q_hi <= a.sq && k_hi <= a.skv && a.k_offset + k_hi <= a.valid_len &&
                      (!a.causal || a.q_offset + q_lo >= a.k_offset + k_hi - 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * t + (e & 1);  // streamed row in the tile
        P[j][e] = P[j][e] * a.scale - (DKV ? lse_s[s * BC + cl] : lse_r[e >> 1]);
      }
    if (!full) {  // every entry of a full tile is live: no mask
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r0 + 16 * rg + g + 8 * (e >> 1);  // resident row
          const int cl = c0 + 8 * j + 2 * t + (e & 1);    // streamed row
          if (!(DKV ? is_live(cl, rl, a) : is_live(rl, cl, a))) P[j][e] = __uint_as_float(0xff800000u);  // -inf: exp gives 0
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) P[j][e] = expf(P[j][e]);
    if constexpr (DKV)
      accumulate<T, DV, DWV, NJ>(acc_p, P, Y1 + c0v, Ysm + BC * DQ + c0v, lane);
    score_tile<T, DV, NJ, P_::SEG_DS>(dS, X1, Y1, Ysm + BC * DQ, rg, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dl = DKV ? dlt_s[s * BC + 8 * j + 2 * t + (e & 1)] : dlt_r[e >> 1];
        dS[j][e] = P[j][e] * (dS[j][e] - dl);
      }
    accumulate<T, DQ, DWQ, NJ>(acc_ds, dS, Y0 + c0q, Ysm + c0q, lane);
    __syncthreads();  // stage s is refilled by the next iteration's copy
  }

  float* out_ds = a.out0;  // dk or dq
  const int64_t base = (int64_t)h * nr;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 16 * rg + g + 8 * hh;
    if (row >= nr) continue;
    const int64_t offq = (base + row) * a.dqk;
#pragma unroll
    for (int i = 0; i < NIQ; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0q + out_col<T>(i, e, t);
        if (c < a.dqk) out_ds[offq + c] = acc_ds[i][2 * hh + e] * a.scale;
      }
    if constexpr (DKV) {
      const int64_t offv = (base + row) * a.dv;
#pragma unroll
      for (int i = 0; i < NIV; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0v + out_col<T>(i, e, t);
          if (c < a.dv) a.out1[offv + c] = acc_p[i][2 * hh + e];
        }
    }
  }
}

template <typename T, int DQ, int DV, bool VEC, bool DKV>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<T, DQ, DV, DKV>();
  auto kern = flash_bwd_kernel<T, DQ, DV, VEC, DKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BR = Plan<T, DQ, DV, DKV>::BR;
  const int64_t blocks = (int64_t)(((DKV ? a.skv : a.sq) + BR - 1) / BR) * a.H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NT, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// 16-byte copies need 16-byte-aligned base pointers, head and row strides and
// rows of dqk and dv elements
bool aligned16(const Args& a, int elt) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const int64_t strides[8] = {a.q_sh, a.q_si, a.k_sh, a.k_si, a.v_sh, a.v_si, a.o_sh, a.o_si};
  for (int64_t s : strides)
    if (s * elt % 16) return false;
  return (int64_t)a.dqk * elt % 16 == 0 && (int64_t)a.dv * elt % 16 == 0;
}

template <typename T, int DQ, int DV, bool DKV>
cudaError_t launch_width(const Args& a) {
  return aligned16(a, (int)sizeof(T)) ? launch<T, DQ, DV, true, DKV>(a)
                                      : launch<T, DQ, DV, false, DKV>(a);
}

// the narrowest instance that holds both widths (the forward's rule)
template <bool DKV, typename T>
cudaError_t dispatch(const Args& a) {
  const int d = a.dqk > a.dv ? a.dqk : a.dv;
  if (d <= 64) return launch_width<T, 64, 64, DKV>(a);
  if (d <= 128) return launch_width<T, 128, 128, DKV>(a);
  if (a.dqk <= 192 && a.dv <= 128) return launch_width<T, 192, 128, DKV>(a);
  if (d <= 256) return launch_width<T, 256, 256, DKV>(a);
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run(int dtype, const Args& a) {
  if (a.H <= 0 || (DKV ? a.skv : a.sq) <= 0) return (int)cudaSuccess;
  if (a.dqk <= 0 || a.dv <= 0 || a.sq < 0 || a.skv < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<DKV, float>(a);
  if (dtype == 1) return (int)dispatch<DKV, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* out0, void* out1, int H, int sq,
               int skv, int dqk, int dv, long long q_sh, long long q_si, long long k_sh,
               long long k_si, long long v_sh, long long v_si, long long o_sh,
               long long o_si, int q_offset, int k_offset, int valid_len, int causal,
               float scale, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(out0),
              static_cast<float*>(out1), H, sq, skv, dqk, dv, q_sh, q_si, k_sh, k_si, v_sh,
              v_si, o_sh, o_si, q_offset, k_offset, valid_len, causal, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (H, sq, dqk), dout (H, sq, dv), k (H,
// skv, dqk) and v (H, skv, dv), given by their head and row strides in
// elements (the last dimension contiguous); lse and delta (H, sq) contiguous
// f32; dk_out (H, skv, dqk) and dv_out (H, skv, dv) contiguous f32, written
// whole. Returns the launch's cudaError_t.
int marlin_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk_out,
                         void* dv_out, int H, int sq, int skv, int dqk, int dv,
                         long long q_sh, long long q_si, long long k_sh, long long k_si,
                         long long v_sh, long long v_si, long long o_sh, long long o_si,
                         int q_offset, int k_offset, int valid_len, int causal, float scale,
                         void* stream) {
  return run<true>(dtype, make_args(q, k, v, dout, lse, delta, dk_out, dv_out, H, sq, skv,
                                    dqk, dv, q_sh, q_si, k_sh, k_si, v_sh, v_si, o_sh, o_si,
                                    q_offset, k_offset, valid_len, causal, scale, stream));
}

// As marlin_flash_bwd_dkv; dq (H, sq, dqk) contiguous f32, written whole.
int marlin_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dq,
                        int H, int sq, int skv, int dqk, int dv, long long q_sh,
                        long long q_si, long long k_sh, long long k_si, long long v_sh,
                        long long v_si, long long o_sh, long long o_si, int q_offset,
                        int k_offset, int valid_len, int causal, float scale,
                        void* stream) {
  return run<false>(dtype, make_args(q, k, v, dout, lse, delta, dq, nullptr, H, sq, skv, dqk, dv,
                                     q_sh, q_si, k_sh, k_si, v_sh, v_si, o_sh, o_si,
                                     q_offset, k_offset, valid_len, causal, scale, stream));
}

}  // extern "C"
