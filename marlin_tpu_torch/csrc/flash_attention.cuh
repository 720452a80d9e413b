// One flash-attention forward panel with carried state, hand-written for
// Hopper (sm_90a) on its tensor cores: the kernel, shared by the translation
// units that instantiate it (flash_attention.cu: d <= 64 and d <= 128, and
// the C entry; flash_attention_wide.cu: d <= 256).
//
// Replaces: marlin_tpu/ops/flash_attention.py `_panel_kernel` (reached through
// `flash_attention_panel` and `flash_attention_single_panel`), a Pallas TPU
// kernel over the grid (q blocks, kv blocks) that keeps the (bq, bkv) score
// tile in VMEM, carries the running max m, denominator l and f32 accumulator
// across the sequential kv axis, and skips kv blocks with no live entry.
//
// Computes, for every head h and query row i of the panel (global position
// q_offset + i), against keys j (global position k_offset + j):
//   s = (q . k) * scale in f32; live iff k_offset + j < valid_len and, when
//   causal, q_offset + i >= k_offset + j; dead entries at -1e30;
//   m' = max(m, max s); alpha = exp(m - m'); p = live ? exp(s - m') : 0
//   (a fully masked row stays exactly zero);
//   l' = l * alpha + sum p; acc' = acc * alpha + (p in the input type) . v.
// m, l (H, sq) and acc (H, sq, d) are f32 in and out; q, k, v are f32 or bf16.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): operations, 4 * d per live
// (query, key) pair (S = Q K^T and P V), at 495 / 3 = 165 TFLOP/s for f32 in
// three TF32 passes and 989 TFLOP/s for bf16.
//
// Design (the backward's, flash_attention_bwd.cu, with one resident matrix
// and the online softmax between the two products):
// - A block keeps BR query rows resident in shared memory, 16 per warp, and
//   streams BC-row tiles of K and V through a two-stage cp.async ring with
//   zero fill: the next tile's copy is in flight while the current one
//   computes, and one barrier per tile orders the two. The TPU's sequential
//   kv grid axis is this loop; it ends at the last tile holding a live key
//   (valid_len, and the causal frontier of the block's last row), the TPU
//   kernel's block skip, and a warp whose rows all lie before a tile's first
//   key skips it. Skipping a tile with no live entry is exact: it would add
//   p = 0 and rescale by alpha = 1.
// - Products on the tensor cores with mma.sync (m16n8k8 TF32, m16n8k16 bf16).
//   Each warp computes its 16 x BC score tile S = Q K^T; the accumulator
//   layout of S is the A fragment of P V (the column pairs (2t, 2t+1) become
//   the k slots (t, t+4)), so p never touches shared memory. V is the B
//   operand in its [key][d] layout, which TF32 wgmma (K-major operands only)
//   cannot read; register fragments take any layout.
// - f32 inputs take three TF32 passes (tensor_core.cuh): f32 accuracy, as the
//   TPU kernel pins Precision.HIGHEST. Q, K, V and p are split into their big
//   and small halves in registers as their fragments load, rounded by integer
//   operations. (Splitting each streamed tile once in shared memory, as the
//   backward does, cost a phase and a barrier per tile, and the small halves'
//   loads: on an H100 the kernel is held by the latency of each fragment's
//   load, split and product, not by the bandwidth of shared memory.) The
//   tensor cores do not round their f32 sums to nearest: each 32 columns of
//   S, and each tile's P V, sum in a fresh accumulator that is then added in
//   IEEE f32 (acc = acc * alpha + pv). bf16 inputs take one bf16 pass; p is
//   rounded to bf16 as it is packed, and each bf16 product is exact in the
//   f32 accumulator.
// - Online softmax in registers: a thread holds two rows (g, g + 8) of its
//   warp's tile; row max and row sum reduce over the four lanes of a quad.
//   Tiles wholly live skip the mask.
// - Tiles (Tiles): 128 resident rows, 8 warps; f32 streams 64-key tiles at
//   d <= 64 and 32-key tiles at d <= 128 (wider tiles spill registers at
//   ptxas -O3); f32 d <= 256 keeps 64 rows (4 warps) x 32 keys; bf16 64-key
//   tiles, 32 at d <= 256. 16-byte chunks are XOR-swizzled by row so the
//   fragment loads hit distinct banks.
// - The 1-D grid puts a q tile's heads together and the last q tiles (the
//   longest loops when causal) first, so the short ones fill the tail.
// - Ragged edges (sq, skv not multiples of the tiles, d below the compiled
//   width) are zero-filled by the copies and masked; strides for q, k, v let
//   the caller pass a (seq, heads, d) layout without a transposed copy;
//   offsets are 64-bit. For pointers, strides or rows (d * element size) that
//   are not 16-byte aligned the host picks the same kernel with element-wise
//   copies (VEC = false).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace flash_fwd {

constexpr int STAGES = 2;
constexpr float kNeg = -1e30f;

struct Args {
  const void *q, *k, *v;
  const float *m_in, *l_in, *acc_in;
  float *m_out, *l_out, *acc_out;
  int H, sq, skv, d;
  int64_t q_sh, q_si, k_sh, k_si, v_sh, v_si;
  int q_offset, k_offset, valid_len, causal;
  float scale;
  cudaStream_t stream;
};

// resident rows BR (16 per warp), streamed rows BC and threads of an instance
template <typename T, int DP>
struct Tiles {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int BR = (F32 && DP == 256) ? 64 : 128;
  static constexpr int BC = (DP == 256 || (F32 && DP == 128)) ? 32 : 64;
  static constexpr int NT = 2 * BR;
  // Q and the ring of K/V stages
  static constexpr size_t smem = ((size_t)BR * DP + (size_t)STAGES * 2 * BC * DP) * sizeof(T);
};

__device__ __forceinline__ bool is_live(int qi, int kj, const Args& a) {
  const int64_t qpos = (int64_t)a.q_offset + qi;
  const int64_t kpos = (int64_t)a.k_offset + kj;
  return qi < a.sq && kj < a.skv && kpos < a.valid_len && (!a.causal || qpos >= kpos);
}

// S[j] = Q[16w + (g, g+8)] . K[8j + g] over d: the warp's 16 x BC score tile.
// Thread t reads 16-byte chunk 4kc + t of each row; its two k steps map the
// fragment's k slots onto the chunk's elements (0, 1) and (2, 3) for TF32,
// the pairs (0-1, 2-3) and (4-5, 6-7) for bf16. Every row read has row % 8 ==
// g, so chunk 4kc + t of it sits at chunk 4 (kc ^ b) + ((t ^ sg) & 3), sg =
// swz(g), b = sg / 4: an offset of 4E kc plus one of two per-thread
// constants, by the parity of kc. f32: each pair of chunks (32 columns) sums
// into a fresh accumulator, added to S in IEEE f32; in one accumulator a sum
// over d = 256 drifts past chip_smoke's 1e-5 on m.
template <typename T, int DP, int NJ>
__device__ __forceinline__ void score_tile(float (&S)[NJ][4], const T* Q, const T* K, int w,
                                           int g, int t) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr bool F32 = std::is_same_v<T, float>;
  constexpr int KC = F32 ? 2 : 1;  // chunks per fresh accumulator
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
  const int sg = tc::swz(g);
  const int lo = E * ((t ^ sg) & 3) + g * DP;
  const int lo_par[2] = {lo + 4 * E * (sg >> 2), lo - 4 * E * (sg >> 2)};
  const T* xr = Q + 16 * w * DP;
#pragma unroll
  for (int kp = 0; kp < DP / (4 * E); kp += KC) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int c = 4 * E * (kp + u) + lo_par[(kp + u) & 1];
      const uint4 xa = tc::lds128(xr + c);
      const uint4 xb = tc::lds128(xr + 8 * DP + c);
      if constexpr (F32) {
        tc::Split<4> qs[2];
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const uint32_t a[4] = {st ? xa.z : xa.x, st ? xb.z : xb.x, st ? xa.w : xa.y,
                                 st ? xb.w : xb.y};
          qs[st] = tc::split_tf32(a);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const tc::Split<4> ks = tc::split_tf32(tc::lds128(K + 8 * j * DP + c));
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            const uint32_t bb[2] = {ks.big[2 * st], ks.big[2 * st + 1]};
            const uint32_t bs[2] = {ks.small[2 * st], ks.small[2 * st + 1]};
            tc::mma_tf32(part[j], qs[st].small, bb);
            tc::mma_tf32(part[j], qs[st].big, bs);
            tc::mma_tf32(part[j], qs[st].big, bb);
          }
        }
      } else {
        uint4 y[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) y[j] = tc::lds128(K + 8 * j * DP + c);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const uint32_t a[4] = {st ? xa.z : xa.x, st ? xb.z : xb.x, st ? xa.w : xa.y,
                                 st ? xb.w : xb.y};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const uint32_t b[2] = {st ? y[j].z : y[j].x, st ? y[j].w : y[j].y};
            tc::mma_bf16(part[j], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] += part[j][e];
  }
}

// acc = acc * alpha + P . V over the BC rows of V, P the warp's 16 x BC tile
// of p in the accumulator layout of score_tile and alpha the rescale of rows
// g and g + 8 (the backward's accumulate). TF32: k step j takes accumulator
// tile j, slots (t, t+4) = columns (8j + 2t, 8j + 2t + 1); output tile i
// holds columns 32 (i / 4) + 4 n + i % 4, so one 16-byte read of rows 8j + 2t
// and 8j + 2t + 1 gives B for four tiles. bf16: k step jj takes tiles 2jj and
// 2jj + 1 (their pairs, in order), B by ldmatrix.trans, tile i = columns
// 8i..8i+7. Four output tiles at a time sum the tile's BC rows in a fresh
// accumulator, added to acc in IEEE f32.
template <typename T, int DP, int NJ>
__device__ __forceinline__ void accumulate_pv(float (&acc)[DP / 8][4], const float (&P)[NJ][4],
                                              const float (&alpha)[2], const T* V, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float part[4][4];
  if constexpr (std::is_same_v<T, float>) {
    // column 32 ig + 4g of row r: chunk 8 ig + (g ^ swz(r))
    const int base0 = 2 * t * DP + 4 * (g ^ tc::swz(2 * t));
    const int base1 = (2 * t + 1) * DP + 4 * (g ^ tc::swz(2 * t + 1));
#pragma unroll
    for (int ig = 0; ig < DP / 32; ++ig) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[e][x] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float af[4] = {P[j][0], P[j][2], P[j][1], P[j][3]};
        const tc::Split<4> as = tc::split_tf32(af);
        const int o = 8 * j * DP + 32 * ig;
        const tc::Split<4> r0 = tc::split_tf32(tc::lds128(V + base0 + o));
        const tc::Split<4> r1 = tc::split_tf32(tc::lds128(V + base1 + o));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bb[2] = {r0.big[e], r1.big[e]};
          const uint32_t bs[2] = {r0.small[e], r1.small[e]};
          tc::mma_tf32(part[e], as.small, bb);
          tc::mma_tf32(part[e], as.big, bs);
          tc::mma_tf32(part[e], as.big, bb);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc[4 * ig + e][x] = acc[4 * ig + e][x] * alpha[x >> 1] + part[e][x];
    }
  } else {
    uint32_t a[NJ / 2][4];
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      a[jj][0] = tc::pack_bf16(P[2 * jj][0], P[2 * jj][1]);
      a[jj][1] = tc::pack_bf16(P[2 * jj][2], P[2 * jj][3]);
      a[jj][2] = tc::pack_bf16(P[2 * jj + 1][0], P[2 * jj + 1][1]);
      a[jj][3] = tc::pack_bf16(P[2 * jj + 1][2], P[2 * jj + 1][3]);
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
    for (int i = 0; i < DP / 8; i += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[e][x] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        const int o = 16 * jj * DP + 8 * i;
        uint32_t b[2][4];
        tc::ldmatrix_x4_trans(b[0], V + o + ob[(i / 4) & 1][0]);
        tc::ldmatrix_x4_trans(b[1], V + o + ob[(i / 4) & 1][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bb[2] = {b[e >> 1][2 * (e & 1)], b[e >> 1][2 * (e & 1) + 1]};
          tc::mma_bf16(part[e], a[jj], bb);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i + e][x] = acc[i + e][x] * alpha[x >> 1] + part[e][x];
    }
  }
}

// the column of d that accumulator tile i, element e (0 or 1) holds
template <typename T>
__device__ __forceinline__ int out_col(int i, int e, int t) {
  if constexpr (std::is_same_v<T, float>) return 32 * (i / 4) + 8 * t + 4 * e + i % 4;
  return 8 * i + 2 * t + e;
}

template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(Tiles<T, DP>::NT, 1) flash_fwd_kernel(const Args a) {
  using C = Tiles<T, DP>;
  constexpr int BR = C::BR, BC = C::BC, NT = C::NT;
  constexpr int NJ = BC / 8, NI = DP / 8;
  extern __shared__ uint4 smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BR][DP]
  T* Ys = Qs + BR * DP;                // [STAGES][2][BC][DP]: K, V

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x % a.H;
  const int r0 = ((a.sq + BR - 1) / BR - 1 - blockIdx.x / a.H) * BR;
  const int wr0 = r0 + 16 * w;  // the warp's first row

  const T* q = static_cast<const T*>(a.q) + (int64_t)h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + (int64_t)h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + (int64_t)h * a.v_sh;

  // keys at or past c_end hold no live entry for any row of this block
  int64_t c_end = a.skv;
  c_end = c_end < (int64_t)a.valid_len - a.k_offset ? c_end
                                                     : (int64_t)a.valid_len - a.k_offset;
  if (a.causal) {
    const int64_t f = (int64_t)a.q_offset + (r0 + BR < a.sq ? r0 + BR : a.sq) - a.k_offset;
    c_end = c_end < f ? c_end : f;
  }
  const int ntiles = c_end > 0 ? (int)((c_end + BC - 1) / BC) : 0;

  auto load_stage = [&](int it) {
    T* K0 = Ys + (it % STAGES) * 2 * BC * DP;
    tc::load_tile<T, DP, VEC, NT>(K0, k, a.k_si, it * BC, BC, a.skv, a.d);
    tc::load_tile<T, DP, VEC, NT>(K0 + BC * DP, v, a.v_si, it * BC, BC, a.skv, a.d);
  };
  if (ntiles > 0) {  // a block with no tile copies the state through
    tc::load_tile<T, DP, VEC, NT>(Qs, q, a.q_si, r0, BR, a.sq, a.d);
    load_stage(0);
    tc::cp_async_commit();
  }

  // the carried state of rows wr0 + g and wr0 + g + 8
  const int64_t row0 = (int64_t)h * a.sq;
  float m[2], l[2], acc[NI][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = wr0 + g + 8 * hh;
    m[hh] = row < a.sq ? a.m_in[row0 + row] : kNeg;
    l[hh] = row < a.sq ? a.l_in[row0 + row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr0 + g + 8 * (e >> 1);
      const int c = out_col<T>(i, e & 1, t);
      acc[i][e] = (row < a.sq && c < a.d) ? a.acc_in[(row0 + row) * a.d + c] : 0.f;
    }

  // the position of the warp's last row; a tile whose first key lies past it
  // holds no live entry for the warp when causal
  const int64_t w_qlast = (int64_t)a.q_offset + (wr0 + 15 < a.sq ? wr0 + 15 : a.sq - 1);
  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<0>();  // Q and tile it have landed
    // every warp is past tile it - 1, whose stage the next copy refills
    __syncthreads();
    if (it + 1 < ntiles) {
      load_stage(it + 1);
      tc::cp_async_commit();
    }
    const int c0 = it * BC;
    const T* K = Ys + (it % STAGES) * 2 * BC * DP;
    const T* V = K + BC * DP;
    if (wr0 >= a.sq || (a.causal && w_qlast < (int64_t)a.k_offset + c0)) continue;

    float S[NJ][4];
    score_tile<T, DP, NJ>(S, Qs, K, w, g, t);
    const bool full =
        wr0 + 16 <= a.sq && c0 + BC <= a.skv && (int64_t)a.k_offset + c0 + BC <= a.valid_len &&
        (!a.causal || (int64_t)a.q_offset + wr0 >= (int64_t)a.k_offset + c0 + BC - 1);
    uint32_t dead = 0;  // bit 4j + e: entry (j, e) is masked
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = S[j][e] * a.scale;
        if (!full && !is_live(wr0 + g + 8 * (e >> 1), c0 + 8 * j + 2 * t + (e & 1), a)) {
          dead |= 1u << (4 * j + e);
          s = kNeg;
        }
        S[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_new[hh] = fmaxf(m[hh], tc::quad_max(mx[hh]));
      alpha[hh] = expf(m[hh] - m_new[hh]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (dead >> (4 * j + e)) & 1u ? 0.f : expf(S[j][e] - m_new[e >> 1]);
        S[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = l[hh] * alpha[hh] + tc::quad_sum(rs[hh]);
      m[hh] = m_new[hh];
    }
    accumulate_pv<T, DP, NJ>(acc, S, alpha, V, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = wr0 + g + 8 * hh;
    if (row >= a.sq) continue;
    if (t == 0) {
      a.m_out[row0 + row] = m[hh];
      a.l_out[row0 + row] = l[hh];
    }
    const int64_t off = (row0 + row) * a.d;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = out_col<T>(i, e, t);
        if (c < a.d) a.acc_out[off + c] = acc[i][2 * hh + e];
      }
  }
}

template <typename T, int DP, bool VEC>
cudaError_t launch(const Args& a) {
  using C = Tiles<T, DP>;
  auto kern = flash_fwd_kernel<T, DP, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)((a.sq + C::BR - 1) / C::BR) * a.H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, C::NT, C::smem, a.stream>>>(a);
  return cudaGetLastError();
}

// 16-byte copies need 16-byte-aligned base pointers, head and row strides and
// rows of d elements
inline bool aligned16(const Args& a, int elt) {
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const int64_t strides[6] = {a.q_sh, a.q_si, a.k_sh, a.k_si, a.v_sh, a.v_si};
  for (int64_t s : strides)
    if (s * elt % 16) return false;
  return (int64_t)a.d * elt % 16 == 0;
}

// the instance of width DP for a's alignment
template <typename T, int DP>
cudaError_t launch_width(const Args& a) {
  return aligned16(a, (int)sizeof(T)) ? launch<T, DP, true>(a) : launch<T, DP, false>(a);
}

// the d <= 256 instances (flash_attention_wide.cu); dtype 0 = f32, 1 = bf16
cudaError_t launch_wide(int dtype, const Args& a);

}  // namespace flash_fwd
