// The bf16 flash-attention forward panel on Hopper's own path (sm_90a): TMA
// into a ring of shared-memory stages, wgmma on two consumer warpgroups, a
// producer warp. The kernel, shared by the translation units that
// instantiate it (flash_attention_sm90.cu: q/k and v both 64 or both 128,
// and the C entry; flash_attention_sm90_mla.cu: q/k 192 and v 128).
//
// Replaces, for bf16 inputs whose widths an instance covers and whose base
// pointers and strides are 16-byte aligned (TMA's rule), the mma.sync design
// of flash_attention.cuh (which keeps f32, unaligned views and every other
// width). Both replace marlin_tpu/ops/flash_attention.py `_panel_kernel`.
// The contract is flash_attention.cuh's, term for term: the same Args (q, k,
// v with per-head and per-row strides; m, l, acc carried in and out in f32;
// q_offset, k_offset, valid_len, causal, scale), the same live set, a fully
// masked row left exactly zero, the same bf16 products into f32 sums and p
// rounded to bf16 before P V.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): 2 (dqk + dv) operations
// per live (query, key) pair at 989 TFLOP/s bf16; at 16 heads x 32768 causal,
// (192, 128), 5.56 ms. The mma.sync design took 42.02 ms there: mma.sync
// cannot reach Hopper's tensor-core rate, each warp reloaded its Q fragments
// from shared memory on every tile, and softmax and products took turns.
//
// Design:
// - A block holds BR = 128 query rows of one head. Warpgroup 0 is the
//   producer: one thread issues every TMA load. Consumer warpgroup w takes
//   rows [64 w, 64 w + 64). No `setmaxnreg`: ptxas (CUDA 12.9) compiles the
//   consumers within the block's 168 registers a thread whatever it asks
//   for them (measured: the same spills with and without it), so moving
//   registers to them at run time buys nothing.
// - Q is loaded once; K and V tiles of BC = 128 keys stream through a ring
//   of two stages, K and V each with full and empty mbarriers (one arrival a
//   consumer warpgroup releases a slot), so S = Q K^T of a tile starts
//   before its V lands. Tensor maps are built on the host from the strides
//   the caller passes, (heads, rows, d) with any row and head strides, so a
//   (seq, heads, d) view needs no copy; TMA writes zeros past sq and skv.
//   Every operand is stored as boxes of 64 columns (128 bytes) x rows with
//   the 128-byte swizzle. Shared memory at (192, 128): Q 48 KB, a stage's K
//   48 KB and V 32 KB, 208 KB in all.
// - S = Q K^T by wgmma m64n128k16, A (Q) and B (K) K-major from shared
//   memory; the descriptor steps 32 bytes inside a swizzled row per 16
//   columns of d, and a box (BR or BC rows of 128 bytes) per 64.
// - Online softmax in registers, on the accumulator's layout: a thread
//   holds rows g and g + 8 of its warp's 16 and 32 keys of each; m' =
//   max(m, kNeg, row max over the quad of S scale), p = 2^(S scale log2 e -
//   m' log2 e) (one FFMA and ex2.approx), alpha = 2^((m - m') log2 e). A
//   tile is masked only where a warp's rows cross the causal frontier,
//   valid_len or a ragged edge; a dead entry's p is exactly 0 and a row
//   with no live key keeps m at kNeg, l and acc at 0. Each thread keeps its
//   own part of l; the quad's parts are summed once, at the end.
// - O += P V by wgmma m64n{DV}k16 with A (P) from registers: the S
//   accumulator's column pairs are the A fragment's k pairs, so p is rounded
//   to bf16 as it is packed and never touches shared memory; V is read in
//   its [key][d] layout as an MN-major B operand (bf16 wgmma's transposed
//   B), which TF32 wgmma lacks (hence f32 stays on mma.sync). O accumulates
//   in the wgmma accumulator, rescaled by alpha in registers between tiles.
// - Overlap across warpgroups (ping-pong): two named barriers make the
//   warpgroups issue their score products in turns, so one warpgroup's
//   softmax runs under the other's products; each warpgroup runs S,
//   softmax and P V of a tile in order. Measured at 16 heads x 32768, causal
//   (NVIDIA H100, 700 W, CUDA events): 8.74-8.82 ms at (192, 128); without
//   the turns 8.62-9.14 (the same within noise), and 0.69 against 0.77 ms
//   at d = 64 (8 x 16384). Overlap inside a warpgroup (tile j's S issued
//   with tile j - 1's P V, the softmax under P V) holds S, P and O (64 + 32
//   + 64 registers a thread at (192, 128)) at once, past the 168 a thread:
//   it spilled and serialised the products (16.59 ms), as did a turn that
//   holds both products (15.7 ms). In order, the live set peaks at S and O.
// - Tiles with no live key for the block are never loaded (c_end: the
//   causal frontier of the block's last row, valid_len, skv). A tile with no
//   live key for one warpgroup (offsets that are no tile multiple) runs
//   masked: it adds p = 0 and rescales by alpha = 1, exactly.
// - The 1-D grid puts a q tile's heads together and the last q tiles (the
//   longest causal loops) first, as flash_attention.cuh does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"  // Args, kNeg
#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace flash_sm90 {

using flash_fwd::Args;
using flash_fwd::kNeg;

constexpr int kSmemBudget = 232448;  // dynamic shared memory of one block
constexpr float kLog2e = 1.4426950408889634f;

template <int DQ, int DV>
struct Cfg {
  static constexpr int BR = 128;  // query rows of a block
  static constexpr int BC = 128;  // keys of a tile
  static constexpr int STAGES = 2;
  static constexpr int NT = 384;  // the producer warpgroup and two consumers
  static constexpr int kBox = 64;  // bf16 columns of a 128-byte box
  static constexpr int kQBytes = BR * DQ * 2;
  static constexpr int kKBytes = BC * DQ * 2;
  static constexpr int kVBytes = BC * DV * 2;
  static constexpr int kBars = 1 + 4 * STAGES;  // q full; k, v full and empty
  static constexpr int kSmem = 1024 + kQBytes + STAGES * (kKBytes + kVBytes) + 8 * kBars;
  static_assert(DQ % kBox == 0 && DV % kBox == 0, "whole 128-byte boxes");
  static_assert(DV == 64 || DV == 128, "wgmma widths with a wrapper in wgmma.cuh");
  static_assert(kSmem <= kSmemBudget, "shared memory of one block");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a descriptor the compiler must form where it stands: otherwise ptxas
// hoists the descriptor of every k step out of the tile loop, 2 registers
// each (24 for Q at dqk 192 alone), and the consumers spill
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// S = Q K^T of one tile for the warpgroup's 64 rows, issued and committed
// as one wgmma group: dq, dk the descriptors of the warpgroup's rows in the
// first Q box and of the stage's first K box; k step kk reads 32 bytes of
// box kk / 4's rows (descriptor addresses count 16 bytes)
template <int DQ, int BR, int BC>
__device__ __forceinline__ void issue_scores(float (&S)[BC / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < DQ / 16; ++kk)
    wg::wgmma_bf16(S, dq + ((kk / 4) * BR * 8 + (kk % 4) * 2),
                   dk + ((kk / 4) * BC * 8 + (kk % 4) * 2), kk > 0);
  wg::wgmma_commit();
}

// O += P V of one tile, issued and committed as one wgmma group: dv the
// descriptor of the stage's first V box (keys 16 kk .. 16 kk + 15 are 2048
// bytes on)
template <int DV, int BC>
__device__ __forceinline__ void issue_pv(float (&O)[DV / 2], const uint32_t (&P)[BC / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) wg::wgmma_bf16_rs_mn(O, P[kk], dv + kk * 128, 1);
  wg::wgmma_commit();
}

// The online softmax of one tile on the S accumulator (module note): S
// (raw scores) becomes p in f32, m the new running max, lp the thread's part
// of l; alpha the rescale of rows g and g + 8. The scale is folded into the
// exponent: max_j (S_j scale) = (max_j S_j sign) |scale| exactly, so a
// negative scale flips S first and the row's max is taken on raw scores.
// Masked tiles (full false) keep key kc + 8 j + c of row hh live below
// kend[hh]; dead entries leave the max at -inf and their p at 0. Maxima and
// sums run in four chains a row, so one warp's softmax is not held by the
// latency of a single chain (measured: 13.7 -> 9.3 ms at 16 x 32768, (192,
// 128)).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&S)[NS], float (&m)[2], float (&lp)[2],
                                             float (&alpha)[2], float scale, bool full,
                                             const int (&kend)[2], int kc) {
  const float sa = fabsf(scale);
  if (scale < 0.f) {
#pragma unroll
    for (int i = 0; i < NS; ++i) S[i] = -S[i];
  }
  if (!full) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (kc + 8 * (i / 4) + (i & 1) >= kend[(i >> 1) & 1]) S[i] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = -INFINITY;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float& x = mx[(i >> 1) & 1][2 * ((i >> 2) & 1) + (i & 1)];
    x = fmaxf(x, S[i]);
  }
  float mb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float* x = mx[hh];
    const float r = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    // a row with no live key: r * sa is -inf (NaN at scale 0), and m stays
    // at least kNeg, as the mma.sync design's dead entries leave it
    const float m_new = fmaxf(m[hh], fmaxf(kNeg, tc::quad_max(r) * sa));
    alpha[hh] = ex2((m[hh] - m_new) * kLog2e);
    m[hh] = m_new;
    mb[hh] = -m_new * kLog2e;
  }
  const float sl = sa * kLog2e;
#pragma unroll
  for (int i = 0; i < NS; ++i) S[i] = ex2(fmaf(S[i], sl, mb[(i >> 1) & 1]));
  if (!full) {  // exactly 0 at any scale (at scale 0, -inf * 0 is NaN)
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (kc + 8 * (i / 4) + (i & 1) >= kend[(i >> 1) & 1]) S[i] = 0.f;
  }
  float rs[2][4] = {};
#pragma unroll
  for (int i = 0; i < NS; ++i) rs[(i >> 1) & 1][2 * ((i >> 2) & 1) + (i & 1)] += S[i];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    lp[hh] = lp[hh] * alpha[hh] + ((rs[hh][0] + rs[hh][1]) + (rs[hh][2] + rs[hh][3]));
}

// O *= alpha by row, then P = p in bf16 as wgmma's A fragments: k step kk
// takes accumulator column groups 2 kk and 2 kk + 1
template <int DV, int BC>
__device__ __forceinline__ void rescale_and_pack(float (&O)[DV / 2], uint32_t (&P)[BC / 16][4],
                                                 const float (&S)[BC / 2],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) O[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      P[kk][r] = tc::pack_bf16(S[8 * kk + 2 * r], S[8 * kk + 2 * r + 1]);
}

struct Maps {
  CUtensorMap q, k, v;
};

template <int DQ, int DV>
__global__ void __launch_bounds__(Cfg<DQ, DV>::NT, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ Maps maps, const Args a) {
  using C = Cfg<DQ, DV>;
  constexpr int BR = C::BR, BC = C::BC, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tc::smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const uint32_t sQ = base;                     // [DQ / 64][BR][128 B]
  const uint32_t sK = sQ + C::kQBytes;          // [ST][DQ / 64][BC][128 B]
  const uint32_t sV = sK + ST * C::kKBytes;     // [ST][DV / 64][BC][128 B]
  const uint32_t bars = sV + ST * C::kVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };

  const int h = blockIdx.x % a.H;
  const int r0 = ((a.sq + BR - 1) / BR - 1 - blockIdx.x / a.H) * BR;
  // keys at or past c_end hold no live entry for any row of this block
  int64_t c_end = a.skv;
  c_end = c_end < (int64_t)a.valid_len - a.k_offset ? c_end
                                                     : (int64_t)a.valid_len - a.k_offset;
  if (a.causal) {
    const int64_t f = (int64_t)a.q_offset + (r0 + BR < a.sq ? r0 + BR : a.sq) - a.k_offset;
    c_end = c_end < f ? c_end : f;
  }
  const int ntiles = c_end > 0 ? (int)((c_end + BC - 1) / BC) : 0;

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(k_full(s), 1);
      wg::mbar_init(v_full(s), 1);
      wg::mbar_init(k_empty(s), 2);  // one arrival a consumer warpgroup
      wg::mbar_init(v_empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x != 0 || ntiles == 0) return;
    wg::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
    for (int c = 0; c < DQ / 64; ++c)
      wg::tma_load_3d(sQ + c * BR * 128, &maps.q, q_full, 64 * c, r0, h);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST;
      const uint32_t ph = (it / ST) & 1;
      wg::mbar_wait(k_empty(s), ph ^ 1);
      wg::mbar_expect_tx(k_full(s), C::kKBytes);
#pragma unroll
      for (int c = 0; c < DQ / 64; ++c)
        wg::tma_load_3d(sK + s * C::kKBytes + c * BC * 128, &maps.k, k_full(s), 64 * c,
                        it * BC, h);
      wg::mbar_wait(v_empty(s), ph ^ 1);
      wg::mbar_expect_tx(v_full(s), C::kVBytes);
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
        wg::tma_load_3d(sV + s * C::kVBytes + c * BC * 128, &maps.v, v_full(s), 64 * c,
                        it * BC, h);
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int cw = wgi - 1;  // rows [64 cw, 64 cw + 64) of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int wr0 = r0 + 64 * cw + 16 * warp;  // the warp's first row
    const int qi = wr0 + g;                    // the thread's rows qi, qi + 8
    // a product completes for the whole warpgroup at once, so one thread
    // releases its slot
    const bool signals = tid == 0;
    const int64_t row0 = (int64_t)h * a.sq;

    // the carried state: m by row, the thread's part of l (the quad's first
    // lane holds l_in), O on the accumulator's layout
    float m[2], lp[2], O[DV / 2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = qi + 8 * hh;
      m[hh] = row < a.sq ? a.m_in[row0 + row] : kNeg;
      lp[hh] = row < a.sq && t == 0 ? a.l_in[row0 + row] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = qi + 8 * hh;
        float2 x = make_float2(0.f, 0.f);
        if (row < a.sq)
          x = *reinterpret_cast<const float2*>(a.acc_in + (row0 + row) * DV + 8 * j + 2 * t);
        O[4 * j + 2 * hh] = x.x;
        O[4 * j + 2 * hh + 1] = x.y;
      }

    if (ntiles > 0) {
      // keys [0, kend) of the thread's rows are live (flash_fwd::is_live),
      // and keys [0, wend) of all the warp's rows: a tile below wend needs
      // no mask
      auto live_end = [&](int row) {
        if (row >= a.sq) return 0;
        int64_t e = a.skv;
        const int64_t v = (int64_t)a.valid_len - a.k_offset;
        e = v < e ? v : e;
        if (a.causal) {
          const int64_t c = (int64_t)a.q_offset + row - a.k_offset + 1;
          e = c < e ? c : e;
        }
        return (int)(e > 0 ? e : 0);
      };
      const int kend[2] = {live_end(qi), live_end(qi + 8)};
      const int wend = wr0 + 16 <= a.sq ? live_end(wr0) : 0;
      const uint64_t dq = wg::smem_desc(sQ + cw * 64 * 128);  // the warpgroup's Q rows
      // named barrier 1 + w: warpgroup w's turn to issue its scores
      const int my_turn = 1 + cw, other_turn = 2 - cw;
      float S[BC / 2], alpha[2];
      uint32_t P[BC / 16][4];
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) S[i] = 0.f;
      wg::mbar_wait(q_full, 0);
      if (cw == 1) wg::named_arrive(1, 256);  // warpgroup 0 issues first
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        const uint32_t ph = (it / ST) & 1;
        const int c0 = it * BC;
        wg::mbar_wait(k_full(s), ph);
        wg::named_sync(my_turn, 256);
        wg::fence_regs(S);
        wg::wgmma_fence();
        issue_scores<DQ, BR, BC>(S, opaque(dq), opaque(wg::smem_desc(sK + s * C::kKBytes)));
        // warpgroup 0's last turn comes after warpgroup 1's last but one
        if (cw == 0 || it + 1 < ntiles) wg::named_arrive(other_turn, 256);
        wg::wgmma_wait<0>();
        wg::fence_regs(S);
        if (signals) wg::mbar_arrive(k_empty(s));
        softmax_tile(S, m, lp, alpha, a.scale, c0 + BC <= wend, kend, c0 + 2 * t);
        rescale_and_pack<DV, BC>(O, P, S, alpha);
        wg::mbar_wait(v_full(s), ph);
        wg::fence_regs(O);
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) wg::fence_frag(P[kk]);
        wg::wgmma_fence();
        issue_pv<DV, BC>(O, P, opaque(wg::smem_desc_mn(sV + s * C::kVBytes, BC * 128)));
        wg::wgmma_wait<0>();
        wg::fence_regs(O);
        if (signals) wg::mbar_arrive(v_empty(s));
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = qi + 8 * hh;
      const float l = tc::quad_sum(lp[hh]);
      if (row >= a.sq) continue;
      if (t == 0) {
        a.m_out[row0 + row] = m[hh];
        a.l_out[row0 + row] = l;
      }
      float* out = a.acc_out + (row0 + row) * DV + 2 * t;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        wg::store2(out + 8 * j, O[4 * j + 2 * hh], O[4 * j + 2 * hh + 1]);
    }
  }
}

// the strides TMA reads: a dimension of one row or one head keeps any
// stride the caller's view has, so it gets the one a contiguous tensor
// would
inline void tma_strides(int64_t heads, int64_t rows, int64_t w, int64_t& si, int64_t& sh) {
  if (rows <= 1) si = w;
  if (heads <= 1) sh = si * (rows > 1 ? rows : 1);
}

template <int DQ, int DV>
cudaError_t launch(const Args& a) {
  using C = Cfg<DQ, DV>;
  if (a.dqk != DQ || a.dv != DV) return cudaErrorInvalidValue;
  const int64_t kv_rows = a.skv > 0 ? a.skv : 1;  // no tile is loaded then
  int64_t q_si = a.q_si, q_sh = a.q_sh, k_si = a.k_si, k_sh = a.k_sh, v_si = a.v_si,
          v_sh = a.v_sh;
  tma_strides(a.H, a.sq, DQ, q_si, q_sh);
  tma_strides(a.H, kv_rows, DQ, k_si, k_sh);
  tma_strides(a.H, kv_rows, DV, v_si, v_sh);
  Maps maps;
  cudaError_t err;
  using bf16 = __nv_bfloat16;
  if ((err = wg::make_map_3d<bf16>(&maps.q, a.q, a.H, a.sq, DQ, q_si, q_sh, C::BR)) !=
      cudaSuccess)
    return err;
  if ((err = wg::make_map_3d<bf16>(&maps.k, a.k, a.H, kv_rows, DQ, k_si, k_sh, C::BC)) !=
      cudaSuccess)
    return err;
  if ((err = wg::make_map_3d<bf16>(&maps.v, a.v, a.H, kv_rows, DV, v_si, v_sh, C::BC)) !=
      cudaSuccess)
    return err;
  auto kern = flash_fwd_kernel_sm90<DQ, DV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)((a.sq + C::BR - 1) / C::BR) * a.H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, C::NT, C::kSmem, a.stream>>>(maps, a);
  return cudaGetLastError();
}

// TMA's rule for the maps: 16-byte-aligned base pointers, and head and row
// strides of a positive multiple of 16 bytes wherever the dimension holds
// more than one head or row (ops/flash_attention.py: _tma_ready)
inline bool tma_ready(const Args& a) {
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const int64_t rows[3] = {a.sq, a.skv, a.skv};
  const int64_t sh[3] = {a.q_sh, a.k_sh, a.v_sh}, si[3] = {a.q_si, a.k_si, a.v_si};
  for (int i = 0; i < 3; ++i) {
    if (a.H > 1 && (sh[i] <= 0 || sh[i] * 2 % 16)) return false;
    if (rows[i] > 1 && (si[i] <= 0 || si[i] * 2 % 16)) return false;
  }
  return true;
}

// the (192, 128) instance (flash_attention_sm90_mla.cu)
cudaError_t launch_mla(const Args& a);

}  // namespace flash_sm90
