// Warp-level tensor-core, asynchronous-copy and shared-memory helpers for
// Hopper (sm_90a), shared by the hand-written attention kernels.
//
// - mma.sync m16n8k8 TF32 and m16n8k16 bf16, f32 accumulate. Fragment
//   layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / m16n8k16"), with
//   g = lane / 4 and t = lane % 4:
//     A (16 x K, row): TF32 a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4);
//                      bf16 pairs a01 (g, 2t..) a23 (g+8, 2t..) a45 (g, 2t+8..)
//                      a67 (g+8, 2t+8..)
//     B (K x 8, col):  TF32 b0 (t, g) b1 (t+4, g); bf16 b01 (2t.., g) b23 (2t+8.., g)
//     C (16 x 8):      c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   A product sums over k in any order, so the kernels may map a fragment's
//   k slots onto any physical columns, as long as A and B use the same map.
// - 3xTF32: x = big + small with big = tf32_rna(x), small = tf32_rna(x - big)
//   (tf32_rna rounds as cvt.rna.tf32.f32 does);
//   a.b ~ small_a.big_b + big_a.small_b + big_a.big_b, each product of two
//   TF32 values exact in the f32 accumulator. What is dropped (small.small,
//   and the rounding of small) is about 2^-22 of |a||b|: f32 accuracy at a
//   third of the TF32 rate.
// - cp.async with zero fill: src_bytes < 16 (0 for a row past the end)
//   writes zeros for the rest of the 16-byte chunk.
// - A row of 16-byte chunks is stored with chunk c at c ^ swz(row): the
//   fragment loads of the attention kernels (16-byte reads at chunk 4kc + t of
//   rows g and g + 8 or 8j + g; 16-byte reads at chunk 8i + g of rows 2t and
//   2t + 1; ldmatrix of 8 consecutive rows) then hit 8 distinct 16-byte bank
//   groups in every quarter warp.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a permutation of 0..7; see the head note
__device__ __forceinline__ int swz(int row) {
  return ((((row >> 1) ^ row) & 1) << 2) | (((row >> 2) & 1) << 1) | (row & 1);
}

// element offset of (row, col) in a [rows][DP] tile of T stored with swizzled
// 16-byte chunks
template <typename T, int DP>
__device__ __forceinline__ int swz_at(int row, int col) {
  constexpr int E = 16 / (int)sizeof(T);
  return row * DP + (((col / E) ^ swz(row)) * E) + (col % E);
}

__device__ __forceinline__ uint4 lds128(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// cvt.rna.tf32.f32 (10 mantissa bits, ties away from zero) in two integer
// operations: adding half of the last kept bit to the pattern and clearing
// the 13 low bits rounds the magnitude and leaves the sign. The same bits as
// the conversion instruction, which issues at a quarter of the integer rate
// on Hopper (16 per clock and SM): with it the splits, not the products,
// bounded the backward kernels.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the big and small TF32 halves of an operand fragment
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Split<N> split_tf32(const uint32_t (&bits)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = __uint_as_float(bits[i]);
    s.big[i] = tf32_rna(x);
    s.small[i] = tf32_rna(x - __uint_as_float(s.big[i]));
  }
  return s;
}

template <int N>
__device__ __forceinline__ Split<N> split_tf32(const float (&x)[N]) {
  uint32_t bits[N];
#pragma unroll
  for (int i = 0; i < N; ++i) bits[i] = __float_as_uint(x[i]);
  return split_tf32(bits);
}

// the halves of a 16-byte chunk of four f32
__device__ __forceinline__ Split<4> split_tf32(const uint4& x) {
  const uint32_t bits[4] = {x.x, x.y, x.z, x.w};
  return split_tf32(bits);
}

// not volatile: a pure function of its operands, which the compiler may
// schedule among the other independent products
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j] += a.b[j] for N independent accumulators in three TF32 passes, the
// small terms first; each pass runs across all N, so consecutive products
// do not wait on each other
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], const Split<4>& a,
                                           const Split<2> (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.big, b[j].big);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8 of
// matrix l / 8 and receives, from each matrix m, r[m] = (M[2t][g], M[2t+1][g])
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// rows [r0, r0 + nrows) of an (n, d) matrix with row stride si into a
// swizzled [nrows][DP] tile, by the NT threads of a block; zeros past n and
// past d. VEC: 16-byte cp.async copies, which need a 16-byte-aligned base,
// stride and row (d * sizeof(T)); otherwise element-wise synchronous copies.
template <typename T, int DP, bool VEC, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int64_t si,
                                          int r0, int nrows, int n, int d) {
  if constexpr (VEC) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CPR = DP / E;
    for (int idx = threadIdx.x; idx < nrows * CPR; idx += NT) {
      const int r = idx / CPR;
      const int c = (idx % CPR) * E;
      const int row = r0 + r;
      const bool ok = row < n && c < d;
      cp_async16(dst + swz_at<T, DP>(r, c), ok ? src + (int64_t)row * si + c : src,
                 ok ? 16 : 0);
    }
  } else {
    // one synchronous load in flight a thread, as the backward's load_rows:
    // unrolled, the loads held at once spilled the forward's f32 (192, 128)
    // instance at ptxas -O3
#pragma unroll 1
    for (int idx = threadIdx.x; idx < nrows * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int row = r0 + r;
      dst[swz_at<T, DP>(r, c)] =
          (row < n && c < d) ? src[(int64_t)row * si + c] : static_cast<T>(0.f);
    }
  }
}

// max and sum over the four lanes of a quad (lanes 4g..4g+3), which hold the
// columns of accumulator rows g and g + 8
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace tc
