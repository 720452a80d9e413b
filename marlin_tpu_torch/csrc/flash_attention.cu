// One flash-attention forward panel with carried state, hand-written for
// Hopper (sm_90a).
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
// Design:
// - One launch covers all heads: a block per (64-row q tile, head), 256
//   threads. The TPU's sequential kv grid axis becomes a loop over 64-key
//   tiles inside the block; the loop ends at the last tile that holds a live
//   key (valid_len, and the causal frontier of the tile's last row), which is
//   the TPU kernel's block skip. Skipping a tile with no live entry is exact:
//   it would add p = 0 and rescale by alpha = 1.
// - Q (transposed), K (transposed), V and P tiles sit in shared memory as f32;
//   each thread owns a 4 x 4 block of the score tile and a 4 x (d/16) block of
//   the accumulator, read as float4 rows (no bank conflicts on the reads).
//   Row statistics reduce over the 16 threads of a half-warp with shuffles.
// - f32 inputs are multiplied with plain f32 FMA: no TF32 (the TPU kernel pins
//   Precision.HIGHEST). bf16 inputs are widened on their way into shared
//   memory; products of two bf16 values are exact in f32.
// - Ragged edges (sq, skv not multiples of 64, d below the compiled width)
//   are masked here with zero fill; strides for q/k/v let the caller pass a
//   (seq, heads, d) layout without a transposed copy. Offsets are 64-bit.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): operations, 4 * d per live
// (query, key) pair, at 67 TFLOP/s for f32 outside the tensor cores (989 for
// bf16 on the tensor cores, which this CUDA-core kernel does not use yet).
// wgmma (3xTF32 for f32) with TMA-fed stages is the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NT = 256;
constexpr int LDQ = BQ + 4;   // Qt / Pt row stride (floats), float4-aligned
constexpr int LDK = BKV + 4;  // Kt row stride
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ float in_type(float x);
template <> __device__ __forceinline__ float in_type<float>(float x) { return x; }
template <> __device__ __forceinline__ float in_type<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum / max over the 16 lanes that share a query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DP>
constexpr size_t smem_floats() {
  return (size_t)DP * LDQ + (size_t)DP * LDK + (size_t)BKV * DP + (size_t)BKV * LDQ;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, const float* __restrict__ acc_in,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 float* __restrict__ acc_out, int sq, int skv, int d, int64_t q_sh,
                 int64_t q_si, int64_t k_sh, int64_t k_si, int64_t v_sh, int64_t v_si,
                 int q_offset, int k_offset, int valid_len, int causal, float scale) {
  constexpr int DC = DP / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DP][LDQ]
  float* Kt = Qt + DP * LDQ;                    // [DP][LDK]
  float* Vs = Kt + DP * LDK;                    // [BKV][DP]
  float* Pt = Vs + BKV * DP;                    // [BKV][LDQ]

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* qh = q + (int64_t)h * q_sh;
  const T* kh = k + (int64_t)h * k_sh;
  const T* vh = v + (int64_t)h * v_sh;
  const int64_t row0 = (int64_t)h * sq;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int qi = q0 + r;
    Qt[c * LDQ + r] = (qi < sq && c < d) ? to_f(qh[(int64_t)qi * q_si + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const bool in = qi < sq;
    m[i] = in ? m_in[row0 + qi] : kNeg;
    l[i] = in ? l_in[row0 + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx * DC + j;
      acc[i][j] = (in && c < d) ? acc_in[(row0 + qi) * d + c] : 0.f;
    }
  }

  // keys past k_end hold no live entry for any row of this tile
  int k_end = skv;
  k_end = min(k_end, valid_len - k_offset);
  if (causal) {
    const int q_last = q_offset + min(q0 + BQ, sq) - 1;
    k_end = min(k_end, q_last - k_offset + 1);
  }
  const int qpos0 = q_offset + q0 + ty * 4;

  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BKV * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int kj = k0 + r;
      const bool in = kj < skv && c < d;
      Kt[c * LDK + r] = in ? to_f(kh[(int64_t)kj * k_si + c]) : 0.f;
      Vs[r * DP + c] = in ? to_f(vh[(int64_t)kj * v_si + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + c * LDQ + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(Kt + c * LDK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qpos0 + i;
      bool keep[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const int kpos = k_offset + kj;
        keep[j] = kj < skv && kpos < valid_len && (!causal || qpos >= kpos);
        s[i][j] = keep[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        s[i][j] = p;
      }
      rs = row_sum(rs);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 pj = make_float4(in_type<T>(s[0][j]), in_type<T>(s[1][j]),
                              in_type<T>(s[2][j]), in_type<T>(s[3][j]));
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * LDQ + ty * 4) = pj;
    }
    __syncthreads();

    float pv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < BKV; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + r * LDQ + ty * 4);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; j += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(Vs + r * DP + tx * DC + j);
        vv[j] = v4.x;
        vv[j + 1] = v4.y;
        vv[j + 2] = v4.z;
        vv[j + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) pv[i][j] = fmaf(pr[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    if (tx == 0) {
      m_out[row0 + qi] = m[i];
      l_out[row0 + qi] = l[i];
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx * DC + j;
      if (c < d) acc_out[(row0 + qi) * d + c] = acc[i][j];
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const float* m_in,
                   const float* l_in, const float* acc_in, float* m_out, float* l_out,
                   float* acc_out, int H, int sq, int skv, int d, int64_t q_sh,
                   int64_t q_si, int64_t k_sh, int64_t k_si, int64_t v_sh, int64_t v_si,
                   int q_offset, int k_offset, int valid_len, int causal, float scale,
                   cudaStream_t s) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)H);
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), m_in, l_in, acc_in, m_out, l_out,
                              acc_out, sq, skv, d, q_sh, q_si, k_sh, k_si, v_sh, v_si,
                              q_offset, k_offset, valid_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* m_in,
                     const float* l_in, const float* acc_in, float* m_out, float* l_out,
                     float* acc_out, int H, int sq, int skv, int d, int64_t q_sh,
                     int64_t q_si, int64_t k_sh, int64_t k_si, int64_t v_sh,
                     int64_t v_si, int q_offset, int k_offset, int valid_len, int causal,
                     float scale, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, H, sq, skv,
                         d, q_sh, q_si, k_sh, k_si, v_sh, v_si, q_offset, k_offset,
                         valid_len, causal, scale, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, H, sq,
                          skv, d, q_sh, q_si, k_sh, k_si, v_sh, v_si, q_offset,
                          k_offset, valid_len, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (H, sq, d), k and v (H, skv, d), given
// by their head and row strides in elements (the last dimension contiguous);
// m_in, l_in, m_out, l_out (H, sq) and acc_in, acc_out (H, sq, d) contiguous
// f32. Outputs may not alias inputs. Returns the launch's cudaError_t.
int marlin_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     const void* m_in, const void* l_in, const void* acc_in,
                     void* m_out, void* l_out, void* acc_out, int H, int sq, int skv,
                     int d, long long q_sh, long long q_si, long long k_sh,
                     long long k_si, long long v_sh, long long v_si, int q_offset,
                     int k_offset, int valid_len, int causal, float scale,
                     void* stream) {
  if (H <= 0 || sq <= 0) return (int)cudaSuccess;
  if (d <= 0 || skv < 0 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mi = static_cast<const float*>(m_in);
  const float* li = static_cast<const float*>(l_in);
  const float* ai = static_cast<const float*>(acc_in);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, mi, li, ai, mo, lo, ao, H, sq, skv, d, q_sh,
                                q_si, k_sh, k_si, v_sh, v_si, q_offset, k_offset,
                                valid_len, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mi, li, ai, mo, lo, ao, H, sq, skv, d,
                                        q_sh, q_si, k_sh, k_si, v_sh, v_si, q_offset,
                                        k_offset, valid_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
