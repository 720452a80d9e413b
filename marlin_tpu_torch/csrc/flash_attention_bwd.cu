// The two flash-attention backward kernels of one panel, hand-written for
// Hopper (sm_90a).
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
// kernels cast them down before each dot. q, k, v, dO are f32 or bf16; lse and
// delta (H, sq) f32; dq (H, sq, d), dk and dv (H, skv, d) f32 out.
//
// Design:
// - Two kernels, as on the TPU, so every output element has one writer: no
//   atomics, and the results do not change from run to run.
// - dK/dV: a block per (64-key tile, head), 256 threads. K and V stay in
//   shared memory, the dK and dV accumulators in registers (4 key rows x d/16
//   columns each per thread); a loop over 64-row q tiles takes the place of
//   the TPU's sequential q grid axis. It starts at the causal frontier (the
//   first q tile holding a row at or past the tile's first key) and a key tile
//   wholly past valid_len runs no iteration: skipping a tile with no live
//   entry is exact, it would add p = ds = 0.
// - dQ: a block per (64-row q tile, head); Q and dO stay in shared memory, the
//   loop over 64-key tiles ends at the last tile holding a live key (valid_len
//   and the causal frontier of the tile's last row), as the forward's does.
//   Blocks take the q tiles last to first, so the longest loops start first
//   (the dK/dV kernel's first key tiles are its longest already).
// - Every tile sits in shared memory as f32, row-major with a row stride of
//   d + 4 floats. For the score tiles a thread owns rows t + 16 i of one side
//   and t' + 16 j of the other, read as float4 along d: lanes of a half-warp
//   then read 16-byte slots in distinct banks. p and ds go through shared
//   memory once, transposed, for the second products.
// - f32 inputs are multiplied with plain f32 FMA: no TF32 (the TPU kernels pin
//   Precision.HIGHEST). bf16 inputs are widened on their way into shared
//   memory; products of two bf16 values are exact in f32.
// - Ragged edges (sq, skv not multiples of 64, d below the compiled width)
//   are masked with zero fill; strides for q, k, v and dO let the caller pass
//   a (seq, heads, d) layout without a transposed copy. Offsets are 64-bit.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): operations, at 67 TFLOP/s
// for f32 outside the tensor cores — 8 * d per live (query, key) pair for
// dK/dV (the s and dO.V recomputes, p.dO and ds.Q) and 6 * d for dQ (s, dO.V,
// ds.K). The kernels run on CUDA cores; wgmma (3xTF32 for f32, bf16 directly)
// with TMA-fed stages, or one fused kernel with atomic dQ, is the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows of a q tile, keys of a kv tile
constexpr int NT = 256;
constexpr int LDP = BT + 4;   // row stride of the p / ds tiles (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ float in_type(float x);
template <> __device__ __forceinline__ float in_type<float>(float x) { return x; }
template <> __device__ __forceinline__ float in_type<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [r0, r0 + BT) of an (n, d) matrix with row stride si, into a
// [BT][DP + 4] f32 tile; zero past n and past d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int n, int d, int64_t si) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < BT * DP; idx += NT) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int row = r0 + r;
    dst[r * LD + c] = (row < n && c < d) ? to_f(src[(int64_t)row * si + c]) : 0.f;
  }
}

// s[i][j] = sum_c A[ra + 16 i][c] * B[rb + 16 j][c] for two [BT][DP + 4] tiles
template <int DP>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A,
                                          const float* B, int ra, int rb) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ bool is_live(int qi, int kj, int sq, int skv, int q_offset,
                                        int k_offset, int valid_len, int causal) {
  const int64_t qpos = (int64_t)q_offset + qi;
  const int64_t kpos = (int64_t)k_offset + kj;
  return qi < sq && kj < skv && kpos < valid_len && (!causal || qpos >= kpos);
}

template <int DP>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)BT * (DP + 4) + 2 * (size_t)BT * LDP + 2 * BT;
}

template <int DP>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)BT * (DP + 4) + (size_t)BT * LDP + 2 * BT;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
                     int d, int64_t q_sh, int64_t q_si, int64_t k_sh, int64_t k_si,
                     int64_t v_sh, int64_t v_si, int64_t o_sh, int64_t o_si, int q_offset,
                     int k_offset, int valid_len, int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BT][LD]
  float* Vs = Ks + BT * LD;                     // [BT][LD]
  float* Qs = Vs + BT * LD;                     // [BT][LD]
  float* Os = Qs + BT * LD;                     // dO, [BT][LD]
  float* Pt = Os + BT * LD;                     // p, [q][key]
  float* St = Pt + BT * LDP;                    // ds, [q][key]
  float* lse_s = St + BT * LDP;
  float* dlt_s = lse_s + BT;

  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* qh = q + (int64_t)h * q_sh;
  const T* oh = dout + (int64_t)h * o_sh;
  const int64_t qrow0 = (int64_t)h * sq;

  load_tile<T, DP>(Ks, k + (int64_t)h * k_sh, k0, skv, d, k_si);
  load_tile<T, DP>(Vs, v + (int64_t)h * v_sh, k0, skv, d, v_si);

  float dka[4][4 * NC], dva[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) {
      dka[i][c] = 0.f;
      dva[i][c] = 0.f;
    }

  // rows before q_begin see none of this tile's keys; a tile whose first key
  // is at or past valid_len has no live entry at all
  int64_t q_begin = 0;
  if (causal) {
    q_begin = (int64_t)k_offset + k0 - q_offset;
    q_begin = q_begin < 0 ? 0 : q_begin;
  }
  const bool any = (int64_t)k_offset + k0 < valid_len && q_begin < sq;
  const int q_stop = any ? sq : 0;
  const int q_first = any ? (int)(q_begin / BT) * BT : 0;

  for (int q0 = q_first; q0 < q_stop; q0 += BT) {
    __syncthreads();  // the previous tile's Q, dO, p and ds are no longer read
    load_tile<T, DP>(Qs, qh, q0, sq, d, q_si);
    load_tile<T, DP>(Os, oh, q0, sq, d, o_si);
    if (tid < BT) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < sq ? lse[qrow0 + qi] : 0.f;
      dlt_s[tid] = qi < sq ? delta[qrow0 + qi] : 0.f;
    }
    __syncthreads();

    // score tile: key ty + 16 i against query tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<DP>(s, Ks, Qs, ty, tx);
    tile_dots<DP>(dp, Vs, Os, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = ty + 16 * i;
        const int ql = tx + 16 * j;
        const bool live =
            is_live(q0 + ql, k0 + kl, sq, skv, q_offset, k_offset, valid_len, causal);
        const float p = live ? expf(s[i][j] * scale - lse_s[ql]) : 0.f;
        const float ds = p * (dp[i][j] - dlt_s[ql]);
        Pt[ql * LDP + kl] = in_type<T>(p);
        St[ql * LDP + kl] = in_type<T>(ds);
      }
    __syncthreads();

    // dV += p^T dO, dK += ds^T Q: key rows ty * 4 + i, columns g * 64 + tx * 4 + e
#pragma unroll 2
    for (int r = 0; r < BT; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + r * LDP + ty * 4);
      const float4 s4 = *reinterpret_cast<const float4*>(St + r * LDP + ty * 4);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 o4 = *reinterpret_cast<const float4*>(Os + r * LD + g * 64 + tx * 4);
        const float4 q4 = *reinterpret_cast<const float4*>(Qs + r * LD + g * 64 + tx * 4);
        const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dva[i][g * 4 + e] = fmaf(pr[i], ov[e], dva[i][g * 4 + e]);
            dka[i][g * 4 + e] = fmaf(sr[i], qv[e], dka[i][g * 4 + e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= skv) continue;
    const int64_t row = ((int64_t)h * skv + kj) * d;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 64 + tx * 4 + e;
        if (c < d) {
          dk[row + c] = dka[i][g * 4 + e] * scale;
          dv[row + c] = dva[i][g * 4 + e];
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int sq, int skv, int d, int64_t q_sh,
                    int64_t q_si, int64_t k_sh, int64_t k_si, int64_t v_sh, int64_t v_si,
                    int64_t o_sh, int64_t o_si, int q_offset, int k_offset, int valid_len,
                    int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BT][LD]
  float* Os = Qs + BT * LD;                     // dO, [BT][LD]
  float* Ks = Os + BT * LD;                     // [BT][LD]
  float* Vs = Ks + BT * LD;                     // [BT][LD]
  float* St = Vs + BT * LD;                     // ds, [key][q]
  float* lse_s = St + BT * LDP;
  float* dlt_s = lse_s + BT;

  const int h = blockIdx.y;
  // the last q tiles see the most keys under a causal mask: they are handed
  // out first, so that the short tiles fill the tail of the launch
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* kh = k + (int64_t)h * k_sh;
  const T* vh = v + (int64_t)h * v_sh;
  const int64_t qrow0 = (int64_t)h * sq;

  load_tile<T, DP>(Qs, q + (int64_t)h * q_sh, q0, sq, d, q_si);
  load_tile<T, DP>(Os, dout + (int64_t)h * o_sh, q0, sq, d, o_si);
  if (tid < BT) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < sq ? lse[qrow0 + qi] : 0.f;
    dlt_s[tid] = qi < sq ? delta[qrow0 + qi] : 0.f;
  }

  float dqa[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dqa[i][c] = 0.f;

  // keys at or past k_end hold no live entry for any row of this tile
  int64_t k_end = skv;
  k_end = k_end < (int64_t)valid_len - k_offset ? k_end : (int64_t)valid_len - k_offset;
  if (causal) {
    const int64_t q_last = (int64_t)q_offset + (q0 + BT < sq ? q0 + BT : sq) - 1;
    const int64_t f = q_last - k_offset + 1;
    k_end = k_end < f ? k_end : f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous tile's K, V and ds are no longer read
    load_tile<T, DP>(Ks, kh, k0, skv, d, k_si);
    load_tile<T, DP>(Vs, vh, k0, skv, d, v_si);
    __syncthreads();

    // score tile: query ty + 16 i against key tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<DP>(s, Qs, Ks, ty, tx);
    tile_dots<DP>(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = ty + 16 * i;
        const int kl = tx + 16 * j;
        const bool live =
            is_live(q0 + ql, k0 + kl, sq, skv, q_offset, k_offset, valid_len, causal);
        const float p = live ? expf(s[i][j] * scale - lse_s[ql]) : 0.f;
        St[kl * LDP + ql] = in_type<T>(p * (dp[i][j] - dlt_s[ql]));
      }
    __syncthreads();

    // dQ += ds K: query rows ty * 4 + i, columns g * 64 + tx * 4 + e
#pragma unroll 2
    for (int r = 0; r < BT; ++r) {
      const float4 s4 = *reinterpret_cast<const float4*>(St + r * LDP + ty * 4);
      const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 k4 = *reinterpret_cast<const float4*>(Ks + r * LD + g * 64 + tx * 4);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dqa[i][g * 4 + e] = fmaf(sr[i], kv[e], dqa[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    const int64_t row = (qrow0 + qi) * d;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 64 + tx * 4 + e;
        if (c < d) dq[row + c] = dqa[i][g * 4 + e] * scale;
      }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *out0, *out1;
  int H, sq, skv, d;
  int64_t q_sh, q_si, k_sh, k_si, v_sh, v_si, o_sh, o_si;
  int q_offset, k_offset, valid_len, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_floats<DP>() * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.skv + BT - 1) / BT), (unsigned)a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.out0, a.out1, a.sq, a.skv, a.d,
      a.q_sh, a.q_si, a.k_sh, a.k_si, a.v_sh, a.v_si, a.o_sh, a.o_si, a.q_offset,
      a.k_offset, a.valid_len, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<DP>() * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.sq + BT - 1) / BT), (unsigned)a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.out0, a.sq, a.skv, a.d, a.q_sh,
      a.q_si, a.k_sh, a.k_si, a.v_sh, a.v_si, a.o_sh, a.o_si, a.q_offset, a.k_offset,
      a.valid_len, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_width(const Args& a) {
  if (a.d <= 64) return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.d <= 128) return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run(int dtype, const Args& a) {
  if (a.H <= 0 || (DKV ? a.skv : a.sq) <= 0) return (int)cudaSuccess;
  if (a.d <= 0 || a.sq < 0 || a.skv < 0 || a.H > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_width<DKV, float>(a);
  if (dtype == 1) return (int)dispatch_width<DKV, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* out0, void* out1, int H, int sq,
               int skv, int d, long long q_sh, long long q_si, long long k_sh,
               long long k_si, long long v_sh, long long v_si, long long o_sh,
               long long o_si, int q_offset, int k_offset, int valid_len, int causal,
               float scale, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(out0),
              static_cast<float*>(out1), H, sq, skv, d, q_sh, q_si, k_sh, k_si, v_sh,
              v_si, o_sh, o_si, q_offset, k_offset, valid_len, causal, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q and dout (H, sq, d), k and v (H, skv, d),
// given by their head and row strides in elements (the last dimension
// contiguous); lse and delta (H, sq) contiguous f32; dk and dv (H, skv, d)
// contiguous f32, written whole. Returns the launch's cudaError_t.
int marlin_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int H, int sq, int skv, int d, long long q_sh,
                         long long q_si, long long k_sh, long long k_si, long long v_sh,
                         long long v_si, long long o_sh, long long o_si, int q_offset,
                         int k_offset, int valid_len, int causal, float scale,
                         void* stream) {
  return run<true>(dtype, make_args(q, k, v, dout, lse, delta, dk, dv, H, sq, skv, d, q_sh,
                                    q_si, k_sh, k_si, v_sh, v_si, o_sh, o_si, q_offset,
                                    k_offset, valid_len, causal, scale, stream));
}

// As marlin_flash_bwd_dkv; dq (H, sq, d) contiguous f32, written whole.
int marlin_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dq,
                        int H, int sq, int skv, int d, long long q_sh, long long q_si,
                        long long k_sh, long long k_si, long long v_sh, long long v_si,
                        long long o_sh, long long o_si, int q_offset, int k_offset,
                        int valid_len, int causal, float scale, void* stream) {
  return run<false>(dtype, make_args(q, k, v, dout, lse, delta, dq, nullptr, H, sq, skv, d,
                                     q_sh, q_si, k_sh, k_si, v_sh, v_si, o_sh, o_si,
                                     q_offset, k_offset, valid_len, causal, scale, stream));
}

}  // extern "C"
