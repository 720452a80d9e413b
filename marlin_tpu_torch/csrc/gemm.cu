// Tiled f32-accumulating GEMM, c = a @ b, hand-written for Hopper (sm_90a).
//
// Replaces: marlin_tpu/ops/pallas_kernels.py `_matmul_kernel` (reached through
// `pallas_matmul`), a Pallas TPU kernel over the grid (m/bm, n/bn, k/bk) that
// carries an f32 accumulator in VMEM scratch across the sequential k axis and
// pads its operands up to the tile grid.
//
// Design:
// - One thread block owns one BM x BN output tile. The TPU's sequential k grid
//   axis becomes a loop inside the block: each step stages a BM x BK panel of A
//   (stored k-major, i.e. transposed, rows padded by APAD) and a BK x BN panel
//   of B in shared memory as f32, then every thread does BK rank-1 updates of
//   its 8 x 8 register block of outputs with plain f32 FMA (no TF32: the
//   answer matches an f32 product up to accumulation-order rounding).
// - A thread's 8 rows are two groups of 4 (ty*4 and BM/2 + ty*4), and so are
//   its 8 columns, so the float4 reads of a shared-memory row are contiguous
//   across the warp and free of bank conflicts.
// - The ragged edge is masked here, at load (zero fill) and at store (bounds
//   check): no padded copy of an operand is ever made. At 20000^2 such a copy
//   would be 1.6 GB per operand.
// - Every global offset is 64-bit.
// - bf16 inputs are widened to f32 on their way into shared memory; the output
//   is written in the input type.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): 2*m*n*k operations at
// 67 TFLOP/s of f32 outside the tensor cores, i.e. 0.239 s at 20000^3. The
// kernel is compute-bound there; wgmma with 3xTF32 and TMA-fed multi-stage
// pipelines are the later steps.
//
// The instantiated (BM, BN, BK) tiles are the tile family that
// marlin_tpu_torch/ops/tile_family.py proposes; keep the two lists in step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;  // outputs per thread along m
constexpr int TN = 8;  // outputs per thread along n
constexpr int APAD = 4;  // row padding of the k-major A panel: its transposing
                         // stores would otherwise hit one bank 16 to 32 ways

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Threads per block, and blocks per SM the register budget must allow: 512
// threads per SM caps a thread at 128 registers. One register more halves the
// blocks an SM holds: on an H100 SXM, 129 registers made the 20000^3 product
// 46 % slower (chip_smoke.py).
template <int BM, int BN>
constexpr int kThreads = (BM / TM) * (BN / TN);
template <int BM, int BN>
constexpr int kMinBlocks = 512 / kThreads<BM, BN>;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads<BM, BN>, kMinBlocks<BM, BN>)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
            int64_t m, int64_t n, int64_t k, unsigned tiles_n) {
  constexpr int NT = kThreads<BM, BN>;
  constexpr int TX = BN / TN;  // threads along n
  static_assert((BM * BK) % NT == 0, "A panel must split evenly over threads");
  static_assert((BK * BN) % NT == 0, "B panel must split evenly over threads");
  static_assert(BM % 8 == 0 && BN % 8 == 0, "tiles are multiples of 8");

  extern __shared__ __align__(16) float smem[];
  constexpr int AS = BM + APAD;  // row stride of As, a multiple of 4 floats
  float* As = smem;              // [BK][AS], k-major
  float* Bs = smem + BK * AS;    // [BK][BN]

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  // a 1-D grid over the output tiles, n fastest: no 65535 cap on either
  // dimension's tile count, as a 2-D grid's y axis would impose
  const int64_t row0 = (int64_t)(blockIdx.x / tiles_n) * BM;
  const int64_t col0 = (int64_t)(blockIdx.x % tiles_n) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    // A panel: element e -> (r, kk), consecutive threads walk along k, which
    // is contiguous in global memory.
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK;
      const int kk = e % BK;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kk;
      float v = 0.0f;
      if (gr < m && gk < k) v = to_f32(a[gr * k + gk]);
      As[kk * AS + r] = v;
    }
    // B panel: element e -> (kk, cc), consecutive threads walk along n.
#pragma unroll
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN;
      const int cc = e % BN;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + cc;
      float v = 0.0f;
      if (gk < k && gc < n) v = to_f32(b[gk * n + gc]);
      Bs[kk * BN + cc] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk * AS + ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk * AS + BM / 2 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk * BN + BN / 2 + tx * 4]);
      av[0] = a_lo.x; av[1] = a_lo.y; av[2] = a_lo.z; av[3] = a_lo.w;
      av[4] = a_hi.x; av[5] = a_hi.y; av[6] = a_hi.z; av[7] = a_hi.w;
      bv[0] = b_lo.x; bv[1] = b_lo.y; bv[2] = b_lo.z; bv[3] = b_lo.w;
      bv[4] = b_hi.x; bv[5] = b_hi.y; bv[6] = b_hi.z; bv[7] = b_hi.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (gc < n) from_f32(&c[gr * n + gc], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
                   int64_t k, cudaStream_t stream) {
  constexpr int NT = kThreads<BM, BN>;
  const size_t smem = sizeof(float) * (size_t)(BK * (BM + APAD) + BK * BN);
  auto kern = gemm_kernel<T, BM, BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = tiles_n * ((m + BM - 1) / BM);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)tiles, NT, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, (unsigned)tiles_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bm, int bn, int bk, const void* a, const void* b, void* c,
                     int64_t m, int64_t n, int64_t k, cudaStream_t s) {
#define MARLIN_TILE(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch<T, BM_, BN_, BK_>(a, b, c, m, n, k, s);
  MARLIN_TILE(64, 64, 16)
  MARLIN_TILE(64, 64, 32)
  MARLIN_TILE(64, 128, 16)
  MARLIN_TILE(64, 128, 32)
  MARLIN_TILE(128, 64, 16)
  MARLIN_TILE(128, 64, 32)
  MARLIN_TILE(128, 128, 16)
  MARLIN_TILE(128, 128, 32)
#undef MARLIN_TILE
  return cudaErrorInvalidValue;  // not an instantiated tile
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. a (m, k), b (k, n), c (m, n), all
// row-major and contiguous, on the stream's device. Returns the launch's
// cudaError_t (0 on success); cudaErrorInvalidValue for an unknown tile.
int marlin_gemm(int dtype, int bm, int bn, int bk, const void* a, const void* b,
                void* c, long long m, long long n, long long k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(bm, bn, bk, a, b, c, m, n, k, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(bm, bn, bk, a, b, c, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}

const char* marlin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
