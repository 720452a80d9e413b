// One step of full-batch logistic-gradient descent over rows of (label,
// features), reading each stored row once, hand-written for Hopper (sm_90a).
// Built as a library of its own (ops/_build.py), so a process that runs only
// logistic regression builds only it: lr_gradient.cu (the C entry points and
// the float32 instances), lr_gradient_bf16.cu and lr_gradient_f64.cu, which
// compile at once.
//
// Replaces no TPU kernel: the JAX package's `_lr_fori`
// (marlin_tpu/ml/logistic_regression.py) leaves its two mat-vecs,
// feats @ w and feats.T @ mul, to XLA, over a copy of the data whose label
// column is replaced by the intercept's 1. On the card those were two cuBLAS
// gemv passes over the whole matrix an iteration, each near the memory's
// bandwidth, and the copy doubled the footprint. This kernel reads the rows
// once an iteration, where they are, and computes the margin, the residual
// and the row's share of the gradient together.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): bytes, one read of the
// m (d + 1) stored values an iteration at 3.35 TB/s, i.e. 6.125 ms for
// 10^7 x 513 float32. The arithmetic (two FMAs an element) is a tenth of
// that.
//
// Rows are float32, bfloat16 or float64 (dtype codes 0, 1, 2); the
// arithmetic, the weights and the gradient are float64 for float64 rows and
// float32 otherwise (bf16 values are widened as they are read).
//
// Design:
// - a persistent grid, one block an SM, chunks of rows taken in turn by
//   block. A producer warp streams slabs of whole rows into a ring of
//   shared-memory stages by 1-D bulk copies (TMA) completing on mbarriers; a
//   slab's copy is the byte range from the 16-byte boundary at or below its
//   first element to the one at or above its last, so any start and any row
//   stride (with unit column stride) is read in place. Eight consumer warps
//   read the slab from shared memory; column 0 is read as the label and
//   stands for the intercept's 1; mul = 1 / (1 + exp(-margin)) - label in
//   IEEE arithmetic.
// - lr_grad_rows, rows of at most 32 columns a lane (1024 columns; 512 for
//   float64, whose registers are twice as wide): the warps take the slab's
//   rows in turn; lane l holds columns l, l + 32, ... of the row and of w in
//   registers (KC = ceil(n / 32) of them, an instance for each count), the
//   margin is the warp's butterfly sum of their products (every lane gets
//   the same bits), and mul times the row is added into the lane's column
//   sums. At the end of each chunk the eight warps' sums are added in warp
//   order, through shared memory, into the chunk's row of the partial sums.
// - lr_grad_cols, wider rows (up to 8192 columns, as a stage holds them):
//   the 256 consumer threads split every row's columns, thread t holding
//   columns t, t + 256, ... of w and of the column sums in registers (KW =
//   ceil(n / 256) of them, an instance for each count). For each slab, four
//   rows at a time (two in float64), each warp's butterfly sums of its
//   columns' products go to shared memory; after a block barrier one thread
//   a row adds the eight warps' sums in warp order and takes the residual;
//   after another every thread adds mul times its columns, in row order.
//   Each thread writes its own columns of the chunk's partial row. Its
//   chunks are an eighth as long as lr_grad_rows' (ops/lr_gradient.py's
//   plan), so a thread's serial run of row terms is as long in both.
// - lr_reduce_kernel: sums the partial rows column by column in a fixed
//   order (32 serial runs, then a tree over them) and either writes the
//   gradient or applies w -= g * scale, the scale read on the card.
// No atomics and no order that depends on the grid: two launches on the
// same input give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kWarps = 8;                    // consumer warps
constexpr int kConsumers = kWarps * 32;      // consumer threads
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kStageBytes = 34 * 1024;       // mirrored by ops/lr_gradient.py
constexpr int kMaxStages = 6;
constexpr int kRowsKC = 32;                  // lr_grad_rows: columns a lane at most
constexpr int kColsKW = 32;                  // lr_grad_cols: columns a thread at most
constexpr int kMaxCols = kColsKW * kConsumers;  // 8192
constexpr int kSmemMax = 227 * 1024;         // a block's shared memory on sm_90
// shared memory: the mbarriers, then the stages, then the consumers' sums (the
// warps' column sums of a chunk; or a slab's per-warp sums and residuals, and
// slack past them)
constexpr int kStagesAt = 128;  // the stages' offset (16-byte aligned for TMA)

// the arithmetic's type for rows of T
template <typename T>
using Acc = std::conditional_t<std::is_same_v<T, double>, double, float>;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

// 1 / (1 + exp(-dot)) - label, rounded at each step
__device__ __forceinline__ float residual(float dot, float label) {
  return 1.0f / (1.0f + expf(-dot)) - label;
}
__device__ __forceinline__ double residual(double dot, double label) {
  return 1.0 / (1.0 + exp(-dot)) - label;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Slab {
  const char* src;  // 16-byte aligned
  uint32_t bytes;   // a multiple of 16
  uint32_t skip;    // bytes before the first row's first element
  int rows;
};

// rows [r0, r1) of x, as the enclosing 16-byte-aligned byte range
template <typename T>
__device__ __forceinline__ Slab slab_of(const T* x, int64_t n, int64_t stride, int64_t r0,
                                        int64_t r1) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(x + r0 * stride);
  const uintptr_t e = reinterpret_cast<uintptr_t>(x + (r1 - 1) * stride + n);
  const uintptr_t b16 = b & ~uintptr_t(15);
  const uintptr_t e16 = (e + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const char*>(b16), (uint32_t)(e16 - b16), (uint32_t)(b - b16),
          (int)(r1 - r0)};
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");
}

// The ring of stages: `full` completes when a slab has landed, `empty` when
// every consumer warp is done with it.
struct Ring {
  uint32_t bars;  // shared address of the mbarriers; the stages follow at kStagesAt
  int n_stages;
  int s = 0;
  uint32_t phase = 0;
  __device__ uint32_t full(int i) const { return bars + 8 * i; }
  __device__ uint32_t empty(int i) const { return bars + 8 * (kMaxStages + i); }
  __device__ uint32_t stage(int i) const { return bars + kStagesAt + i * kStageBytes; }
  __device__ void next() {
    if (++s == n_stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ Ring ring_init(uint8_t* smem, int n_stages) {
  Ring ring{static_cast<uint32_t>(__cvta_generic_to_shared(smem)), n_stages};
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(ring.full(i), 1);
      mbar_init(ring.empty(i), kWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// the producer warp's lane 0: every slab of this block's chunks into the ring
template <typename T>
__device__ __forceinline__ void produce(Ring& ring, const T* x, int64_t rows, int64_t n,
                                        int64_t stride, int slab_rows, int64_t chunk_rows,
                                        int64_t chunks) {
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t end = min64(c * chunk_rows + chunk_rows, rows);
    for (int64_t r0 = c * chunk_rows; r0 < end; r0 += slab_rows) {
      const Slab sl = slab_of(x, n, stride, r0, min64(r0 + slab_rows, end));
      mbar_wait(ring.empty(ring.s), ring.phase ^ 1);
      mbar_expect_tx(ring.full(ring.s), sl.bytes);
      bulk_load(ring.stage(ring.s), sl.src, sl.bytes, ring.full(ring.s));
      ring.next();
    }
  }
}

// KC = ceil(n / 32), the columns a lane holds: an exact count, so a lane
// issues no work for columns past the row (as a count for the widest row
// did: a third slower at 513 float32 columns on an H100, compute-bound)
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 1)
lr_grad_rows(const T* __restrict__ x, int64_t rows, int64_t n, int64_t stride,
             const Acc<T>* __restrict__ w, Acc<T>* __restrict__ partial, int slab_rows,
             int64_t chunk_rows, int64_t chunks, int n_stages) {
  using A = Acc<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stages = smem + kStagesAt;
  A* red = reinterpret_cast<A*>(stages + n_stages * kStageBytes);  // kWarps x n
  Ring ring = ring_init(smem, n_stages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWarps) {
    if (lane == 0) produce(ring, x, rows, n, stride, slab_rows, chunk_rows, chunks);
    return;
  }

  A wr[KC], acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int64_t j = lane + 32 * k;
    wr[k] = j < n ? w[j] : A(0);
    acc[k] = A(0);
  }
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t end = min64(c * chunk_rows + chunk_rows, rows);
    for (int64_t r0 = c * chunk_rows; r0 < end; r0 += slab_rows) {
      const Slab sl = slab_of(x, n, stride, r0, min64(r0 + slab_rows, end));
      mbar_wait(ring.full(ring.s), ring.phase);
      const T* slab = reinterpret_cast<const T*>(stages + ring.s * kStageBytes + sl.skip);
      for (int r = warp; r < sl.rows; r += kWarps) {
        const T* row = slab + r * stride;
        A xv[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int64_t j = lane + 32 * k;
          xv[k] = j < n ? widen(row[j]) : A(0);
        }
        const A label = widen(row[0]);
        if (lane == 0) xv[0] = A(1);  // the intercept's 1
        A dot = A(0);
#pragma unroll
        for (int k = 0; k < KC; ++k) dot = fma(xv[k], wr[k], dot);
        const A mul = residual(warp_sum(dot), label);
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] = fma(mul, xv[k], acc[k]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty(ring.s));
      ring.next();
    }
    // the chunk's partial row: the warps' column sums added in warp order
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int64_t j = lane + 32 * k;
      if (j < n) red[warp * n + j] = acc[k];
      acc[k] = A(0);
    }
    consumers_sync();
    for (int64_t j = threadIdx.x; j < n; j += kConsumers) {
      A t = red[j];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) t += red[v * n + j];
      partial[c * n + j] = t;
    }
    consumers_sync();
  }
}

// this thread's sums of its columns' products for U rows `stride` apart from
// `row` (its first column), each warp's butterfly sum to dots[u * kWarps +
// warp]. Branch-free: a column past the row is read (within the stage or the
// slack after the last) and then taken as 0, so every load of the U rows can
// be in flight at once
template <int U, int KW, typename T, typename A>
__device__ __forceinline__ void warp_dots(const T* row, int64_t stride, int kt, const A (&wz)[KW],
                                          A lead, A* dots, int warp, int lane) {
  A dot[U];
#pragma unroll
  for (int u = 0; u < U; ++u) dot[u] = lead;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const A v = widen(row[u * stride + kConsumers * k]);
      dot[u] = fma(k < kt ? v : A(0), wz[k], dot[u]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) dots[u * kWarps + warp] = dot[u];
  }
}

// KW = ceil(n / 256), the columns a thread holds. Per slab: (1) every
// thread's sums of its columns' products, kGroup rows at a time, each warp's
// butterfly sum to shared memory; (2) one thread a row adds the eight warps'
// sums in warp order and takes the residual, once a row; (3) every thread
// adds mul times its columns, in row order. A block barrier after (1) and
// after (2). On an H100 a branch a row and a column in (1), which kept each
// load behind the one before, held it to 1.4-2.4 TB/s at 1025-8192 float32
// columns; every thread taking every row's exp and division cost a little
// more.
template <typename T, int KW>
__global__ void __launch_bounds__(kThreads, 1)
lr_grad_cols(const T* __restrict__ x, int64_t rows, int64_t n, int64_t stride,
             const Acc<T>* __restrict__ w, Acc<T>* __restrict__ partial, int slab_rows,
             int64_t chunk_rows, int64_t chunks, int n_stages) {
  using A = Acc<T>;
  // rows a thread sums at once: two for float64, whose registers are twice
  // as wide (four spilled at 8 columns a thread)
  constexpr int kGroup = std::is_same_v<T, double> ? 2 : 4;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stages = smem + kStagesAt;
  // slab_rows x kWarps warp sums, then slab_rows residuals, then the slack
  // that reads past the last stage's last row land in
  A* dots = reinterpret_cast<A*>(stages + n_stages * kStageBytes);
  A* muls = dots + slab_rows * kWarps;
  Ring ring = ring_init(smem, n_stages);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (warp == kWarps) {
    if (lane == 0) produce(ring, x, rows, n, stride, slab_rows, chunk_rows, chunks);
    return;
  }

  // thread t's columns are t + 256 k for k < kt (read at fixed offsets from
  // the row's t-th value); column 0's weight is 0 here and its 1 starts
  // thread 0's sum instead (the label is read there)
  const int kt = t < n ? (int)((n - t + kConsumers - 1) / kConsumers) : 0;
  A wz[KW], acc[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int64_t j = t + kConsumers * k;
    wz[k] = j < n && j > 0 ? w[j] : A(0);
    acc[k] = A(0);
  }
  const A lead = t == 0 ? w[0] : A(0);
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t end = min64(c * chunk_rows + chunk_rows, rows);
    for (int64_t r0 = c * chunk_rows; r0 < end; r0 += slab_rows) {
      const Slab sl = slab_of(x, n, stride, r0, min64(r0 + slab_rows, end));
      mbar_wait(ring.full(ring.s), ring.phase);
      const T* slab = reinterpret_cast<const T*>(stages + ring.s * kStageBytes + sl.skip) + t;
      int g = 0;
      for (; g + kGroup <= sl.rows; g += kGroup)
        warp_dots<kGroup>(slab + g * stride, stride, kt, wz, lead, dots + g * kWarps, warp, lane);
      for (; g < sl.rows; ++g)
        warp_dots<1>(slab + g * stride, stride, kt, wz, lead, dots + g * kWarps, warp, lane);
      consumers_sync();
      if (t < sl.rows) {
        A dot = dots[t * kWarps];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) dot += dots[t * kWarps + v];
        muls[t] = residual(dot, widen(slab[(int64_t)t * stride - t]));
      }
      consumers_sync();
      for (int r = 0; r < sl.rows; ++r) {
        const T* row = slab + (int64_t)r * stride;
        const A mul = muls[r];
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const A v = k == 0 && t == 0 ? A(1) : widen(row[kConsumers * k]);
          acc[k] = fma(mul, k < kt ? v : A(0), acc[k]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty(ring.s));
      ring.next();
    }
    // the chunk's partial row: each thread's own columns
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int64_t j = t + kConsumers * k;
      if (j < n) partial[c * n + j] = acc[k];
      acc[k] = A(0);
    }
  }
}

template <typename T>
using GradKernel = void (*)(const T*, int64_t, int64_t, int64_t, const Acc<T>*, Acc<T>*, int,
                            int64_t, int64_t, int);

template <typename T, int... K>
GradKernel<T> rows_kernel(int kc, std::integer_sequence<int, K...>) {
  const GradKernel<T> table[] = {&lr_grad_rows<T, K + 1>...};
  return table[kc - 1];
}

// lanes' columns at most for lr_grad_rows: float64's registers are twice as
// wide, so its rows of more than 512 columns go to lr_grad_cols
template <typename T>
constexpr int rows_kc_max() {
  return std::is_same_v<T, double> ? kRowsKC / 2 : kRowsKC;
}

// a thread's columns in lr_grad_cols: at least what the widest row of
// lr_grad_rows leaves, at most 32, or 17 for float64 (a stage holds 4348
// float64 columns)
template <typename T>
constexpr int cols_kw_min() {
  return rows_kc_max<T>() * 32 / kConsumers + 1;
}
template <typename T>
constexpr int cols_kw_max() {
  return std::is_same_v<T, double> ? 17 : kColsKW;
}

template <typename T, int... K>
GradKernel<T> cols_kernel(int kw, std::integer_sequence<int, K...>) {
  const GradKernel<T> table[] = {&lr_grad_cols<T, K + cols_kw_min<T>()>...};
  return table[kw - cols_kw_min<T>()];
}

template <typename T>
int launch_grad(const void* xp, long long rows, long long n, long long stride, const void* w,
                void* partial, int slab_rows, long long chunk_rows, long long chunks, int grid,
                cudaStream_t stream) {
  using A = Acc<T>;
  if ((long long)(slab_rows - 1) * stride * (long long)sizeof(T) + n * (long long)sizeof(T) +
          32 > kStageBytes ||
      reinterpret_cast<uintptr_t>(xp) % sizeof(T) != 0)
    return (int)cudaErrorInvalidValue;
  const int kc = (int)((n + 31) / 32);
  GradKernel<T> kern;
  long long sum_bytes;  // the consumers' shared memory past the stages
  if (kc <= rows_kc_max<T>()) {
    kern = rows_kernel<T>(kc, std::make_integer_sequence<int, rows_kc_max<T>()>{});
    sum_bytes = kWarps * n * (long long)sizeof(A);
  } else {
    const int kw = (int)((n + kConsumers - 1) / kConsumers);
    if (kw < cols_kw_min<T>() || kw > cols_kw_max<T>()) return (int)cudaErrorInvalidValue;
    kern = cols_kernel<T>(
        kw, std::make_integer_sequence<int, cols_kw_max<T>() - cols_kw_min<T>() + 1>{});
    // the warps' sums and the residuals, then slack for lr_grad_cols' reads
    // past a row's end (fewer than 256 values), so that those past the last
    // stage's last row stay in bounds
    sum_bytes = (long long)slab_rows * (kWarps + 1) * (long long)sizeof(A) +
                (long long)kConsumers * (long long)sizeof(T);
  }
  const long long fit = (kSmemMax - kStagesAt - sum_bytes) / kStageBytes;
  const int n_stages = (int)(fit < kMaxStages ? fit : kMaxStages);
  if (n_stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = (int)(kStagesAt + n_stages * kStageBytes + sum_bytes);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(xp), rows, n, stride,
                                         static_cast<const A*>(w), static_cast<A*>(partial),
                                         slab_rows, chunk_rows, chunks, n_stages);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float step_down(float w, float g, float scale) {
  return __fsub_rn(w, __fmul_rn(g, scale));
}
__device__ __forceinline__ double step_down(double w, double g, double scale) {
  return __dsub_rn(w, __dmul_rn(g, scale));
}

// Column c of the sum of `parts` rows of n values: warp v adds rows v, v +
// 32, ... in order, then the 32 warps' sums meet in a tree. With w, w[c] -=
// sum * scale[0] (rounded as the plain loop rounds: the product, then the
// difference); else g[c] = sum.
template <typename A>
__global__ void __launch_bounds__(1024)
lr_reduce_kernel(const A* __restrict__ partial, int64_t parts, int64_t n, A* __restrict__ g,
                 A* __restrict__ w, const A* __restrict__ scale) {
  __shared__ A t[32][33];
  const int lane = threadIdx.x % 32, v = threadIdx.x / 32;
  const int64_t c = (int64_t)blockIdx.x * 32 + lane;
  A sum = A(0);
  if (c < n) {
#pragma unroll 8
    for (int64_t p = v; p < parts; p += 32) sum += partial[p * n + c];
  }
  t[v][lane] = sum;
  __syncthreads();
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    if (v < h) t[v][lane] += t[v + h][lane];
    __syncthreads();
  }
  if (v == 0 && c < n) {
    if (w != nullptr)
      w[c] = step_down(w[c], t[0][lane], scale[0]);
    else
      g[c] = t[0][lane];
  }
}

template <typename A>
int launch_reduce(const void* partial, long long parts, long long n, void* g, void* w,
                  const void* scale, cudaStream_t stream) {
  lr_reduce_kernel<A><<<(unsigned)((n + 31) / 32), 1024, 0, stream>>>(
      static_cast<const A*>(partial), parts, n, static_cast<A*>(g), static_cast<A*>(w),
      static_cast<const A*>(scale));
  return (int)cudaGetLastError();
}

}  // namespace

// the bfloat16 and float64 launches, each in a source of its own
int lr_grad_bf16(const void* x, long long rows, long long n, long long stride, const void* w,
                 void* partial, int slab_rows, long long chunk_rows, long long chunks, int grid,
                 cudaStream_t stream);
int lr_grad_f64(const void* x, long long rows, long long n, long long stride, const void* w,
                void* partial, int slab_rows, long long chunk_rows, long long chunks, int grid,
                cudaStream_t stream);
