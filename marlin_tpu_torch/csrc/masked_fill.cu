// Zero everything outside the logical (rows, cols) region of an (R, C) matrix,
// out = where(r < rows && c < cols, x, 0), hand-written for Hopper (sm_90a).
//
// Replaces: marlin_tpu/ops/pallas_kernels.py `_masked_fill_kernel` (reached
// through `masked_fill`), the one-pass iota-compare-and-select that restores
// the zero-pad invariant.
//
// Design: one elementwise pass in a grid-stride loop with 64-bit indices. The
// kernel works on the bits of the elements (2, 4 or 8 bytes), so it serves
// every float type and writes exactly zero outside the region. Where a row's
// byte length is a multiple of 16 and both buffers are 16-byte aligned, each
// thread moves 16 bytes per step; a 16-byte vector then never straddles two
// rows. Vectors wholly outside the region are written without reading x.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): bytes, one read and one
// write of R*C elements at 3.35 TB/s, i.e. 0.96 ms for a 20000^2 f32 matrix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename E>
__global__ void masked_fill_vec(const uint4* __restrict__ x, uint4* __restrict__ out,
                                int64_t nvec, int64_t C, int64_t rows, int64_t cols) {
  constexpr int V = 16 / sizeof(E);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int64_t e0 = i * V;
    const int64_t r = e0 / C;
    const int64_t c0 = e0 - r * C;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c0 < cols) {
      v = x[i];
      if (c0 + V > cols) {
        E* lanes = reinterpret_cast<E*>(&v);
#pragma unroll
        for (int l = 0; l < V; ++l)
          if (c0 + l >= cols) lanes[l] = E(0);
      }
    }
    out[i] = v;
  }
}

template <typename E>
__global__ void masked_fill_scalar(const E* __restrict__ x, E* __restrict__ out,
                                   int64_t total, int64_t C, int64_t rows, int64_t cols) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t r = i / C;
    const int64_t c = i - r * C;
    out[i] = (r < rows && c < cols) ? x[i] : E(0);
  }
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > (1 << 20)) b = 1 << 20;  // grid-stride loop covers the rest
  return (unsigned)(b < 1 ? 1 : b);
}

template <typename E>
cudaError_t launch(const void* x, void* out, int64_t R, int64_t C, int64_t rows,
                   int64_t cols, cudaStream_t s) {
  const int64_t total = R * C;
  const bool vec = (C * (int64_t)sizeof(E)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int64_t nvec = total * (int64_t)sizeof(E) / 16;
    masked_fill_vec<E><<<blocks_for(nvec), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), nvec, C, rows, cols);
  } else {
    masked_fill_scalar<E><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const E*>(x), static_cast<E*>(out), total, C, rows, cols);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out: (R, C), row-major, contiguous, on the stream's device; esize is
// the element size in bytes (2, 4 or 8). Returns the launch's cudaError_t.
int marlin_masked_fill(const void* x, void* out, long long R, long long C,
                       long long rows, long long cols, int esize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  if (esize == 2) return (int)launch<uint16_t>(x, out, R, C, rows, cols, s);
  if (esize == 4) return (int)launch<uint32_t>(x, out, R, C, rows, cols, s);
  if (esize == 8) return (int)launch<uint64_t>(x, out, R, C, rows, cols, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
