// The C entry points of the fused logistic-gradient step (lr_gradient.cuh)
// and its float32 instances.

#include "lr_gradient.cuh"

extern "C" {

// x: rows of n values of the dtype (0 float32, 1 bfloat16, 2 float64),
// `stride` values apart (stride >= n), unit column stride, on the stream's
// device; w: n values and partial: chunks x n values of the arithmetic's
// type (float64 for float64 rows, else float32). Rows [0, rows) are read;
// chunk c covers rows [c chunk_rows, (c + 1) chunk_rows), slab_rows at a
// time (chunk_rows a multiple of slab_rows, a slab within a stage); `grid`
// blocks take the chunks in turn. Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a plan the kernel cannot run.
int marlin_lr_grad(int dtype, const void* x, long long rows, long long n, long long stride,
                   const void* w, void* partial, int slab_rows, long long chunk_rows,
                   long long chunks, int grid, void* stream) {
  if (n < 1 || n > kMaxCols || stride < n || slab_rows < 1 || chunk_rows < slab_rows ||
      chunk_rows % slab_rows != 0 || grid < 1 || rows < 0 ||
      chunks != (rows + chunk_rows - 1) / chunk_rows)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_grad<float>(x, rows, n, stride, w, partial, slab_rows, chunk_rows, chunks,
                              grid, s);
  if (dtype == 1)
    return lr_grad_bf16(x, rows, n, stride, w, partial, slab_rows, chunk_rows, chunks, grid, s);
  if (dtype == 2)
    return lr_grad_f64(x, rows, n, stride, w, partial, slab_rows, chunk_rows, chunks, grid, s);
  return (int)cudaErrorInvalidValue;
}

// partial: parts x n values, contiguous, of the arithmetic's type of the
// rows' dtype (as above). With w (n values) and scale (one value),
// w -= (sum of the rows) * scale; else g (n values) = the sum.
int marlin_lr_reduce(int dtype, const void* partial, long long parts, long long n, void* g,
                     void* w, const void* scale, void* stream) {
  if (n < 1 || parts < 0 || (w == nullptr && g == nullptr) || (w != nullptr && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || dtype == 1) return launch_reduce<float>(partial, parts, n, g, w, scale, s);
  if (dtype == 2) return launch_reduce<double>(partial, parts, n, g, w, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* marlin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
