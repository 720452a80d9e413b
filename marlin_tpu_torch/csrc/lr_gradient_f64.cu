// The float64 instances of the fused logistic-gradient step
// (lr_gradient.cuh), in a source of their own so that they compile beside
// the others.

#include "lr_gradient.cuh"

int lr_grad_f64(const void* x, long long rows, long long n, long long stride, const void* w,
                void* partial, int slab_rows, long long chunk_rows, long long chunks, int grid,
                cudaStream_t stream) {
  return launch_grad<double>(x, rows, n, stride, w, partial, slab_rows, chunk_rows,
      chunks, grid, stream);
}
