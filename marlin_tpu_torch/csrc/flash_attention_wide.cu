// The flash forward's d <= 256 instances (the kernel: flash_attention.cuh),
// in a translation unit of their own so that ops/_build.py builds them at
// ptxas -O1: with 128 accumulator floats a thread, every arrangement tried
// spilled at -O3 and none at -O1, while the narrower instances run 8-10 %
// faster at -O3 (NVIDIA H100, CUDA events).

#include "flash_attention.cuh"

namespace flash_fwd {

cudaError_t launch_wide(int dtype, const Args& a) {
  if (dtype == 0) return launch_width<float, 256, 256>(a);
  return launch_width<__nv_bfloat16, 256, 256>(a);
}

}  // namespace flash_fwd
