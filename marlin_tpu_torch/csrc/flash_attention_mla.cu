// The flash forward's instances with q and k 192 wide and v 128 wide (the
// kernel: flash_attention.cuh), the heads of multi-head latent attention
// (DeepSeek-V2: 128 positional-free and 64 rotary dims of q and k, 128 of v).
// Run in the 256-wide instance, v padded to q's width, they would spend a
// quarter of every Q K^T and a third of every P V on zero columns.

#include "flash_attention.cuh"

namespace flash_fwd {

cudaError_t launch_mla(int dtype, const Args& a) {
  if (dtype == 0) return launch_width<float, 192, 128>(a);
  return launch_width<__nv_bfloat16, 192, 128>(a);
}

}  // namespace flash_fwd
