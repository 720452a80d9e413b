// The bf16 flash forward's Hopper design (flash_attention_sm90.cuh) at q/k
// 192 and v 128 wide, the heads of multi-head latent attention, in a
// translation unit of its own so that it compiles beside the others.

#include "flash_attention_sm90.cuh"

namespace flash_sm90 {

cudaError_t launch_mla(const Args& a) { return launch<192, 128>(a); }

}  // namespace flash_sm90
