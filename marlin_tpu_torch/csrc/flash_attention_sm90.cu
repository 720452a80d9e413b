// The bf16 flash forward's Hopper design (flash_attention_sm90.cuh): its C
// entry and the instances with q/k and v both 64 or both 128 wide; the
// (192, 128) instance is in flash_attention_sm90_mla.cu.

#include "flash_attention_sm90.cuh"

extern "C" {

// marlin_flash_fwd's arguments (flash_attention.cu), bf16 only (dtype 1):
// (dqk, dv) of (64, 64), (128, 128) or (192, 128), and tma_ready's
// alignment; anything else returns cudaErrorInvalidValue without a launch
// (the wrapper sends it to marlin_flash_fwd). Returns the launch's
// cudaError_t.
int marlin_flash_fwd_sm90(int dtype, const void* q, const void* k, const void* v,
                          const void* m_in, const void* l_in, const void* acc_in,
                          void* m_out, void* l_out, void* acc_out, int H, int sq, int skv,
                          int dqk, int dv, long long q_sh, long long q_si, long long k_sh,
                          long long k_si, long long v_sh, long long v_si, int q_offset,
                          int k_offset, int valid_len, int causal, float scale,
                          void* stream) {
  using namespace flash_sm90;
  if (dtype != 1 || skv < 0) return (int)cudaErrorInvalidValue;
  if (H <= 0 || sq <= 0) return (int)cudaSuccess;
  const Args a{q, k, v,
               static_cast<const float*>(m_in), static_cast<const float*>(l_in),
               static_cast<const float*>(acc_in), static_cast<float*>(m_out),
               static_cast<float*>(l_out), static_cast<float*>(acc_out),
               H, sq, skv, dqk, dv, q_sh, q_si, k_sh, k_si, v_sh, v_si,
               q_offset, k_offset, valid_len, causal, scale,
               static_cast<cudaStream_t>(stream)};
  if (!flash_sm90::tma_ready(a)) return (int)cudaErrorInvalidValue;
  if (dqk == 64 && dv == 64) return (int)flash_sm90::launch<64, 64>(a);
  if (dqk == 128 && dv == 128) return (int)flash_sm90::launch<128, 128>(a);
  if (dqk == 192 && dv == 128) return (int)flash_sm90::launch_mla(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
