// The flash forward panel's C entry and its d <= 64 and d <= 128 instances;
// the kernel and its design are in flash_attention.cuh, the d <= 256
// instances in flash_attention_wide.cu.

#include "flash_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (H, sq, d), k and v (H, skv, d), given
// by their head and row strides in elements (the last dimension contiguous);
// m_in, l_in, m_out, l_out (H, sq) and acc_in, acc_out (H, sq, d) contiguous
// f32. Outputs may not alias inputs. d <= 256. Returns the launch's
// cudaError_t.
int marlin_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     const void* m_in, const void* l_in, const void* acc_in,
                     void* m_out, void* l_out, void* acc_out, int H, int sq, int skv,
                     int d, long long q_sh, long long q_si, long long k_sh,
                     long long k_si, long long v_sh, long long v_si, int q_offset,
                     int k_offset, int valid_len, int causal, float scale,
                     void* stream) {
  using namespace flash_fwd;
  if (H <= 0 || sq <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 256 || skv < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(m_in), static_cast<const float*>(l_in),
               static_cast<const float*>(acc_in), static_cast<float*>(m_out),
               static_cast<float*>(l_out), static_cast<float*>(acc_out),
               H, sq, skv, d, q_sh, q_si, k_sh, k_si, v_sh, v_si,
               q_offset, k_offset, valid_len, causal, scale,
               static_cast<cudaStream_t>(stream)};
  if (d > 128) return (int)launch_wide(dtype, a);
  if (dtype == 0) return (int)(d <= 64 ? launch_width<float, 64>(a) : launch_width<float, 128>(a));
  return (int)(d <= 64 ? launch_width<__nv_bfloat16, 64>(a)
                       : launch_width<__nv_bfloat16, 128>(a));
}

}  // extern "C"
