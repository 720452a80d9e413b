// The flash forward panel's C entry and its d <= 64 and d <= 128 instances;
// the kernel and its design are in flash_attention.cuh, the d <= 256
// instances in flash_attention_wide.cu and the (192, 128) ones in
// flash_attention_mla.cu.

#include "flash_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (H, sq, dqk), k (H, skv, dqk) and v (H,
// skv, dv), given by their head and row strides in elements (the last
// dimension contiguous); m_in, l_in, m_out, l_out (H, sq) and acc_in, acc_out
// (H, sq, dv) contiguous f32. Outputs may not alias inputs. dqk, dv <= 256:
// the narrowest instance that holds both widths runs, the (192, 128) one for
// q/k wider than 128 beside v of at most 128. Returns the launch's
// cudaError_t.
int marlin_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     const void* m_in, const void* l_in, const void* acc_in,
                     void* m_out, void* l_out, void* acc_out, int H, int sq, int skv,
                     int dqk, int dv, long long q_sh, long long q_si, long long k_sh,
                     long long k_si, long long v_sh, long long v_si, int q_offset,
                     int k_offset, int valid_len, int causal, float scale,
                     void* stream) {
  using namespace flash_fwd;
  if (H <= 0 || sq <= 0) return (int)cudaSuccess;
  if (dqk <= 0 || dqk > 256 || dv <= 0 || dv > 256 || skv < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(m_in), static_cast<const float*>(l_in),
               static_cast<const float*>(acc_in), static_cast<float*>(m_out),
               static_cast<float*>(l_out), static_cast<float*>(acc_out),
               H, sq, skv, dqk, dv, q_sh, q_si, k_sh, k_si, v_sh, v_si,
               q_offset, k_offset, valid_len, causal, scale,
               static_cast<cudaStream_t>(stream)};
  const int d = dqk > dv ? dqk : dv;
  if (d > 128) return (int)(dqk <= 192 && dv <= 128 ? launch_mla(dtype, a) : launch_wide(dtype, a));
  if (dtype == 0) return (int)(d <= 64 ? launch_width<float, 64, 64>(a) : launch_width<float, 128, 128>(a));
  return (int)(d <= 64 ? launch_width<__nv_bfloat16, 64, 64>(a)
                       : launch_width<__nv_bfloat16, 128, 128>(a));
}

}  // extern "C"
