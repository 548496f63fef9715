// Kernel F's LLR-plane entry point.
// csrc/demod_cl.cuh holds kernels D and F: both plans and the three modes.
// Each mode has its own translation unit (demod_cl.cu, demod_cl_count.cu,
// demod_cl_llr.cu), so nvcc builds the three in parallel. re_t/im_t are
// float32, or bfloat16 when in_bf16.
#include "demod_cl.cuh"

extern "C" int sdr_demod_llr_cl(const void* re_t, const void* im_t, int in_bf16,
                                const float* hr_t, const float* hi_t, void* out, int out_bf16,
                                int B, int S, int log_n, int cp, int bits_per_axis, int bpsk,
                                sdr::AxisTables tab, float inv_nv, const float* twr,
                                const float* twi, void* stream) {
  if (bad_shape(B, S, log_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return SDR_CL_LAUNCH(demod_llr_cl_kernel, re_t, im_t, in_bf16, hr_t, hi_t, out, out_bf16, B,
                         S, log_n, cp, tab, inv_nv, twr, twi))
  return (int)cudaErrorInvalidValue;
}
