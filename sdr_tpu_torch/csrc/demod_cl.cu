// Kernel D's entry points: the channels-last LLR sum.
// csrc/demod_cl.cuh holds kernels D and F: both plans and the three modes.
// Each mode has its own translation unit (demod_cl.cu, demod_cl_count.cu,
// demod_cl_llr.cu), so nvcc builds the three in parallel. re_t/im_t are
// float32, or bfloat16 when in_bf16.
#include "demod_cl.cuh"

// Number of per-block partials the sum's wrapper must allocate.
extern "C" int sdr_demod_sum_cl_partials(int B, int S, int log_n) {
  if (bad_shape(B, S, log_n)) return 0;
  const ClLaunch l = cl_launch(B, S, log_n);
  return (int)(l.grid.x * l.grid.y);
}

extern "C" int sdr_demod_sum_cl(const void* re_t, const void* im_t, int in_bf16,
                                const float* hr_t, const float* hi_t, float* partials,
                                float* out, int B, int S, int log_n, int cp, int bits_per_axis,
                                int bpsk, sdr::AxisTables tab, float inv_nv, const float* twr,
                                const float* twi, void* stream) {
  if (bad_shape(B, S, log_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    rc = SDR_CL_LAUNCH(demod_sum_cl_kernel, re_t, im_t, in_bf16, hr_t, hi_t, partials, B, S,
                       log_n, cp, tab, inv_nv, twr, twi))
  if (rc != 0) return rc;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(partials, sdr_demod_sum_cl_partials(B, S, log_n),
                                               out);
  return (int)cudaGetLastError();
}
