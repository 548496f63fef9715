// Kernel C's count (h plane, taps=, the pilot comb) on bfloat16 sample planes
// in the warp-group form at N = 128 to 4096 (demod_rows.cuh: each sample
// widened to f32 on load, the rest the f32 kernel's code), in its own
// translation unit so that nvcc builds it in parallel with the f32 modes;
// sdr_demod_count (demod_count.cu) calls it.
#include "demod_rows.cuh"

int demod_count_bf16(const RowsArgs& a, const sdr::AxisTables& tab, int bits_per_axis,
                     int bpsk, cudaStream_t st) {
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
                   return rows_launch_n<__nv_bfloat16, M, BPSK, kCount, false>(a, tab, st))
  return (int)cudaErrorInvalidValue;
}
