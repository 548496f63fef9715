// Kernel C's despread (SC-FDE) LLR plane in the warp-group form at N = 128
// to 4096 (demod_rows.cuh), in its own translation unit so that nvcc
// builds it in parallel with the other modes; sdr_demod_llr
// (demod_llr.cu) calls it.
#include "demod_rows.cuh"

int demod_despread_plane(const RowsArgs& a, const sdr::AxisTables& tab, int bits_per_axis,
                         int bpsk, cudaStream_t st) {
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
                   return rows_launch_n<float, M, BPSK, kPlane, true>(a, tab, st))
  return (int)cudaErrorInvalidValue;
}
