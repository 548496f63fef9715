// Kernel G's SC-FDMA instantiations (the kernel is in mc.cuh).
#include "mc.cuh"

int mc_launch_spread(const McParams& p, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                     cudaStream_t st) {
  return launch_mod<true>(p, bits_per_axis, bpsk, tab, st);
}
