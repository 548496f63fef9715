// Kernel C's tensor-parallel stage-2 mode (sdr_tp_stage2_llr; replaces
// sdr_tpu/parallel/tp.py::_stage2_llr_pallas), in its own translation
// unit so that nvcc builds it in parallel with the other modes: one
// rank's digit block of the distributed four-step transform, t
// (B, S, n1d, n2) twiddled stage-1 output after the all_to_all, h
// (B, h_syms, n1d, n2) digit-major, the noise variance one f32 on the
// device (read by the kernel, so one launch sequence serves any Eb/N0
// with no host sync); out (B, S, n1d, n2·BPS), each row subcarrier-major
// [k·BPS + j]. At n2 = 128 to 4096 it is demod_rows.cuh's plane mode with
// the TP flag: a run is the symbols of one digit row (b, k1), row
// (b, s, k1) of t starts at ((b·S + s)·n1d + k1)·n2 with no CP, its h row
// at ((b·h_syms + (h_syms > 1 ? s : 0))·n1d + k1)·n2, and B·n1d·⌈S/32⌉
// blocks run; everything else (the plans, the loads in the time layout,
// T2, the pass to natural order, h staged once a block or by cp.async per
// symbol) is the plane's. n2 = 2 to 64 stays on the tile (demod.cu).
#include "demod_rows.cuh"

extern "C" int sdr_tp_stage2_llr(const float* tr, const float* ti, const float* hr,
                                 const float* hi, int h_syms, const float* nv, float* out, int B,
                                 int S, int n1d, int log_n, int bits_per_axis, int bpsk,
                                 sdr::AxisTables tab, const float* twr, const float* twi,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || n1d <= 0 || h_syms < 1 || log_n < 1 || log_n > 12)
    return (int)cudaErrorInvalidValue;
  if (log_n < kRowsMinLog)
    return demod_tp_tile(tr, ti, hr, hi, h_syms, nv, out, B, S, n1d, log_n, bits_per_axis, bpsk,
                         tab, twr, twi, st);
  const RowsArgs a{tr,  ti,  hr, hi, nullptr, nullptr, nullptr, out,  nullptr, twr, twi,
                   B,   S,   log_n, 0, h_syms, 0,     0,       0.0f, 0.0f,    n1d, nv};
  if (rows_bad_shape(a)) return (int)cudaErrorInvalidValue;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return rows_launch_n<M, BPSK, kPlane, false, true>(a, tab, st))
  return (int)cudaErrorInvalidValue;
}
