// Kernel C's count entry point: per-channel bit errors over the h plane or
// taps=, or with the despread (SC-FDE) receive; pilot > 0 (not with the
// despread) counts the data tones of the comb alone. The warp-group form
// (demod_rows.cuh) takes N = 128 to 4096, its despread mode built in
// demod_despread_count.cu; the shared-memory tile (demod.cu) N = 2 to 64.
#include "demod_rows.cuh"

extern "C" int sdr_demod_count(const float* re, const float* im, const float* hr,
                               const float* hi, int h_syms, const float* taps_r,
                               const float* taps_i, int n_taps, const void* idx, int idx_bytes,
                               int32_t* out, int B, int S, int log_n, int cp,
                               int bits_per_axis, int bpsk, sdr::AxisTables tab, float inv_nv,
                               float nv, int despread, int pilot, const float* twr,
                               const float* twi, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pilot < 0 || pilot == 1 || pilot > (1 << log_n) || (pilot && despread))
    return (int)cudaErrorInvalidValue;
  if (log_n < kRowsMinLog)
    return demod_count_tile(re, im, hr, hi, h_syms, taps_r, taps_i, n_taps, idx, idx_bytes, out,
                            B, S, log_n, cp, bits_per_axis, bpsk, tab, inv_nv, nv, despread,
                            pilot, twr, twi, st);
  if ((long long)B * S == 0) return 0;
  const RowsArgs a{re,  im,  hr,    hi,     taps_r, taps_i, idx,    out,    nullptr,
                   twr, twi, B,     S,      log_n,  cp,     h_syms, n_taps, idx_bytes,
                   inv_nv, nv, 1, nullptr, pilot, pilot ? 1.0f / pilot : 0.0f};
  if (rows_bad_shape(a) || (idx_bytes != 1 && idx_bytes != 2 && idx_bytes != 4) ||
      (despread && n_taps))
    return (int)cudaErrorInvalidValue;
  if (despread) return demod_despread_count(a, tab, bits_per_axis, bpsk, st);
  SDR_DISPATCH_MOD(bits_per_axis, bpsk, return rows_launch_n<M, BPSK, kCount>(a, tab, st))
  return (int)cudaErrorInvalidValue;
}
