// Kernel C's LLR-plane and sum entry points. The warp-group form
// (demod_rows.cuh) takes N = 128 to 4096, its despread modes built in
// demod_despread_llr.cu and demod_despread_sum.cu; the shared-memory tile
// (demod.cu) N = 2 to 64. re/im are float32, or bfloat16 when in_bf16
// (every mode built again in demod_llr_bf16.cu, demod_despread_llr_bf16.cu,
// demod_despread_sum_bf16.cu and demod_tile_bf16.cu).
#include "demod_rows.cuh"

// Number of per-block partials the sum mode's wrapper must allocate.
extern "C" int sdr_demod_llr_partials(int B, int S, int log_n) {
  if (log_n < kRowsMinLog) return demod_llr_tile_partials(B, S, log_n);
  return (int)rows_blocks(B, S);
}

extern "C" int sdr_demod_llr(const void* re, const void* im, int in_bf16, const float* hr,
                             const float* hi, int h_syms, float* out, float* partials, int B,
                             int S, int log_n, int cp, int bits_per_axis, int bpsk,
                             sdr::AxisTables tab, float inv_nv, float nv, int despread,
                             int reduce_sum, const float* twr, const float* twi, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (log_n < kRowsMinLog)
    return (in_bf16 ? demod_llr_tile_bf16 : demod_llr_tile)(
        re, im, hr, hi, h_syms, out, partials, B, S, log_n, cp, bits_per_axis, bpsk, tab, inv_nv,
        nv, despread, reduce_sum, twr, twi, st);
  if ((long long)B * S == 0) return (int)cudaErrorInvalidValue;
  const RowsArgs a{re,  im,  hr,  hi, nullptr, nullptr, nullptr,
                   reduce_sum ? (void*)partials : (void*)out,
                   reduce_sum ? out : nullptr,
                   twr, twi, B,   S,  log_n,   cp,      h_syms, 0, 0, inv_nv, nv, 1, nullptr};
  if (rows_bad_shape(a)) return (int)cudaErrorInvalidValue;
  const RowsMode mode =
      despread ? (reduce_sum ? (in_bf16 ? demod_despread_sum_bf16 : demod_despread_sum)
                             : (in_bf16 ? demod_despread_plane_bf16 : demod_despread_plane))
               : !in_bf16 ? nullptr : reduce_sum ? demod_sum_bf16 : demod_plane_bf16;
  if (mode) return mode(a, tab, bits_per_axis, bpsk, st);
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    if (reduce_sum) return rows_launch_n<float, M, BPSK, kSum>(a, tab, st);
    return rows_launch_n<float, M, BPSK, kPlane>(a, tab, st))
  return (int)cudaErrorInvalidValue;
}
