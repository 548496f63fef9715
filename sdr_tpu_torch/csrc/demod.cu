// Kernel C, rows layout: the shared-memory tile at N = 2 to 64 on float32
// sample planes, with the TP stage-2 mode (demod_tile.cuh has the kernels
// and says what they compute; demod_tile_bf16.cu builds them on bfloat16
// planes). The warp-group form (demod_rows.cuh) takes N = 128 to 4096.
#include "demod_tile.cuh"

namespace {

template <int M, bool BPSK>
int launch_tp_stage2(const float* tr, const float* ti, const float* hr, const float* hi,
                     int h_syms, const float* nv_dev, float* out, long long n_rows, int S,
                     int n1d, int log_n, const sdr::AxisTables& tab, const float* twr,
                     const float* twi, cudaStream_t st) {
  const int log_spb = 9 - log_n;  // N <= 64: at least 8 rows a block
  const LlrLaunch l = llr_launch(n_rows, log_n, log_spb);
  demod_llr_kernel<float, M, BPSK, false, false, true>
      <<<(unsigned)l.blocks, sdr::kThreads, l.smem, st>>>(
      tr, ti, hr, hi, h_syms, out, n_rows, S, log_n, 0, log_spb, tab, 0.0f, 0.0f, twr, twi, n1d,
      nv_dev);
  return (int)cudaGetLastError();
}

}  // namespace

// The TP stage-2 mode at n2 = 2 to 64 (sdr_tp_stage2_llr in demod_tp.cu
// takes n2 = 128 to 4096 in the warp-group form): t (B, S, n1d, n2)
// twiddled stage-1 output, h (B, h_syms, n1d, n2) digit-major, nv one f32
// on the device; out (B, S, n1d, n2·BPS) subcarrier-major.
int demod_tp_tile(const float* tr, const float* ti, const float* hr, const float* hi, int h_syms,
                  const float* nv, float* out, int B, int S, int n1d, int log_n,
                  int bits_per_axis, int bpsk, const sdr::AxisTables& tab, const float* twr,
                  const float* twi, cudaStream_t st) {
  const long long n_rows = (long long)B * S * n1d;
  if (n_rows <= 0 || h_syms < 1 || log_n < 1 || log_n >= kRowsMinLog)
    return (int)cudaErrorInvalidValue;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return launch_tp_stage2<M, BPSK>(tr, ti, hr, hi, h_syms, nv, out, n_rows, S, n1d, log_n, tab,
                                     twr, twi, st))
  return (int)cudaErrorInvalidValue;
}

// Per-block partials of the tile's sum.
int demod_llr_tile_partials(int B, int S, int log_n) {
  const int log_spb = 9 - log_n;  // N <= 64: at least 8 rows a block
  return (int)((((long long)B * S) + (1 << log_spb) - 1) >> log_spb);
}

int demod_llr_tile(const void* re, const void* im, const float* hr, const float* hi,
                   int h_syms, float* out, float* partials, int B, int S, int log_n, int cp,
                   int bits_per_axis, int bpsk, const sdr::AxisTables& tab, float inv_nv,
                   float nv, int despread, int reduce_sum, const float* twr, const float* twi,
                   cudaStream_t st) {
  return llr_tile(static_cast<const float*>(re), static_cast<const float*>(im), hr, hi, h_syms,
                  out, partials, B, S, log_n, cp, bits_per_axis, bpsk, tab, inv_nv, nv, despread,
                  reduce_sum, twr, twi, st);
}

int demod_count_tile(const void* re, const void* im, const float* hr, const float* hi,
                     int h_syms, const float* taps_r, const float* taps_i, int n_taps,
                     const void* idx, int idx_bytes, int32_t* out, int B, int S, int log_n,
                     int cp, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                     float inv_nv, float nv, int despread, int pilot, const float* twr,
                     const float* twi, cudaStream_t st) {
  return count_tile(static_cast<const float*>(re), static_cast<const float*>(im), hr, hi, h_syms,
                    taps_r, taps_i, n_taps, idx, idx_bytes, out, B, S, log_n, cp, bits_per_axis,
                    bpsk, tab, inv_nv, nv, despread, pilot, twr, twi, st);
}
