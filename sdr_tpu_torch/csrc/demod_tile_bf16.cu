// Kernel C's shared-memory tile (demod_tile.cuh) at N = 2 to 64 on bfloat16
// sample planes, each sample widened to f32 on load: the count (h plane,
// taps=, the pilot comb, the despread), the LLR plane and the sum (with the
// despread); in its own translation unit so that nvcc builds it in parallel
// with the f32 tile (demod.cu). sdr_demod_count and sdr_demod_llr call it.
#include "demod_tile.cuh"

int demod_llr_tile_bf16(const void* re, const void* im, const float* hr, const float* hi,
                        int h_syms, float* out, float* partials, int B, int S, int log_n, int cp,
                        int bits_per_axis, int bpsk, const sdr::AxisTables& tab, float inv_nv,
                        float nv, int despread, int reduce_sum, const float* twr,
                        const float* twi, cudaStream_t st) {
  return llr_tile(static_cast<const __nv_bfloat16*>(re), static_cast<const __nv_bfloat16*>(im),
                  hr, hi, h_syms, out, partials, B, S, log_n, cp, bits_per_axis, bpsk, tab,
                  inv_nv, nv, despread, reduce_sum, twr, twi, st);
}

int demod_count_tile_bf16(const void* re, const void* im, const float* hr, const float* hi,
                          int h_syms, const float* taps_r, const float* taps_i, int n_taps,
                          const void* idx, int idx_bytes, int32_t* out, int B, int S, int log_n,
                          int cp, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                          float inv_nv, float nv, int despread, int pilot, const float* twr,
                          const float* twi, cudaStream_t st) {
  return count_tile(static_cast<const __nv_bfloat16*>(re),
                    static_cast<const __nv_bfloat16*>(im), hr, hi, h_syms, taps_r, taps_i,
                    n_taps, idx, idx_bytes, out, B, S, log_n, cp, bits_per_axis, bpsk, tab,
                    inv_nv, nv, despread, pilot, twr, twi, st);
}
