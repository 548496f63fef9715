// Kernel B's gains entry point, sdr_tx: channel off, or a complex gain per
// link or per symbol, then the noise; in any of these, optionally the pilot
// comb (pilot > 0: tone k with k % pilot == 0 carries the pilot point). The warp-group form (tx_rows.cuh)
// takes N = 128 to 4096, the shared-memory tile below N = 2 to 64.
#include "tx_rows.cuh"

namespace {

// The tile: a block holds 2^log_spb symbols and runs the radix-2 FFT on them.
template <typename IdxT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
tx_kernel(const IdxT* __restrict__ idx, float* __restrict__ out_re, float* __restrict__ out_im,
          long long n_rows, int S, int log_n, int cp, int log_spb, float scale,
          const float* __restrict__ twr, const float* __restrict__ twi,
          const float* __restrict__ hs_r, const float* __restrict__ hs_i, int h_syms,
          int noise_mode, const float* __restrict__ n_re, const float* __restrict__ n_im,
          const int32_t* __restrict__ ch_ids, uint32_t k0, uint32_t k1, float sigma, int pilot,
          float pilot_r, float pilot_i) {
  extern __shared__ float smem[];
  const int N = 1 << log_n;
  const int spb = 1 << log_spb;
  float* sre = smem;
  float* sim = smem + (spb << log_n);
  const long long row0 = (long long)blockIdx.x << log_spb;
  const long long left = n_rows - row0;

  load_symbols<IdxT, M, BPSK>(idx, row0, left < spb ? (int)left : spb, log_n, log_spb, sre,
                              sim, pilot, pilot_r, pilot_i);
  __syncthreads();
  sdr::smem_fft(sre, sim, log_n, log_spb, N, 1, twr, twi, -1.0f);

  const int sym_len = N + cp;
  for (int e = threadIdx.x; e < spb * sym_len; e += blockDim.x) {
    const int t = e / sym_len;
    const int u = e - t * sym_len;
    const long long r = row0 + t;
    if (r >= n_rows) continue;
    const int src = (t << log_n) + (u < cp ? N - cp + u : u - cp);
    float yr = sre[src] * scale;
    float yi = sim[src] * scale;
    const long long b = r / S;
    if (hs_r != nullptr) {
      const long long g = h_syms > 1 ? r : b;
      const float fr = hs_r[g], fi = hs_i[g];
      const float tr = yr * fr - yi * fi;
      yi = yr * fi + yi * fr;
      yr = tr;
    }
    store_noisy(yr, yi, r * sym_len + u, noise_mode, n_re, n_im,
                noise_mode == 2 ? (uint32_t)ch_ids[b] : 0u, (int)(r - b * S), u, k0, k1, sigma,
                out_re, out_im);
  }
}

}  // namespace

extern "C" int sdr_tx(const void* idx, int idx_bytes, float* out_re, float* out_im, int B,
                      int S, int log_n, int cp, int bits_per_axis, int bpsk, float scale,
                      const float* twr, const float* twi, const float* hs_r, const float* hs_i,
                      int h_syms, int noise_mode, const float* n_re, const float* n_im,
                      const int32_t* ch_ids, unsigned k0, unsigned k1, float sigma,
                      int pilot, float pilot_r, float pilot_i, void* stream) {
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  if (pilot < 0 || pilot == 1 || pilot > (1 << log_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (log_n < kTxRowsMinLog) {
    const int log_spb = log_symbols_per_block(log_n);
    const long long blocks = (n_rows + (1 << log_spb) - 1) >> log_spb;
    const size_t smem = (size_t)2 * sizeof(float) * ((size_t)1 << (log_spb + log_n));
    SDR_DISPATCH_MOD(bits_per_axis, bpsk,
      SDR_DISPATCH_IDX(idx_bytes,
        tx_kernel<IdxT, M, BPSK><<<(unsigned)blocks, sdr::kThreads, smem, st>>>(
            (const IdxT*)idx, out_re, out_im, n_rows, S, log_n, cp, log_spb, scale, twr, twi,
            hs_r, hs_i, h_syms, noise_mode, n_re, n_im, ch_ids, k0, k1, sigma, pilot,
            pilot_r, pilot_i)))
    return (int)cudaGetLastError();
  }
  TxArgs a;
  if (!tx_rows_args(a, idx, idx_bytes, out_re, out_im, B, S, log_n, cp, scale, twr, twi,
                    noise_mode, n_re, n_im, ch_ids, k0, k1, sigma) ||
      (hs_r != nullptr && h_syms != 1 && h_syms != S))
    return (int)cudaErrorInvalidValue;
  a.hs_r = hs_r, a.hs_i = hs_i, a.h_syms = h_syms;
  a.pilot = pilot, a.pilot_r = pilot_r, a.pilot_i = pilot_i;
  a.pilot_inv = pilot ? 1.0f / pilot : 0.0f;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk, return tx_rows_launch_n<M, BPSK, false>(a, st))
  return (int)cudaErrorInvalidValue;
}
