// Kernel B's FIR entry point, sdr_tx_fir: a causal FIR of at most 16 taps,
// static (B, L) or per symbol (B, S, L), then the noise. The warp-group
// form (tx_rows.cuh) takes N = 128 to 4096, the shared-memory tile below
// N = 2 to 64.
#include "tx_rows.cuh"

namespace {

// The tile: one block per channel; chunks of spb symbols in order. Shared memory:
// the (spb, N) transform tiles, the chunk's taps (spb x kMaxTaps complex)
// and the previous symbol's last n_taps-1 samples.
template <typename IdxT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
tx_fir_kernel(const IdxT* __restrict__ idx, float* __restrict__ out_re,
              float* __restrict__ out_im, int S, int log_n, int cp, int log_spb, float scale,
              const float* __restrict__ twr, const float* __restrict__ twi,
              const float* __restrict__ taps_r, const float* __restrict__ taps_i, int n_taps,
              int taps_per_sym, int noise_mode, const float* __restrict__ n_re,
              const float* __restrict__ n_im, const int32_t* __restrict__ ch_ids, uint32_t k0,
              uint32_t k1, float sigma) {
  extern __shared__ float smem[];
  __shared__ float hist_r[kMaxTaps], hist_i[kMaxTaps];
  const int N = 1 << log_n;
  const int spb = 1 << log_spb;
  float* sre = smem;
  float* sim = smem + (spb << log_n);
  float* tp_r = sim + (spb << log_n);
  float* tp_i = tp_r + spb * kMaxTaps;
  const int b = blockIdx.x;
  const int sym_len = N + cp;
  const int hl = n_taps - 1;
  const uint32_t ch = noise_mode == 2 ? (uint32_t)ch_ids[b] : 0u;
  if ((int)threadIdx.x < kMaxTaps) hist_r[threadIdx.x] = hist_i[threadIdx.x] = 0.0f;

  // Sample v of the CP'd waveform of chunk symbol t (0 <= v < sym_len).
  auto sample_r = [&](int t, int v) {
    return sre[(t << log_n) + (v < cp ? N - cp + v : v - cp)] * scale;
  };
  auto sample_i = [&](int t, int v) {
    return sim[(t << log_n) + (v < cp ? N - cp + v : v - cp)] * scale;
  };

  for (int s0 = 0; s0 < S; s0 += spb) {
    const int n_sym = min(spb, S - s0);
    const long long row0 = (long long)b * S + s0;
    load_symbols<IdxT, M, BPSK>(idx, row0, n_sym, log_n, log_spb, sre, sim, 0, 0.0f, 0.0f);
    for (int e = threadIdx.x; e < n_sym * n_taps; e += blockDim.x) {
      const int t = e / n_taps;
      const int l = e - t * n_taps;
      const long long src = (taps_per_sym ? row0 + t : (long long)b) * n_taps + l;
      tp_r[t * kMaxTaps + l] = taps_r[src];
      tp_i[t * kMaxTaps + l] = taps_i[src];
    }
    __syncthreads();
    sdr::smem_fft(sre, sim, log_n, log_spb, N, 1, twr, twi, -1.0f);

    for (int e = threadIdx.x; e < n_sym * sym_len; e += blockDim.x) {
      const int t = e / sym_len;
      const int u = e - t * sym_len;
      float2 acc = make_float2(0.0f, 0.0f);
      for (int l = 0; l < n_taps; ++l) {
        const int v = u - l;
        float xr, xi;
        if (v >= 0) {
          xr = sample_r(t, v);
          xi = sample_i(t, v);
        } else if (t > 0) {
          xr = sample_r(t - 1, sym_len + v);
          xi = sample_i(t - 1, sym_len + v);
        } else {
          xr = hist_r[hl + v];
          xi = hist_i[hl + v];
        }
        sdr::cmac(acc, make_float2(tp_r[t * kMaxTaps + l], tp_i[t * kMaxTaps + l]), xr, xi);
      }
      store_noisy(acc.x, acc.y, (row0 + t) * sym_len + u, noise_mode, n_re, n_im, ch, s0 + t, u, k0,
                  k1, sigma, out_re, out_im);
    }
    __syncthreads();
    if ((int)threadIdx.x < hl) {
      const int v = sym_len - hl + threadIdx.x;
      hist_r[threadIdx.x] = sample_r(n_sym - 1, v);
      hist_i[threadIdx.x] = sample_i(n_sym - 1, v);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sdr_tx_fir(const void* idx, int idx_bytes, float* out_re, float* out_im, int B,
                          int S, int log_n, int cp, int bits_per_axis, int bpsk, float scale,
                          const float* twr, const float* twi, const float* taps_r,
                          const float* taps_i, int n_taps, int taps_per_sym, int noise_mode,
                          const float* n_re, const float* n_im, const int32_t* ch_ids,
                          unsigned k0, unsigned k1, float sigma, void* stream) {
  if ((long long)B * S == 0) return 0;
  if (n_taps < 1 || n_taps > kMaxTaps || n_taps - 1 > (1 << log_n) + cp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (log_n < kTxRowsMinLog) {
    // No more symbols per chunk than the channel has.
    int log_spb = log_symbols_per_block(log_n);
    while (log_spb > 0 && (1 << (log_spb - 1)) >= S) --log_spb;
    const size_t smem = sizeof(float) * ((size_t)2 * ((size_t)1 << (log_spb + log_n)) +
                                         (size_t)2 * kMaxTaps * ((size_t)1 << log_spb));
    SDR_DISPATCH_MOD(bits_per_axis, bpsk,
      SDR_DISPATCH_IDX(idx_bytes,
        tx_fir_kernel<IdxT, M, BPSK><<<(unsigned)B, sdr::kThreads, smem, st>>>(
            (const IdxT*)idx, out_re, out_im, S, log_n, cp, log_spb, scale, twr, twi, taps_r,
            taps_i, n_taps, taps_per_sym, noise_mode, n_re, n_im, ch_ids, k0, k1, sigma)))
    return (int)cudaGetLastError();
  }
  TxArgs a;
  if (!tx_rows_args(a, idx, idx_bytes, out_re, out_im, B, S, log_n, cp, scale, twr, twi,
                    noise_mode, n_re, n_im, ch_ids, k0, k1, sigma))
    return (int)cudaErrorInvalidValue;
  a.taps_r = taps_r, a.taps_i = taps_i, a.n_taps = n_taps, a.taps_per_sym = taps_per_sym;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk, return tx_rows_launch_n<M, BPSK, true>(a, st))
  return (int)cudaErrorInvalidValue;
}
