// Kernel B: fused TX + channel.
//
// Replaces sdr_tpu/kernels/tx_pallas.py::tx_channel_chain_pallas (per-link
// or per-symbol scalar gains, the causal FIR with static or per-symbol
// taps, AWGN) and ::tx_chain_pallas (channel off).
// Per OFDM symbol (one row of the (B, S, N) index plane):
//   Gray split gi = idx >> m, gq = idx & (L-1); prefix-XOR Gray decode;
//   PAM level 2b - (L-1); N-point inverse FFT scaled by norm/N; cyclic
//   prefix (last cp samples first); then either an optional complex gain
//   hs (per link, (B, 1), or per symbol, (B, S)) or a causal FIR
//   y[u] = sum_l tap_l x[u - l] over the CP'd stream; optional noise
//   sigma*n over every sample of the CP'd symbol, added after the FIR.
// Noise modes: 0 off, 1 injected planes (n_re, n_im) of shape
// (B, S, N+cp), 2 keyed Philox: counter (ch_ids[b], s, sample, 0) on
// key seed ^ ROLE_NOISE, Box-Muller on words 0 and 1 — the same bits as
// the plain version in sdr_tpu_torch/kernels/tx.py.
//
// The TPU kernel ran the inverse DFT as an N x N matmul on the MXU. Here
// each block holds a few symbols in shared memory and runs a radix-2
// FFT there (N log N work on CUDA cores, f32), so the clean waveform
// never goes to device memory: the kernel reads the narrow index plane
// and writes the two impaired sample planes once.
//
// At N = 1024 to 4096 the same kernel serves the TPU's wideband TX:
// fourstep_tx_split_pallas.py::tx_chain_fourstep2 and fourstep_tx_pallas.py
// ::tx_chain_fourstep, which factored the inverse DFT into N1·N2 matmul
// steps because a dense N x N operand outgrew VMEM. One symbol's tile is
// 32 KB here at N = 4096, so a block runs the whole radix-2 transform.
//
// The FIR (tx_fir_kernel) needs, for symbol s, the last L-1 samples of
// symbol s-1's CP'd waveform (zeros before symbol 0). A block therefore
// takes one channel and walks its symbols in order, a few at a time,
// carrying the tail of the last symbol of each chunk in shared memory:
// no symbol is transformed twice. Static taps (B, L) give the
// zero-history stream convolution over the whole (S * (N+cp)) stream;
// per-symbol taps (B, S, L) convolve each symbol with its own taps and
// the previous symbol's tail as history (ops/channel.py::symbol_history).
//
// Bound on the H100: the two f32 output planes (8 bytes per sample
// written against 1 byte of index read) — memory-bound at the slice's
// shapes, plus the Philox rounds and sincos/log of the noise in mode 2
// and L complex multiply-adds per sample in the FIR mode.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxTaps = 16;

// Symbols per block: enough for 256 butterflies per stage (N <= 512).
__host__ int log_symbols_per_block(int log_n) { return log_n >= 9 ? 0 : 9 - log_n; }

// Gray-map n_rows_valid of the n_tr rows starting at row0 into shared
// memory, bit-reversed within each transform; rows past the valid ones
// are zeros.
template <typename IdxT, int M, bool BPSK>
__device__ __forceinline__ void load_symbols(const IdxT* __restrict__ idx, long long row0,
                                             int n_valid, int log_n, int log_tr, float* sre,
                                             float* sim) {
  const int N = 1 << log_n;
  for (int e = threadIdx.x; e < (1 << (log_tr + log_n)); e += blockDim.x) {
    const int t = e >> log_n;
    const int n = e & (N - 1);
    float xr = 0.0f, xi = 0.0f;
    if (t < n_valid) sdr::pam_point<M, BPSK>((int)idx[((row0 + t) << log_n) + n], xr, xi);
    const int dst = (t << log_n) + sdr::bit_reverse(n, log_n);
    sre[dst] = xr;
    sim[dst] = xi;
  }
}

// Adds the noise of sample (b, s, u) at flat offset o and stores it.
__device__ __forceinline__ void store_noisy(float yr, float yi, long long o, int noise_mode,
                                            const float* __restrict__ n_re,
                                            const float* __restrict__ n_im, uint32_t ch, int s,
                                            int u, uint32_t k0, uint32_t k1, float sigma,
                                            float* __restrict__ out_re,
                                            float* __restrict__ out_im) {
  if (noise_mode == 1) {
    yr += sigma * n_re[o];
    yi += sigma * n_im[o];
  } else if (noise_mode == 2) {
    const uint4 w = sdr::philox4x32_10(make_uint4(ch, (uint32_t)s, (uint32_t)u, 0u), k0, k1);
    float g1, g2;
    sdr::box_muller(w.x, w.y, g1, g2);
    yr += sigma * g1;
    yi += sigma * g2;
  }
  out_re[o] = yr;
  out_im[o] = yi;
}

template <typename IdxT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
tx_kernel(const IdxT* __restrict__ idx, float* __restrict__ out_re, float* __restrict__ out_im,
          long long n_rows, int S, int log_n, int cp, int log_spb, float scale,
          const float* __restrict__ twr, const float* __restrict__ twi,
          const float* __restrict__ hs_r, const float* __restrict__ hs_i, int h_syms,
          int noise_mode, const float* __restrict__ n_re, const float* __restrict__ n_im,
          const int32_t* __restrict__ ch_ids, uint32_t k0, uint32_t k1, float sigma) {
  extern __shared__ float smem[];
  const int N = 1 << log_n;
  const int spb = 1 << log_spb;
  float* sre = smem;
  float* sim = smem + (spb << log_n);
  const long long row0 = (long long)blockIdx.x << log_spb;
  const long long left = n_rows - row0;

  load_symbols<IdxT, M, BPSK>(idx, row0, left < spb ? (int)left : spb, log_n, log_spb, sre,
                              sim);
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

// One block per channel; chunks of spb symbols in order. Shared memory:
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
    load_symbols<IdxT, M, BPSK>(idx, row0, n_sym, log_n, log_spb, sre, sim);
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
      float ar = 0.0f, ai = 0.0f;
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
        const float tr = tp_r[t * kMaxTaps + l], ti = tp_i[t * kMaxTaps + l];
        ar += tr * xr - ti * xi;
        ai += tr * xi + ti * xr;
      }
      store_noisy(ar, ai, (row0 + t) * sym_len + u, noise_mode, n_re, n_im, ch, s0 + t, u, k0,
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

extern "C" int sdr_tx(const void* idx, int idx_bytes, float* out_re, float* out_im, int B,
                      int S, int log_n, int cp, int bits_per_axis, int bpsk, float scale,
                      const float* twr, const float* twi, const float* hs_r, const float* hs_i,
                      int h_syms, int noise_mode, const float* n_re, const float* n_im,
                      const int32_t* ch_ids, unsigned k0, unsigned k1, float sigma,
                      void* stream) {
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  const int log_spb = log_symbols_per_block(log_n);
  const long long blocks = (n_rows + (1 << log_spb) - 1) >> log_spb;
  const size_t smem = (size_t)2 * sizeof(float) * ((size_t)1 << (log_spb + log_n));
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    SDR_DISPATCH_IDX(idx_bytes,
      tx_kernel<IdxT, M, BPSK><<<(unsigned)blocks, sdr::kThreads, smem, st>>>(
          (const IdxT*)idx, out_re, out_im, n_rows, S, log_n, cp, log_spb, scale, twr, twi,
          hs_r, hs_i, h_syms, noise_mode, n_re, n_im, ch_ids, k0, k1, sigma)))
  return (int)cudaGetLastError();
}

extern "C" int sdr_tx_fir(const void* idx, int idx_bytes, float* out_re, float* out_im, int B,
                          int S, int log_n, int cp, int bits_per_axis, int bpsk, float scale,
                          const float* twr, const float* twi, const float* taps_r,
                          const float* taps_i, int n_taps, int taps_per_sym, int noise_mode,
                          const float* n_re, const float* n_im, const int32_t* ch_ids,
                          unsigned k0, unsigned k1, float sigma, void* stream) {
  if ((long long)B * S == 0) return 0;
  if (n_taps < 1 || n_taps > kMaxTaps || n_taps - 1 > (1 << log_n) + cp)
    return (int)cudaErrorInvalidValue;
  // No more symbols per chunk than the channel has.
  int log_spb = log_symbols_per_block(log_n);
  while (log_spb > 0 && (1 << (log_spb - 1)) >= S) --log_spb;
  const size_t smem = sizeof(float) * ((size_t)2 * ((size_t)1 << (log_spb + log_n)) +
                                       (size_t)2 * kMaxTaps * ((size_t)1 << log_spb));
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    SDR_DISPATCH_IDX(idx_bytes,
      tx_fir_kernel<IdxT, M, BPSK><<<(unsigned)B, sdr::kThreads, smem, st>>>(
          (const IdxT*)idx, out_re, out_im, S, log_n, cp, log_spb, scale, twr, twi, taps_r,
          taps_i, n_taps, taps_per_sym, noise_mode, n_re, n_im, ch_ids, k0, k1, sigma)))
  return (int)cudaGetLastError();
}
