// Kernel B: fused TX + flat channel.
//
// Replaces sdr_tpu/kernels/tx_pallas.py::tx_channel_chain_pallas (flat
// gain and AWGN-only modes) and ::tx_chain_pallas (channel off).
// Per OFDM symbol (one row of the (B, S, N) index plane):
//   Gray split gi = idx >> m, gq = idx & (L-1); prefix-XOR Gray decode;
//   PAM level 2b - (L-1); N-point inverse FFT scaled by norm/N; cyclic
//   prefix (last cp samples first); optional per-channel complex gain
//   hs[b]; optional noise sigma*n over every sample of the CP'd symbol.
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
// Bound on the H100: the two f32 output planes (8 bytes per sample
// written against 1 byte of index read) — memory-bound at the slice's
// shapes, plus the Philox rounds and sincos/log of the noise in mode 2.
#include "common.cuh"
#include "philox.cuh"

template <typename IdxT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
tx_kernel(const IdxT* __restrict__ idx, float* __restrict__ out_re, float* __restrict__ out_im,
          long long n_rows, int S, int log_n, int cp, int log_spb, float scale,
          const float* __restrict__ twr, const float* __restrict__ twi,
          const float* __restrict__ hs_r, const float* __restrict__ hs_i, int noise_mode,
          const float* __restrict__ n_re, const float* __restrict__ n_im,
          const int32_t* __restrict__ ch_ids, uint32_t k0, uint32_t k1, float sigma) {
  extern __shared__ float smem[];
  const int N = 1 << log_n;
  const int spb = 1 << log_spb;
  float* sre = smem;
  float* sim = smem + (spb << log_n);
  const long long row0 = (long long)blockIdx.x << log_spb;
  constexpr int L = 1 << M;

  for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
    const int t = e >> log_n;
    const int n = e & (N - 1);
    const long long r = row0 + t;
    float xr = 0.0f, xi = 0.0f;
    if (r < n_rows) {
      const int v = (int)idx[(r << log_n) + n];
      if (BPSK) {
        xr = (float)(2 * sdr::gray_to_binary<M>(v) - (L - 1));
      } else {
        xr = (float)(2 * sdr::gray_to_binary<M>(v >> M) - (L - 1));
        xi = (float)(2 * sdr::gray_to_binary<M>(v & (L - 1)) - (L - 1));
      }
    }
    const int dst = (t << log_n) + sdr::bit_reverse(n, log_n);
    sre[dst] = xr;
    sim[dst] = xi;
  }
  __syncthreads();
  sdr::smem_fft<false>(sre, sim, log_n, log_spb, N, 1, twr, twi, -1.0f);

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
      const float fr = hs_r[b], fi = hs_i[b];
      const float tr = yr * fr - yi * fi;
      yi = yr * fi + yi * fr;
      yr = tr;
    }
    const long long o = r * sym_len + u;
    if (noise_mode == 1) {
      yr += sigma * n_re[o];
      yi += sigma * n_im[o];
    } else if (noise_mode == 2) {
      const int s = (int)(r - b * S);
      const uint4 w = sdr::philox4x32_10(
          make_uint4((uint32_t)ch_ids[b], (uint32_t)s, (uint32_t)u, 0u), k0, k1);
      float g1, g2;
      sdr::box_muller(w.x, w.y, g1, g2);
      yr += sigma * g1;
      yi += sigma * g2;
    }
    out_re[o] = yr;
    out_im[o] = yi;
  }
}

extern "C" int sdr_tx(const void* idx, int idx_bytes, float* out_re, float* out_im, int B,
                      int S, int log_n, int cp, int bits_per_axis, int bpsk, float scale,
                      const float* twr, const float* twi, const float* hs_r, const float* hs_i,
                      int noise_mode, const float* n_re, const float* n_im,
                      const int32_t* ch_ids, unsigned k0, unsigned k1, float sigma,
                      void* stream) {
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  // Symbols per block: enough for 256 butterflies per stage (N <= 512).
  const int log_spb = log_n >= 9 ? 0 : 9 - log_n;
  const long long blocks = (n_rows + (1 << log_spb) - 1) >> log_spb;
  const size_t smem = (size_t)2 * sizeof(float) * ((size_t)1 << (log_spb + log_n));
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    SDR_DISPATCH_IDX(idx_bytes,
      tx_kernel<IdxT, M, BPSK><<<(unsigned)blocks, sdr::kThreads, smem, st>>>(
          (const IdxT*)idx, out_re, out_im, n_rows, S, log_n, cp, log_spb, scale, twr, twi,
          hs_r, hs_i, noise_mode, n_re, n_im, ch_ids, k0, k1, sigma)))
  return (int)cudaGetLastError();
}
