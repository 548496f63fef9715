// Kernel E: fading gain + AWGN over a waveform built elsewhere.
//
// Replaces sdr_tpu/kernels/channel_pallas.py::fade_awgn_pallas, the fast
// engine's staged channel stage (link/fast.py::apply_channel_fast): one
// read-modify-write pass over the planar (B, S, L) samples,
//   out = x * h + sigma * n,
// with h an optional complex gain per link (hs of shape (B, 1)) or per
// symbol ((B, S)), sigma = sqrt(noise_var / 2).
// Noise modes: 0 off, 1 injected planes (n_re, n_im) of shape (B, S, L),
// 2 keyed Philox with kernel B's counter: (ch_ids[b], s, sample, 0) on key
// seed ^ ROLE_NOISE, Box-Muller on words 0 and 1. The TPU kernel seeded
// its on-core PRNG per 128-channel block; the counter here is kernel B's,
// so the staged route (plain FIR + this kernel) and the fused one (kernel
// B's FIR mode) draw the same noise for the same samples.
//
// Bound on the H100: pure memory traffic, two f32 planes read and two
// written (16 bytes per sample), plus the Philox rounds and the log and
// sincos of Box-Muller in mode 2. A block takes kRows consecutive rows,
// so consecutive threads touch consecutive samples (coalesced).
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kRows = 8;  // (b, s) rows per block

__global__ void __launch_bounds__(sdr::kThreads)
fade_awgn_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ out_re, float* __restrict__ out_im, long long n_rows,
                 int S, int L, const float* __restrict__ hr, const float* __restrict__ hi,
                 int h_syms, int noise_mode, const float* __restrict__ n_re,
                 const float* __restrict__ n_im, const int32_t* __restrict__ ch_ids,
                 uint32_t k0, uint32_t k1, float sigma) {
  const long long row0 = (long long)blockIdx.x * kRows;
  for (int e = threadIdx.x; e < kRows * L; e += blockDim.x) {
    const int t = e / L;
    const int u = e - t * L;
    const long long r = row0 + t;
    if (r >= n_rows) break;
    const long long b = r / S;
    const long long o = r * L + u;
    float yr = re[o], yi = im[o];
    if (hr != nullptr) {
      const long long g = h_syms > 1 ? r : b;
      const float fr = hr[g], fi = hi[g];
      const float tr = yr * fr - yi * fi;
      yi = yr * fi + yi * fr;
      yr = tr;
    }
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

}  // namespace

extern "C" int sdr_fade_awgn(const float* re, const float* im, float* out_re, float* out_im,
                             int B, int S, int L, const float* hr, const float* hi, int h_syms,
                             int noise_mode, const float* n_re, const float* n_im,
                             const int32_t* ch_ids, unsigned k0, unsigned k1, float sigma,
                             void* stream) {
  const long long n_rows = (long long)B * S;
  if (n_rows == 0 || L == 0) return 0;
  const long long blocks = (n_rows + kRows - 1) / kRows;
  fade_awgn_kernel<<<(unsigned)blocks, sdr::kThreads, 0, (cudaStream_t)stream>>>(
      re, im, out_re, out_im, n_rows, S, L, hr, hi, h_syms, noise_mode, n_re, n_im, ch_ids,
      k0, k1, sigma);
  return (int)cudaGetLastError();
}
